"""Co-located serving (``repro_torch.train.colocate``, ``ServeSpec``) on
one device, against the JAX package's own ``ColocatedMeshTrainer``.

The in-process tests of ``tests/test_colocate.py`` are mirrored on the
port: serve-slice carving, the SLO policy, the steady traffic generator,
``ServeSpec`` validation, the batcher's stats on an idle queue, the
front-door guards (mesh backend and BSP only), the shared-mode charge, and
dedicated mode on one device raising "fully preempted".

The reference's trainer runs here as in ``tests/test_torch_mesh.py``: its
``shard_map`` wrapped to pass ``mesh=`` by keyword, and every module that
reads the time (``train.mesh``, ``train.colocate``, ``serve.scheduler``,
``serve.slots``, on both sides) given a fake clock of its own whose
``perf_counter()`` advances by 1.0 a read.  Both trainers train linreg on
the reference's batches from its initial parameters, and the port's decode
engine gets the reference's serve parameters after construction (its
warm-up restores state, so nothing else changes).  Batches, worker times,
the engine clock, ``round_charges``, ``serve_stats()`` and every finished
token stream are ``==``; losses agree to rtol 1e-4.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import numpy as np
import pytest
import torch

import repro.api as R
import repro.serve.scheduler as ref_sched_mod
import repro.serve.slots as ref_slots_mod
import repro.train.colocate as ref_colo_mod
import repro.train.mesh as ref_mesh_mod
import repro_torch.serve.scheduler as sched_mod
import repro_torch.serve.slots as slots_mod
import repro_torch.train.colocate as colo_mod
import repro_torch.train.mesh as mesh_mod
from repro.compat import shard_map as ref_shard_map
from repro.core import carve_serve as ref_carve_serve
from repro.models.simple import paper_workloads as ref_paper_workloads
from repro.optim import sgd as ref_sgd
from repro.serve.colocate import ServeSpec as RefServeSpec
from repro_torch import api as T
from repro_torch.core import ServeSlice, carve_serve
from repro_torch.models import (paper_params_from_jax, paper_workloads,
                                params_from_jax)
from repro_torch.optim import sgd
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.serve.colocate import ServeSpec, ServeTraffic, SLOPolicy

CPU = dict(device="cpu")


class FakeClock:
    """``perf_counter()`` that advances by exactly 1.0 a read."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


REF_CLOCKED = (ref_mesh_mod, ref_colo_mod, ref_sched_mod, ref_slots_mod)
PORT_CLOCKED = (mesh_mod, colo_mod, sched_mod, slots_mod)


def _keyword_shard_map(f, mesh, **kw):
    return ref_shard_map(f, mesh=mesh, **kw)


# ----------------------------------------------------------- serve carving


class TestCarveServe:
    """``tests/test_colocate.py::TestCarveServe`` on the port, each plan
    ``==`` the reference's."""

    def test_dedicated_withholds_top_devices(self):
        plan, sl = carve_serve(8, 3, 2, mode="dedicated")
        assert sl.dedicated and sl.start == 6 and sl.length == 2
        assert plan.extent == 6 and plan.k == 3
        covered = sorted(i for w in range(plan.k)
                         for i in plan.devices_of(w))
        assert covered == list(range(6))
        assert set(sl.devices()) == {6, 7}
        ref_plan, ref_sl = ref_carve_serve(8, 3, 2, mode="dedicated")
        assert plan.slices == ref_plan.slices
        assert (sl.start, sl.length, sl.shared_with) == \
            (ref_sl.start, ref_sl.length, ref_sl.shared_with)

    def test_shared_maps_to_last_worker(self):
        plan, sl = carve_serve(8, 3, 0, mode="shared")
        assert not sl.dedicated and sl.shared_with == 2
        assert (sl.start, sl.length) == plan.slices[-1]
        assert plan.extent == 8
        assert plan.slices == ref_carve_serve(8, 3, 0,
                                              mode="shared")[0].slices

    def test_whole_axis_is_a_clear_error(self):
        with pytest.raises(ValueError, match="fully preempted"):
            carve_serve(4, 2, 4, mode="dedicated")
        with pytest.raises(ValueError, match="fully preempted"):
            carve_serve(4, 2, 6, mode="dedicated")

    def test_validation(self):
        with pytest.raises(ValueError):
            carve_serve(8, 2, 1, mode="fractional")
        with pytest.raises(ValueError):
            carve_serve(8, 2, 0, mode="dedicated")
        with pytest.raises(ValueError):
            carve_serve(8, 2, -1, mode="shared")
        with pytest.raises(ValueError):
            carve_serve(8, 2, 3, mode="dedicated", quantum=2)
        with pytest.raises(ValueError):
            carve_serve(4, 2, 3, mode="dedicated")
        with pytest.raises(ValueError):
            ServeSlice(start=-1, length=2)
        with pytest.raises(ValueError):
            ServeSlice(start=0, length=0)

    def test_dedicated_respects_quantum(self):
        plan, sl = carve_serve(12, 2, 4, mode="dedicated", quantum=4)
        assert sl.start == 8 and sl.length == 4
        assert all(length % 4 == 0 for length in plan.lengths)


def test_mesh_trainer_reserve_whole_axis_errors():
    from repro_torch.train.loop import TrainConfig
    from repro_torch.train.mesh import MeshTrainer

    wl = T.paper_workload("linreg")
    for reserve in (1, -1):
        with pytest.raises(ValueError, match="fully preempted"):
            MeshTrainer(
                num_workers=1, init_params=wl.init,
                loss_and_grad=wl.loss_and_grad, next_batch=wl.next_batch,
                optimizer=sgd(0.05),
                cfg=TrainConfig(b0=8, microbatch=4, max_steps=2),
                reserve=reserve, **CPU)


# ------------------------------------------------------------- SLO policy


class TestSLOPolicy:
    IDLE = {"finished": 0, "queued": 0, "free_slots": 2,
            "mean_queue_delay_steps": 0.0, "p95_queue_delay_steps": 0.0,
            "occupancy_now": 0.0}

    def test_zero_free_slots_with_backlog_grows(self):
        policy = SLOPolicy(slo_queue_delay=2.0)
        stats = dict(self.IDLE, queued=3, free_slots=0, occupancy_now=1.0)
        assert policy.decide(stats) == "grow"

    def test_slo_breach_grows_even_with_free_slots(self):
        policy = SLOPolicy(slo_queue_delay=2.0)
        stats = dict(self.IDLE, queued=1, free_slots=1,
                     mean_queue_delay_steps=5.0, occupancy_now=0.5)
        assert policy.decide(stats) == "grow"

    def test_busy_but_healthy_holds(self):
        policy = SLOPolicy(slo_queue_delay=2.0)
        stats = dict(self.IDLE, queued=0, free_slots=1, occupancy_now=0.5)
        assert policy.decide(stats) == "hold"

    def test_idle_needs_patience_then_shrinks(self):
        policy = SLOPolicy(idle_patience=3)
        assert policy.decide(self.IDLE) == "hold"
        assert policy.decide(self.IDLE) == "hold"
        assert policy.decide(self.IDLE) == "shrink"
        assert policy.decide(self.IDLE) == "hold"

    def test_activity_resets_the_idle_streak(self):
        policy = SLOPolicy(idle_patience=2)
        assert policy.decide(self.IDLE) == "hold"
        busy = dict(self.IDLE, occupancy_now=0.5, free_slots=1)
        assert policy.decide(busy) == "hold"
        assert policy.decide(self.IDLE) == "hold"
        assert policy.decide(self.IDLE) == "shrink"


# ------------------------------------------------------- traffic generator


class TestServeTraffic:
    def test_fractional_rate_accumulates(self):
        t = ServeTraffic(rate=0.5, prompt_len=3, max_new_tokens=4,
                         vocab_size=100)
        arrivals = [len(t.next_round()) for _ in range(6)]
        assert arrivals == [0, 1, 0, 1, 0, 1]
        assert t.submitted == 3

    def test_deterministic_across_seeds(self):
        a = ServeTraffic(rate=1.0, prompt_len=4, max_new_tokens=2,
                         vocab_size=50, seed=7)
        b = ServeTraffic(rate=1.0, prompt_len=4, max_new_tokens=2,
                         vocab_size=50, seed=7)
        for _ in range(3):
            ra, rb = a.next_round(), b.next_round()
            assert [r.prompt.tolist() for r in ra] == \
                [r.prompt.tolist() for r in rb]

    def test_validation(self):
        with pytest.raises(ValueError):
            ServeTraffic(rate=-1.0, prompt_len=3, max_new_tokens=4,
                         vocab_size=10)
        with pytest.raises(ValueError):
            ServeTraffic(rate=1.0, prompt_len=0, max_new_tokens=4,
                         vocab_size=10)


# ----------------------------------------------------------- spec validation


class TestServeSpec:
    def test_defaults_valid(self):
        ServeSpec()
        assert ServeSpec() == ServeSpec(**vars(RefServeSpec()))

    @pytest.mark.parametrize("kw", [
        {"mode": "exclusive"},
        {"devices": 0},
        {"slots": 0},
        {"requests_per_round": -0.5},
        {"prompt_len": 0},
        {"cache_len": 4, "prompt_len": 4},
        {"decode_steps_per_round": 0},
        {"check_every": 0},
        {"engine": "turbo"},
        {"traffic": "bursty"},
        {"peak_rate": 0.5, "requests_per_round": 1.0},
        {"period": 1},
    ])
    def test_rejects_bad_fields(self, kw):
        with pytest.raises(ValueError):
            ServeSpec(**kw)
        with pytest.raises(ValueError):
            RefServeSpec(**kw)

    def test_production_shape_fields(self):
        sp = ServeSpec(engine="disaggregated", traffic="diurnal",
                       peak_rate=4.0, period=16)
        assert sp.engine == "disaggregated" and sp.traffic == "diurnal"


# -------------------------------------------- batcher stats / empty queue


@pytest.fixture(scope="module")
def small_lm():
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm, reduced

    cfg = reduced(get_config("gemma-2b"))
    return init_lm(torch.Generator().manual_seed(0), cfg), cfg


def test_batcher_stats_under_empty_queue(small_lm):
    params, cfg = small_lm
    b = ContinuousBatcher(params, cfg, slots=3, cache_len=32, **CPU)
    stats = b.stats()
    assert stats["finished"] == 0 and stats["queued"] == 0
    assert stats["free_slots"] == 3 and stats["occupancy_now"] == 0.0
    assert stats["mean_queue_delay_steps"] == 0.0
    assert stats["p95_queue_delay_steps"] == 0.0
    b.step()
    b.step()
    stats = b.stats()
    assert stats["free_slots"] == 3 and stats["queued"] == 0
    assert b.step_count == 2


def test_batcher_queue_delay_stats_are_windowed(small_lm):
    params, cfg = small_lm
    rng = np.random.default_rng(3)
    b = ContinuousBatcher(params, cfg, slots=1, cache_len=16, **CPU)
    for uid in range(3):
        b.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size,
                                                      size=2),
                         max_new_tokens=2))
    b.run_until_idle()
    assert b.stats()["mean_queue_delay_steps"] > 0
    b.recent_delays.extend([0] * b.recent_delays.maxlen)
    assert b.stats()["mean_queue_delay_steps"] == 0.0
    assert b.stats()["p95_queue_delay_steps"] == 0.0


def test_batcher_warmup_compiles_without_state_leak(small_lm):
    params, cfg = small_lm
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=4)

    plain = ContinuousBatcher(params, cfg, slots=2, cache_len=32, **CPU)
    plain.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
    want = plain.run_until_idle()[0].tokens

    warmed = ContinuousBatcher(params, cfg, slots=2, cache_len=32, **CPU)
    warmed.warmup()
    assert warmed.stats()["free_slots"] == 2
    warmed.submit(Request(uid=0, prompt=prompt, max_new_tokens=5))
    assert warmed.run_until_idle()[0].tokens == want, \
        "warmup must not perturb subsequent decodes"


# ------------------------------------------ front-door guards + fallback run


def _experiment(serve, backend, sync="bsp", steps=2):
    return T.Experiment(
        workload=T.paper_workload("linreg"),
        cluster=T.ClusterSpec.homogeneous(30, 3, backend=backend,
                                          serve=serve),
        optimizer=sgd(0.05),
        config=T.TrainConfig(b0=8, microbatch=4, batching="dynamic",
                             init_allocation="uniform", sync=sync,
                             max_steps=steps))


def test_serve_requires_mesh_backend():
    with pytest.raises(ValueError, match="mesh"):
        _experiment(ServeSpec(), T.SimBackend(**CPU)).build()


def test_serve_requires_bsp():
    with pytest.raises(ValueError, match="asp"):
        _experiment(ServeSpec(), T.MeshBackend(**CPU), sync="asp").build()


def test_shared_mode_charges_contended_worker_on_fallback():
    """One device: the workers time-multiplex it and the decode loop
    shares it; the charge lands on the contended worker's recorded times
    and the serve stats reach the result and the summary."""
    collector = T.MetricCollector()
    exp = _experiment(
        ServeSpec(mode="shared", requests_per_round=2.0, slots=2,
                  decode_steps_per_round=2, prompt_len=2, max_new_tokens=3,
                  cache_len=16),
        T.MeshBackend(**CPU), steps=3)
    session = exp.session(hooks=[collector])
    out = session.run()
    trainer = session.trainer
    assert out["steps"] == 3
    serve = out["serve"]
    assert serve["mode"] == "shared"
    assert serve["shared_with"] == trainer.k - 1
    assert serve["decode_steps"] > 0
    assert serve["charged_seconds"] > 0
    contended = serve["shared_with"]
    total = sum(r.worker_times[contended] for r in out["history"])
    assert total >= serve["charged_seconds"]
    assert sum(trainer.round_charges) == pytest.approx(
        serve["charged_seconds"])
    assert collector.summary["serve"]["charged_seconds"] == \
        serve["charged_seconds"]
    with pytest.raises(ValueError, match="fully preempted"):
        _experiment(ServeSpec(mode="dedicated", devices=1),
                    T.MeshBackend(**CPU), steps=2).build()


# --------------------------------- == the reference's ColocatedMeshTrainer

SHARED = dict(mode="shared", requests_per_round=2.0, slots=2,
              decode_steps_per_round=2, prompt_len=2, max_new_tokens=3,
              cache_len=16)
# (serve spec knobs, cluster, TrainConfig knobs, steps, schedule)
RUNS = {
    # the configuration whose reference numbers the module docstring of
    # this test pins: uniform start, a steady 2 requests a round
    "shared-batcher": (dict(SHARED, engine="batcher"), "homogeneous",
                       dict(init_allocation="uniform"), 4, False),
    "shared-disaggregated": (dict(SHARED, engine="disaggregated"),
                             "homogeneous", dict(init_allocation="uniform"),
                             4, False),
    # poisson traffic into a probed h-level fleet, worker 0 leaving at
    # step 3 (the contended worker's index follows)
    "poisson-probe-remove": (
        dict(mode="shared", requests_per_round=1.5, slots=3,
             decode_steps_per_round=3, prompt_len=3, max_new_tokens=4,
             cache_len=24, traffic="poisson", seed=5, engine="batcher"),
        "hlevel", dict(), 6, True),
}
PINNED = {"batches": [[11, 11, 2], [12, 11, 1], [12, 11, 1], [12, 11, 1]],
          "worker_times": [[1.0, 1.0, 6.0]] * 4, "charged_seconds": 20.0,
          "decode_steps": 8, "finished": 4, "serve_slice": (0, 1),
          "shared_with": 2,
          "streams": [(0, [326] * 3), (1, [138] * 3), (2, [20] * 3),
                      (3, [8] * 3)]}


def _injected_next_batch(make_batch, seed):
    counters = {}

    def nb(worker, n):
        counters[worker] = counters.get(worker, 0) + 1
        key = jax.random.fold_in(jax.random.PRNGKey(seed + worker),
                                 counters[worker])
        return {k: torch.from_numpy(np.array(v))
                for k, v in make_batch(key, n).items()}

    return nb


def _cluster(api, kind, backend, serve, remove):
    if kind == "homogeneous":
        spec = api.ClusterSpec.homogeneous(30, 3, backend=backend,
                                           serve=serve)
    else:
        spec = api.ClusterSpec.hlevel(39, 4.0, 3, backend=backend,
                                      serve=serve)
    if remove:
        spec = spec.with_schedule(api.RemoveWorker(3, 0))
    return spec


def _summary(out, trainer):
    hist = out["history"]
    return {"batches": [r.batches for r in hist],
            "worker_times": [r.worker_times for r in hist],
            "sim_time": [r.sim_time for r in hist],
            "round_charges": list(trainer.round_charges),
            "serve": out["serve"],
            "metrics": out["metrics"]["serve"],
            "membership": [tuple(e) for e in out.get("membership_log", [])],
            "streams": sorted((r.uid, list(r.tokens))
                              for r in trainer.batcher.finished),
            "queued": [(r.uid, list(r.tokens))
                       for r in trainer.batcher.queue],
            "losses": [r.loss for r in hist]}


@pytest.fixture(scope="module", params=list(RUNS))
def ref_run(request):
    """The reference's co-located run: shim and fake clocks on for its
    duration only."""
    knobs, cluster, cfg_kw, steps, remove = RUNS[request.param]
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_mesh_mod, "shard_map", _keyword_shard_map)
    for mod in REF_CLOCKED:
        mp.setattr(mod, "_time", FakeClock())
    try:
        exp = R.Experiment(
            workload=R.paper_workload("linreg"),
            cluster=_cluster(R, cluster, R.MeshBackend(),
                             RefServeSpec(**knobs), remove),
            optimizer=ref_sgd(0.05),
            config=R.TrainConfig(b0=8, microbatch=4, batching="dynamic",
                                 sync="bsp", max_steps=steps, **cfg_kw))
        session = exp.session(hooks=[R.MetricCollector()])
        out = session.run()
        serve_params = jax.tree_util.tree_map(
            np.asarray, session.trainer._serve_params)
        return request.param, _summary(out, session.trainer), serve_params
    finally:
        mp.undo()


def test_colocated_trainer_matches_reference(ref_run, monkeypatch):
    name, want, serve_params = ref_run
    knobs, cluster, cfg_kw, steps, remove = RUNS[name]
    for mod in PORT_CLOCKED:
        monkeypatch.setattr(mod, "_time", FakeClock())
    ref_wl = ref_paper_workloads()["linreg"]
    params0 = jax.tree_util.tree_map(
        np.asarray, ref_wl.init(jax.random.PRNGKey(0)))
    wl = T.Workload(
        name="linreg",
        init=lambda gen: paper_params_from_jax("linreg", params0,
                                               device=gen.device),
        loss_and_grad=T.sum_loss_adapter(paper_workloads()["linreg"].loss_fn),
        next_batch=_injected_next_batch(ref_wl.make_batch, 100))
    exp = T.Experiment(
        workload=wl,
        cluster=_cluster(T, cluster, T.MeshBackend(**CPU),
                         ServeSpec(**knobs), remove),
        optimizer=sgd(0.05),
        config=T.TrainConfig(b0=8, microbatch=4, batching="dynamic",
                             sync="bsp", max_steps=steps, **cfg_kw))
    session = exp.session(hooks=[T.MetricCollector()])
    trainer = session.trainer
    # the reference's decode parameters, into every program that decodes
    params = params_from_jax(serve_params, trainer.serve_model_cfg, **CPU)
    if trainer.prefill is not None:
        trainer.prefill.params = params
        for shard in trainer.batcher.shards.values():
            shard.params = params
    else:
        trainer.batcher.params = params
    got = _summary(session.run(), trainer)
    np.testing.assert_allclose(got.pop("losses"), want["losses"], rtol=1e-4)
    assert got == {k: v for k, v in want.items() if k != "losses"}
    if name.startswith("shared-"):
        assert got["batches"] == PINNED["batches"]
        assert got["worker_times"] == PINNED["worker_times"]
        serve = got["serve"]
        assert serve["charged_seconds"] == PINNED["charged_seconds"]
        assert serve["decode_steps"] == PINNED["decode_steps"]
        assert serve["requests_finished"] == PINNED["finished"]
        assert serve["serve_slice"] == PINNED["serve_slice"]
        assert serve["shared_with"] == PINNED["shared_with"]
        assert got["streams"] == PINNED["streams"]
    else:
        assert got["membership"] and trainer.serve_slice.shared_with == 1
