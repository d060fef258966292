"""Slice 5, the measured backend, against the reference's own ``MeshTrainer``
on the CPU.

The reference's mesh leg does not run on this toolchain as it stands:
``repro/train/mesh.py`` passes the mesh to ``shard_map`` by position, and
the installed jax takes it by keyword.  The ``clocks`` fixture therefore
patches, for one test at a time (pytest's ``monkeypatch`` undoes it):

  * ``repro.train.mesh.shard_map`` with a wrapper that passes ``mesh=`` by
    keyword, which changes nothing else of the reference;
  * ``repro.train.mesh._time`` and the port's ``repro_torch.train.mesh._time``
    with one fake clock each, whose ``perf_counter()`` advances by exactly
    1.0 a read, so both trainers measure the same times: 1.0 s a gradient
    call, times the worker's dilation.

The inputs are the same on both sides: the paper workloads with the
reference's batches injected and its initial parameters carried over, and
a reduced gemma-2b on the shared numpy token stream with the reference's
parameters.  What the measured times decide (probe plan, per-step batches,
worker times, buckets, warm-up reruns, engine clock, membership logs, ASP's
update order and staleness) must be ``==`` the reference's; losses agree to
rtol 1e-4.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import math

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.api as R
import repro.het.spot as ref_spot
import repro.train.mesh as ref_mesh
from repro.compat import shard_map as ref_shard_map
from repro.configs import get_config as ref_get_config
from repro.core import ControllerConfig as RefControllerConfig
from repro.core import plan_slices as ref_plan_slices
from repro.core import weighted_psum as ref_weighted_psum
from repro.data import DataPipeline as RefDataPipeline
from repro.het.simulator import WorkerSpec as RefWorkerSpec
from repro.models import reduced as ref_reduced
from repro.models.simple import paper_workloads as ref_paper_workloads
from repro.optim import adam as ref_adam
from repro.optim import sgd as ref_sgd
from repro_torch import api as T
from repro_torch import core as TC
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.het import WorkerSpec
from repro_torch.het.spot import storm_market
from repro_torch.models import (paper_params_from_jax, paper_workloads,
                                params_from_jax, reduced)
from repro_torch.optim import adam, sgd
from repro_torch.train import mesh as port_mesh

import test_torch_slice_outer as conformance

DILATION = [3.0, 1.5, 1.0]
CPU = dict(device="cpu")


class FakeClock:
    """``perf_counter()`` that advances by exactly 1.0 a read."""

    def __init__(self):
        self.t = 0.0
        self.reads = 0

    def perf_counter(self):
        self.t += 1.0
        self.reads += 1
        return self.t


def _keyword_shard_map(f, mesh, **kw):
    return ref_shard_map(f, mesh=mesh, **kw)


@pytest.fixture
def clocks(monkeypatch):
    monkeypatch.setattr(ref_mesh, "shard_map", _keyword_shard_map)
    ref_clock, port_clock = FakeClock(), FakeClock()
    monkeypatch.setattr(ref_mesh, "_time", ref_clock)
    monkeypatch.setattr(port_mesh, "_time", port_clock)
    return ref_clock, port_clock


# ------------------------------------------------------------------ inputs


def _injected_next_batch(make_batch, seed):
    """The reference's ``CounterBatchSource`` stream, as CPU tensors."""
    counters = {}

    def nb(worker, n):
        counters[worker] = counters.get(worker, 0) + 1
        key = jax.random.fold_in(jax.random.PRNGKey(seed + worker),
                                 counters[worker])
        return {k: torch.from_numpy(np.array(v))
                for k, v in make_batch(key, n).items()}

    return nb


def _paper_pair(name):
    """(reference workload, port workload on its initial params and batches)."""
    ref_wl = ref_paper_workloads()[name]
    params0 = jax.tree_util.tree_map(
        np.asarray, ref_wl.init(jax.random.PRNGKey(0)))
    port = T.Workload(
        name=name,
        init=lambda gen: paper_params_from_jax(name, params0,
                                               device=gen.device),
        loss_and_grad=T.sum_loss_adapter(paper_workloads()[name].loss_fn),
        next_batch=_injected_next_batch(ref_wl.make_batch, 100))
    return R.paper_workload(name), port


GEMMA_SEQ = 16


def _gemma_pair():
    ref_cfg = ref_reduced(ref_get_config("gemma-2b"))
    ref_wl = R.lm_workload(ref_cfg, RefDataPipeline(ref_cfg, seq_len=GEMMA_SEQ,
                                                    num_workers=3))
    params0 = jax.tree_util.tree_map(
        np.asarray, ref_wl.init(jax.random.PRNGKey(0)))
    cfg = reduced(get_config("gemma-2b"))
    port = T.lm_workload(cfg, DataPipeline(cfg, seq_len=GEMMA_SEQ,
                                           num_workers=3, device="cpu"),
                         use_kernel=True)
    port.init = lambda gen: params_from_jax(params0, cfg, device=gen.device)
    return ref_wl, port


# (workload pair, cost model, TrainConfig knobs, optimizers, steps)
RUNS = {
    "linreg": (lambda: _paper_pair("linreg"), "mnist-cnn",
               dict(b0=16, microbatch=4), (ref_sgd(0.05), sgd(0.05)), 5),
    "mnist-cnn": (lambda: _paper_pair("mnist-cnn"), "mnist-cnn",
                  dict(b0=4, microbatch=4), (ref_adam(2e-3), adam(2e-3)), 2),
    "gemma": (_gemma_pair, "transformer",
              dict(b0=4, microbatch=2), (ref_adam(1e-3), adam(1e-3)), 3),
}


def _config(api, *, controller_pkg=None, **kw):
    kw.setdefault("batching", "dynamic")
    kw.setdefault("seed", 0)
    if controller_pkg is not None:
        kw["controller"] = controller_pkg(kind="p")
    return api.TrainConfig(**kw)


def _both(name, *, schedule=(), sync="bsp", dilation=DILATION, steps=None,
          cluster=None):
    """Run ``RUNS[name]`` on the reference's and the port's MeshBackend;
    returns ((out, trainer, initial batches), same for the port)."""
    pair, cost, knobs, (ref_opt, opt), n = RUNS[name]
    ref_wl, port_wl = pair()
    runs = []
    for api, wl, optimizer, backend, ctl in (
            (R, ref_wl, ref_opt, R.MeshBackend(dilation=dilation),
             RefControllerConfig),
            (T, port_wl, opt, T.MeshBackend(dilation=dilation, **CPU),
             TC.ControllerConfig)):
        spec = cluster(api) if cluster is not None else \
            api.ClusterSpec.hlevel(39, 6, workload=cost, backend=backend)
        spec.backend = backend
        if schedule:
            spec.with_schedule(*schedule(api))
        session = api.Experiment(
            workload=wl, cluster=spec, optimizer=optimizer,
            config=_config(api, sync=sync, max_steps=steps or n,
                           controller_pkg=ctl, **knobs)).session()
        init = list(session.trainer.batches)
        runs.append((session.run(), session.trainer, init))
    return runs


def _decisions(out, t, init):
    return {
        "probe_plan": init,
        "records": [(r.step, r.batches, r.worker_times, r.sim_time,
                     r.iteration_time, r.adjusted, r.straggler_waste)
                    for r in out["history"]],
        "buckets": [sorted(b) for b in t.worker_buckets],
        "timing_reruns": t.timing_reruns,
        "clock": (t.time_model.time, t.time_model.iteration),
        "exec": t.exec_state_dict(),
        "membership": [tuple(e) for e in t.membership_log],
        "final_batches": list(out["final_batches"]),
    }


def _assert_losses_close(out, ref_out):
    for a, b in zip(out["history"], ref_out["history"], strict=True):
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4)


# ----------------------------------------------------- BSP against the ref


@pytest.mark.parametrize("name", list(RUNS))
def test_bsp_matches_reference_mesh_trainer(clocks, name):
    (ref_out, ref_t, ref_init), (out, t, init) = _both(name)
    want = _decisions(ref_out, ref_t, ref_init)
    assert _decisions(out, t, init) == want
    _assert_losses_close(out, ref_out)
    # the run is ragged, and the reruns counted are the warm-ups' (one per
    # bucket of the shared record), within the ladder bound per worker
    assert any(len(set(r.batches)) > 1 for r in out["history"])
    assert t.timing_reruns == len(set().union(*t.worker_buckets))
    b0 = RUNS[name][2]["b0"]
    for k, buckets in enumerate(t.worker_buckets):
        seen = [r.batches[k] for r in out["history"]] + [b0, init[k]]
        lo, hi = min(seen), max(seen)
        bound = math.ceil(math.log(hi / lo, 1.25)) + 1 if hi > lo else 1
        assert len(buckets) <= bound
    # two reads of the fake clock a call, two more a rerun, as the reference
    ref_clock, port_clock = clocks
    assert port_clock.reads == ref_clock.reads == \
        2 * (t.accum_calls + t.timing_reruns)
    # the dilation reached the controller: the slowest worker ran least
    assert out["final_batches"][0] == min(out["final_batches"])


def test_membership_events_match_reference(clocks):
    def schedule(api):
        spec = RefWorkerSpec if api is R else WorkerSpec
        return (api.RemoveWorker(step=3, worker=0),
                api.AddWorker(step=6, spec=spec(cores=12)))

    (ref_out, ref_t, ref_init), (out, t, init) = _both(
        "linreg", schedule=schedule, dilation=None, steps=9)
    assert _decisions(out, t, init) == _decisions(ref_out, ref_t, ref_init)
    assert [(s, kind) for s, kind, _ in out["membership_log"]] == \
        [(3, "remove"), (6, "add")]
    assert len(out["final_batches"]) == 3
    total = sum(out["history"][0].batches)
    assert all(sum(r.batches) == total for r in out["history"])
    _assert_losses_close(out, ref_out)


def test_lone_worker_owns_the_device_slice_as_in_reference(clocks):
    """With its default switch the reference gives a lone worker the
    one-device slice record (``concurrent``, slices [[0, 1]]); the port
    keeps the same record, so buckets, reruns and ``exec_state_dict`` are
    ``==``."""
    def cluster(api):
        spec = RefWorkerSpec if api is R else WorkerSpec
        return api.ClusterSpec.explicit([spec(cores=8)], workload="mnist-cnn",
                                        seed=0)

    (ref_out, ref_t, ref_init), (out, t, init) = _both(
        "linreg", cluster=cluster, dilation=None, steps=4)
    assert _decisions(out, t, init) == _decisions(ref_out, ref_t, ref_init)
    _assert_losses_close(out, ref_out)
    assert t.exec_state_dict()["slices"] == [[0, 1]]


def test_record_switch_clears_buckets(clocks):
    """Down to one worker and back: the lone survivor moves to the slice
    record and the rejoined fleet back to a shared one, each a new record,
    so the buckets are cleared and the first call at each bucket is rerun
    again.  (The reference's own switch fails on this jax: its slice mesh
    and the full mesh carry different axis types.)"""
    session = _port_linreg(max_steps=6).session()
    t = session.trainer
    session.step()
    t.remove_worker(0)
    t.remove_worker(0)
    assert t.exec_state_dict()["slices"] == [[0, 1]]
    assert t.worker_buckets == [set()]
    reruns, lone = t.timing_reruns, t.batches[0]
    session.step()
    assert lone == 48
    assert t.worker_buckets == [{t.bucket_for(0, lone)}]
    assert t.timing_reruns == reruns + 1
    t.add_worker(WorkerSpec(cores=12))
    assert t.exec_state_dict()["slices"] is None
    assert t.worker_buckets == [set(), set()]
    session.step()
    assert t.timing_reruns == reruns + 1 + len(set().union(*t.worker_buckets))
    assert sum(t.batches) == 48


def _storm(pkg, seed=3):
    market = (storm_market if pkg is None else pkg.storm_market)(
        4, zones=2, seed=seed, horizon=14, degrade_rate=0.01,
        straggle_rate=0.02)
    return market


@pytest.mark.parametrize("seed", [3, 11])
def test_compiled_storm_matches_reference(clocks, seed):
    """A ``compile_churn`` storm (preemptions, rejoins, slowdowns, each with
    a cost-aware Reallocate) through both mesh trainers' membership
    methods: equal membership logs, dilations and decisions; Σb_k kept."""
    def cluster(api):
        m = _storm(ref_spot if api is R else None, seed)
        churn = api.compile_churn(m.simulate(), min_workers=2)
        return api.ClusterSpec.explicit(m.initial_fleet(), workload="linreg",
                                        seed=0).with_churn(churn)

    (ref_out, ref_t, ref_init), (out, t, init) = _both(
        "linreg", cluster=cluster, dilation="from-spec", steps=14)
    want = _decisions(ref_out, ref_t, ref_init)
    assert _decisions(out, t, init) == want
    kinds = {e[1] for e in want["membership"]}
    assert {"remove", "add", "reallocate"} <= kinds, "the storm must storm"
    assert t.dilation == ref_t.dilation
    total = sum(init)
    assert all(sum(r.batches) == total for r in out["history"])
    _assert_losses_close(out, ref_out)


def test_asp_matches_reference(clocks):
    """ASP through the event engine: the update order, staleness and
    emulated timeline under the fake clock equal the reference's."""
    order = {}

    def spy(api):
        def wrap(trainer):
            inner = trainer._measured_worker_grad
            calls = order.setdefault(api.__name__, [])

            def recorded(worker, batch):
                calls.append((worker, batch))
                return inner(worker, batch)

            trainer._measured_worker_grad = recorded
        return (api.At(step=0, fn=wrap),)

    (ref_out, ref_t, ref_init), (out, t, init) = _both(
        "linreg", sync="asp", dilation="from-spec", steps=18, schedule=spy)
    assert _decisions(out, t, init) == _decisions(ref_out, ref_t, ref_init)
    assert order[T.__name__] == order[R.__name__]
    assert len(order[T.__name__]) == 18
    stale = [r.straggler_waste for r in out["history"]]
    assert max(stale) >= 1
    _assert_losses_close(out, ref_out)


# --------------------------------------------------- the ragged gradients


_RIG = {}


def _ragged_rig():
    """One port MeshTrainer reused across the property's examples, with a
    batch source that records what each call fetched."""
    if not _RIG:
        wl = T.paper_workload("linreg")
        wl.to("cpu")
        fetched = []

        def nb(worker, n):
            batch = wl.next_batch(worker, n)
            fetched.append(batch)
            return batch

        trainer = port_mesh.MeshTrainer(
            num_workers=4, init_params=wl.init,
            loss_and_grad=wl.loss_and_grad, next_batch=nb,
            optimizer=sgd(0.05),
            cfg=T.TrainConfig(b0=16, microbatch=4, batching="uniform",
                              max_steps=5),
            device="cpu")
        _RIG.update(trainer=trainer, wl=wl, fetched=fetched)
    return _RIG["trainer"], _RIG["wl"], _RIG["fetched"]


@settings(max_examples=10, deadline=None)
@given(st.lists(st.integers(1, 37), min_size=2, max_size=4))
def test_padded_masked_equals_unpadded_combine(batches):
    """Padded and masked, then ``weighted_psum``, then the lambda-combine,
    equals the unpadded combine over the same examples."""
    trainer, wl, fetched = _ragged_rig()
    mesh_grads, ref_grads = [], []
    for k, b in enumerate(batches):
        fetched.clear()
        g, ls, ws, _t = trainer._measured_worker_grad(k, b)
        assert ws == b
        (padded,) = fetched
        assert padded["x"].shape[0] == trainer.bucket_for(k, b) >= b
        sliced = {key: x[:b] for key, x in padded.items()}
        (ls_ref, ws_ref, _), g_sum = wl.loss_and_grad(
            trainer.params, sliced, torch.ones(b))
        assert float(ws_ref) == b
        np.testing.assert_allclose(ls, float(ls_ref), rtol=1e-5)
        ref_grads.append({n: x / b for n, x in g_sum.items()})
        mesh_grads.append(g)
    got = TC.combine_weighted(mesh_grads, batches)
    want = TC.combine_weighted(ref_grads, batches)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_weighted_psum_matches_reference():
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((5, 3)).astype(np.float32),
             "b": rng.standard_normal(7).astype(np.float32)}
    w = np.float32(6.0)
    mesh = jax.make_mesh((1,), ("data",))
    P = jax.sharding.PartitionSpec
    ref = ref_shard_map(lambda g, x: ref_weighted_psum(g, x, "data"),
                        mesh=mesh, in_specs=(P(), P()), out_specs=P())(
        {k: jax.numpy.asarray(v) for k, v in grads.items()},
        jax.numpy.asarray(w))
    port, sq = TC.weighted_psum_with_sqnorm(
        {k: torch.from_numpy(v.copy()) for k, v in grads.items()},
        torch.tensor(w))
    for k in grads:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_allclose(float(sq), float(TC.tree_sqnorm(port)))
    zero = TC.weighted_psum({"a": torch.zeros(2)}, torch.tensor(0.0))
    assert torch.equal(zero["a"], torch.zeros(2))   # max(w, 1e-8): no NaN


# ---------------------------------------------------- dilation and build


def test_dilation_from_specs_matches_reference():
    cores = [4, 11, 24, 6.5]
    specs = [WorkerSpec(cores=c, flops_ratio=1.0 + i / 4)
             for i, c in enumerate(cores)]
    ref_specs = [RefWorkerSpec(cores=c, flops_ratio=1.0 + i / 4)
                 for i, c in enumerate(cores)]
    for p in (0.95, 0.9):
        dil, for_spec = port_mesh.dilation_from_specs(specs, amdahl_p=p)
        ref_dil, ref_for_spec = ref_mesh.dilation_from_specs(ref_specs,
                                                             amdahl_p=p)
        assert dil == ref_dil
        assert for_spec(WorkerSpec(cores=3)) == \
            ref_for_spec(RefWorkerSpec(cores=3))


@pytest.mark.parametrize("dilation", ["nope", [1.0]], ids=["word", "length"])
def test_dilation_validation_matches_reference(clocks, dilation):
    def build(api, backend):
        return api.Experiment(
            workload=api.paper_workload("linreg"),
            cluster=api.ClusterSpec.hlevel(39, 6, workload="mnist-cnn",
                                           backend=backend),
            optimizer=(ref_sgd if api is R else sgd)(0.05),
            config=_config(api, b0=16, microbatch=4, max_steps=2)).build()

    with pytest.raises(ValueError, match="dilation") as ref_err:
        build(R, R.MeshBackend(dilation=dilation))
    with pytest.raises(ValueError, match="dilation") as err:
        build(T, T.MeshBackend(dilation=dilation, **CPU))
    assert str(err.value) == str(ref_err.value)


def test_several_devices_name_slice_5b():
    """A list of devices builds the concurrent trainer (slice 5b): three
    workers over four CPU rows take the reference's slice plan, each
    worker's bucket quantum is its slice's length, and the round runs
    with every call in flight."""
    exp = T.Experiment(
        workload=T.paper_workload("linreg"),
        cluster=T.ClusterSpec.hlevel(39, 6, workload="mnist-cnn",
                                     backend=T.MeshBackend(
                                         device=["cpu"] * 4)),
        optimizer=sgd(0.05), config=T.TrainConfig(b0=8, microbatch=4))
    t = exp.build()
    assert t.concurrent and t.data_extent == t.train_extent == 4
    assert t.slice_plan.slices == ref_plan_slices(4, 3).slices
    assert [rec.quantum for rec in t._exec] == [2, 1, 1]
    rec = t.bsp_step()
    assert rec.iteration_time == max(rec.worker_times)
    assert len(t.last_round_stamps) == 3


# -------------------------------------------------------------- checkpoints


def _port_linreg(max_steps=10, backend=None, **cfg):
    return T.Experiment(
        workload=T.paper_workload("linreg", seed=100),
        cluster=T.ClusterSpec.hlevel(
            39, 6, workload="mnist-cnn",
            backend=backend or T.MeshBackend(dilation=DILATION, **CPU)),
        optimizer=adam(2e-3),
        config=_config(T, b0=16, microbatch=4, max_steps=max_steps, **cfg))


def _state(session):
    t = session.trainer
    return {"step": t.step_idx, "batches": list(t.batches),
            "smoothed_loss": session.smoothed_loss,
            "controller": t.controller.state_dict(),
            "exec": t.exec_state_dict(),
            "engine": (t.engine.version, list(t.engine.read_version)),
            "data": session.workload.state_dict()}


def test_mesh_checkpoint_resumes_bitwise(clocks, tmp_path):
    path = str(tmp_path / "mesh.ckpt")
    straight = _port_linreg().session()
    straight.run()
    first = _port_linreg().session()
    for rec in first:
        if rec.step == 4:
            first.save(path)
            break
    resumed = _port_linreg().session(resume_from=path)
    assert _state(resumed) == _state(first)
    assert all(torch.equal(resumed.params[k], p)
               for k, p in first.params.items())
    resumed.run()
    assert resumed.step_idx == 10
    assert [(r.step, r.loss, r.batches, r.worker_times, r.sim_time)
            for r in resumed.history] == \
        [(r.step, r.loss, r.batches, r.worker_times, r.sim_time)
         for r in straight.history[5:]]
    assert _state(resumed) == _state(straight)
    assert all(torch.equal(resumed.params[k], p)
               for k, p in straight.params.items())
    for m in ("m", "v"):
        assert all(torch.equal(resumed.trainer.opt_state[m][k], x)
                   for k, x in straight.trainer.opt_state[m].items())


def test_reference_mesh_checkpoint_restores_into_port(clocks, tmp_path):
    """The reference's mesh checkpoint (its npz + JSON sidecar) loads into
    the port's mesh session with an equal ``exec_state_dict``."""
    path = str(tmp_path / "ref-mesh.ckpt")
    ref = R.Experiment(
        workload=R.paper_workload("linreg", seed=100),
        cluster=R.ClusterSpec.hlevel(39, 6, workload="mnist-cnn",
                                     backend=R.MeshBackend(
                                         dilation=DILATION)),
        optimizer=ref_sgd(0.05),
        config=_config(R, b0=16, microbatch=4, max_steps=10)).session()
    for rec in ref:
        if rec.step == 3:
            break
    ref.save(path)
    port = T.Experiment(
        workload=T.paper_workload("linreg", seed=100),
        cluster=T.ClusterSpec.hlevel(39, 6, workload="mnist-cnn",
                                     backend=T.MeshBackend(dilation=DILATION,
                                                           **CPU)),
        optimizer=sgd(0.05),
        config=_config(T, b0=16, microbatch=4, max_steps=10)).session()
    port.restore(path)
    t, rt = port.trainer, ref.trainer
    assert t.exec_state_dict() == rt.exec_state_dict()
    assert t.controller.state_dict() == rt.controller.state_dict()
    assert (t.step_idx, t.batches) == (rt.step_idx, rt.batches)
    assert (t.engine.version, t.engine.read_version) == \
        (rt.engine.version, rt.engine.read_version)
    for k, p in t.params.items():
        np.testing.assert_array_equal(p.numpy(), np.asarray(rt.params[k]))
    assert port.step().step == 4


def _sim_linreg(api, max_steps=2):
    return api.Experiment(
        workload=api.paper_workload("linreg"),
        cluster=api.ClusterSpec.hlevel(
            39, 6, workload="mnist-cnn",
            backend=T.SimBackend(**CPU) if api is T else R.SimBackend()),
        optimizer=(ref_sgd if api is R else sgd)(0.05),
        config=_config(api, b0=16, microbatch=4, max_steps=max_steps))


def _mesh_linreg(api, max_steps=2):
    return api.Experiment(
        workload=api.paper_workload("linreg"),
        cluster=api.ClusterSpec.hlevel(
            39, 6, workload="mnist-cnn",
            backend=T.MeshBackend(**CPU) if api is T else R.MeshBackend()),
        optimizer=(ref_sgd if api is R else sgd)(0.05),
        config=_config(api, b0=16, microbatch=4, max_steps=max_steps))


@pytest.mark.parametrize("written,restored", [("sim", "mesh"),
                                              ("mesh", "sim")])
def test_restore_rejects_the_other_backend_kind(clocks, tmp_path, written,
                                                restored):
    make = {"sim": _sim_linreg, "mesh": _mesh_linreg}
    msgs = []
    for api in (R, T):
        path = str(tmp_path / f"{api.__name__}-{written}.ckpt")
        first = make[written](api).session()
        first.run()
        first.save(path)
        other = make[restored](api).session()
        with pytest.raises(ValueError, match="backend") as err:
            other.restore(path)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_restore_rejects_a_checkpoint_of_another_mesh(clocks, tmp_path):
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    path = str(tmp_path / "wide.ckpt")
    first = _port_linreg(max_steps=2).session()
    first.run()
    first.save(path)
    tree, meta = load_checkpoint(path, "cpu")
    meta["session"]["mesh"]["extent"] = 8
    save_checkpoint(path, tree, meta)
    fresh = _port_linreg(max_steps=2).session()
    data = fresh.workload.state_dict()
    with pytest.raises(ValueError, match="data extent 8, this mesh has 1"):
        fresh.restore(path)
    assert fresh.workload.state_dict() == data    # nothing was loaded


# ---------------------------------------------- the conformance geometry


@pytest.mark.parametrize("elastic", [False, True], ids=["static", "elastic"])
@pytest.mark.parametrize("kind", conformance.KINDS)
def test_conformance_mesh_leg_matches_reference_sim(clocks, monkeypatch,
                                                    kind, elastic):
    """``tests/conformance_runner.py``'s geometry on the port's MeshBackend
    (ladder growth 2.0, so no batch ever pads): its decisions must equal
    the reference's SimBackend leg, as the reference asserts sim == mesh."""
    ref_out, ref_t = conformance._ref_case(kind, elastic)
    conformance._with_ref_q_head(monkeypatch)
    out, t = conformance._port_case(
        kind, elastic, conformance._linreg_injected(),
        backend=T.MeshBackend(growth=2.0, dilation="from-spec", **CPU))
    assert t.backend_kind == "mesh"
    want = conformance._trajectory(ref_out, ref_t, kind)
    assert conformance._trajectory(out, t, kind) == want
    assert all(b == t.bucket_for(k, b) for r in out["history"]
               for k, b in enumerate(r.batches))
    for split, total in zip(want["batches"], want["b_global"]):
        assert sum(split) == total
