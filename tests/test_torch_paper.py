"""The paper's workloads through the port's closed loops: parity with the
reference on injected batches, then mirrors of the reference's claims.

1. Whole sim-backend runs of ``mnist-cnn`` with the reference's batches
   (its ``fold_in`` stream, as numpy) injected into the port and the
   reference's initial parameters carried over by ``paper_params_from_jax``:
   per-step ``batches``, ``sim_time`` and ``adjusted`` depend only on the
   simulated clock and must be bit-identical; losses agree to rtol 1e-4
   (fp32, other summation orders; PERF.md §2).
2. Mirrors of ``tests/test_system.py``'s claims, ``tests/test_elastic.py``
   and ``tests/test_api.py``'s golden equivalences, on the port's own
   numpy data stream through ``HeterogeneousTrainer.run()``,
   ``ElasticTrainer.run_with_events`` and ``Experiment.run()``.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.api as R
from repro.core import ControllerConfig as RefControllerConfig
from repro.optim import adam as ref_adam
from repro_torch import api as T
from repro_torch.core import ControllerConfig
from repro_torch.het import WORKLOADS, ClusterSim, WorkerSpec, hlevel_cluster
from repro_torch.models import paper_params_from_jax, paper_workloads
from repro_torch.optim import adam, sgd
from repro_torch.train import ElasticTrainer, HeterogeneousTrainer

CPU = T.SimBackend(device="cpu")

# --------------------------------------------- 1. parity on injected batches


def _injected_next_batch(make_batch, seed):
    """The reference's ``CounterBatchSource`` stream (``fold_in(PRNGKey(seed
    + worker), call)``), handed over as CPU tensors."""
    counters = {}

    def nb(worker, n):
        counters[worker] = counters.get(worker, 0) + 1
        key = jax.random.fold_in(jax.random.PRNGKey(seed + worker),
                                 counters[worker])
        return {k: torch.from_numpy(np.array(v))
                for k, v in make_batch(key, n).items()}

    return nb


@pytest.mark.parametrize("batching,sync,steps", [
    ("uniform", "bsp", 8), ("static", "bsp", 8), ("dynamic", "bsp", 8),
    ("dynamic", "asp", 12)])
def test_sim_runs_match_reference_on_injected_batches(batching, sync, steps):
    name = "mnist-cnn"
    ref_wl = R.paper_workload(name, seed=100)
    ref = R.Experiment(
        workload=ref_wl,
        cluster=R.ClusterSpec.hlevel(39, 8, workload=name, seed=0),
        optimizer=ref_adam(2e-3),
        config=R.TrainConfig(b0=32, microbatch=8, batching=batching,
                             sync=sync, max_steps=steps,
                             controller=RefControllerConfig()),
    ).run()
    from repro.models.simple import paper_workloads as ref_paper_workloads

    ref_simple = ref_paper_workloads()[name]
    params0 = jax.tree_util.tree_map(
        np.asarray, ref_simple.init(jax.random.PRNGKey(0)))
    wl = T.Workload(
        name=name,
        init=lambda gen: paper_params_from_jax(name, params0,
                                               device=gen.device),
        loss_and_grad=T.sum_loss_adapter(paper_workloads()[name].loss_fn),
        next_batch=_injected_next_batch(ref_simple.make_batch, 100))
    ours = T.Experiment(
        workload=wl,
        cluster=T.ClusterSpec.hlevel(39, 8, workload=name, seed=0,
                                     backend=CPU),
        optimizer=adam(2e-3),
        config=T.TrainConfig(b0=32, microbatch=8, batching=batching,
                             sync=sync, max_steps=steps,
                             controller=ControllerConfig()),
    ).run()
    assert ours["steps"] == ref["steps"] == steps
    for a, b in zip(ours["history"], ref["history"]):
        assert a.batches == b.batches
        assert a.sim_time == b.sim_time
        assert a.adjusted == b.adjusted
        assert a.iteration_time == b.iteration_time
        assert a.worker_times == b.worker_times
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4)
    assert ours["final_batches"] == ref["final_batches"]
    assert ours["batch_adjustments"] == ref["batch_adjustments"]
    np.testing.assert_allclose(ours["final_loss"], ref["final_loss"],
                               rtol=1e-4)


# ---------------------------------------- 2. test_system.py, on the port


def _run(mode, workload="linreg", h=6, steps=120, target=None, sync="bsp",
         seed=0):
    wl = paper_workloads()[workload]
    sim = ClusterSim(hlevel_cluster(39, h), WORKLOADS[workload], seed=seed)
    cfg = T.TrainConfig(b0=32, microbatch=8, batching=mode, sync=sync,
                        max_steps=steps, target_loss=target, seed=seed,
                        controller=ControllerConfig())
    tr = HeterogeneousTrainer(
        init_params=wl.init, loss_and_grad=T.sum_loss_adapter(wl.loss_fn),
        next_batch=T.CounterBatchSource(wl.make_batch, 100).to("cpu"),
        optimizer=sgd(0.05) if workload == "linreg" else adam(2e-3),
        sim=sim, cfg=cfg, device="cpu")
    return tr.run()


def test_variable_batching_reduces_time_to_target():
    """Core claim (Fig. 6): same target loss, less simulated time."""
    uni = _run("uniform", "linreg", h=8, steps=400, target=0.05)
    dyn = _run("dynamic", "linreg", h=8, steps=400, target=0.05)
    assert uni["reached_target"] and dyn["reached_target"]
    assert dyn["steps"] < 400 and uni["steps"] < 400
    # linreg is communication-bound: modest but non-negative benefit expected
    assert dyn["sim_time"] <= uni["sim_time"] * 1.02


def test_dynamic_beats_uniform_on_compute_bound():
    uni = _run("uniform", "mnist-cnn", h=8, steps=60)
    dyn = _run("dynamic", "mnist-cnn", h=8, steps=60)
    # same number of steps, same global batch => similar loss...
    assert abs(uni["final_loss"] - dyn["final_loss"]) < 0.5
    # ...but heterogeneity-aware batching finishes much faster
    assert dyn["sim_time"] < 0.75 * uni["sim_time"]


def test_static_between_uniform_and_dynamic():
    uni = _run("uniform", "mnist-cnn", h=8, steps=40)
    sta = _run("static", "mnist-cnn", h=8, steps=40)
    dyn = _run("dynamic", "mnist-cnn", h=8, steps=40)
    assert sta["sim_time"] < uni["sim_time"]
    assert dyn["sim_time"] <= sta["sim_time"] * 1.05


def test_asp_mode_trains():
    # ASP steps are per-worker updates (1/K of a BSP step's data each)
    out = _run("dynamic", "linreg", h=6, steps=450, sync="asp")
    assert np.isfinite(out["final_loss"])
    assert out["final_loss"] < 0.5


def test_global_batch_invariant_in_runs():
    out = _run("dynamic", "mnist-cnn", h=8, steps=30)
    for rec in out["history"]:
        assert sum(rec.batches) == 96


def test_run_result_has_the_reference_keys():
    out = _run("dynamic", "linreg", steps=3)
    assert set(out) == {"steps", "sim_time", "final_loss", "reached_target",
                        "wall_time", "batch_adjustments", "outer_resizes",
                        "history", "final_batches"}
    assert out["steps"] == 3 and out["outer_resizes"] == 0


# --------------------------------------- test_elastic.py, on the port


def _make(specs, steps=40):
    wl = paper_workloads()["linreg"]

    def lag(params, batch, mask):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        ls, ws, aux = wl.loss_fn(leaves, batch, mask)
        grads = torch.autograd.grad(ls / torch.clamp(ws, min=1e-9),
                                    list(leaves.values()))
        return (ls.detach(), ws, aux), dict(zip(leaves, grads))

    return ElasticTrainer(
        worker_specs=specs, workload=WORKLOADS["linreg"],
        init_params=wl.init, loss_and_grad=lag,
        next_batch=T.CounterBatchSource(wl.make_batch, 0).to("cpu"),
        optimizer=sgd(0.05),
        cfg=T.TrainConfig(b0=32, microbatch=8, batching="dynamic",
                          max_steps=steps,
                          controller=ControllerConfig(dead_band=0.05)),
        device="cpu")


def test_preemption_preserves_global_batch():
    tr = _make([WorkerSpec(cores=4), WorkerSpec(cores=11),
                WorkerSpec(cores=24)])
    out = tr.run_with_events(
        {10: lambda t: t.remove_worker(2)}, max_steps=25)
    assert len(out["final_batches"]) == 2
    # the paper's invariant survives the membership change
    for rec in out["history"]:
        assert sum(rec.batches) == 96
    assert out["membership_log"] == [(10, "remove", 2)]
    assert np.isfinite(out["final_loss"])


def test_replacement_joins_and_rebalances():
    tr = _make([WorkerSpec(cores=8), WorkerSpec(cores=16),
                WorkerSpec(cores=24)])
    out = tr.run_with_events(
        {8: lambda t: t.remove_worker(2),
         16: lambda t: t.add_worker(WorkerSpec(cores=12))},
        max_steps=30)
    assert len(out["final_batches"]) == 3
    for rec in out["history"]:
        assert sum(rec.batches) == 96
    # the smaller replacement gets a smaller share than the departed 24-core
    assert out["final_batches"][-1] < 48


def test_cannot_remove_last_worker():
    tr = _make([WorkerSpec(cores=8)])
    with pytest.raises(ValueError):
        tr.remove_worker(0)


def test_elastic_trainer_needs_a_cluster():
    with pytest.raises(ValueError, match="worker_specs"):
        ElasticTrainer(init_params=None, loss_and_grad=None, next_batch=None,
                       optimizer=sgd(0.05), cfg=T.TrainConfig(b0=8,
                                                              microbatch=8),
                       device="cpu")


# --------------------------------------- test_api.py golden runs, on the port


def _legacy_nb(make_batch, seed=100):
    """Hand-written counterpart of ``CounterBatchSource``."""
    counters = {}

    def nb(worker, n):
        counters[worker] = counters.get(worker, 0) + 1
        rng = np.random.default_rng((seed + worker, counters[worker]))
        return {k: torch.as_tensor(v) for k, v in make_batch(rng, n).items()}

    return nb


def _cfg(**kw):
    kw.setdefault("b0", 32)
    kw.setdefault("microbatch", 8)
    kw.setdefault("batching", "dynamic")
    kw.setdefault("max_steps", 12)
    return T.TrainConfig(**kw)


def _experiment(cfg, *, workload="linreg", h=6, schedule=(), seed=0):
    cluster = T.ClusterSpec.hlevel(39, h, workload=workload, seed=seed,
                                   backend=CPU)
    if schedule:
        cluster.with_schedule(*schedule)
    return T.Experiment(
        workload=T.paper_workload(workload, seed=100),
        cluster=cluster,
        optimizer=sgd(0.05) if workload == "linreg" else adam(2e-3),
        config=cfg,
    )


def _legacy_kw():
    wl = paper_workloads()["linreg"]
    return dict(init_params=wl.init,
                loss_and_grad=T.sum_loss_adapter(wl.loss_fn),
                next_batch=_legacy_nb(wl.make_batch), optimizer=sgd(0.05),
                device="cpu")


def _assert_histories_identical(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.step == rb.step
        assert ra.loss == rb.loss                      # bit-for-bit
        assert ra.sim_time == rb.sim_time
        assert ra.iteration_time == rb.iteration_time
        assert ra.batches == rb.batches
        assert ra.adjusted == rb.adjusted
        assert ra.straggler_waste == rb.straggler_waste


def test_golden_equivalence_bsp():
    """Seeded Experiment.run() == hand-wired HeterogeneousTrainer.run()."""
    legacy = HeterogeneousTrainer(
        sim=ClusterSim(hlevel_cluster(39, 6), WORKLOADS["linreg"], seed=0),
        cfg=_cfg(target_loss=0.05, max_steps=60), **_legacy_kw()).run()
    new = _experiment(_cfg(target_loss=0.05, max_steps=60)).run()
    _assert_histories_identical(legacy["history"], new["history"])
    assert new["final_loss"] == legacy["final_loss"]
    assert new["final_batches"] == legacy["final_batches"]
    assert new["reached_target"] == legacy["reached_target"]
    assert new["steps"] == legacy["steps"]
    assert new["batch_adjustments"] == legacy["batch_adjustments"]


def test_golden_equivalence_asp():
    legacy = HeterogeneousTrainer(
        sim=ClusterSim(hlevel_cluster(39, 6), WORKLOADS["linreg"], seed=0),
        cfg=_cfg(sync="asp", max_steps=30), **_legacy_kw()).run()
    new = _experiment(_cfg(sync="asp", max_steps=30)).run()
    _assert_histories_identical(legacy["history"], new["history"])
    assert new["final_batches"] == legacy["final_batches"]


def test_golden_equivalence_elastic_schedule():
    """ClusterSpec schedule == legacy run_with_events {step: fn} dict."""
    legacy_tr = ElasticTrainer(
        worker_specs=hlevel_cluster(39, 6), workload=WORKLOADS["linreg"],
        cfg=_cfg(max_steps=20), **_legacy_kw())
    legacy = legacy_tr.run_with_events(
        {6: lambda t: t.remove_worker(2),
         13: lambda t: t.add_worker(WorkerSpec(cores=12))},
        max_steps=20)
    new = _experiment(
        _cfg(max_steps=20),
        schedule=(T.RemoveWorker(step=6, worker=2),
                  T.AddWorker(step=13, spec=WorkerSpec(cores=12)))).run()
    _assert_histories_identical(legacy["history"], new["history"])
    assert new["membership_log"] == legacy["membership_log"]
    assert new["final_batches"] == legacy["final_batches"]
    assert all(sum(r.batches) == 96 for r in new["history"])


def test_mean_loss_workload_matches_sum_convention():
    """A per-example mean-style loss gives the same training as the
    SUM-convention loss of the same model."""

    def per_example(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        return 0.5 * (pred - batch["y"]) ** 2

    wl = paper_workloads()["linreg"]
    mean_wl = T.mean_loss_workload("linreg-mean", wl.init, per_example,
                                   wl.make_batch, seed=100)
    base = _experiment(_cfg(max_steps=8))
    out_sum = base.run()
    out_mean = dataclasses.replace(base, workload=mean_wl).run()
    _assert_histories_identical(out_sum["history"], out_mean["history"])


def test_counter_batch_source_stream_is_a_function_of_seed_worker_call():
    wl = paper_workloads()["mnist-cnn"]
    a = T.CounterBatchSource(wl.make_batch, 5).to("cpu")
    b = T.CounterBatchSource(wl.make_batch, 5).to("cpu")
    a(0, 4)
    first, second = a(1, 4), a(1, 6)
    b.load_state_dict(a.state_dict())
    assert a.state_dict() == {"seed": 5, "counters": {0: 1, 1: 2}}
    again = T.CounterBatchSource(wl.make_batch, 5).to("cpu")
    assert torch.equal(again(1, 4)["x"], first["x"])
    assert not torch.equal(again(1, 4)["x"][:4], second["x"][:4])
    assert torch.equal(b(1, 3)["y"], a(1, 3)["y"])
    assert first["x"].dtype == torch.float32 and first["y"].dtype == torch.int64
