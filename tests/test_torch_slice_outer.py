"""Slice 4 end to end: the non-fixed outer kinds through the port's trainer,
against the reference on the same inputs.

1. ``tree_sqnorm`` and ``combine_weighted_with_sqnorm`` (the GNS side
   statistics) against the reference's.
2. The reference's cross-backend conformance geometry
   (``tests/conformance_runner.py``: fleet cores 12 / 8, B0 8, microbatch
   4, 14 steps, ladder growth 2.0, max_factor 4.0, ``batch_coupled`` SGD)
   for every kind, static and elastic, on linreg with the reference's
   batches injected and its initial parameters (and, for dynamix, its
   Q-head) carried over: the port's sim run and the reference's
   ``SimBackend`` run must take the same decisions (``==``), with losses to
   rtol 1e-4.
3. Geometric on ASP, the cost-aware start, the coupled LR reaching the
   update, ``Session.save`` / ``restore`` mid-run for gns and dynamix
   (resumed bit for bit), elastic membership leaving the outer state
   alone: mirrors of ``tests/test_global_batch.py``.
4. A reduced gemma-2b gns run: per-step |g_k|^2 and |g|^2 against the
   reference's ``use_kernel=False`` run, equal decisions.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import numpy as np
import pytest
import torch

import repro.api as R
import repro.core as RC
from repro.core.control.global_batch.policy import _init_params as ref_init_q
from repro.core.control.global_batch.policy import _q_values as ref_q_values
from repro.het.simulator import WorkerSpec as RefWorkerSpec
from repro.models.simple import paper_workloads as ref_paper_workloads
from repro.optim import adam as ref_adam
from repro.optim import batch_coupled as ref_batch_coupled
from repro.optim import sgd as ref_sgd
from repro_torch import api as T
from repro_torch import core as TC
from repro_torch.core.control.global_batch import policy
from repro_torch.het import WORKLOADS, ClusterSim, WorkerSpec, hlevel_cluster
from repro_torch.models import paper_params_from_jax, paper_workloads
from repro_torch.optim import adam, batch_coupled, sgd
from repro_torch.train import ElasticTrainer

CPU = T.SimBackend(device="cpu")


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


# --------------------------------------------------------- side statistics


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"z.bias": (7,), "a.weight": (64, 33), "m.0.w": (5, 4, 3),
              "m.10.w": (129,), "b": ()}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def test_tree_sqnorm_matches_reference():
    tree = _grad_tree(0)
    ref = float(RC.tree_sqnorm({k: jax.numpy.asarray(v)
                                for k, v in tree.items()}))
    port = TC.tree_sqnorm({k: torch.from_numpy(v) for k, v in tree.items()})
    assert port.dtype == torch.float32 and port.dim() == 0
    np.testing.assert_allclose(float(port), ref, rtol=1e-6)
    # the leaves are summed in sorted-key order, whatever the dict's order
    rev = {k: torch.from_numpy(tree[k]) for k in reversed(list(tree))}
    assert torch.equal(TC.tree_sqnorm(rev), port)
    half = {k: torch.from_numpy(v).half() for k, v in tree.items()}
    assert TC.tree_sqnorm(half).dtype == torch.float32
    assert float(TC.tree_sqnorm({})) == 0.0


def test_combine_weighted_with_sqnorm_matches_reference():
    trees = [_grad_tree(s) for s in (1, 2, 3)]
    batches = [3, 5, 8]
    g_ref, sq_ref = RC.combine_weighted_with_sqnorm(
        [{k: jax.numpy.asarray(v) for k, v in t.items()} for t in trees],
        batches)
    g, sq = TC.combine_weighted_with_sqnorm(
        [{k: torch.from_numpy(v) for k, v in t.items()} for t in trees],
        batches)
    np.testing.assert_allclose(float(sq), float(sq_ref), rtol=1e-6)
    assert torch.equal(sq, TC.tree_sqnorm(g))
    for k in g:
        np.testing.assert_allclose(g[k].numpy(), np.asarray(g_ref[k]),
                                   rtol=1e-6, atol=1e-7)


# --------------------------------------- the conformance geometry's sim leg

STEPS, B0, KINDS = 14, 8, ("fixed", "gns", "bandit", "dynamix")


def outer_cfg(pkg, kind):
    """``tests/conformance_runner.py::outer_cfg``."""
    common = dict(warmup=4, cooldown=2, ladder_growth=2.0, max_factor=4.0,
                  seed=0)
    if kind == "fixed":
        return pkg.GlobalBatchConfig()
    if kind == "gns":
        return pkg.GlobalBatchConfig(kind="gns", gns_min_samples=2, **common)
    if kind == "bandit":
        return pkg.GlobalBatchConfig(kind="bandit", bandit_window=3,
                                     time_signal="steps", **common)
    return pkg.GlobalBatchConfig(kind="dynamix", bandit_window=3,
                                 gns_min_samples=2, time_signal="steps",
                                 **common)


def _pin(trainer) -> None:
    """Pin the split to the even apportionment of the current B_global."""
    total, k = sum(trainer.batches), trainer.k
    base, extra = divmod(total, k)
    trainer.batches = [base + (1 if i < extra else 0) for i in range(k)]


def _schedule(api, spec, elastic):
    if not elastic:
        return ()
    return (api.RemoveWorker(step=6, worker=1), api.At(step=6, fn=_pin),
            api.AddWorker(step=10, spec=spec(cores=8.0)),
            api.At(step=10, fn=_pin))


def _trajectory(out, trainer, kind):
    traj = {"batches": [list(r.batches) for r in out["history"]],
            "b_global": [sum(r.batches) for r in out["history"]]}
    if trainer.outer is not None:
        st = trainer.outer.state_dict()
        traj.update(rung=st["rung"], rungs=st["rungs"],
                    step_count=st["step_count"],
                    num_resizes=st["num_resizes"],
                    resize_log=st["resize_log"])
        if kind == "bandit":
            traj["arm_counts"] = st["extra"]["counts"]
        if kind == "dynamix":
            traj["action_log"] = st["extra"]["action_log"]
            traj["decisions"] = st["extra"]["decisions"]
    return traj


def _ref_case(kind, elastic):
    cluster = R.ClusterSpec.explicit(
        [RefWorkerSpec(cores=12.0), RefWorkerSpec(cores=8.0)],
        workload="linreg", seed=0)
    evs = _schedule(R, RefWorkerSpec, elastic)
    if evs:
        cluster = cluster.with_schedule(*evs)
    session = R.Experiment(
        workload=R.paper_workload("linreg"), cluster=cluster,
        optimizer=ref_sgd(ref_batch_coupled(0.05, rule="linear")),
        config=R.TrainConfig(b0=B0, microbatch=4, batching="uniform",
                             max_steps=STEPS, seed=0,
                             global_batch=outer_cfg(RC, kind)),
    ).session()
    return session.run(), session.trainer


def _linreg_injected():
    """linreg with the reference's initial parameters and batch stream."""
    ref_wl = ref_paper_workloads()["linreg"]
    params0 = jax.tree_util.tree_map(
        np.asarray, ref_wl.init(jax.random.PRNGKey(0)))
    return T.Workload(
        name="linreg",
        init=lambda gen: paper_params_from_jax("linreg", params0,
                                               device=gen.device),
        loss_and_grad=T.sum_loss_adapter(paper_workloads()["linreg"].loss_fn),
        next_batch=_injected_next_batch(ref_wl.make_batch, 100))


def _with_ref_q_head(monkeypatch, seed=0, hidden=16):
    """Make the port's dynamix start from the reference's Q-head."""
    head = {k: np.asarray(v) for k, v in
            ref_init_q(jax.random.PRNGKey(seed), hidden).items()}
    monkeypatch.setattr(policy, "_init_params",
                        lambda s, h: policy.policy_params_from_jax(head))


def _port_case(kind, elastic, workload, backend=CPU):
    cluster = T.ClusterSpec.explicit(
        [WorkerSpec(cores=12.0), WorkerSpec(cores=8.0)], workload="linreg",
        seed=0, backend=backend)
    evs = _schedule(T, WorkerSpec, elastic)
    if evs:
        cluster = cluster.with_schedule(*evs)
    session = T.Experiment(
        workload=workload, cluster=cluster,
        optimizer=sgd(batch_coupled(0.05, rule="linear")),
        config=T.TrainConfig(b0=B0, microbatch=4, batching="uniform",
                             max_steps=STEPS, seed=0,
                             global_batch=outer_cfg(TC, kind)),
    ).session()
    return session.run(), session.trainer


@pytest.mark.parametrize("elastic", [False, True], ids=["static", "elastic"])
@pytest.mark.parametrize("kind", KINDS)
def test_conformance_sim_leg_matches_reference(monkeypatch, kind, elastic):
    ref_out, ref_t = _ref_case(kind, elastic)
    _with_ref_q_head(monkeypatch)
    out, t = _port_case(kind, elastic, _linreg_injected())
    want = _trajectory(ref_out, ref_t, kind)
    assert _trajectory(out, t, kind) == want
    assert out["steps"] == STEPS
    for a, b in zip(out["history"], ref_out["history"]):
        assert (a.sim_time, a.adjusted) == (b.sim_time, b.adjusted)
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4)
    if kind in ("gns", "bandit"):
        assert want["num_resizes"] > 0, "the leg must move the ladder"
    if kind in ("gns", "dynamix"):
        # the estimator's floats agree closely, not bit for bit
        # (differences of nearly equal sqnorms; measured 4e-7 rel)
        np.testing.assert_allclose(t.outer.estimator.b_noise,
                                   ref_t.outer.estimator.b_noise, rtol=1e-5)
    if kind == "dynamix":
        # on this geometry the reference's policy holds at all four
        # decisions (its features pull toward B = 16): the Q-values at the
        # last one must agree too, not only the argmax
        assert want["decisions"] == len(want["action_log"]) == 4
        state = torch.from_numpy(ref_t.outer._pending[0])
        q_ref = np.asarray(ref_q_values(ref_t.outer.params,
                                        jax.numpy.asarray(state.numpy())))
        np.testing.assert_allclose(
            policy._q_values(t.outer.params, state).numpy(), q_ref,
            rtol=1e-5, atol=1e-6)


# ------------------------------------------ mirrors of test_global_batch.py


def _sim_experiment(gb, max_steps=14, opt=None, sync="bsp", workload=None):
    """``tests/test_global_batch.py::_sim_experiment`` on the port."""
    return T.Experiment(
        workload=workload or T.paper_workload("linreg", seed=100),
        cluster=T.ClusterSpec.hlevel(24, 3.0, 3, workload="linreg", seed=0,
                                     backend=CPU),
        optimizer=opt or sgd(0.05),
        config=T.TrainConfig(b0=8, microbatch=8, batching="dynamic",
                             sync=sync, max_steps=max_steps, seed=0,
                             global_batch=gb))


def test_geometric_on_asp_matches_reference():
    kw = dict(kind="geometric", geo_factor=2.0, geo_every=2, warmup=2,
              cooldown=1)
    ref_session = R.Experiment(
        workload=R.paper_workload("linreg", seed=100),
        cluster=R.ClusterSpec.hlevel(24, 3.0, 3, workload="linreg", seed=0),
        optimizer=ref_sgd(0.05),
        config=R.TrainConfig(b0=8, microbatch=8, batching="dynamic",
                             sync="asp", max_steps=30, seed=0,
                             global_batch=RC.GlobalBatchConfig(**kw)),
    ).session()
    ref = ref_session.run()
    session = _sim_experiment(TC.GlobalBatchConfig(**kw), max_steps=30,
                              sync="asp",
                              workload=_linreg_injected()).session()
    out = session.run()
    assert out["outer_resizes"] == ref["outer_resizes"] >= 1
    assert (session.trainer.outer.state_dict()
            == ref_session.trainer.outer.state_dict())
    for a, b in zip(out["history"], ref["history"]):
        assert a.batches == b.batches
        assert (a.sim_time, a.adjusted) == (b.sim_time, b.adjusted)
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4)
    for rec in out["history"]:
        assert sum(rec.batches) in session.trainer.outer.rungs


@pytest.mark.parametrize("fleet", ["hlevel", "capped-priced"])
def test_cost_aware_start_matches_reference(fleet):
    """A dynamic run with a non-fixed kind starts from the price- and
    capacity-aware split, not the static one."""
    if fleet == "hlevel":
        specs = [dict(cores=c) for c in (4.0, 8.0, 12.0)]
    else:
        specs = [dict(cores=16.0, b_mem=6, price=3.0),
                 dict(cores=8.0, price=0.5), dict(cores=8.0, price=1.0)]
    starts = {}
    for name, api, spec, pkg in (("ref", R, RefWorkerSpec, RC),
                                 ("port", T, WorkerSpec, TC)):
        for kind in ("fixed", "gns"):
            kw = dict(backend=CPU) if name == "port" else {}
            exp = api.Experiment(
                workload=api.paper_workload("linreg", seed=100),
                cluster=api.ClusterSpec.explicit(
                    [spec(**s) for s in specs], workload="linreg", seed=0,
                    **kw),
                optimizer=(sgd if name == "port" else ref_sgd)(0.05),
                config=api.TrainConfig(
                    b0=8, microbatch=4, batching="dynamic", max_steps=2,
                    global_batch=pkg.GlobalBatchConfig(kind=kind)))
            starts[name, kind] = list(exp.session().trainer.batches)
    assert starts["port", "gns"] == starts["ref", "gns"]
    assert starts["port", "fixed"] == starts["ref", "fixed"]
    assert sum(starts["port", "gns"]) == 24
    if fleet == "capped-priced":
        assert starts["port", "gns"] != starts["port", "fixed"]
        assert starts["port", "gns"][0] <= 6


def test_coupled_lr_reaches_the_update():
    """``test_coupled_lr_reaches_jitted_update`` on the port: the optimizer
    reads the coupled schedule at every update, so a resize takes effect
    at the next one, at every rung visited."""
    exp = T.Experiment(
        workload=T.paper_workload("linreg"),
        cluster=T.ClusterSpec.hlevel(24, 3.0, 3, workload="linreg", seed=0,
                                     backend=CPU),
        optimizer=sgd(batch_coupled(0.02, rule="linear")),
        config=T.TrainConfig(b0=4, microbatch=4, batching="dynamic",
                             max_steps=4, seed=0,
                             global_batch=TC.GlobalBatchConfig(kind="gns")))
    t = exp.session().trainer

    def eff_lr():
        p = {"w": torch.ones(2)}
        new_p, _ = t.optimizer.update(p, {"w": torch.ones(2)},
                                      t.optimizer.init(p), 0)
        return float(p["w"][0] - new_p["w"][0])

    assert eff_lr() == pytest.approx(0.02, rel=1e-4)
    t._apply_global_batch(30)                        # ratio 30/12 = 2.5
    assert t.optimizer.schedule.scale == pytest.approx(2.5)
    assert sum(t.batches) == 30
    assert eff_lr() == pytest.approx(0.05, rel=1e-4)
    t._apply_global_batch(24)                        # revisit a lower rung
    assert eff_lr() == pytest.approx(0.04, rel=1e-4)
    # a fresh trainer resets a reused coupled schedule to ratio 1
    T.Experiment(workload=T.paper_workload("linreg"), cluster=exp.cluster,
                 optimizer=t.optimizer, config=exp.config).session()
    assert t.optimizer.schedule.scale == 1.0


def test_fixed_kind_is_bitwise_golden():
    base = _sim_experiment(TC.GlobalBatchConfig()).run()
    fixed = _sim_experiment(TC.GlobalBatchConfig(kind="fixed")).run()
    assert base["outer_resizes"] == fixed["outer_resizes"] == 0
    for ra, rb in zip(base["history"], fixed["history"]):
        assert (ra.loss, ra.sim_time, ra.batches, ra.adjusted) == \
            (rb.loss, rb.sim_time, rb.batches, rb.adjusted)


RESUME_KINDS = {
    "gns": dict(kind="gns", warmup=2, cooldown=1, gns_min_samples=2,
                hysteresis=0.1),
    "dynamix": dict(kind="dynamix", warmup=2, cooldown=1, bandit_window=2,
                    gns_min_samples=2),
}


@pytest.mark.parametrize("kind", list(RESUME_KINDS))
def test_outer_state_survives_session_save_restore(tmp_path, kind):
    """``test_outer_state_survives_session_save_restore`` for the kinds with
    side statistics: the resumed run equals the uninterrupted one bit for
    bit, outer controller included."""
    gb = TC.GlobalBatchConfig(**RESUME_KINDS[kind])

    def experiment():
        return _sim_experiment(gb, max_steps=16,
                               opt=sgd(batch_coupled(0.05)))

    straight = experiment().session()
    straight.run()
    first = experiment().session()
    for rec in first:
        if rec.step == 7:
            break
    first.save(str(tmp_path / "ck.npz"))
    resumed = experiment().session()
    resumed.restore(str(tmp_path / "ck.npz"))
    assert (resumed.trainer.outer.state_dict()
            == first.trainer.outer.state_dict())
    assert (resumed.trainer.optimizer.schedule.scale
            == first.trainer.optimizer.schedule.scale)
    out = resumed.run()
    assert out["steps"] == 16
    assert straight.trainer.outer.num_resizes >= 1
    assert (resumed.trainer.outer.state_dict()
            == straight.trainer.outer.state_dict())
    for a, b in zip(resumed.history, straight.history[8:]):
        assert (a.loss, a.batches, a.sim_time, a.adjusted) == \
            (b.loss, b.batches, b.sim_time, b.adjusted)
    assert all(torch.equal(resumed.params[k], p)
               for k, p in straight.params.items())


def test_restore_rejects_outer_config_mismatch(tmp_path):
    gb = TC.GlobalBatchConfig(kind="geometric", warmup=2, cooldown=1)
    first = _sim_experiment(gb, max_steps=6).session()
    first.run()
    first.save(str(tmp_path / "ck.npz"))
    plain = _sim_experiment(TC.GlobalBatchConfig(), max_steps=6).session()
    with pytest.raises(ValueError, match="global-batch"):
        plain.restore(str(tmp_path / "ck.npz"))
    assert plain.trainer.outer is None and plain.trainer.step_idx == 0


def test_elastic_membership_preserves_outer_state():
    wl = T.paper_workload("linreg", seed=100)
    gb = TC.GlobalBatchConfig(kind="gns", warmup=4, cooldown=2,
                              gns_min_samples=2)
    trainer = ElasticTrainer(
        init_params=wl.init, loss_and_grad=wl.loss_and_grad,
        next_batch=wl.next_batch.to("cpu"), optimizer=sgd(0.05),
        sim=ClusterSim(hlevel_cluster(24, 3.0, 3), WORKLOADS["linreg"],
                       seed=0),
        cfg=T.TrainConfig(b0=8, microbatch=8, batching="dynamic",
                          max_steps=40, seed=0, global_batch=gb),
        device="cpu")
    for _ in range(6):
        trainer.bsp_step()
    est_before = trainer.outer.estimator.state_dict()
    assert est_before["samples"] > 0
    total_before = sum(trainer.batches)
    rungs_before = list(trainer.outer.rungs)
    trainer.remove_worker(1)
    assert trainer.outer.estimator.state_dict() == est_before
    assert trainer.outer.rungs == rungs_before
    assert sum(trainer.batches) == total_before
    trainer.add_worker(WorkerSpec(cores=8.0))
    assert trainer.outer.estimator.state_dict() == est_before
    assert sum(trainer.batches) == total_before
    for _ in range(4):
        trainer.bsp_step()
    assert trainer.outer.estimator.samples > est_before["samples"]


# ------------------------------------------------------ reduced gemma, gns

SEQ, WORKERS, LM_STEPS = 64, 3, 6
GNS_LM = dict(kind="gns", warmup=2, cooldown=2, gns_min_samples=2,
              ladder_growth=2.0, max_factor=2.0)


def _record_stats(trainer):
    """Wrap the outer controller's ``observe`` to keep each step's stats."""
    seen = []
    observe = trainer.outer.observe

    def spy(**kw):
        seen.append(kw["stats"])
        return observe(**kw)

    trainer.outer.observe = spy
    return seen


def test_reduced_gemma_gns_matches_reference():
    """Per-step sqnorms within rtol 1e-5 of the reference's (fp32 sums of
    squares in other orders; measured <= 3.5e-7), and the same decisions:
    batches, resize log (empty: at random init b_noise is ~0.17, far under
    B = 12, so gns holds at the bottom rung), estimator sample count."""
    from repro.configs import get_config as ref_get_config
    from repro.data import DataPipeline as RefDataPipeline
    from repro.models import reduced as ref_reduced
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.models import params_from_jax, reduced

    rcfg = ref_reduced(ref_get_config("gemma-2b"))
    ref_wl = R.lm_workload(rcfg, RefDataPipeline(rcfg, seq_len=SEQ,
                                                 num_workers=WORKERS),
                           aux_weight=0.01, use_kernel=False)
    params0 = jax.tree_util.tree_map(
        np.asarray, ref_wl.init(jax.random.PRNGKey(0)))
    ref_session = R.Experiment(
        workload=ref_wl,
        cluster=R.ClusterSpec.hlevel(39, 6.0, WORKERS,
                                     workload="transformer", seed=0),
        optimizer=ref_adam(1e-3),
        config=R.TrainConfig(b0=4, microbatch=2, batching="dynamic",
                             max_steps=LM_STEPS,
                             controller=RC.ControllerConfig(kind="p"),
                             global_batch=RC.GlobalBatchConfig(**GNS_LM)),
    ).session()
    ref_stats = _record_stats(ref_session.trainer)
    ref = ref_session.run()

    cfg = reduced(get_config("gemma-2b"))
    wl = T.lm_workload(cfg, DataPipeline(cfg, seq_len=SEQ,
                                         num_workers=WORKERS, device="cpu"),
                       aux_weight=0.01, use_kernel=True)
    wl.init = lambda gen: params_from_jax(params0, cfg, device=gen.device)
    session = T.Experiment(
        workload=wl,
        cluster=T.ClusterSpec.hlevel(39, 6.0, WORKERS, workload="transformer",
                                     seed=0, backend=CPU),
        optimizer=adam(1e-3),
        config=T.TrainConfig(b0=4, microbatch=2, batching="dynamic",
                             max_steps=LM_STEPS,
                             controller=TC.ControllerConfig(kind="p"),
                             global_batch=TC.GlobalBatchConfig(**GNS_LM)),
    ).session()
    stats = _record_stats(session.trainer)
    out = session.run()

    assert len(stats) == len(ref_stats) == LM_STEPS
    for a, b in zip(stats, ref_stats):
        assert a.batches == b.batches
        np.testing.assert_allclose(a.per_worker_sqnorm, b.per_worker_sqnorm,
                                   rtol=1e-5)
        np.testing.assert_allclose(a.combined_sqnorm, b.combined_sqnorm,
                                   rtol=1e-5)
        assert all(x > 0 for x in a.per_worker_sqnorm + [a.combined_sqnorm])
    for a, b in zip(out["history"], ref["history"]):
        assert (a.batches, a.sim_time, a.adjusted) == \
            (b.batches, b.sim_time, b.adjusted)
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4)
    po, ro = session.trainer.outer, ref_session.trainer.outer
    assert po.resize_log == ro.resize_log
    assert po.estimator.samples == ro.estimator.samples == LM_STEPS
    # b_noise is a ratio of differences of nearly equal sqnorms: it moves
    # more than the sqnorms do (measured 2.5e-6 rel)
    np.testing.assert_allclose(po.estimator.b_noise, ro.estimator.b_noise,
                               rtol=1e-4)
