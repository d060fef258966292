"""Slice 10 end to end: spot-market storms through the port's trainer, a
mirror of ``tests/test_churn.py``'s in-process tests, plus parity with the
reference on the same inputs.

1. Storm invariants, controller state through churn and checkpoint under
   fire (fixed, gns and dynamix outers), on ``SimBackend(device="cpu")``.
   The reference's mesh storm (``tests/churn_runner.py``) belongs to the
   measured backend's slice and is not mirrored here.
2. A storm compiled from ``storm_market`` on linreg, with the reference's
   batches injected and its initial parameters (and, for dynamix, its
   Q-head) carried over: the port's membership log, per-step batches,
   simulated clock, ``adjusted`` flags and the outer's resize and action
   logs equal (``==``) the reference's ``SimBackend`` run; losses agree to
   rtol 1e-4.
3. A failed ``Session.restore`` leaves the session as it was, data cursors
   included.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.api as R
import repro.core as RC
import repro.het.spot as ref_spot
from repro.core.control.global_batch.policy import _init_params as ref_init_q
from repro.models.simple import paper_workloads as ref_paper_workloads
from repro.optim import batch_coupled as ref_batch_coupled
from repro.optim import sgd as ref_sgd
from repro_torch import api as T
from repro_torch import core as TC
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core.control.global_batch import policy
from repro_torch.het.spot import storm_market
from repro_torch.models import paper_params_from_jax, paper_workloads
from repro_torch.optim import batch_coupled, sgd

CPU = T.SimBackend(device="cpu")


def _storm(seed, *, workers=8, zones=2, horizon=30, pkg=None):
    market = storm_market if pkg is None else pkg.storm_market
    return market(workers, zones=zones, seed=seed, horizon=horizon,
                  degrade_rate=0.01, straggle_rate=0.02)


def _outer_cfg(kind, pkg=TC, **extra):
    if kind == "fixed":
        return pkg.GlobalBatchConfig()
    if kind == "gns":
        return pkg.GlobalBatchConfig(kind="gns", warmup=4, cooldown=4,
                                     gns_min_samples=4, **extra)
    assert kind == "dynamix"
    return pkg.GlobalBatchConfig(kind="dynamix", warmup=4, cooldown=4,
                                 bandit_window=3, gns_min_samples=4, **extra)


def _experiment(market, churn, *, gns=False, outer=None, max_steps=40,
                seed=0):
    cluster = T.ClusterSpec.explicit(
        market.initial_fleet(), workload="linreg", seed=seed,
        backend=CPU).with_churn(churn)
    gb = _outer_cfg(outer if outer is not None
                    else ("gns" if gns else "fixed"))
    return T.Experiment(
        workload=T.paper_workload("linreg"),
        cluster=cluster,
        optimizer=sgd(batch_coupled(0.02, rule="linear")),
        config=T.TrainConfig(b0=4, microbatch=4, batching="dynamic",
                             max_steps=max_steps, seed=seed,
                             global_batch=gb),
    )


# ------------------------------------------------------- storm invariants


class TestStormInvariants:
    @given(seed=st.integers(min_value=0, max_value=2**16))
    @settings(max_examples=5, deadline=None)
    def test_storm_conserves_global_batch(self, seed):
        """Whatever storm the market deals, Σb_k never drifts (fixed outer
        kind)."""
        m = _storm(seed)
        churn = T.compile_churn(m.simulate(), min_workers=2)
        result = _experiment(m, churn).session().run()
        assert result["steps"] == 40
        total0 = sum(result["history"][0].batches)
        for rec in result["history"]:
            assert sum(rec.batches) == total0, \
                f"step {rec.step}: Σb_k = {sum(rec.batches)} != {total0}"
        assert sum(result["final_batches"]) == total0

    @given(seed=st.integers(min_value=0, max_value=2**16))
    @settings(max_examples=3, deadline=None)
    def test_storm_with_gns_outer_tracks_b_global(self, seed):
        """With the GNS outer loop active Σb_k equals the outer's current
        rung through every membership event the storm injects."""
        m = _storm(seed)
        churn = T.compile_churn(m.simulate(), min_workers=2)
        session = _experiment(m, churn, gns=True).session()
        result = session.run()
        t = session.trainer
        assert t.outer is not None
        assert sum(result["final_batches"]) == t.outer.b_global
        assert t.controller.global_batch == t.outer.b_global

    def test_storm_actually_storms(self):
        m = _storm(7)
        churn = T.compile_churn(m.simulate(), min_workers=2)
        s = churn.summary()
        assert s.get("RemoveWorker", 0) >= 1 and s.get("AddWorker", 0) >= 1
        session = _experiment(m, churn).session()
        session.run()
        kinds = {e[1] for e in session.trainer.membership_log}
        assert "remove" in kinds and "add" in kinds


class TestControllerStateThroughChurn:
    def test_survivors_keep_adaptive_state_across_preempt(self):
        m = _storm(1)
        exp = T.Experiment(
            workload=T.paper_workload("linreg"),
            cluster=T.ClusterSpec.explicit(m.initial_fleet(),
                                           workload="linreg", backend=CPU),
            optimizer=sgd(batch_coupled(0.02, rule="linear")),
            config=T.TrainConfig(b0=4, microbatch=4, batching="dynamic",
                                 max_steps=60, seed=0),
        )
        session = exp.session()
        for _ in zip(range(20), session):
            pass
        t = session.trainer
        before = [(w.b_max, w.last_throughput)
                  for w in t.controller.workers[:-1]]
        t.remove_worker(t.k - 1)
        after = [(w.b_max, w.last_throughput) for w in t.controller.workers]
        assert after == before, \
            "preemption must not erase survivors' adaptive b_max/throughput"
        assert sum(t.batches) == sum(session.history[0].batches)

    def test_reallocate_bumps_membership_events_not_num_updates(self):
        # resnet time model: compute-dominated iteration times, so a big
        # slowdown visibly moves the cost-aware split
        m = _storm(1)
        exp = T.Experiment(
            workload=T.paper_workload("linreg"),
            cluster=T.ClusterSpec.explicit(m.initial_fleet(),
                                           workload="resnet", backend=CPU),
            optimizer=sgd(batch_coupled(0.02, rule="linear")),
            config=T.TrainConfig(b0=8, microbatch=4, batching="dynamic",
                                 max_steps=60, seed=0),
        )
        session = exp.session()
        for _ in zip(range(10), session):
            pass
        session.trainer.slow_worker(0, 8.0)
        c = session.trainer.controller
        updates, events = c.num_updates, c.membership_events
        bmax_before = [w.b_max for w in c.workers]
        total = sum(session.trainer.batches)
        before = list(session.trainer.batches)
        session.trainer.reallocate_cost_aware()
        assert session.trainer.batches != before, \
            "an 8x slowdown must move the cost-aware split"
        assert c.num_updates == updates
        assert c.membership_events == events + 1
        assert [w.b_max for w in c.workers] == bmax_before
        assert sum(session.trainer.batches) == total


# --------------------------------------------------- checkpoint under fire


def _state_snapshot(session):
    t = session.trainer
    return {
        "step": t.step_idx,
        "batches": list(t.batches),
        "smoothed_loss": session.smoothed_loss,
        "controller": t.controller.state_dict(),
        "outer": (t.outer.state_dict()
                  if getattr(t, "outer", None) is not None else None),
        "engine": (t.engine.version, list(t.engine.read_version)),
        "sim": (t.sim.time, t.sim.iteration, t.sim.rng.bit_generator.state),
    }


class TestCheckpointUnderFire:
    def _run_under_fire(self, tmp_path, *, outer):
        m = _storm(5)
        churn = T.compile_churn(m.simulate(), min_workers=2)
        event_steps = sorted({ev.step for ev in churn.events})
        save_step = next(s for s in event_steps if s >= 5)
        path = str(tmp_path / "under-fire")

        a = _experiment(m, churn, outer=outer).session()
        for _ in a:
            if a.step_idx >= save_step:
                break
        assert a.step_idx == save_step
        a.save(path)
        snap_a = _state_snapshot(a)

        # resume fleet = the fleet as of the save; resume schedule = the
        # not-yet-fired suffix, including the event AT the save step
        assert any(ev.step == save_step for ev in churn.events)
        fleet_now = list(a.trainer.sim.workers)
        suffix = [ev for ev in churn.events if ev.step >= save_step]
        exp_b = T.Experiment(
            workload=T.paper_workload("linreg"),
            cluster=T.ClusterSpec.explicit(
                fleet_now, workload="linreg",
                backend=CPU).with_schedule(*suffix),
            optimizer=sgd(batch_coupled(0.02, rule="linear")),
            config=T.TrainConfig(b0=4, microbatch=4, batching="dynamic",
                                 max_steps=40, seed=0,
                                 global_batch=_outer_cfg(outer)),
        )
        b = exp_b.session()
        b.restore(path)
        snap_b = _state_snapshot(b)
        assert snap_a == snap_b, "restore mid-storm is not bit-identical"
        if outer == "dynamix":
            oa, ob = a.trainer.outer, b.trainer.outer
            assert oa.state_dict()["extra"]["params"] == \
                ob.state_dict()["extra"]["params"]
            assert oa.state_dict()["extra"]["velocity"] == \
                ob.state_dict()["extra"]["velocity"]
            assert oa.replay == ob.replay
            assert oa._rng.bit_generator.state == \
                ob._rng.bit_generator.state
            assert oa.action_log == ob.action_log

        for _ in a:
            pass
        for _ in b:
            pass
        tail_a = [(r.step, r.loss, tuple(r.batches), r.iteration_time)
                  for r in a.history[save_step:]]
        tail_b = [(r.step, r.loss, tuple(r.batches), r.iteration_time)
                  for r in b.history]
        assert tail_a == tail_b, \
            "resumed run diverged from the uninterrupted one"
        log_a = [e for e in a.trainer.membership_log if e[0] >= save_step]
        assert log_a == b.trainer.membership_log
        assert any(e[0] == save_step for e in log_a)
        assert _state_snapshot(a) == _state_snapshot(b)
        assert all(torch.equal(b.params[k], p) for k, p in a.params.items())

    def test_checkpoint_under_fire_fixed(self, tmp_path):
        self._run_under_fire(tmp_path, outer="fixed")

    def test_checkpoint_under_fire_gns_outer(self, tmp_path):
        self._run_under_fire(tmp_path, outer="gns")

    def test_checkpoint_under_fire_dynamix_outer(self, tmp_path):
        self._run_under_fire(tmp_path, outer="dynamix")

    def test_restore_rejects_already_fired_events(self, tmp_path):
        """A schedule still holding events BEFORE the checkpoint step is a
        config error, not a silent double-apply."""
        m = _storm(5)
        churn = T.compile_churn(m.simulate(), min_workers=2)
        save_step = max(ev.step for ev in churn.events)
        path = str(tmp_path / "stale")
        a = _experiment(m, churn).session()
        for _ in a:
            if a.step_idx >= save_step:
                break
        a.save(path)
        b = T.Experiment(
            workload=T.paper_workload("linreg"),
            cluster=T.ClusterSpec.explicit(
                list(a.trainer.sim.workers), workload="linreg",
                backend=CPU).with_schedule(*churn.events),
            optimizer=sgd(batch_coupled(0.02, rule="linear")),
            config=T.TrainConfig(b0=4, microbatch=4, batching="dynamic",
                                 max_steps=40, seed=0),
        ).session()
        with pytest.raises(ValueError, match="resume past membership"):
            b.restore(path)


# ------------------------------------------- a failed restore changes nothing


def _restore_session(workload="linreg", seed=100, kind="fixed"):
    gb = (TC.GlobalBatchConfig() if kind == "fixed" else
          TC.GlobalBatchConfig(kind=kind, warmup=2, cooldown=1,
                               gns_min_samples=2))
    return T.Experiment(
        workload=T.paper_workload(workload, seed=seed),
        cluster=T.ClusterSpec.hlevel(24, 3.0, 3, workload="linreg", seed=0,
                                     backend=CPU),
        optimizer=sgd(0.05),
        config=T.TrainConfig(b0=8, microbatch=8, batching="dynamic",
                             max_steps=10, seed=0, global_batch=gb),
    ).session()


def _malformed_outer(path):
    tree, meta = load_checkpoint(path, "cpu")
    meta["session"]["outer"]["kind"] = "no-such-kind"
    save_checkpoint(path, tree, meta)


FAILED_RESTORES = {
    # (saved session, session restored into, edit of the file, message)
    "parameters": (dict(), dict(workload="mnist-cnn"), None,
                   "parameters do not match"),
    "outer-payload": (dict(kind="gns"), dict(kind="gns"), _malformed_outer,
                      "unknown global-batch kind"),
    "data-seed": (dict(), dict(seed=101), None, "seed"),
}


@pytest.mark.parametrize("case", list(FAILED_RESTORES))
def test_failed_restore_leaves_data_cursors_and_trainer_alone(tmp_path,
                                                             case):
    saved_kw, fresh_kw, edit, match = FAILED_RESTORES[case]
    first = _restore_session(**saved_kw)
    for _ in zip(range(3), first):
        pass
    path = str(tmp_path / "ck")
    first.save(path)
    if edit is not None:
        edit(path)
    fresh = _restore_session(**fresh_kw)
    data = fresh.workload.state_dict()
    snap = _state_snapshot(fresh)
    params = {k: p.clone() for k, p in fresh.params.items()}
    with pytest.raises(ValueError, match=match):
        fresh.restore(path)
    assert fresh.workload.state_dict() == data
    assert _state_snapshot(fresh) == snap
    assert all(torch.equal(fresh.params[k], p) for k, p in params.items())
    # and the session still runs from where it was
    assert fresh.step().step == 0


# ------------------------------------------------------ parity with repro


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


# The storm of each parity leg: seed, steps, and the outer's extra settings.
# At its default epsilon the reference's dynamix holds at every decision on
# these storms, so its leg explores harder (epsilon 0.6, decay 0.99) and the
# storm is one at which the reference's policy resizes.
PARITY_LEGS = {
    "fixed": (3, 40, {}),
    "gns": (3, 40, {}),
    "dynamix": (3, 40, dict(epsilon=0.6, epsilon_decay=0.99)),
}


def _storm_leg(api, pkg, spot, kind, workload, backend=None):
    seed, steps, extra = PARITY_LEGS[kind]
    market = _storm(seed, pkg=spot)
    churn = api.compile_churn(market.simulate(), min_workers=2)
    kw = {} if backend is None else dict(backend=backend)
    session = api.Experiment(
        workload=workload,
        cluster=api.ClusterSpec.explicit(
            market.initial_fleet(), workload="linreg", seed=0,
            **kw).with_churn(churn),
        optimizer=(sgd(batch_coupled(0.02, rule="linear")) if api is T else
                   ref_sgd(ref_batch_coupled(0.02, rule="linear"))),
        config=api.TrainConfig(b0=4, microbatch=4, batching="dynamic",
                               max_steps=steps, seed=0,
                               global_batch=_outer_cfg(kind, pkg, **extra)),
    ).session()
    return session.run(), session.trainer


def _decisions(out, trainer, kind):
    got = {"membership": list(trainer.membership_log),
           "records": [(r.step, list(r.batches), r.sim_time, r.adjusted)
                       for r in out["history"]],
           "final_batches": list(out["final_batches"])}
    if trainer.outer is not None:
        st = trainer.outer.state_dict()
        got.update(rungs=st["rungs"], rung=st["rung"],
                   num_resizes=st["num_resizes"],
                   resize_log=st["resize_log"])
        if kind == "dynamix":
            got["action_log"] = st["extra"]["action_log"]
    return got


@pytest.mark.parametrize("kind", list(PARITY_LEGS))
def test_storm_matches_reference(monkeypatch, kind):
    ref_out, ref_t = _storm_leg(R, RC, ref_spot, kind,
                                R.paper_workload("linreg"))
    _with_ref_q_head(monkeypatch)
    out, t = _storm_leg(T, TC, None, kind, _linreg_injected(), backend=CPU)
    want = _decisions(ref_out, ref_t, kind)
    assert _decisions(out, t, kind) == want
    kinds = {e[1] for e in want["membership"]}
    assert {"remove", "add", "reallocate"} <= kinds, "the storm must storm"
    for a, b in zip(out["history"], ref_out["history"], strict=True):
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4)
    if kind == "gns":
        assert want["num_resizes"] >= 1, "the leg must move the ladder"
    if kind == "dynamix":
        assert any(a != 1 for a in want["action_log"]), \
            "the reference's policy must leave HOLD at least once"
        assert want["num_resizes"] >= 1


def test_rejoined_worker_pins_no_params_on_bsp():
    """On BSP nothing reads the event engine's per-worker payloads, so a
    rejoin must not leave the params of its step alive there (a full copy
    of the model on the card per rejoin); on ASP the newcomer still gets
    the current params."""
    m = _storm(7)
    churn = T.compile_churn(m.simulate(), min_workers=2)
    session = _experiment(m, churn, max_steps=30).session()
    session.run()
    t = session.trainer
    assert any(e[1] == "add" for e in t.membership_log)
    assert t.engine.payload == [None] * t.k
    asp = T.Experiment(
        workload=T.paper_workload("linreg"),
        cluster=T.ClusterSpec.explicit(m.initial_fleet(), workload="linreg",
                                       backend=CPU),
        optimizer=sgd(0.02),
        config=T.TrainConfig(b0=4, microbatch=4, batching="dynamic",
                             sync="asp", max_steps=5, seed=0),
    ).session()
    asp.run()
    asp.trainer.add_worker(m.initial_fleet()[0])
    assert asp.trainer.engine.payload[-1] is asp.trainer.params
