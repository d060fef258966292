"""Scenarios of the measured backend over several devices, written once for
both packages, and the reference's side of them.

Run as a script, in a fresh interpreter whose environment carries
``JAX_PLATFORMS=cpu`` and ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(set before jax starts), it runs every scenario on the JAX package's own
``MeshTrainer`` over ``make_debug_mesh(8)`` (a data axis of 4, a model axis
of 2) and prints a JSON line as each ends: ``{"name": ..., "result":
...}``.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        PYTHONPATH=src python tests/concurrent_runner.py

``tests/test_torch_concurrent.py`` runs the same scenarios on the port over
``["cpu"] * 4`` and compares.  The reference's mesh leg needs two patches on
this jax, applied here only: ``repro.train.mesh.shard_map`` passes the mesh
by keyword, and the awaiter threads' completion stamps become
``dispatch stamp + duration(worker)``, since threads read a clock in
whatever order they run.  Every module that reads the time gets a fake
clock of its own (1.0 a read), fresh for each scenario.

The scenarios are those of ``tests/mesh_slice_runner.py`` (BSP with a
checkpoint round trip, ASP, membership replans), ``tests/colocate_runner.py``
(the SLO policy growing the dedicated slice under a burst and shrinking it
after the drain, the grown reserve across a checkpoint),
``tests/serve_runner.py`` (the disaggregated
engine's shards reconciled through ``set_reserve``, a shared-mode
concurrent round) and ``tests/churn_runner.py`` (a spot-market storm
through slice replans).  A side object gives each scenario its package:
``api``, ``backend(**kw)``, ``workload()``, ``sgd(lr)``, ``WorkerSpec``,
``ServeSpec``, ``storm_market``, ``inject(trainer)`` (the port takes the
reference's decode parameters) and ``fresh_clocks()``.
"""

import json
import os
import sys
import tempfile

# linreg throughout: the cheapest workload the runners use
CFG = dict(b0=16, microbatch=4, batching="dynamic", seed=0)
DILATION = [3.0, 1.5, 1.0]


def duration(worker: int) -> float:
    """A concurrent call's completion stamp is its dispatch stamp plus
    this: fixed by worker, whatever order the awaiter threads run in."""
    return 1.0 + 0.25 * worker


class FakeClock:
    """``perf_counter()`` that advances by exactly 1.0 a read."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


# ------------------------------------------------------------- results


def decisions(out, t, init) -> dict:
    """What the measured times decide, as JSON (losses apart)."""
    return {
        "probe_plan": list(init),
        "records": [[r.step, r.batches, r.worker_times, r.sim_time,
                     r.iteration_time, r.adjusted, r.straggler_waste]
                    for r in out["history"]],
        "buckets": [sorted(b) for b in t.worker_buckets],
        "timing_reruns": t.timing_reruns,
        "clock": [t.time_model.time, t.time_model.iteration],
        "exec": t.exec_state_dict(),
        "membership": [list(e) for e in t.membership_log],
        "final_batches": list(out["final_batches"]),
        "stamps": t.last_round_stamps,
        "quanta": [rec.quantum for rec in t._exec],
        "losses": [r.loss for r in out["history"]],
    }


def so_far(t) -> dict:
    """The parts of ``Session.run``'s result that :func:`decisions` reads,
    for a session stepped by hand."""
    return {"history": t.history, "final_batches": list(t.batches)}


def controller_state(session) -> dict:
    t = session.trainer
    return {"step": t.step_idx, "batches": list(t.batches),
            "controller": t.controller.state_dict(),
            "exec": t.exec_state_dict(),
            "engine": [t.engine.version, list(t.engine.read_version)]}


def serve_summary(t) -> dict:
    stats = t.serve_stats()
    return {"policy_log": [list(e) for e in t.policy_log],
            "round_charges": list(t.round_charges),
            "serve": json.loads(json.dumps(stats)),
            "streams": sorted([r.uid, list(r.tokens)]
                              for r in t.batcher.finished)}


# ----------------------------------------------------------- scenarios


def experiment(side, *, schedule=(), backend=None, **cfg_kw):
    """``tests/mesh_slice_runner.py``'s experiment."""
    api = side.api
    cfg = dict(CFG, max_steps=10)
    cfg.update(cfg_kw)
    cluster = api.ClusterSpec.hlevel(
        39, 6, workload="mnist-cnn",
        backend=backend or side.backend(dilation=DILATION))
    if schedule:
        cluster = cluster.with_schedule(*schedule)
    return api.Experiment(workload=side.workload(), cluster=cluster,
                          optimizer=side.sgd(0.05),
                          config=api.TrainConfig(**cfg))


def run_decisions(exp) -> dict:
    session = exp.session()
    init = list(session.trainer.batches)
    out = session.run()
    return decisions(out, session.trainer, init)


def scenario_bsp(side):
    """Six concurrent BSP rounds, saved; the checkpoint restored into a
    fresh session, which runs on to step 10."""
    path = os.path.join(tempfile.mkdtemp(), "ckpt")
    s1 = experiment(side).session()
    init = list(s1.trainer.batches)
    for i, _rec in enumerate(s1):
        if i == 5:
            break
    s1.save(path)
    s2 = experiment(side).session()
    s2.restore(path)
    state = controller_state(s2)
    if state != controller_state(s1):
        raise AssertionError("restore is not bit-identical")
    resumed = list(s2.trainer.batches)
    out = s2.run()
    return {"run": decisions(so_far(s1.trainer), s1.trainer, init),
            "restored": state,
            "resumed": decisions(out, s2.trainer, resumed)}


def scenario_asp(side):
    return run_decisions(experiment(side, sync="asp", max_steps=9))


def scenario_replan(side):
    api = side.api
    sched = (api.RemoveWorker(step=3, worker=0),
             api.AddWorker(step=6, spec=side.WorkerSpec(cores=12)))
    return run_decisions(experiment(side, schedule=sched, b0=8, max_steps=9))


def colocate_experiment(side, serve, **cfg_kw):
    """``tests/colocate_runner.py``'s experiment."""
    api = side.api
    cfg = dict(CFG, init_allocation="uniform", max_steps=10)
    cfg.update(cfg_kw)
    exp = api.Experiment(
        workload=side.workload(),
        cluster=api.ClusterSpec.homogeneous(
            30, 3, backend=side.backend(), serve=serve),
        optimizer=side.sgd(0.05), config=api.TrainConfig(**cfg))
    session = exp.session()
    side.inject(session.trainer)
    return session


def scenario_dedicated_policy(side):
    """A burst grows the dedicated slice (training yields a device through
    the replan path); once it grew the traffic stops and the drained
    queue returns the device.  The grown reserve is saved after four
    rounds and restored into a fresh session, which runs on."""
    serve = side.ServeSpec(mode="dedicated", devices=1, slots=1,
                           requests_per_round=3.0, decode_steps_per_round=1,
                           prompt_len=2, max_new_tokens=4, cache_len=16,
                           slo_queue_delay=0.5, check_every=1,
                           idle_patience=1)
    path = os.path.join(tempfile.mkdtemp(), "colo-ckpt")
    session = colocate_experiment(side, serve, max_steps=8)
    t = session.trainer
    reserves, slices = [], []
    for i, _rec in enumerate(session):
        reserves.append(t.reserve)
        slices.append(None if t.slice_plan is None
                      else [list(s) for s in t.slice_plan.slices])
        if i == 3:
            session.save(path)
            saved = t.exec_state_dict()
        if t.reserve > 1:
            t.traffic.rate = 0.0
    out = {"reserves": reserves, "slices": slices,
           "decisions": decisions(so_far(t), t, [16] * 3)}
    out.update(serve_summary(t))
    s2 = colocate_experiment(side, serve, max_steps=8)
    fresh = s2.trainer.reserve
    s2.restore(path)
    t2 = s2.trainer
    if t2.exec_state_dict() != saved:
        raise AssertionError("reserve restore is not bit-identical")
    out["restored"] = {"fresh_reserve": fresh, "exec": saved,
                       "serve_slice": [t2.serve_slice.start,
                                       t2.serve_slice.length]}
    out["resumed"] = decisions(s2.run(), t2, [16] * 3)
    return out


def scenario_disaggregated(side):
    """``tests/serve_runner.py``'s shard reconciliation: a shard a reserved
    row; growing the region with requests live adds one and keeps the
    others' lanes, shrinking migrates or resumes the dropped shard's slots,
    and every request still finishes."""
    serve = side.ServeSpec(mode="dedicated", devices=2,
                           engine="disaggregated", traffic="poisson",
                           requests_per_round=2.0, slots=2,
                           decode_steps_per_round=2, prompt_len=3,
                           max_new_tokens=6, cache_len=16)
    session = colocate_experiment(side, serve, max_steps=6)
    t = session.trainer
    mgr = t.batcher
    shards = [len(mgr.shards)]
    for _ in zip(range(4), session):
        mgr.check()
    before = set(mgr.shards)
    t.set_reserve(3)
    mgr.check()
    shards.append(len(mgr.shards))
    if not before <= set(mgr.shards):
        raise AssertionError("a kept row's shard was replaced")
    t.set_reserve(2)
    mgr.check()
    shards.append(len(mgr.shards))
    t.traffic.rate = 0.0
    mgr.run_until_idle()
    mgr.check()
    if len(mgr.finished) != t.traffic.submitted:
        raise AssertionError("a request was lost in the fleet churn")
    out = {"shards": shards, "concurrent": t.concurrent,
           "decisions": decisions(so_far(t), t, [16] * 3)}
    out.update(serve_summary(t))
    return out


def scenario_shared(side):
    """``tests/serve_runner.py``'s shared mode on concurrent slices: the
    other workers in flight while the decode loop runs on the contended
    worker's slice, the charge on the contended worker."""
    serve = side.ServeSpec(mode="shared", engine="disaggregated",
                           traffic="poisson", requests_per_round=2.0,
                           slots=2, decode_steps_per_round=3, prompt_len=3,
                           max_new_tokens=4, cache_len=16)
    session = colocate_experiment(side, serve, max_steps=4)
    t = session.trainer
    windows = []
    for _rec in session:
        windows.append(t.last_serve_window)
    out = {"windows": windows,
           "decisions": decisions(so_far(t), t, [16] * 3)}
    out.update(serve_summary(t))
    return out


def scenario_storm(side):
    """``tests/churn_runner.py``'s seed-6 storm through slice replans."""
    api = side.api
    market = side.storm_market(4, zones=2, seed=6, horizon=12,
                               volatility=0.35, spike_rate=0.3,
                               degrade_rate=0.05, straggle_rate=0.08)
    churn = api.compile_churn(market.simulate(), min_workers=2)
    cluster = api.ClusterSpec.explicit(
        market.initial_fleet(), workload="mnist-cnn",
        backend=side.backend(dilation="from-spec"))
    exp = api.Experiment(
        workload=side.workload(),
        cluster=cluster.with_schedule(*churn.events),
        optimizer=side.sgd(0.05),
        config=api.TrainConfig(**dict(CFG, max_steps=14)))
    session = exp.session()
    init = list(session.trainer.batches)
    out = session.run()
    res = decisions(out, session.trainer, init)
    res["dilation"] = list(session.trainer.dilation)
    return res


SCENARIOS = {
    "bsp": scenario_bsp,
    "asp": scenario_asp,
    "replan": scenario_replan,
    "dedicated_policy": scenario_dedicated_policy,
    "disaggregated": scenario_disaggregated,
    "shared": scenario_shared,
    "storm": scenario_storm,
}


def run(side, name: str):
    """One scenario on fresh clocks, as JSON would give it back."""
    side.fresh_clocks()
    return json.loads(json.dumps(SCENARIOS[name](side)))


# ------------------------------------------------------- reference side


class ReferenceSide:
    """The JAX package over ``make_debug_mesh(8)``, patched as above."""

    def __init__(self):
        import jax
        import repro.api as R
        import repro.serve.scheduler as sched
        import repro.serve.slots as slots
        import repro.train.colocate as colo
        import repro.train.mesh as mesh_mod
        from repro.compat import shard_map
        from repro.het.simulator import WorkerSpec
        from repro.het.spot import storm_market
        from repro.launch.mesh import make_debug_mesh
        from repro.optim import sgd
        from repro.serve.colocate import ServeSpec

        if len(jax.devices()) != 8:
            raise RuntimeError(
                f"needs 8 host devices (XLA_FLAGS), got {jax.devices()}")
        self.api = R
        self.mesh = make_debug_mesh(8)
        self.sgd = sgd
        self.WorkerSpec = WorkerSpec
        self.ServeSpec = ServeSpec
        self.storm_market = storm_market
        self._clocked = (mesh_mod, colo, sched, slots)

        def keyword_shard_map(f, mesh, **kw):
            return shard_map(f, mesh=mesh, **kw)

        def stamp(d):
            jax.block_until_ready(d.out)
            return d.t0 + duration(d.worker)

        def submit_awaiters(trainer, dispatches):
            pool = trainer._await_pool()
            return [pool.submit(stamp, d) for d in dispatches]

        mesh_mod.shard_map = keyword_shard_map
        mesh_mod.MeshTrainer._submit_awaiters = submit_awaiters

    def backend(self, **kw):
        return self.api.MeshBackend(mesh=self.mesh, **kw)

    def workload(self):
        return self.api.paper_workload("linreg")

    def inject(self, trainer):
        pass

    def fresh_clocks(self):
        for mod in self._clocked:
            mod._time = FakeClock()


def main() -> int:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    side = ReferenceSide()
    for name in SCENARIOS:
        print(json.dumps({"name": name, "result": run(side, name)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
