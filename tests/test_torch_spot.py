"""Slice 10: the spot market, the churn compiler, the device pool and the
chaos harness of the port, a mirror of ``tests/test_spot.py``, plus parity
with the reference.

The modules are numpy and pure Python, copied from the reference, so every
parity case asks for ``==``: the market's traces event for event, the
compiled schedules and their ``dropped`` lists, ``plan_slices`` /
``carve_serve`` / ``DevicePool`` results and the seeded fault plans.  Events
of the two packages are different classes, so both sides are first reduced
to plain tuples of (type name, fields).  The chaos sessions run on
``SimBackend(device="cpu")``.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import dataclasses
import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.api as R
import repro.core.placement as ref_placement
import repro.het.chaos as ref_chaos
import repro.het.spot as ref_spot
from repro_torch import api as T
from repro_torch.core import DevicePool, carve_serve, plan_slices
from repro_torch.core import GlobalBatchConfig
from repro_torch.het.chaos import Fault, make_fault_plan, run_chaos
from repro_torch.het.spot import (
    Degrade,
    Preempt,
    Rejoin,
    SpotMarket,
    SpotZone,
    Straggle,
    storm_market,
)
from repro_torch.optim import batch_coupled, sgd

CPU = T.SimBackend(device="cpu")


def _market(**kw):
    args = dict(workers=8, zones=2, seed=3, horizon=40,
                degrade_rate=0.02, straggle_rate=0.03)
    args.update(kw)
    workers = args.pop("workers")
    return storm_market(workers, **args)


def plain(x):
    """A value of either package as plain data: dataclasses become (type
    name, fields...), sequences tuples, ranges (start, stop)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, range):
        return ("range", x.start, x.stop)
    return x


# ----------------------------------------------------------------- market


class TestSpotMarket:
    def test_same_seed_trace_identical(self):
        a, b = _market().simulate(), _market().simulate()
        assert a.prices == b.prices
        assert a.capacities == b.capacities
        assert a.events == b.events

    def test_different_seed_trace_differs(self):
        a = _market(seed=3).simulate()
        b = _market(seed=4).simulate()
        assert a.prices != b.prices

    def test_capacity_starts_full_and_stays_bounded(self):
        tr = _market().simulate()
        for z in tr.zones:
            caps = tr.capacities[z.name]
            assert caps[0] == z.workers
            assert all(0 <= c <= z.workers for c in caps)
            assert all(p > 0 for p in tr.prices[z.name])

    def test_initial_fleet_matches_step0_capacity(self):
        m = _market()
        fleet = m.initial_fleet()
        tr = m.simulate()
        assert len(fleet) == sum(c[0] for c in tr.capacities.values())

    def test_events_consistent_with_capacity_deltas(self):
        tr = _market().simulate()
        for z in tr.zones:
            caps = tr.capacities[z.name]
            net = sum(1 for ev in tr.events
                      if isinstance(ev, Rejoin) and ev.zone == z.name) - \
                sum(1 for ev in tr.events
                    if isinstance(ev, Preempt) and ev.zone == z.name)
            assert caps[-1] - caps[0] == net

    def test_csv_export(self, tmp_path):
        tr = _market().simulate()
        path = str(tmp_path / "trace.csv")
        tr.to_csv(path)
        lines = open(path).read().splitlines()
        assert lines[0] == "step,kind,zone,slot,price,capacity,detail"
        assert len(lines) == 1 + len(tr.events)

    def test_validation(self):
        with pytest.raises(ValueError, match="bid"):
            SpotZone(name="z", workers=2, base_price=2.0, bid=1.0)
        with pytest.raises(ValueError, match="duplicate"):
            SpotMarket([SpotZone(name="z", workers=1),
                        SpotZone(name="z", workers=2)])
        with pytest.raises(ValueError, match="horizon"):
            SpotMarket([SpotZone(name="z", workers=1)], horizon=0)

    def test_summary_counts(self):
        tr = _market().simulate()
        s = tr.summary()
        kinds = [type(ev) for ev in tr.events]
        assert s["preempts"] == kinds.count(Preempt)
        assert s["rejoins"] == kinds.count(Rejoin)
        assert s["degrades"] == kinds.count(Degrade)
        assert s["straggles"] == kinds.count(Straggle)


# --------------------------------------------------------------- compiler


class TestCompileChurn:
    def test_compile_is_deterministic(self):
        tr = _market().simulate()
        a, b = T.compile_churn(tr), T.compile_churn(tr)
        assert a.events == b.events
        assert a.dropped == b.dropped

    def test_indices_valid_when_replayed(self):
        """Replaying the compiled schedule against a model fleet never
        indexes out of range nor shrinks below min_workers."""
        m = _market(workers=12, zones=3, seed=7)
        tr = m.simulate()
        churn = T.compile_churn(tr, min_workers=2)
        k = len(m.initial_fleet())
        removed = added = 0
        for ev in churn.events:
            if isinstance(ev, T.RemoveWorker):
                assert 0 <= ev.worker < k
                k -= 1
                removed += 1
                assert k >= 2
            elif isinstance(ev, T.AddWorker):
                k += 1
                added += 1
                assert ev.spec.price > 0
            elif isinstance(ev, T.SlowWorker):
                assert 0 <= ev.worker < k
                assert ev.factor > 0
            else:
                assert isinstance(ev, T.Reallocate)
        applied_preempts = sum(
            1 for ev in tr.events if isinstance(ev, Preempt)) - sum(
            1 for ev in churn.dropped if isinstance(ev, Preempt))
        assert k == len(m.initial_fleet()) - applied_preempts + added

    def test_events_sorted_and_reallocate_trails_each_changed_step(self):
        churn = T.compile_churn(_market().simulate())
        steps = [ev.step for ev in churn.events]
        assert steps == sorted(steps)
        by_step = {}
        for ev in churn.events:
            by_step.setdefault(ev.step, []).append(ev)
        for evs in by_step.values():
            reallocs = [ev for ev in evs if isinstance(ev, T.Reallocate)]
            assert len(reallocs) == 1
            assert evs[-1] is reallocs[0]

    def test_degrade_staircase_nets_out_to_one(self):
        """A Degrade lowers to a multiplicative ramp staircase whose total
        product (restore included) returns the worker to full speed."""
        z = SpotZone(name="z", workers=3, volatility=0.0, spike_rate=0.0,
                     degrade_rate=0.08)
        tr = SpotMarket([z], seed=1, horizon=60).simulate()
        degrades = [ev for ev in tr.events if isinstance(ev, Degrade)]
        assert degrades, "expected at least one degrade at this rate"
        churn = T.compile_churn(tr)
        slows = [ev for ev in churn.events if isinstance(ev, T.SlowWorker)]
        assert slows
        net: dict[int, float] = {}
        for ev in slows:
            net[ev.worker] = net.get(ev.worker, 1.0) * ev.factor
        for worker, product in net.items():
            assert product == pytest.approx(1.0), \
                f"worker {worker} left {product}x slower after the ramp"

    def test_start_step_offsets_whole_schedule(self):
        tr = _market().simulate()
        base = T.compile_churn(tr)
        offset = T.compile_churn(tr, start_step=100)
        assert [ev.step + 100 for ev in base.events] == \
            [ev.step for ev in offset.events]

    def test_min_workers_floor_drops_preempts(self):
        m = _market(workers=4, zones=1, seed=9, volatility=0.4,
                    spike_rate=0.2)
        tr = m.simulate()
        churn = T.compile_churn(tr, min_workers=4)
        assert churn.dropped
        assert all(isinstance(ev, Preempt) for ev in churn.dropped)
        k = len(m.initial_fleet())
        for ev in churn.events:
            if isinstance(ev, T.RemoveWorker):
                k -= 1
            elif isinstance(ev, T.AddWorker):
                k += 1
            assert k >= 4

    def test_with_churn_lands_in_cluster_schedule(self):
        m = _market()
        churn = T.compile_churn(m.simulate())
        spec = T.ClusterSpec.explicit(m.initial_fleet(),
                                      workload="linreg").with_churn(churn)
        assert len(spec.schedule) == len(churn.events)
        steps = [ev.step for ev in spec.schedule]
        assert steps == sorted(steps)


# ------------------------------------------------------------ device pool


class TestDevicePool:
    def test_lease_release_resize_packing(self):
        pool = DevicePool(16, quantum=2)
        assert pool.lease("train", 8) == (0, 8)
        assert pool.lease("serve", 4) == (8, 4)
        assert pool.lease("exp2", 2) == (12, 2)
        assert pool.free == 2
        pool.release("serve")
        assert pool.region("exp2") == (8, 2)
        assert pool.migrations == 1
        assert pool.resize("train", 10) == (0, 10)
        assert pool.region("exp2") == (10, 2)
        assert pool.migrations == 2
        pool.check()

    def test_plan_inside_lease(self):
        pool = DevicePool(16, quantum=2)
        pool.lease("train", 12)
        plan = pool.plan("train", 3)
        assert plan.extent == 12 and plan.k == 3
        assert sum(plan.lengths) == 12

    def test_errors(self):
        pool = DevicePool(8, quantum=2)
        pool.lease("a", 4)
        with pytest.raises(ValueError, match="already holds"):
            pool.lease("a", 2)
        with pytest.raises(ValueError, match="free"):
            pool.lease("b", 6)
        with pytest.raises(ValueError, match="quantum"):
            pool.lease("b", 3)
        with pytest.raises(KeyError):
            pool.region("ghost")
        with pytest.raises(ValueError, match="available"):
            pool.resize("a", 10)
        with pytest.raises(ValueError, match="quantum"):
            DevicePool(9, quantum=2)

    @given(ops=st.lists(st.tuples(st.sampled_from(["lease", "release",
                                                   "resize"]),
                                  st.integers(min_value=0, max_value=5),
                                  st.integers(min_value=1, max_value=8)),
                        min_size=1, max_size=40))
    @settings(max_examples=40, deadline=None)
    def test_invariants_under_arbitrary_churn(self, ops):
        """Any sequence of lease/release/resize keeps the pool disjoint,
        packed from device 0, quantum-aligned, and within the extent."""
        pool = DevicePool(16, quantum=2)
        for op, t, n in ops:
            tenant = f"t{t}"
            try:
                if op == "lease":
                    pool.lease(tenant, 2 * n)
                elif op == "release":
                    pool.release(tenant)
                else:
                    pool.resize(tenant, 2 * n)
            except (ValueError, KeyError):
                continue
            pool.check()
            cursor = 0
            for name in pool.tenants:
                start, length = pool.region(name)
                assert start == cursor, "leases must be packed from 0"
                assert length % pool.quantum == 0
                cursor += length
            assert cursor == pool.leased <= pool.extent


# ----------------------------------------------------------------- chaos


def _chaos_session():
    exp = T.Experiment(
        workload=T.paper_workload("linreg"),
        cluster=T.ClusterSpec.hlevel(24, 3.0, 3, workload="linreg", seed=0,
                                     backend=CPU),
        optimizer=sgd(batch_coupled(0.02, rule="linear")),
        config=T.TrainConfig(b0=4, microbatch=4, batching="dynamic",
                             max_steps=30, seed=0,
                             global_batch=GlobalBatchConfig(
                                 kind="gns", warmup=4, cooldown=4,
                                 gns_min_samples=4)),
    )
    return exp.session()


class TestChaos:
    def test_plan_is_seeded_data(self):
        a = make_fault_plan(11, horizon=40)
        b = make_fault_plan(11, horizon=40)
        assert a == b
        assert make_fault_plan(12, horizon=40) != a
        kinds = [f.kind for f in a.faults]
        assert set(kinds) == {"preempt-during-checkpoint",
                              "preempt-during-resize",
                              "straggler-during-gns-cooldown"}

    def test_unknown_fault_kind_rejected(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            Fault(kind="set-datacenter-on-fire", arm_step=1, victim_bias=0)

    def test_chaos_replay_is_bit_identical(self, tmp_path):
        path = str(tmp_path / "chaos-ckpt")
        plan = make_fault_plan(11, horizon=30)
        r1, h1 = run_chaos(_chaos_session, plan, checkpoint_path=path)
        r2, h2 = run_chaos(_chaos_session, plan, checkpoint_path=path)
        assert r1["chaos_log"] == r2["chaos_log"]
        assert r1["chaos_log"], "the plan should have injected something"
        hist1 = [(r.step, r.loss, tuple(r.batches)) for r in r1["history"]]
        hist2 = [(r.step, r.loss, tuple(r.batches)) for r in r2["history"]]
        assert hist1 == hist2
        if any(kind == "preempt-during-checkpoint"
               for _, kind, _ in r1["chaos_log"]):
            assert os.path.exists(path)

    def test_chaos_preserves_global_batch(self):
        def make_session():
            exp = T.Experiment(
                workload=T.paper_workload("linreg"),
                cluster=T.ClusterSpec.hlevel(24, 3.0, 3, workload="linreg",
                                             seed=0, backend=CPU),
                optimizer=sgd(batch_coupled(0.02, rule="linear")),
                config=T.TrainConfig(b0=4, microbatch=4, batching="dynamic",
                                     max_steps=30, seed=0),
            )
            return exp.session()

        plan = make_fault_plan(5, horizon=30)
        result, _hook = run_chaos(make_session, plan)
        assert result["chaos_log"], "the plan should have injected something"
        total0 = sum(result["history"][0].batches)
        for rec in result["history"]:
            assert sum(rec.batches) == total0, f"step {rec.step} leaked batch"
        assert sum(result["final_batches"]) == total0


# ------------------------------------------------------ parity with repro

STORM = dict(degrade_rate=0.02, straggle_rate=0.03)


def _storms(seed):
    return (ref_spot.storm_market(8, zones=2, seed=seed, horizon=40,
                                  **STORM),
            storm_market(8, zones=2, seed=seed, horizon=40, **STORM))


@pytest.mark.parametrize("seed", range(12))
def test_market_trace_equals_reference(seed):
    ref_m, m = _storms(seed)
    ref, port = ref_m.simulate(), m.simulate()
    assert plain(port.events) == plain(ref.events)
    assert port.prices == ref.prices and port.capacities == ref.capacities
    assert plain(port.zones) == plain(ref.zones)
    assert plain(m.initial_fleet()) == plain(ref_m.initial_fleet())
    assert port.summary() == ref.summary()


COMPILE_OPTS = {
    "default": {},
    "floor": dict(min_workers=2),
    "offset": dict(start_step=7, min_workers=3),
    "stairs": dict(ramp_stairs=1, min_workers=2),
    "no-realloc": dict(reallocate=False, ramp_stairs=5),
}


@pytest.mark.parametrize("opts", list(COMPILE_OPTS))
def test_compile_churn_equals_reference(opts):
    kw = COMPILE_OPTS[opts]
    for seed in range(12):
        ref_m, m = _storms(seed)
        ref = R.compile_churn(ref_m.simulate(), **kw)
        port = T.compile_churn(m.simulate(), **kw)
        assert plain(port.events) == plain(ref.events), seed
        assert plain(port.dropped) == plain(ref.dropped), seed
        assert port.summary() == ref.summary()
    # a degrade-rich single-zone market exercises the staircase and drops
    z = dict(name="z", workers=3, volatility=0.3, spike_rate=0.1,
             degrade_rate=0.08, straggle_rate=0.05)
    ref = R.compile_churn(ref_spot.SpotMarket(
        [ref_spot.SpotZone(**z)], seed=1, horizon=60).simulate(), **kw)
    port = T.compile_churn(SpotMarket([SpotZone(**z)], seed=1,
                                      horizon=60).simulate(), **kw)
    assert plain(port.events) == plain(ref.events)
    assert plain(port.dropped) == plain(ref.dropped)


def test_the_card_storm_compiles_to_every_event_kind():
    """The seed-11 storm that the chip smoke test replays at gemma width:
    two preemptions at step 1, rejoins at 5 and 6, a straggler at 9 and its
    restore at 12, a Reallocate after each, equal to the reference's."""
    kw = dict(zones=2, seed=11, horizon=12, degrade_rate=0.01,
              straggle_rate=0.02)
    ref = R.compile_churn(ref_spot.storm_market(4, **kw).simulate(),
                          min_workers=2)
    port = T.compile_churn(storm_market(4, **kw).simulate(), min_workers=2)
    assert plain(port.events) == plain(ref.events)
    kinds = [(type(ev).__name__, ev.step) for ev in port.events]
    assert kinds == [("RemoveWorker", 1), ("RemoveWorker", 1),
                     ("Reallocate", 1), ("AddWorker", 5), ("Reallocate", 5),
                     ("AddWorker", 6), ("Reallocate", 6), ("SlowWorker", 9),
                     ("Reallocate", 9), ("SlowWorker", 12),
                     ("Reallocate", 12)]


def test_placement_equals_reference():
    for extent, k, weights, quantum in [
            (8, 3, None, 1), (16, 3, [1.0, 2.0, 5.0], 2), (12, 3, None, 3),
            (64, 5, [0.3, 1.0, 1.0, 2.5, 0.7], 4), (9, 7, None, 1)]:
        ref = ref_placement.plan_slices(extent, k, weights, quantum=quantum)
        port = plan_slices(extent, k, weights, quantum=quantum)
        assert plain(port) == plain(ref)
        assert plain(port.remove(k // 2)) == plain(ref.remove(k // 2))
        assert plain(port.add()) == plain(ref.add())
        assert plain(port.add(2.0)) == plain(ref.add(2.0))
        assert [plain(port.devices_of(i)) for i in range(k)] == \
            [plain(ref.devices_of(i)) for i in range(k)]
    for args, kw in [((16, 3, 4), {}), ((16, 3, 4), dict(mode="shared")),
                     ((16, 2, 4), dict(quantum=2, weights=[1.0, 3.0])),
                     ((8, 4, 0), dict(mode="shared", quantum=2))]:
        ref = ref_placement.carve_serve(*args, **kw)
        port = carve_serve(*args, **kw)
        assert plain(port) == plain(ref)
        assert plain(port[1].devices()) == plain(ref[1].devices())
        assert port[1].dedicated == ref[1].dedicated


POOL_OPS = [("lease", "train", 8), ("lease", "serve", 4),
            ("lease", "exp2", 2), ("release", "serve", 0),
            ("resize", "train", 10), ("lease", "serve", 6),
            ("resize", "exp2", 8), ("plan", "train", 3),
            ("release", "train", 0), ("resize", "exp2", 4),
            ("lease", "big", 20), ("plan", "exp2", 2)]


def _drive_pool(pool):
    out = []
    for op, tenant, n in POOL_OPS:
        try:
            if op == "lease":
                got = pool.lease(tenant, n)
            elif op == "release":
                got = pool.release(tenant)
            elif op == "resize":
                got = pool.resize(tenant, n)
            else:
                got = pool.plan(tenant, n)
        except (ValueError, KeyError) as e:
            got = type(e).__name__
        out.append((plain(got), pool.tenants, pool.free, pool.migrations,
                    pool.regions()))
    return out


def test_device_pool_equals_reference():
    assert _drive_pool(DevicePool(16, quantum=2)) == \
        _drive_pool(ref_placement.DevicePool(16, quantum=2))


@pytest.mark.parametrize("seed", [0, 5, 11, 12, 2**20])
def test_fault_plan_equals_reference(seed):
    for horizon, kw in [(30, {}), (40, {}), (4, {}),
                        (200, dict(faults_per_kind=3)),
                        (17, dict(kinds=("preempt-during-resize",)))]:
        ref = ref_chaos.make_fault_plan(seed, horizon=horizon, **kw)
        port = make_fault_plan(seed, horizon=horizon, **kw)
        assert plain(port) == plain(ref)
        assert port.summary() == ref.summary()
