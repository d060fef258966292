"""The port's host layer (numpy / pure Python) gives outputs bit-identical to
the reference's: batching plans, allocation, the P/PI/PID/gain controllers,
the cluster simulator and the event engine, fed the same seeded inputs."""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import dataclasses

import numpy as np
import pytest

from repro.core import allocation as ref_alloc
from repro.core import batching as ref_batching
from repro.core import control as ref_control
from repro.het import simulator as ref_sim
from repro.train import engine as ref_engine
from repro_torch.core import allocation, batching, control
from repro_torch.het import simulator
from repro_torch.train import engine


@pytest.mark.parametrize("batch,micro", [(1, 1), (7, 2), (8, 4), (13, 5),
                                         (64, 8), (3, 8)])
def test_plan_microbatches_identical(batch, micro):
    a = batching.plan_microbatches(batch, micro)
    b = ref_batching.plan_microbatches(batch, micro)
    assert (a.n_steps, a.padded_examples) == (b.n_steps, b.padded_examples)
    assert a.masks().dtype == b.masks().dtype
    assert np.array_equal(a.masks(), b.masks())
    assert batching.plan_cluster([batch, micro], micro).weights == \
        ref_batching.plan_cluster([batch, micro], micro).weights


@pytest.mark.parametrize("b_max,base,growth,quantum",
                         [(12, 1, 1.25, 1), (300, 4, 1.5, 4), (64, 2, 2.0, 2)])
def test_bucket_ladder_identical(b_max, base, growth, quantum):
    kw = dict(base=base, growth=growth, quantum=quantum)
    assert batching.bucket_ladder(b_max, **kw) == \
        ref_batching.bucket_ladder(b_max, **kw)
    for b in range(1, b_max + 1, 3):
        assert batching.bucket_up(b, **kw) == ref_batching.bucket_up(b, **kw)


def test_allocation_identical():
    rng = np.random.default_rng(3)
    for _ in range(20):
        xput = list(rng.uniform(0.5, 20.0, size=4))
        b0 = int(rng.integers(2, 64))
        assert allocation.static_allocation(xput, b0) == \
            ref_alloc.static_allocation(xput, b0)
        caps = [int(c) for c in rng.integers(b0 // 2 + 1, 4 * b0, size=4)]
        prices = list(rng.uniform(0.2, 2.0, size=4))
        kw = dict(capacities=caps, prices=prices)
        assert allocation.cost_aware_allocation(xput, 4 * b0, **kw) == \
            ref_alloc.cost_aware_allocation(xput, 4 * b0, **kw)


def _times_sequence(k, n, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.5, 3.0, size=k)
    for i in range(n):
        shock = 2.5 if i == n // 2 else 1.0
        yield list(base * rng.uniform(0.9, 1.1, size=k)
                   * np.where(np.arange(k) == 0, shock, 1.0))


@pytest.mark.parametrize("kind", ["p", "pi", "pid", "gain"])
def test_controller_observe_sequences_identical(kind):
    init = [12, 10, 8, 6]
    cfg = dict(kind=kind, dead_band=0.02)
    ours = control.make_controller(init, control.ControllerConfig(**cfg))
    ref = ref_control.make_controller(init, ref_control.ControllerConfig(**cfg))
    for times in _times_sequence(len(init), 30, seed=len(kind)):
        a, b = ours.observe(times), ref.observe(times)
        assert (a.batches, a.updated) == (b.batches, b.updated)
    assert ours.state_dict() == ref.state_dict()
    assert ours.remove_worker(1) == ref.remove_worker(1)
    assert ours.add_worker(7.5) == ref.add_worker(7.5)


def _sims(workload="transformer", seed=0):
    specs = simulator.hlevel_cluster(39, 6.0, 3)
    ref_specs = ref_sim.hlevel_cluster(39, 6.0, 3)
    assert [dataclasses.asdict(s) for s in specs] == \
        [dataclasses.asdict(s) for s in ref_specs]
    return (simulator.ClusterSim(specs, simulator.WORKLOADS[workload],
                                 seed=seed),
            ref_sim.ClusterSim(ref_specs, ref_sim.WORKLOADS[workload],
                               seed=seed))


@pytest.mark.parametrize("workload", ["transformer", "mnist-cnn"])
def test_cluster_sim_iteration_times_identical(workload):
    ours, ref = _sims(workload)
    for batches in ([4, 4, 4], [2, 4, 6], [1, 5, 9], [7, 3, 2]):
        assert ours.bsp_step(batches) == ref.bsp_step(batches)
        for k in range(3):
            assert ours.peek_throughput(k, batches[k]) == \
                ref.peek_throughput(k, batches[k])
    assert ours.time == ref.time
    assert ours.asp_run([3, 4, 5], 12) == ref.asp_run([3, 4, 5], 12)


def test_event_engine_pop_order_identical():
    ours_sim, ref_sim_ = _sims()
    ours, ref = engine.EventEngine(ours_sim), ref_engine.EventEngine(ref_sim_)
    batches = [2, 4, 6]
    assert ours.bsp_round(batches) == ref.bsp_round(batches)
    ours.asp_schedule(batches, payload=0)
    ref.asp_schedule(batches, payload=0)
    for i in range(15):
        if i == 7:
            ours.remove_worker(1)
            ref.remove_worker(1)
            batches = [3, 9]
        a, b = ours.asp_next(batches), ref.asp_next(batches)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert ours.version == ref.version
    assert ours.read_version == ref.read_version


@pytest.mark.parametrize("b0,quantum,factor", [(12, 3, 8.0), (32, 4, 2.5),
                                               (7, 1, 1.0)])
def test_fixed_outer_controller_identical(b0, quantum, factor):
    from repro.core.control import global_batch as ref_gb
    from repro_torch.core.control import global_batch as gb

    ours = gb.make_global_controller(gb.GlobalBatchConfig(max_factor=factor),
                                     b0, quantum)
    ref = ref_gb.make_global_controller(
        ref_gb.GlobalBatchConfig(max_factor=factor), b0, quantum)
    assert ours.rungs == ref.rungs
    for step in range(12):
        kw = dict(loss=3.0 - 0.1 * step, seconds=0.5)
        assert ours.observe(**kw) == ref.observe(**kw)
    assert ours.state_dict() == ref.state_dict()
    back = gb.global_batch_from_state_dict(ref.state_dict())
    assert back.state_dict() == ref.state_dict()
