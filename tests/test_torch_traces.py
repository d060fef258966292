"""Slice 10: the availability-trace combinators of the port
(``repro_torch.het.traces``), a mirror of ``tests/test_traces.py``, plus
parity with the reference's module.

One deliberate change to the mirrored properties: the half-open preemption
window probes its left neighbour as ``math.nextafter(at, 0)``, the largest
float below ``at``.  The reference test probes ``at * (1 - 1e-9)``, which
rounds back to ``at`` itself when Hypothesis draws a subnormal ``at``, so
that property fails on a correct trace for some draws.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.het import traces as ref_traces
from repro_torch.het import traces

seeds = st.integers(min_value=0, max_value=2**31 - 1)
times = st.floats(min_value=0.0, max_value=500.0, allow_nan=False,
                  allow_infinity=False)
levels = st.floats(min_value=1e-3, max_value=1.0, allow_nan=False,
                   allow_infinity=False)


class TestDeterminism:
    @given(seed=seeds, data=st.data())
    @settings(max_examples=50, deadline=None)
    def test_same_seed_random_spikes_pointwise_identical(self, seed, data):
        a = traces.random_spikes(seed, horizon=300.0)
        b = traces.random_spikes(seed, horizon=300.0)
        for _ in range(20):
            t = data.draw(times)
            assert a(t) == b(t)

    def test_different_seeds_differ_somewhere(self):
        a = traces.random_spikes(0, horizon=300.0, rate_per_100s=10.0)
        b = traces.random_spikes(1, horizon=300.0, rate_per_100s=10.0)
        grid = [i * 0.5 for i in range(600)]
        assert any(a(t) != b(t) for t in grid)


class TestRange:
    @given(seed=seeds, level=levels, t=times)
    @settings(max_examples=50, deadline=None)
    def test_compose_stays_in_unit_interval(self, seed, level, t):
        tr = traces.compose(
            traces.random_spikes(seed, horizon=500.0, level=level),
            traces.step_interference(10.0, 50.0, level),
            traces.periodic_interference(30.0, 0.4, level),
            traces.ramp(100.0, 50.0, level),
        )
        v = tr(t)
        assert 0.0 < v <= 1.0

    @given(t=times)
    @settings(max_examples=50, deadline=None)
    def test_stacked_preemptions_hit_the_floor_not_zero(self, t):
        tr = traces.compose(
            traces.preemption(0.0, level=1e-3),
            traces.preemption(0.0, level=1e-3),
            traces.preemption(0.0, level=1e-3),
        )
        assert tr(t) == 1e-6

    def test_two_preemptions_sit_exactly_on_the_clamp(self):
        tr = traces.compose(traces.preemption(5.0, level=1e-3),
                            traces.preemption(5.0, level=1e-3))
        assert tr(5.0) == 1e-6
        assert tr(4.999) == 1.0

    def test_compose_clamps_above_one(self):
        tr = traces.compose(traces.constant(1.8), traces.constant(0.9))
        assert tr(0.0) == 1.0


class TestBoundaries:
    @given(at=times, dur=st.floats(min_value=0.1, max_value=100.0),
           level=levels)
    @settings(max_examples=50, deadline=None)
    def test_preemption_half_open_window(self, at, dur, level):
        restore = at + dur
        tr = traces.preemption(at, restore, level=level)
        assert tr(at) == level          # t == at: already preempted
        assert tr(restore) == 1.0       # t == restore: already back
        assert tr(at + dur / 2) == level
        if at > 0:
            # the float just below `at`, subnormal `at` included
            assert tr(math.nextafter(at, 0.0)) == 1.0

    def test_preemption_left_neighbour_of_a_subnormal_onset(self):
        """The draw that breaks the reference's ``at * (1 - 1e-9)`` probe:
        at the smallest subnormal the product rounds back to ``at``."""
        at = 5e-324
        assert at * (1 - 1e-9) == at
        tr = traces.preemption(at, at + 1.0, level=0.5)
        assert tr(math.nextafter(at, 0.0)) == 1.0 and tr(at) == 0.5

    def test_preemption_without_restore_never_returns(self):
        tr = traces.preemption(3.0, level=0.5)
        assert tr(2.999) == 1.0 and tr(3.0) == 0.5 and tr(1e9) == 0.5

    @given(start=times, dur=st.floats(min_value=0.1, max_value=100.0),
           lo=levels)
    @settings(max_examples=50, deadline=None)
    def test_ramp_endpoints_pinned(self, start, dur, lo):
        tr = traces.ramp(start, dur, lo)
        assert tr(start) == 1.0
        assert math.isclose(tr(start + dur), lo)
        assert math.isclose(tr(start + dur * 10), lo)
        mid = tr(start + dur / 2)
        assert min(1.0, lo) - 1e-12 <= mid <= max(1.0, lo) + 1e-12

    def test_step_interference_half_open(self):
        tr = traces.step_interference(2.0, 4.0, 0.25)
        assert tr(2.0) == 0.25 and tr(4.0) == 1.0 and tr(1.999) == 1.0

    @given(seed=seeds)
    @settings(max_examples=50, deadline=None)
    def test_spike_active_at_its_own_start_instant(self, seed):
        """A spike is active on [start, start + spike_len), its start
        instant included."""
        rng = np.random.default_rng(seed)
        n = rng.poisson(2.0 * 300.0 / 100.0)
        starts = np.sort(rng.uniform(0.0, 300.0, size=n))
        tr = traces.random_spikes(seed, horizon=300.0, spike_len=10.0,
                                  level=0.3)
        for s in starts:
            assert tr(float(s)) == 0.3, f"spike at {s} not active at onset"
            assert tr(float(s) + 10.0 - 1e-6) == 0.3
        if n:
            assert tr(float(starts[0]) - 1e-6) == 1.0


# ------------------------------------------------------ parity with repro

GRID = [0.0, 5e-324, 1e-9, 0.5, 1.999, 2.0, 3.0, 4.0, 9.99, 10.0, 29.9,
        30.0, 49.999, 50.0, 75.0, 100.0, 125.0, 150.0, 299.5, 1e4]


def _both(name, *args, **kw):
    return getattr(ref_traces, name)(*args, **kw), \
        getattr(traces, name)(*args, **kw)


@pytest.mark.parametrize("seed", [0, 1, 7, 123, 2**31 - 1])
def test_every_trace_equals_reference_on_a_grid(seed):
    rng = np.random.default_rng(seed)
    a, b = sorted(rng.uniform(0.0, 100.0, size=2))
    level = float(rng.uniform(1e-3, 1.0))
    cases = [
        _both("constant", level),
        _both("step_interference", a, b, level),
        _both("periodic_interference", 30.0, 0.4, level, phase=a),
        _both("ramp", a, b - a, level),
        _both("random_spikes", seed, horizon=300.0, rate_per_100s=10.0,
              spike_len=b / 10, level=level),
        _both("preemption", a, b, level=level),
        _both("preemption", a),
    ]
    ref_tr = ref_traces.compose(*(r for r, _ in cases))
    port_tr = traces.compose(*(p for _, p in cases))
    cases.append((ref_tr, port_tr))
    grid = GRID + [float(t) for t in rng.uniform(0.0, 300.0, size=40)]
    for ref, port in cases:
        assert [port(t) for t in grid] == [ref(t) for t in grid]
