"""Dynamic resource-availability traces (interference, overcommit, preemption).

A trace maps sim-time (seconds) -> availability multiplier in (0, 1].
Composable with `compose`; all traces are deterministic functions of time so
BSP/ASP replays are reproducible.

Boundary convention (property-tested in tests/test_traces.py): every
windowed trace is active on the half-open interval [start, end) — the
instant an event begins it is already in effect, the instant it ends it is
fully over.  `ramp` reaches its floor exactly at ``start + duration``.
`compose` clamps the product into [1e-6, 1.0], so stacked preemptions
(level=1e-3 squared is already at the floor) can never drive availability
to zero or a misbehaving component push it above full.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def constant(level: float = 1.0):
    return lambda t: level


def step_interference(start: float, end: float, level: float):
    """Colocated job between [start, end): availability drops to `level`."""

    def trace(t):
        return level if start <= t < end else 1.0

    return trace


def periodic_interference(period: float, duty: float, level: float,
                          phase: float = 0.0):
    """Square wave: `duty` fraction of each period at `level` availability."""

    def trace(t):
        frac = ((t + phase) % period) / period
        return level if frac < duty else 1.0

    return trace


def ramp(start: float, duration: float, lo: float):
    """Gradual slowdown (e.g. thermal throttling / growing neighbor load)."""

    def trace(t):
        if t < start:
            return 1.0
        f = min((t - start) / max(duration, 1e-9), 1.0)
        return 1.0 + f * (lo - 1.0)

    return trace


def random_spikes(seed: int, horizon: float, rate_per_100s: float = 2.0,
                  spike_len: float = 10.0, level: float = 0.3):
    """Poisson-arrival interference spikes, pre-sampled for determinism."""
    rng = np.random.default_rng(seed)
    n = rng.poisson(rate_per_100s * horizon / 100.0)
    starts = np.sort(rng.uniform(0.0, horizon, size=n))

    def trace(t):
        # side='right' so a spike is active on [start, start+spike_len):
        # at t == start the spike has begun (searchsorted 'left' would put
        # the boundary instant BEFORE its own spike)
        i = int(np.searchsorted(starts, t, side="right")) - 1
        if i >= 0 and t - starts[i] < spike_len:
            return level
        return 1.0

    return trace


def preemption(at: float, restore: float | None = None, level: float = 1e-3):
    """Transient-VM preemption at `at` (availability ~0), optionally restored."""

    def trace(t):
        if t >= at and (restore is None or t < restore):
            return level
        return 1.0

    return trace


def compose(*traces):
    """Product of traces, clamped into [1e-6, 1.0].

    The lower clamp keeps stacked near-total outages (e.g. two overlapping
    ``preemption(level=1e-3)`` windows) from collapsing availability to a
    divide-by-zero zero; the upper clamp keeps the composition inside the
    (0, 1] availability contract even if a component exceeds 1.
    """

    def trace(t):
        out = 1.0
        for tr in traces:
            out *= tr(t)
        return min(max(out, 1e-6), 1.0)

    return trace
