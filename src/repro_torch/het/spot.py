"""Spot-market price/capacity model -> deterministic churn traces (§16).

The paper's motivating environment is transient spot capacity — fleets
whose membership *changes under you* as market prices cross your bid.
This module models that market so the elastic path (DESIGN.md §16) can be
driven by realistic storms instead of hand-scripted add/remove pairs:

  * a :class:`SpotZone` is one market (an AZ/instance-type pair) holding
    ``workers`` identical instances.  Its price follows a mean-reverting
    (Ornstein–Uhlenbeck) walk plus Poisson price *spikes* with geometric
    decay — the empirical shape of EC2 spot price series;
  * capacity is derived from price vs our standing ``bid``: while the
    price stays at or below the bid the zone runs at full capacity; when
    it spikes past the bid, capacity collapses as ``(bid/price)^elasticity``
    — a price spike is a *mass preemption*, recovery is a *rejoin storm*;
  * zones also emit *slow-degrading* instances (thermal throttling /
    noisy neighbors, lowered as multiplicative slowdown ramps, DESIGN.md
    §16) and transient *stragglers* — heterogeneity the controller must
    absorb without a membership change.

Everything is pre-sampled from ``np.random.default_rng([seed, zone_index])``
into a :class:`ChurnTrace` — plain data (price paths, capacity paths, typed
events) that replays bit-identically on any backend: the same seed gives
the pointwise-identical trace, always.  Trace *steps* are controller steps,
so a trace lowered by :func:`repro_torch.api.cluster.compile_churn` fires
at the same step index on ``SimBackend`` and ``MeshBackend``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.het.simulator import WorkerSpec

# ------------------------------------------------------------------- zones


@dataclasses.dataclass(frozen=True)
class SpotZone:
    """One spot market: ``workers`` identical instances behind one price.

    ``bid`` is our standing bid: price <= bid -> full capacity; price >
    bid -> capacity collapses as ``floor(workers * (bid/price)^elasticity)``
    (elasticity tunes how cliff-like the preemption is).  ``degrade_rate``
    and ``straggle_rate`` are per-step probabilities of a slow-degrade
    onset / a transient straggler among the zone's live instances.
    """

    name: str
    workers: int
    cores: float = 8.0
    kind: str = "cpu"
    b_mem: Optional[int] = None
    base_price: float = 1.0
    bid: float = 1.5
    volatility: float = 0.12        # OU noise scale (relative to base_price)
    reversion: float = 0.25         # OU pull toward base_price per step
    spike_rate: float = 0.03        # per-step Poisson spike probability
    spike_mag: float = 1.5          # spike height (x base_price)
    spike_decay: float = 0.7        # geometric spike decay per step
    elasticity: float = 2.0         # capacity ~ (bid/price)^elasticity
    degrade_rate: float = 0.0       # per-step slow-degrade onset probability
    straggle_rate: float = 0.0      # per-step transient-straggler probability

    def __post_init__(self) -> None:
        if self.workers < 1:
            raise ValueError(f"zone {self.name!r} needs >= 1 worker")
        if self.base_price <= 0 or self.bid <= 0:
            raise ValueError(f"zone {self.name!r} prices must be positive")
        if self.bid < self.base_price:
            raise ValueError(
                f"zone {self.name!r}: bid {self.bid} below base price "
                f"{self.base_price} — the fleet would start preempted")

    def capacity_at(self, price: float) -> int:
        if price <= self.bid:
            return self.workers
        frac = (self.bid / price) ** self.elasticity
        return int(np.floor(self.workers * frac))


# ------------------------------------------------------------ churn events


@dataclasses.dataclass(frozen=True)
class Preempt:
    """The market reclaimed one instance of ``zone`` before ``step``."""

    step: int
    zone: str


@dataclasses.dataclass(frozen=True)
class Rejoin:
    """Capacity recovered: one instance of ``zone`` comes back at ``price``."""

    step: int
    zone: str
    price: float


@dataclasses.dataclass(frozen=True)
class Degrade:
    """Slot ``slot`` of ``zone`` starts degrading: its speed falls by
    ``factor`` (>1 = slower) over ``ramp_steps``, holds for ``hold_steps``,
    then recovers.  Lowered as a multiplicative slowdown *ramp staircase*
    (DESIGN.md §16) — not a membership change."""

    step: int
    zone: str
    slot: int
    factor: float
    ramp_steps: int
    hold_steps: int


@dataclasses.dataclass(frozen=True)
class Straggle:
    """Transient straggler: slot ``slot`` of ``zone`` runs ``factor`` x
    slower for ``hold_steps`` steps, then snaps back."""

    step: int
    zone: str
    slot: int
    factor: float
    hold_steps: int


ChurnEvent = Union[Preempt, Rejoin, Degrade, Straggle]


# -------------------------------------------------------------- the trace


@dataclasses.dataclass(frozen=True)
class ChurnTrace:
    """Replayable market history: per-zone price/capacity paths + events.

    Plain data, fully determined by ``(zones, seed, horizon)``.  Steps are
    controller steps; ``events`` is sorted by step (zone order within a
    step follows the zone list).  Capacity at step 0 is always full — the
    initial fleet is what the experiment starts with.
    """

    seed: int
    horizon: int
    zones: tuple[SpotZone, ...]
    prices: dict[str, tuple[float, ...]]
    capacities: dict[str, tuple[int, ...]]
    events: tuple[ChurnEvent, ...]

    def events_at(self, step: int) -> list[ChurnEvent]:
        return [ev for ev in self.events if ev.step == step]

    def summary(self) -> dict:
        kinds = [type(ev).__name__ for ev in self.events]
        workers = sum(z.workers for z in self.zones)
        preempts = kinds.count("Preempt")
        return {
            "zones": len(self.zones),
            "initial_workers": workers,
            "preempts": preempts,
            "rejoins": kinds.count("Rejoin"),
            "degrades": kinds.count("Degrade"),
            "straggles": kinds.count("Straggle"),
            "cycled_fraction": preempts / max(workers, 1),
        }

    def to_csv(self, path: str) -> None:
        """One row per event (plus per-step zone price/capacity samples),
        the artifact the CI churn job archives next to BENCH_8.json."""
        with open(path, "w") as fh:
            fh.write("step,kind,zone,slot,price,capacity,detail\n")
            for ev in self.events:
                slot = getattr(ev, "slot", "")
                price = getattr(ev, "price", "")
                detail = ""
                if isinstance(ev, Degrade):
                    detail = (f"factor={ev.factor:.3g} ramp={ev.ramp_steps} "
                              f"hold={ev.hold_steps}")
                elif isinstance(ev, Straggle):
                    detail = f"factor={ev.factor:.3g} hold={ev.hold_steps}"
                cap = self.capacities[ev.zone][min(ev.step, self.horizon - 1)]
                price_s = f"{price:.4g}" if price != "" else ""
                fh.write(f"{ev.step},{type(ev).__name__},{ev.zone},{slot},"
                         f"{price_s},{cap},{detail}\n")


# -------------------------------------------------------------- the market


class SpotMarket:
    """Simulates the zones' price processes and derives the churn trace."""

    def __init__(self, zones: Sequence[SpotZone], *, seed: int = 0,
                 horizon: int = 200):
        if not zones:
            raise ValueError("need at least one zone")
        names = [z.name for z in zones]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate zone names: {names}")
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        self.zones = tuple(zones)
        self.seed = int(seed)
        self.horizon = int(horizon)
        self._trace: Optional[ChurnTrace] = None

    # ------------------------------------------------------------- fleet

    def initial_fleet(self) -> list[WorkerSpec]:
        """Zone-major worker list matching the trace's step-0 capacities —
        what the ClusterSpec starts with.  ``compile_churn`` relies on this
        ordering to map (zone, slot) to fleet indices."""
        fleet = []
        for z in self.zones:
            fleet.extend(
                WorkerSpec(cores=z.cores, kind=z.kind, b_mem=z.b_mem,
                           price=z.base_price)
                for _ in range(z.workers))
        return fleet

    def spec_for(self, zone: SpotZone, price: float) -> WorkerSpec:
        """Spec for an instance rejoining ``zone`` at ``price`` — same
        hardware, current spot price (feeds cost-aware reallocation)."""
        return WorkerSpec(cores=zone.cores, kind=zone.kind, b_mem=zone.b_mem,
                          price=max(float(price), 1e-3))

    # ---------------------------------------------------------- simulate

    def _zone_paths(self, zi: int, z: SpotZone) -> tuple[np.ndarray,
                                                         np.ndarray]:
        """Price + capacity path for one zone — OU walk plus decaying
        Poisson spikes, pre-sampled so the trace is pure data."""
        rng = np.random.default_rng([self.seed, zi])
        n = self.horizon
        noise = rng.standard_normal(n)
        spikes = rng.random(n) < z.spike_rate
        price = np.empty(n)
        cap = np.empty(n, dtype=int)
        p, spike = z.base_price, 0.0
        for t in range(n):
            if t == 0:
                # step 0 is the fleet the experiment starts with: pin the
                # price to base so capacity begins full, by construction
                price[0], cap[0] = z.base_price, z.workers
                continue
            p = p + z.reversion * (z.base_price - p) \
                + z.volatility * z.base_price * noise[t]
            p = max(p, 0.05 * z.base_price)
            spike *= z.spike_decay
            if spikes[t]:
                spike += z.spike_mag * z.base_price
            price[t] = p + spike
            cap[t] = z.capacity_at(price[t])
        return price, cap

    def simulate(self) -> ChurnTrace:
        """Build (and cache) the trace.  Deterministic: same ``(zones,
        seed, horizon)`` -> pointwise-identical paths and events."""
        if self._trace is not None:
            return self._trace
        prices: dict[str, tuple[float, ...]] = {}
        caps: dict[str, tuple[int, ...]] = {}
        events: list[ChurnEvent] = []
        for zi, z in enumerate(self.zones):
            price, cap = self._zone_paths(zi, z)
            prices[z.name] = tuple(float(p) for p in price)
            caps[z.name] = tuple(int(c) for c in cap)
            # degradation / straggler processes ride the same zone rng
            # stream, drawn AFTER the price path so the paths above are
            # unaffected by the rates
            rng = np.random.default_rng([self.seed, zi, 1])
            degrades = rng.random(self.horizon) < z.degrade_rate
            straggles = rng.random(self.horizon) < z.straggle_rate
            for t in range(1, self.horizon):
                delta = int(cap[t]) - int(cap[t - 1])
                if delta < 0:
                    events.extend(Preempt(step=t, zone=z.name)
                                  for _ in range(-delta))
                elif delta > 0:
                    events.extend(Rejoin(step=t, zone=z.name,
                                         price=float(price[t]))
                                  for _ in range(delta))
                if cap[t] > 0 and degrades[t]:
                    events.append(Degrade(
                        step=t, zone=z.name,
                        slot=int(rng.integers(0, int(cap[t]))),
                        factor=float(2.0 + 2.0 * rng.random()),
                        ramp_steps=int(rng.integers(3, 9)),
                        hold_steps=int(rng.integers(3, 9))))
                if cap[t] > 0 and straggles[t]:
                    events.append(Straggle(
                        step=t, zone=z.name,
                        slot=int(rng.integers(0, int(cap[t]))),
                        factor=float(3.0 + 3.0 * rng.random()),
                        hold_steps=int(rng.integers(1, 4))))
        # stable sort by step: zone order (then emission order) is kept
        # within a step, which compile_churn relies on
        events.sort(key=lambda ev: ev.step)
        self._trace = ChurnTrace(
            seed=self.seed, horizon=self.horizon, zones=self.zones,
            prices=prices, capacities=caps, events=tuple(events))
        return self._trace


def storm_market(workers: int = 32, *, zones: int = 4, seed: int = 0,
                 horizon: int = 200, cores: float = 8.0,
                 volatility: float = 0.18, spike_rate: float = 0.05,
                 degrade_rate: float = 0.01, straggle_rate: float = 0.02,
                 ) -> SpotMarket:
    """Convenience fleet: ``workers`` instances spread over ``zones`` spot
    markets with storm-prone dynamics — the churn_bench default."""
    if zones < 1 or workers < zones:
        raise ValueError(f"need >= 1 worker per zone ({workers} over {zones})")
    per = [workers // zones] * zones
    per[0] += workers - sum(per)
    zs = [
        SpotZone(name=f"z{i}", workers=per[i], cores=cores,
                 base_price=1.0 + 0.1 * i, bid=1.5 * (1.0 + 0.1 * i),
                 volatility=volatility, spike_rate=spike_rate,
                 spike_mag=1.2 + 0.2 * i, degrade_rate=degrade_rate,
                 straggle_rate=straggle_rate)
        for i in range(zones)
    ]
    return SpotMarket(zs, seed=seed, horizon=horizon)
