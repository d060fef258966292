"""Seeded traffic replay for the serving subsystem (DESIGN.md §17).

The steady :class:`~repro_torch.serve.colocate.ServeTraffic` emits a *fixed*
number of requests per round — good for pinning the interference charge,
useless for exercising the SLO policy's grow/shrink dynamics, which only
move when load *varies*.  This module adds the production-shaped load models:

  * :class:`PoissonTraffic` — open-loop Poisson arrivals at a mutable
    ``rate`` (requests per training round), seeded so the same seed replays
    a bit-identical arrival trace (golden-tested in tests/test_traffic.py);
  * :class:`DiurnalTraffic` — a raised-cosine day/night envelope over the
    Poisson process: rate swings between ``rate`` (trough) and
    ``peak_rate`` with period ``period`` rounds, the preset that forces the
    SLO policy through at least one grow *and* one shrink per period;
  * :class:`TrafficTrace` — the frozen per-round (rate, arrivals) record
    every generator accumulates, exportable as CSV (CI archives it next to
    ``BENCH_9.json``);
  * :class:`QueueSim` — a deterministic host-side model of a slotted
    decode fleet (c servers, fixed tokens per request), producing the
    latency-percentile summary the golden tests pin and a
    ``ContinuousBatcher.stats()``-compatible snapshot the
    :class:`~repro_torch.serve.colocate.SLOPolicy` can consume without devices.

Every generator exposes the same ``next_round() -> list[Request]`` /
mutable ``rate`` / ``submitted`` surface as :class:`ServeTraffic`, so the
co-located trainer (and the drain-the-queue idiom in tests — set
``traffic.rate = 0.0``) works with any of them.
"""

from __future__ import annotations

import dataclasses
import io
import math
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.serve.scheduler import Request

TRAFFIC_KINDS = ("steady", "poisson", "diurnal")


@dataclasses.dataclass(frozen=True)
class TrafficTrace:
    """Frozen per-round arrival record: same seed ⇒ bit-identical trace."""

    kind: str
    seed: int
    rates: tuple[float, ...]       # offered rate at each round
    arrivals: tuple[int, ...]      # requests that actually arrived

    @property
    def rounds(self) -> int:
        return len(self.arrivals)

    @property
    def total(self) -> int:
        return int(sum(self.arrivals))

    def to_csv(self) -> str:
        buf = io.StringIO()
        buf.write("round,rate,arrivals\n")
        for i, (r, a) in enumerate(zip(self.rates, self.arrivals)):
            buf.write(f"{i},{r:.6g},{a}\n")
        return buf.getvalue()


class PoissonTraffic:
    """Open-loop Poisson arrivals, seeded and replayable.

    ``rate`` is requests per training round and is MUTABLE — tests and
    benchmarks drain the queue by setting it to 0.0 mid-run, the same idiom
    :class:`~repro_torch.serve.colocate.ServeTraffic` supports.  Prompt lengths
    are uniform over ``[1, prompt_len]`` (ragged prompts are what make the
    prefill bucket ladder earn its keep, DESIGN.md §17).
    """

    kind = "poisson"

    def __init__(self, *, rate: float, prompt_len: int, max_new_tokens: int,
                 vocab_size: int, seed: int = 0, ragged_prompts: bool = True):
        if rate < 0:
            raise ValueError(f"arrival rate must be >= 0, got {rate}")
        if prompt_len < 1 or max_new_tokens < 1:
            raise ValueError("prompt_len and max_new_tokens must be >= 1")
        self.rate = float(rate)
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.vocab_size = vocab_size
        self.seed = seed
        self.ragged_prompts = ragged_prompts
        self._rng = np.random.default_rng(seed)
        self.submitted = 0
        self.round = 0
        self._rates: list[float] = []
        self._arrivals: list[int] = []

    def _rate_now(self) -> float:
        return self.rate

    def _make_request(self) -> Request:
        n = (int(self._rng.integers(1, self.prompt_len + 1))
             if self.ragged_prompts else self.prompt_len)
        prompt = self._rng.integers(
            0, self.vocab_size, size=n).astype(np.int32)
        req = Request(uid=self.submitted, prompt=prompt,
                      max_new_tokens=self.max_new_tokens)
        self.submitted += 1
        return req

    def next_round(self) -> list[Request]:
        rate = self._rate_now()
        n = int(self._rng.poisson(rate)) if rate > 0 else 0
        self._rates.append(rate)
        self._arrivals.append(n)
        self.round += 1
        return [self._make_request() for _ in range(n)]

    def trace(self) -> TrafficTrace:
        return TrafficTrace(kind=self.kind, seed=self.seed,
                            rates=tuple(self._rates),
                            arrivals=tuple(self._arrivals))


class DiurnalTraffic(PoissonTraffic):
    """Poisson arrivals under a raised-cosine day/night envelope.

    The offered rate at round r is

        rate + (peak_rate - rate) * (1 - cos(2π r / period)) / 2

    i.e. troughs at ``rate`` (round 0), peaks at ``peak_rate`` (round
    period/2).  A peak sized beyond the decode fleet's capacity forces the
    SLO policy to grow (training yields devices); the following trough
    drains the queue and forces the shrink — one full period oscillates
    training's device count through the membership replan path, which is
    exactly what ``benchmarks/serve_bench.py --mode diurnal`` measures.

    Setting ``.rate`` scales the whole envelope's trough; setting
    ``peak_rate = rate`` flattens it back to plain Poisson (the drain
    idiom: ``t.rate = t.peak_rate = 0.0``).
    """

    kind = "diurnal"

    def __init__(self, *, rate: float, peak_rate: float, period: int,
                 prompt_len: int, max_new_tokens: int, vocab_size: int,
                 seed: int = 0, ragged_prompts: bool = True):
        if peak_rate < rate:
            raise ValueError(
                f"peak_rate {peak_rate} must be >= trough rate {rate}")
        if period < 2:
            raise ValueError(f"period must be >= 2 rounds, got {period}")
        super().__init__(rate=rate, prompt_len=prompt_len,
                         max_new_tokens=max_new_tokens,
                         vocab_size=vocab_size, seed=seed,
                         ragged_prompts=ragged_prompts)
        self.peak_rate = float(peak_rate)
        self.period = int(period)

    def _rate_now(self) -> float:
        phase = (1.0 - math.cos(2.0 * math.pi * self.round / self.period)) / 2
        return self.rate + (self.peak_rate - self.rate) * phase


def make_traffic(kind: str, *, rate: float, prompt_len: int,
                 max_new_tokens: int, vocab_size: int, seed: int = 0,
                 peak_rate: Optional[float] = None, period: int = 32):
    """Factory keyed by ``ServeSpec.traffic`` (DESIGN.md §17)."""
    if kind == "steady":
        from repro_torch.serve.colocate import ServeTraffic

        return ServeTraffic(rate=rate, prompt_len=prompt_len,
                            max_new_tokens=max_new_tokens,
                            vocab_size=vocab_size, seed=seed)
    if kind == "poisson":
        return PoissonTraffic(rate=rate, prompt_len=prompt_len,
                              max_new_tokens=max_new_tokens,
                              vocab_size=vocab_size, seed=seed)
    if kind == "diurnal":
        return DiurnalTraffic(
            rate=rate, peak_rate=peak_rate if peak_rate is not None
            else max(4.0 * rate, rate + 1.0), period=period,
            prompt_len=prompt_len, max_new_tokens=max_new_tokens,
            vocab_size=vocab_size, seed=seed)
    raise ValueError(
        f"traffic kind must be one of {TRAFFIC_KINDS}, got {kind!r}")


# --------------------------------------------------------------- queue model


class QueueSim:
    """Deterministic host model of a slotted decode fleet (no devices).

    ``slots`` requests decode concurrently; each finishes after
    ``tokens_per_request`` rounds of service (one token per round per slot
    — the manager's synchronized decode step).  Admission is FIFO.  The
    model is integer-exact, so a replayed seeded traffic stream produces a
    bit-identical latency summary — the golden the traffic tests pin — and
    :meth:`stats` mirrors ``ContinuousBatcher.stats()`` closely enough for
    :class:`~repro_torch.serve.colocate.SLOPolicy` to run against it, which is
    how the diurnal grow/shrink dynamic is unit-tested without a mesh.
    """

    def __init__(self, *, slots: int, tokens_per_request: int):
        if slots < 1 or tokens_per_request < 1:
            raise ValueError("slots and tokens_per_request must be >= 1")
        self.slots = slots
        self.tokens_per_request = tokens_per_request
        self.round = 0
        self.queue: deque[int] = deque()     # arrival round per queued req
        self.active: list[int] = []          # remaining tokens per active req
        self.waits: list[int] = []           # admission delay per admitted req
        self.finished = 0
        self.recent_delays: deque[int] = deque(maxlen=64)

    def step(self, arrivals: int) -> None:
        for _ in range(arrivals):
            self.queue.append(self.round)
        while self.queue and len(self.active) < self.slots:
            arrived = self.queue.popleft()
            wait = self.round - arrived
            self.waits.append(wait)
            self.recent_delays.append(wait)
            self.active.append(self.tokens_per_request)
        self.active = [t - 1 for t in self.active]
        self.finished += sum(t <= 0 for t in self.active)
        self.active = [t for t in self.active if t > 0]
        self.round += 1

    def stats(self) -> dict:
        lat = list(self.recent_delays)
        return {
            "finished": self.finished,
            "queued": len(self.queue),
            "free_slots": self.slots - len(self.active),
            "mean_queue_delay_steps": float(np.mean(lat)) if lat else 0.0,
            "p95_queue_delay_steps": (float(np.percentile(lat, 95))
                                      if lat else 0.0),
            "occupancy_now": len(self.active) / self.slots,
        }

    def summary(self) -> dict:
        """Whole-run latency percentiles (integer-exact, golden-stable)."""
        w = self.waits
        return {
            "admitted": len(w),
            "finished": self.finished,
            "wait_mean": float(np.mean(w)) if w else 0.0,
            "wait_p50": float(np.percentile(w, 50)) if w else 0.0,
            "wait_p95": float(np.percentile(w, 95)) if w else 0.0,
            "wait_p99": float(np.percentile(w, 99)) if w else 0.0,
            "wait_max": float(max(w)) if w else 0.0,
        }


def replay_latency_summary(traffic, rounds: int, *, slots: int,
                           tokens_per_request: int) -> dict:
    """Replay ``rounds`` of a traffic generator through a :class:`QueueSim`
    and return its latency summary — one call = one golden."""
    sim = QueueSim(slots=slots, tokens_per_request=tokens_per_request)
    for _ in range(rounds):
        sim.step(len(traffic.next_round()))
    return sim.summary()
