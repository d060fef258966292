"""Co-located serving support: traffic + the SLO preemption policy
(DESIGN.md §13).

Host-side pieces the co-located trainer (`repro_torch.train.colocate`)
composes with the continuous batcher:

  * :class:`ServeTraffic` — a deterministic, seeded open-loop request
    generator (fractional requests-per-round accumulator, fixed prompt
    shape), so co-location benchmarks and CI smokes replay identical
    arrival streams;
  * :class:`SLOPolicy` — the serve-latency-first preemption law: when
    queue pressure breaches the SLO, training *yields* devices (the serve
    slice grows by one device through ``MeshTrainer.set_reserve``'s replan
    path); when the queue drains and stays idle, the freed capacity is
    returned the same way.  The policy is pure — it maps a
    :meth:`~repro_torch.serve.scheduler.ContinuousBatcher.stats` snapshot to a
    ``"grow" | "shrink" | "hold"`` decision — so it is unit-testable
    without a mesh (``tests/test_colocate.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.serve.scheduler import Request


@dataclasses.dataclass
class ServeSpec:
    """Declarative co-located serving workload (DESIGN.md §13).

    Attached to an experiment via ``ClusterSpec(serve=ServeSpec(...))``;
    only the mesh backend can honor it (the sim backend has no devices to
    share, and rejects it with a clear error).

    ``mode``:

      * ``"shared"`` (default) — the decode loop time-multiplexes the last
        training worker's devices; its measured seconds are charged to
        that worker's step time so the batch controller re-equalizes
        around the interference;
      * ``"dedicated"`` — ``devices`` data-axis devices are withheld from
        training for the decode loop, and the SLO policy
        (:class:`SLOPolicy`) grows/shrinks that slice with queue pressure.

    The decode model is the *reduced* config named by ``arch`` with
    freshly initialized (seeded) parameters — co-location is about device
    time, not output quality.  Traffic is the deterministic
    :class:`ServeTraffic` stream (``requests_per_round``, fractional rates
    allowed), and at most ``decode_steps_per_round`` scheduler steps run
    per training round.

    The production shape (DESIGN.md §17):

      * ``engine`` — ``"batcher"`` keeps the single-device
        :class:`~repro_torch.serve.scheduler.ContinuousBatcher`;
        ``"disaggregated"`` runs the sharded
        :class:`~repro_torch.serve.slots.KVSlotManager` (one
        :class:`~repro_torch.serve.slots.LMShard` per serve-region device, with
        ``slots`` decode lanes EACH, behind a dedicated prefill program);
      * ``traffic`` — ``"steady"`` (the fixed-rate accumulator),
        ``"poisson"``, or ``"diurnal"`` (`repro_torch.serve.traffic`); the
        diurnal envelope peaks at ``peak_rate`` every ``period`` rounds,
        the preset that forces
        the SLO policy to oscillate training's device count.
    """

    mode: str = "shared"             # "shared" | "dedicated"
    devices: int = 1                 # dedicated-slice width (data-axis devs)
    slots: int = 2                   # concurrent decode sequences
    #                                  (per shard when disaggregated)
    cache_len: int = 64              # KV-cache length per slot
    arch: str = "gemma-2b"           # decode model family (reduced config)
    requests_per_round: float = 1.0  # open-loop arrival rate (trough rate
    #                                  for the diurnal envelope)
    prompt_len: int = 4
    max_new_tokens: int = 8
    decode_steps_per_round: int = 4  # scheduler steps per training round
    #                                  (per reserved device when dedicated:
    #                                  a wider slice buys more throughput)
    slo_queue_delay: float = 2.0     # SLOPolicy: admission-delay ceiling
    check_every: int = 5             # trainer rounds between policy checks
    idle_patience: int = 3           # idle checks before capacity returns
    seed: int = 0
    engine: str = "batcher"          # "batcher" | "disaggregated" (§17)
    traffic: str = "steady"          # "steady" | "poisson" | "diurnal"
    peak_rate: Optional[float] = None  # diurnal peak (default 4× trough)
    period: int = 32                 # diurnal period in trainer rounds

    def __post_init__(self) -> None:
        if self.mode not in ("shared", "dedicated"):
            raise ValueError(
                f"serve mode must be 'shared' or 'dedicated', "
                f"got {self.mode!r}")
        if self.engine not in ("batcher", "disaggregated"):
            raise ValueError(
                f"serve engine must be 'batcher' or 'disaggregated', "
                f"got {self.engine!r}")
        from repro_torch.serve.traffic import TRAFFIC_KINDS
        if self.traffic not in TRAFFIC_KINDS:
            raise ValueError(
                f"traffic must be one of {TRAFFIC_KINDS}, "
                f"got {self.traffic!r}")
        if self.peak_rate is not None \
                and self.peak_rate < self.requests_per_round:
            raise ValueError(
                f"peak_rate {self.peak_rate} must be >= the trough rate "
                f"{self.requests_per_round}")
        if self.period < 2:
            raise ValueError(f"period must be >= 2 rounds, got {self.period}")
        if self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.requests_per_round < 0:
            raise ValueError("requests_per_round must be >= 0")
        if self.prompt_len < 1 or self.max_new_tokens < 1:
            raise ValueError("prompt_len and max_new_tokens must be >= 1")
        if self.cache_len < self.prompt_len + 2:
            raise ValueError(
                f"cache_len {self.cache_len} cannot hold a "
                f"{self.prompt_len}-token prompt plus decoded tokens")
        if self.decode_steps_per_round < 1:
            raise ValueError("decode_steps_per_round must be >= 1")
        if self.check_every < 1 or self.idle_patience < 1:
            raise ValueError("check_every and idle_patience must be >= 1")


class ServeTraffic:
    """Deterministic open-loop arrivals: ``rate`` requests per training
    round (fractional rates accumulate), uniform random prompts."""

    def __init__(self, *, rate: float, prompt_len: int, max_new_tokens: int,
                 vocab_size: int, seed: int = 0):
        if rate < 0:
            raise ValueError(f"arrival rate must be >= 0, got {rate}")
        if prompt_len < 1 or max_new_tokens < 1:
            raise ValueError("prompt_len and max_new_tokens must be >= 1")
        self.rate = float(rate)
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.vocab_size = vocab_size
        self._rng = np.random.default_rng(seed)
        self._acc = 0.0
        self.submitted = 0

    def next_round(self) -> list[Request]:
        """Requests arriving during one training round."""
        self._acc += self.rate
        out = []
        while self._acc >= 1.0:
            self._acc -= 1.0
            prompt = self._rng.integers(
                0, self.vocab_size, size=self.prompt_len).astype(np.int32)
            out.append(Request(uid=self.submitted, prompt=prompt,
                               max_new_tokens=self.max_new_tokens))
            self.submitted += 1
        return out


@dataclasses.dataclass
class SLOPolicy:
    """Serve-latency SLO first; training yields (and reclaims) devices.

    ``decide`` reads one ``ContinuousBatcher.stats()`` snapshot:

      * **grow**   — requests are waiting (``queued > 0`` with zero free
        slots, or the mean queue delay exceeds ``slo_queue_delay``): the
        decode loop is falling behind its SLO, so the serve slice should
        take one more device from training;
      * **shrink** — the batcher has been completely idle (empty queue,
        all slots free) for ``idle_patience`` consecutive decisions:
        return one device to training;
      * **hold**   — anything in between.

    The caller applies decisions through the trainer's replan path
    (``set_reserve``); this object only accumulates the idle streak.
    """

    slo_queue_delay: float = 2.0     # mean admission delay ceiling (steps)
    idle_patience: int = 3           # idle decisions before giving back
    _idle_streak: int = dataclasses.field(default=0, init=False)

    def decide(self, stats: dict) -> str:
        backlogged = stats["queued"] > 0 and stats["free_slots"] == 0
        breached = (stats["queued"] > 0
                    and stats["mean_queue_delay_steps"]
                    > self.slo_queue_delay)
        idle = stats["queued"] == 0 and stats["free_slots"] >= 1 \
            and stats["occupancy_now"] == 0.0
        if backlogged or breached:
            self._idle_streak = 0
            return "grow"
        if idle:
            self._idle_streak += 1
            if self._idle_streak >= self.idle_patience:
                self._idle_streak = 0
                return "shrink"
            return "hold"
        self._idle_streak = 0
        return "hold"
