"""Outer global-batch controller: B_global(t) over the heterogeneity split.

Two-level batch control (DESIGN.md §15).  The paper's inner P/PI/PID law
splits a FIXED global batch across heterogeneous workers to equalize
iteration times; statistical efficiency says the global batch itself should
GROW as gradient noise shrinks (AdaDamp/GeoDamp family).  This module is the
outer loop: it owns B_global and hands resize decisions to the trainer,
which applies them through `BatchController.set_global_batch` so the inner
law keeps its per-worker shares, EWMA windows, and adaptive bounds.

B_global only ever takes values on a GLOBAL bucket ladder built once at
construction from the initial global batch (`core/batching.bucket_ladder`
with quantum = worker count).  Because per-worker shares are roughly
B_global/K and each worker pads to its own per-worker ladder (DESIGN.md
§11), a B_global walk of R rungs costs at most R recompiles per worker —
the slew-rate limit (`max_rungs_per_resize`) plus the warmup/cooldown gates
bound how fast that walk can happen.

Kinds (`GlobalBatchConfig.kind`):
  * ``fixed``     — never resizes; the trainer does not even instantiate an
                    outer controller for this kind, so today's behaviour is
                    reproduced bit-for-bit (golden-tested).
  * ``geometric`` — GeoDamp: B = b0 * geo_factor^(step // geo_every),
                    snapped up to the ladder.
  * ``gns``       — tracks the critical batch from the in-graph
                    gradient-noise-scale estimator (`gns.py`) with a
                    hysteresis band and the slew-rate limit.
  * ``bandit``    — epsilon-greedy over ladder rungs on loss-per-second
                    reward (the DYNAMIX-shaped learned-schedule plug point).
  * ``dynamix``   — learned contextual policy (`policy.py`, DESIGN.md §18):
                    a small Q-head over a normalized system+statistical
                    state vector picks {down, hold, up} on the same ladder.

Every kind of the reference is here, copied bit for bit.  Pure host-side
python; the ``dynamix`` kind lives in `policy.py` (its Q-head is a few fp32
torch tensors on the CPU) and is resolved lazily, as the reference resolves
it.  All state is JSON-serializable for the checkpoint payload, in the
reference's layout, so an outer payload loads in either package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.batching import bucket_ladder, bucket_up
from repro_torch.core.control.global_batch.gns import GNSEstimator, GradStats

GLOBAL_BATCH_KINDS = ("fixed", "geometric", "gns", "bandit", "dynamix")


@dataclasses.dataclass
class GlobalBatchConfig:
    """Knobs for the outer global-batch controller.

    The default ``kind="fixed"`` is the no-op outer loop: trainers skip
    constructing a controller entirely, so the fixed path is literally the
    pre-existing code.  ``max_factor`` caps growth at ``max_factor * b0``;
    the ladder never extends below b0 (growing-batch methods shrink at most
    back to where they started, never below the inner law's design point).
    """

    kind: str = "fixed"
    max_factor: float = 8.0          # ladder cap: B <= max_factor * b0
    ladder_growth: float = 1.25      # rung ratio (matches mesh bucket ladder)
    warmup: int = 8                  # steps before the first resize
    cooldown: int = 4                # min steps between resizes
    max_rungs_per_resize: int = 1    # slew-rate limit on the ladder walk
    # -- geometric (GeoDamp) --
    geo_factor: float = 2.0          # B multiplies by this ...
    geo_every: int = 25              # ... every geo_every outer steps
    # -- gns --
    gns_alpha: float = 0.1           # EWMA on the moment estimates
    gns_min_samples: int = 4         # estimator warmup (accepted steps)
    hysteresis: float = 0.25         # grow if b_noise > (1+h)B, shrink < (1-h)B
    allow_shrink: bool = True        # permit walking back down toward b0
    # -- bandit + dynamix --
    epsilon: float = 0.15            # exploration rate
    bandit_window: int = 6           # steps per episode / decision window
    seed: int = 0                    # exploration + weight-init RNG seed
    # -- dynamix (policy.py, DESIGN.md §18) --
    policy_hidden: int = 16          # Q-head width (0 = linear head)
    policy_lr: float = 0.1           # TD step size
    policy_momentum: float = 0.9     # SGD momentum on the Q-head
    policy_gamma: float = 0.7        # discount across decision windows
    policy_shaping: float = 1.0      # potential-based shaping toward b_noise
    replay_capacity: int = 256       # transition ring-buffer size
    replay_batch: int = 16           # transitions per jitted TD update
    epsilon_min: float = 0.02        # exploration floor
    epsilon_decay: float = 0.92      # per-decision epsilon decay
    # reward/feature clock: 'measured' divides episode reward by wall or
    # simulated seconds and feeds time-derived features; 'steps' divides by
    # the step count and zeroes the time features, making bandit/dynamix
    # decisions a pure function of the (backend-independent) discrete
    # trajectory — what the cross-backend conformance battery pins on
    time_signal: str = "measured"

    def __post_init__(self) -> None:
        if self.kind not in GLOBAL_BATCH_KINDS:
            raise ValueError(
                f"unknown global-batch kind {self.kind!r}; "
                f"expected one of {GLOBAL_BATCH_KINDS}")
        if self.max_factor < 1.0:
            raise ValueError("max_factor must be >= 1")
        if self.ladder_growth <= 1.0:
            raise ValueError("ladder_growth must be > 1")
        if self.warmup < 0 or self.cooldown < 0:
            raise ValueError("warmup/cooldown must be >= 0")
        if self.max_rungs_per_resize < 1:
            raise ValueError("max_rungs_per_resize must be >= 1")
        if self.geo_factor <= 1.0:
            raise ValueError("geo_factor must be > 1")
        if self.geo_every < 1:
            raise ValueError("geo_every must be >= 1")
        if not (0.0 < self.gns_alpha <= 1.0):
            raise ValueError("gns_alpha must be in (0,1]")
        if self.gns_min_samples < 1:
            raise ValueError("gns_min_samples must be >= 1")
        if self.hysteresis < 0:
            raise ValueError("hysteresis must be >= 0")
        if not (0.0 <= self.epsilon <= 1.0):
            raise ValueError("epsilon must be in [0,1]")
        if self.bandit_window < 1:
            raise ValueError("bandit_window must be >= 1")
        if self.policy_hidden < 0:
            raise ValueError("policy_hidden must be >= 0")
        if self.policy_lr <= 0:
            raise ValueError("policy_lr must be > 0")
        if not (0.0 <= self.policy_momentum < 1.0):
            raise ValueError("policy_momentum must be in [0,1)")
        if not (0.0 <= self.policy_gamma < 1.0):
            raise ValueError("policy_gamma must be in [0,1)")
        if self.policy_shaping < 0:
            raise ValueError("policy_shaping must be >= 0")
        if self.replay_batch < 1:
            raise ValueError("replay_batch must be >= 1")
        if self.replay_capacity < self.replay_batch:
            raise ValueError("replay_capacity must be >= replay_batch")
        if not (0.0 <= self.epsilon_min <= 1.0):
            raise ValueError("epsilon_min must be in [0,1]")
        if not (0.0 < self.epsilon_decay <= 1.0):
            raise ValueError("epsilon_decay must be in (0,1]")
        if self.time_signal not in ("measured", "steps"):
            raise ValueError(
                f"time_signal must be 'measured' or 'steps', "
                f"got {self.time_signal!r}")

    @property
    def needs_grad_stats(self) -> bool:
        """Does this kind need the in-graph |g|^2 side stats?"""
        return self.kind in ("gns", "dynamix")


class GlobalBatchController:
    """Shared outer-loop machinery: ladder, warmup/cooldown, slew limit.

    Subclasses implement `_target_rung` (and optionally `_ingest`).  The
    rung set is FROZEN at construction — membership events change how the
    inner law splits B_global, never the outer ladder — which keeps two
    invariants trivially true: resizes only ever land on ladder rungs, and
    elastic add/remove preserves the outer estimator state untouched.
    """

    kind = "base"

    def __init__(self, config: GlobalBatchConfig, b0: int,
                 quantum: int = 1) -> None:
        if b0 < 1:
            raise ValueError("initial global batch must be >= 1")
        if quantum < 1:
            raise ValueError("quantum must be >= 1")
        self.config = config
        self.b0 = int(b0)
        self.quantum = int(quantum)
        b_cap = int(math.ceil(config.max_factor * b0))
        # rungs: b0 (snapped up to the quantum) up to the cap
        lo = bucket_up(1, base=b0, growth=config.ladder_growth, quantum=quantum)
        full = bucket_ladder(max(b_cap, lo), base=b0,
                             growth=config.ladder_growth, quantum=quantum)
        self.rungs = [r for r in full if r <= max(b_cap, lo)] or [lo]
        self.rung = 0
        self.step_count = 0
        self.last_resize_step: Optional[int] = None
        self.num_resizes = 0
        self.resize_log: list[list[int]] = []  # [outer_step, new B_global]
        # transient system context (worker times / prices / queue) for
        # context-aware kinds; refreshed every observe(), never checkpointed
        self._last_context: dict = {}

    # ------------------------------------------------------------------ api

    @property
    def b_global(self) -> int:
        return self.rungs[self.rung]

    def observe(self, *, loss: float, seconds: float,
                stats: Optional[GradStats] = None,
                context: Optional[dict] = None) -> Optional[int]:
        """Feed one outer step; return the new B_global iff a resize fires.

        ``loss`` is the step's (smoothed or raw) training loss, ``seconds``
        the wall/simulated time the step cost, ``stats`` the in-graph
        gradient moments (the gns and dynamix kinds consume them), and
        ``context`` an optional dict of system signals — ``worker_times``
        (the round's per-worker seconds), ``prices`` (per-worker spot
        prices) and ``queue`` (serve queue depth) — that the dynamix policy
        folds into its state vector.  Warmup, cooldown, and the slew-rate
        limit gate every kind identically.
        """
        self.step_count += 1
        self._last_context = dict(context) if context else {}
        self._ingest(float(loss), float(seconds), stats)
        cfg = self.config
        if self.step_count < cfg.warmup:
            return None
        if (self.last_resize_step is not None
                and self.step_count - self.last_resize_step < cfg.cooldown):
            return None
        target = self._target_rung()
        if target is None:
            return None
        target = max(0, min(int(target), len(self.rungs) - 1))
        delta = target - self.rung
        if delta == 0:
            return None
        m = cfg.max_rungs_per_resize
        delta = max(-m, min(m, delta))  # slew-rate limit
        self.rung += delta
        self.last_resize_step = self.step_count
        self.num_resizes += 1
        self.resize_log.append([self.step_count, self.b_global])
        return self.b_global

    def _rung_covering(self, b: float) -> int:
        """Index of the smallest rung >= b (clamped to the ladder)."""
        for i, r in enumerate(self.rungs):
            if r >= b:
                return i
        return len(self.rungs) - 1

    # ------------------------------------------------------------ overrides

    def _ingest(self, loss: float, seconds: float,
                stats: Optional[GradStats]) -> None:
        """Hook: fold one step's signals into kind-specific state."""

    def _target_rung(self) -> Optional[int]:
        """Control law: desired rung index (None = hold)."""
        raise NotImplementedError

    # --------------------------------------------------------------- serde

    def _extra_state(self) -> dict:
        return {}

    def _load_extra_state(self, state: dict) -> None:
        pass

    def state_dict(self) -> dict:
        return {
            "kind": self.kind,
            "config": dataclasses.asdict(self.config),
            "b0": self.b0,
            "quantum": self.quantum,
            "rung": self.rung,
            "rungs": list(self.rungs),
            "step_count": self.step_count,
            "last_resize_step": self.last_resize_step,
            "num_resizes": self.num_resizes,
            "resize_log": [list(x) for x in self.resize_log],
            "extra": self._extra_state(),
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "GlobalBatchController":
        ctrl = cls(GlobalBatchConfig(**state["config"]),
                   b0=state["b0"], quantum=state["quantum"])
        if list(state["rungs"]) != list(ctrl.rungs):
            raise ValueError(
                "checkpointed ladder does not match the rebuilt ladder: "
                f"{state['rungs']} vs {ctrl.rungs}")
        ctrl.rung = int(state["rung"])
        ctrl.step_count = int(state["step_count"])
        ctrl.last_resize_step = state["last_resize_step"]
        ctrl.num_resizes = int(state["num_resizes"])
        ctrl.resize_log = [list(x) for x in state["resize_log"]]
        ctrl._load_extra_state(state.get("extra", {}))
        return ctrl


class FixedGlobalBatch(GlobalBatchController):
    """Explicit no-op outer loop (trainers normally skip construction)."""

    kind = "fixed"

    def _target_rung(self) -> Optional[int]:
        return None


class GeometricGlobalBatch(GlobalBatchController):
    """GeoDamp schedule: B multiplies by geo_factor every geo_every steps."""

    kind = "geometric"

    def _target_rung(self) -> Optional[int]:
        cfg = self.config
        ideal = self.b0 * cfg.geo_factor ** (self.step_count // cfg.geo_every)
        return self._rung_covering(min(ideal, self.rungs[-1]))


class GNSGlobalBatch(GlobalBatchController):
    """Track the critical batch with hysteresis around the current rung.

    Grow toward the rung covering b_noise only when the estimate exceeds
    (1 + hysteresis) * B; shrink (if allowed) only when it falls below
    (1 - hysteresis) * B.  The band prevents rung-flapping when b_noise
    hovers near a rung boundary; the base-class slew limit turns a large
    jump in b_noise into a bounded ladder walk.
    """

    kind = "gns"

    def __init__(self, config: GlobalBatchConfig, b0: int,
                 quantum: int = 1) -> None:
        super().__init__(config, b0, quantum)
        self.estimator = GNSEstimator(alpha=config.gns_alpha,
                                      min_samples=config.gns_min_samples)

    def _ingest(self, loss: float, seconds: float,
                stats: Optional[GradStats]) -> None:
        if stats is not None:
            self.estimator.observe(stats)

    def _target_rung(self) -> Optional[int]:
        if not self.estimator.ready:
            return None
        bn = self.estimator.b_noise
        if bn is None:
            return None
        cfg = self.config
        b = float(self.b_global)
        if bn > (1.0 + cfg.hysteresis) * b:
            return self._rung_covering(min(bn, self.rungs[-1]))
        if cfg.allow_shrink and bn < (1.0 - cfg.hysteresis) * b:
            return self._rung_covering(max(bn, float(self.rungs[0])))
        return None

    def _extra_state(self) -> dict:
        return {"estimator": self.estimator.state_dict()}

    def _load_extra_state(self, state: dict) -> None:
        if "estimator" in state:
            self.estimator = GNSEstimator.from_state_dict(state["estimator"])


class BanditGlobalBatch(GlobalBatchController):
    """Epsilon-greedy over ladder rungs on loss-per-second reward.

    Each rung is an arm; an episode holds the current arm for
    ``bandit_window`` outer steps, then scores it by EWMA-smoothed loss
    drop per second and epsilon-greedily picks the next arm among the
    rungs within slew distance (so exploration also walks the ladder with
    bounded recompiles).  This is the DYNAMIX-shaped plug point: replace
    the value table with a learned policy and the trainer-side wiring is
    identical.
    """

    kind = "bandit"

    def __init__(self, config: GlobalBatchConfig, b0: int,
                 quantum: int = 1) -> None:
        super().__init__(config, b0, quantum)
        n = len(self.rungs)
        self.counts = [0] * n
        self.values = [0.0] * n          # running mean reward per arm
        self._rng = np.random.default_rng(config.seed)
        self._loss_ewma: Optional[float] = None
        self._ep_steps = 0
        self._ep_seconds = 0.0
        self._ep_loss0: Optional[float] = None

    def _ingest(self, loss: float, seconds: float,
                stats: Optional[GradStats]) -> None:
        self._loss_ewma = loss if self._loss_ewma is None else (
            0.2 * loss + 0.8 * self._loss_ewma)
        if self._ep_loss0 is None:
            self._ep_loss0 = self._loss_ewma
        self._ep_steps += 1
        self._ep_seconds += max(seconds, 0.0)

    def _target_rung(self) -> Optional[int]:
        cfg = self.config
        if self._ep_steps < cfg.bandit_window:
            return None
        # score the finished episode: smoothed loss drop per time unit
        # (seconds, or the step count under time_signal='steps' so the
        # reward — and hence the arm walk — is backend-independent)
        denom = (self._ep_seconds if cfg.time_signal == "measured"
                 else float(self._ep_steps))
        reward = (self._ep_loss0 - self._loss_ewma) / max(denom, 1e-9)
        arm = self.rung
        self.counts[arm] += 1
        self.values[arm] += (reward - self.values[arm]) / self.counts[arm]
        self._ep_steps = 0
        self._ep_seconds = 0.0
        self._ep_loss0 = self._loss_ewma
        # candidate arms: within slew distance of the current rung
        m = cfg.max_rungs_per_resize
        cand = list(range(max(0, arm - m), min(len(self.rungs), arm + m + 1)))
        if float(self._rng.random()) < cfg.epsilon:
            return int(self._rng.choice(cand))
        # greedy with optimistic init: prefer unvisited candidates
        unvisited = [i for i in cand if self.counts[i] == 0]
        if unvisited:
            return unvisited[0]
        return max(cand, key=lambda i: self.values[i])

    def _extra_state(self) -> dict:
        return {
            "counts": list(self.counts),
            "values": [float(v) for v in self.values],
            "rng_state": self._rng.bit_generator.state,
            "loss_ewma": self._loss_ewma,
            "ep_steps": self._ep_steps,
            "ep_seconds": self._ep_seconds,
            "ep_loss0": self._ep_loss0,
        }

    def _load_extra_state(self, state: dict) -> None:
        self.counts = [int(c) for c in state["counts"]]
        self.values = [float(v) for v in state["values"]]
        self._rng = np.random.default_rng(self.config.seed)
        self._rng.bit_generator.state = state["rng_state"]
        self._loss_ewma = state["loss_ewma"]
        self._ep_steps = int(state["ep_steps"])
        self._ep_seconds = float(state["ep_seconds"])
        self._ep_loss0 = state["ep_loss0"]


_KIND_TO_CLS = {
    "fixed": FixedGlobalBatch,
    "geometric": GeometricGlobalBatch,
    "gns": GNSGlobalBatch,
    "bandit": BanditGlobalBatch,
}


def _controller_cls(kind: str):
    """Class for ``kind`` — 'dynamix' resolves lazily because `policy.py`
    imports torch (the rest of this package is numpy and pure python)."""
    if kind == "dynamix":
        from repro_torch.core.control.global_batch.policy import (
            DynamixGlobalBatch,
        )
        return DynamixGlobalBatch
    return _KIND_TO_CLS[kind]


def make_global_controller(config: GlobalBatchConfig, b0: int,
                           quantum: int = 1) -> GlobalBatchController:
    """Factory: outer controller for ``config.kind``."""
    return _controller_cls(config.kind)(config, b0, quantum)


def global_batch_from_state_dict(state: dict) -> GlobalBatchController:
    """Rebuild the right subclass from a `state_dict()` payload."""
    kind = state["kind"]
    if kind not in GLOBAL_BATCH_KINDS:
        raise ValueError(f"unknown global-batch kind in checkpoint: {kind!r}")
    return _controller_cls(kind).from_state_dict(state)
