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
with quantum = worker count).

The port holds ``GlobalBatchConfig`` (every kind's knobs, so a config moves
between the packages unchanged), the shared controller machinery and the
``fixed`` kind, which never resizes; the trainer does not even instantiate
an outer controller for it.  The ``geometric``, ``gns``, ``bandit`` and
``dynamix`` kinds, and the gradient-noise-scale estimator behind ``gns``,
are the non-fixed-outer-kinds slice of the port (ROADMAP queue 1): asking
for one raises ``NotImplementedError``.

Pure host-side python; all state is JSON-serializable for the checkpoint
payload.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.batching import bucket_ladder, bucket_up

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

    # ------------------------------------------------------------------ api

    @property
    def b_global(self) -> int:
        return self.rungs[self.rung]

    def observe(self, *, loss: float, seconds: float, stats=None,
                context: Optional[dict] = None) -> Optional[int]:
        """Feed one outer step; return the new B_global iff a resize fires.

        ``loss`` is the step's (smoothed or raw) training loss, ``seconds``
        the wall/simulated time the step cost, ``stats`` the in-graph
        gradient moments (only the non-fixed kinds consume them), and
        ``context`` an optional dict of system signals that the dynamix
        policy folds into its state vector.  Warmup, cooldown, and the
        slew-rate limit gate every kind identically.
        """
        self.step_count += 1
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

    # ------------------------------------------------------------ overrides

    def _ingest(self, loss: float, seconds: float, stats) -> None:
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


_KIND_TO_CLS = {"fixed": FixedGlobalBatch}


def _controller_cls(kind: str):
    """Class for ``kind``.  Every other kind is the non-fixed-outer-kinds
    slice of the port ('dynamix' also needs policy.py's TD step in torch)."""
    if kind not in _KIND_TO_CLS:
        raise NotImplementedError(
            f"global_batch kind {kind!r} is not ported yet (ROADMAP queue 1, "
            "non-fixed outer kinds with policy.py's TD step in torch)")
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
