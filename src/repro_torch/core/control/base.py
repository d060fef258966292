"""Pluggable mini-batch controller layer (paper §III-C, generalized).

The paper's controller is a proportional (P) law on per-worker iteration
times.  This package factors the machinery that every control law shares —
EWMA smoothing, dead-banding, [b_min, b_max] bounds with the adaptive-b_max
throughput guard, exact integer apportionment of the invariant global batch,
and state-preserving membership changes — into :class:`BatchController`,
and leaves one hook (:meth:`BatchController._raw_targets`) for the control
law itself.  Concrete laws live in sibling modules:

  * ``proportional``  — paper-faithful P controller (Eq. 4-5), bit-for-bit
                        the seed behaviour;
  * ``pid``           — PI and full PID variants (derivative action cancels
                        the EWMA filter lag, integral action removes
                        steady-state error that hides inside the dead-band);
  * ``gain``          — gain-scheduled PID that detects availability-trace
                        shifts and re-tunes (restarts its filter windows).

Controllers are pure-python host-side logic (they react to measured wall
times, which only exist on the host); deliberately free of jax deps so they
can drive the multislice runtime, the simulator, or the event engine.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core.allocation import largest_remainder_round


@dataclasses.dataclass
class ControllerConfig:
    """Knobs for the dynamic batching controller.

    ``kind`` selects the control law ('p' | 'pi' | 'pid' | 'gain'); the
    default 'p' reproduces the paper controller exactly.  Gains default to
    ``None`` = auto-tune per kind (see ``resolved_gains``).
    """

    dead_band: float = 0.05          # paper's 5% relative dead-band
    ewma_alpha: float = 0.3          # smoothing factor for iteration times
    b_min: int = 1                   # lower bound on any worker's batch
    b_max: Optional[int] = None      # static upper bound (None = unbounded)
    adaptive_bmax: bool = True       # clamp b_max on observed throughput drop
    throughput_drop_tol: float = 0.02  # relative drop that triggers clamping
    conserve_global: bool = True     # renormalize so sum(b_k) stays constant
    min_iters_between_updates: int = 1
    # Beyond-paper mode: zero dead-band + per-iteration fractional updates.
    # (Safe in this runtime because a batch resize is a host-side scalar
    # change, not a kill-restart. Kept OFF for the paper-faithful baseline.)
    beyond_paper: bool = False
    # ---- control-law selection (tentpole: pluggable controllers) ----
    kind: str = "p"                  # 'p' | 'pi' | 'pid' | 'gain'
    kp: float = 1.0                  # proportional gain
    ki: Optional[float] = None       # integral gain (None = auto per kind)
    kd: Optional[float] = None       # derivative gain (None = auto per kind)
    i_max: float = 10.0              # anti-windup clamp on the integral term
    shift_threshold: float = 0.3     # 'gain': relative jump that re-tunes

    def __post_init__(self) -> None:
        if not (0.0 <= self.ewma_alpha <= 1.0):
            raise ValueError(f"ewma_alpha must be in [0,1], got {self.ewma_alpha}")
        if self.dead_band < 0:
            raise ValueError("dead_band must be >= 0")
        if self.b_min < 1:
            raise ValueError("b_min must be >= 1")
        if self.kind not in ("p", "pi", "pid", "gain"):
            raise ValueError(f"unknown controller kind {self.kind!r}")
        if self.beyond_paper:
            self.dead_band = 0.0
            self.min_iters_between_updates = 1

    def resolved_gains(self, kind: Optional[str] = None) -> tuple[float, float, float]:
        """(kp, ki, kd) with per-kind auto-tuning applied.

        The derivative default kd = (1-alpha)/alpha exactly cancels the
        one-step lag of the EWMA filter after a step disturbance: the first
        post-step sample moves the EWMA by alpha*e, and its first difference
        is also alpha*e, so kp*alpha*e + kd*alpha*e = e — deadbeat.
        """
        kind = kind or self.kind
        kp = self.kp
        if kind == "p":
            return kp, 0.0, 0.0
        alpha = max(self.ewma_alpha, 1e-6)
        kd_auto = (1.0 - alpha) / alpha
        if kind == "pi":
            ki = 0.1 if self.ki is None else self.ki
            return kp, ki, (0.0 if self.kd is None else self.kd)
        # 'pid' and 'gain'
        ki = 0.05 if self.ki is None else self.ki
        kd = kd_auto if self.kd is None else self.kd
        return kp, ki, kd


@dataclasses.dataclass
class WorkerState:
    """Per-worker controller bookkeeping."""

    batch: int
    ewma_time: Optional[float] = None   # smoothed iteration time since last update
    b_max: Optional[int] = None         # per-worker adaptive upper bound
    last_throughput: Optional[float] = None  # samples/sec at last readjustment
    last_batch: Optional[int] = None    # batch at the previous readjustment
    # PID bookkeeping (window-scoped like the EWMA: reset on each update)
    integral: float = 0.0               # accumulated rel. error since last update
    prev_smoothed: Optional[float] = None  # last EWMA value, for the D term


@dataclasses.dataclass
class ControllerUpdate:
    """Result of one observe() call."""

    batches: list[int]            # current per-worker batch plan
    updated: bool                 # did a readjustment happen this iteration
    errors: list[float]           # tau_k used (0.0 when not updated)
    reason: str                   # 'dead-band', 'updated', 'warmup', ...


class BatchController:
    """Shared machinery: EWMA, dead-band, bounds, apportionment, membership.

    Subclasses implement :meth:`_raw_targets` (the control law) and may
    override :meth:`_pre_smooth` (gain scheduling) and :meth:`_on_update`.
    """

    kind = "base"

    def __init__(
        self,
        initial_batches: Sequence[int],
        config: ControllerConfig | None = None,
    ) -> None:
        if len(initial_batches) == 0:
            raise ValueError("need at least one worker")
        if any(b < 1 for b in initial_batches):
            raise ValueError(f"initial batches must be >= 1: {initial_batches}")
        self.config = config or ControllerConfig()
        self.workers = [WorkerState(batch=int(b)) for b in initial_batches]
        self.global_batch = int(sum(initial_batches))
        self._iters_since_update = 0
        self.num_updates = 0
        self.num_retunes = 0
        self.history: list[list[int]] = [list(initial_batches)]
        self.membership_events = 0

    # ------------------------------------------------------------------ api

    @property
    def batches(self) -> list[int]:
        return [w.batch for w in self.workers]

    @property
    def k(self) -> int:
        return len(self.workers)

    # ------------------------------------------------------------ overrides

    def _pre_smooth(self, iteration_times: Sequence[float]) -> None:
        """Hook before EWMA smoothing (gain scheduling lives here)."""

    def _raw_targets(self, mu: list[float], t_bar: float,
                     errors: list[float]) -> list[float]:
        """Control law: real-valued batch targets from smoothed times."""
        raise NotImplementedError

    def _on_update(self) -> None:
        """Hook after a committed readjustment (window-scoped state resets)."""
        for w in self.workers:
            w.integral = 0.0
            w.prev_smoothed = None

    # -------------------------------------------------------------- observe

    def _hi_bound(self, w: WorkerState) -> int:
        return min(x for x in (self.config.b_max, w.b_max, self.global_batch)
                   if x is not None)

    def observe(self, iteration_times: Sequence[float]) -> ControllerUpdate:
        """Feed one iteration's per-worker times; maybe readjust batches.

        Implements the paper's 4-step "putting it all together" recipe:
          1. EWMA-smooth iteration times since the last batch update.
          2. Control law (P / PI / PID) on the smoothed times.
          3. Enforce [b_min, b_max] bounds.
          4. Dead-band check on the *relative* max change.
        """
        if len(iteration_times) != len(self.workers):
            raise ValueError(
                f"got {len(iteration_times)} times for {len(self.workers)} workers"
            )
        if any(t <= 0 or not math.isfinite(t) for t in iteration_times):
            raise ValueError(f"iteration times must be positive finite: {iteration_times}")

        cfg = self.config
        self._pre_smooth(iteration_times)
        # -- step 1: EWMA over the window since the last readjustment
        for w, t in zip(self.workers, iteration_times):
            if w.ewma_time is None:
                w.ewma_time = float(t)
            else:
                w.ewma_time = cfg.ewma_alpha * float(t) + (1 - cfg.ewma_alpha) * w.ewma_time

        self._iters_since_update += 1
        if self._iters_since_update < cfg.min_iters_between_updates:
            return ControllerUpdate(self.batches, False, [0.0] * len(self.workers), "warmup")

        # -- step 2: control law on smoothed times
        mu = [w.ewma_time for w in self.workers]
        t_bar = sum(mu) / len(mu)
        errors = [m - t_bar for m in mu]
        raw = self._raw_targets(mu, t_bar, errors)

        # conserve the global batch (paper: sum b_k = K*b0 invariant)
        if cfg.conserve_global:
            scale = self.global_batch / sum(raw)
            raw = [r * scale for r in raw]

        # -- step 3: bounds
        bounded = []
        for w, r in zip(self.workers, raw):
            hi = self._hi_bound(w)
            bounded.append(min(max(r, float(cfg.b_min)), float(hi)))
        # -- step 4: dead-band on the *pre-rounding* relative change (integer
        # quantization must not trip the band for small batches)
        max_rel = max(
            abs(r - w.batch) / max(w.batch, 1)
            for r, w in zip(bounded, self.workers)
        )
        if max_rel <= cfg.dead_band:
            return ControllerUpdate(self.batches, False, errors, "dead-band")

        # integer plan that conserves the global batch exactly
        new_batches = largest_remainder_round(
            bounded, self.global_batch if cfg.conserve_global else None,
            lo=cfg.b_min,
            hi=[self._hi_bound(w) for w in self.workers],
        )
        if all(nb == w.batch for nb, w in zip(new_batches, self.workers)):
            return ControllerUpdate(self.batches, False, errors, "dead-band")

        # -- adaptive b_max: detect throughput drops caused by the last grow
        if cfg.adaptive_bmax:
            for w, m in zip(self.workers, mu):
                tput = w.batch / m
                if (
                    w.last_throughput is not None
                    and w.last_batch is not None
                    and w.batch > w.last_batch
                    and tput < w.last_throughput * (1 - cfg.throughput_drop_tol)
                ):
                    # growing past last_batch hurt: clamp to the last good size
                    w.b_max = w.last_batch
                w.last_throughput = tput
                w.last_batch = w.batch

        for w, nb in zip(self.workers, new_batches):
            w.batch = int(nb)
            w.ewma_time = None  # restart the EWMA window (paper: window = since last update)
        self._iters_since_update = 0
        self.num_updates += 1
        self.history.append(self.batches)
        self._on_update()
        return ControllerUpdate(self.batches, True, errors, "updated")

    # --------------------------------------------------------- outer loop

    def set_global_batch(self, total: int) -> list[int]:
        """Outer-loop resize of the conserved Σb_k invariant (DESIGN.md §15).

        The outer global-batch controller calls this when it walks the
        ladder: per-worker shares are rescaled PROPORTIONALLY (each worker
        keeps its fraction of the global batch, i.e. the inner law's learned
        split survives the resize) with exact integer apportionment.
        Adaptive per-worker ``b_max`` bounds and last-throughput history are
        kept; EWMA windows are restarted like any committed readjustment —
        old iteration times describe the old batch sizes.
        """
        total = int(total)
        cfg = self.config
        if total < cfg.b_min * len(self.workers):
            raise ValueError(
                f"global batch {total} infeasible with b_min={cfg.b_min} "
                f"x {len(self.workers)} workers")
        cur = sum(w.batch for w in self.workers)
        if total == cur:
            return self.batches
        targets = [w.batch * total / max(cur, 1) for w in self.workers]
        self.global_batch = total
        new_batches = largest_remainder_round(
            targets, total, lo=cfg.b_min,
            hi=[self._hi_bound(w) for w in self.workers])
        for w, nb in zip(self.workers, new_batches):
            w.batch = int(nb)
            w.ewma_time = None
        self._iters_since_update = 0
        self.history.append(self.batches)
        self._on_update()
        return self.batches

    def apply_allocation(self, plan: Sequence[float]) -> list[int]:
        """Adopt an externally computed batch plan WITHOUT losing state.

        The churn-reallocation path (DESIGN.md §16): after a preemption
        storm, :class:`repro_torch.api.cluster.Reallocate` computes a
        price/capacity-aware split (`core.allocation.cost_aware_allocation`)
        and installs it here.  Per-worker adaptive ``b_max`` bounds and
        last-throughput history survive; the plan is re-apportioned through
        the controller's own [b_min, b_max] bounds so an external allocator
        can never install a plan the control law itself would refuse.  Like
        any committed readjustment, EWMA windows restart (old iteration
        times describe the old batch sizes) — but ``num_updates`` is NOT
        bumped: this is a membership-class action, not a control decision.
        """
        if len(plan) != len(self.workers):
            raise ValueError(
                f"plan has {len(plan)} entries for {len(self.workers)} "
                f"workers")
        cfg = self.config
        if not cfg.conserve_global:
            self.global_batch = int(round(sum(plan)))
        new_batches = largest_remainder_round(
            [float(b) for b in plan],
            self.global_batch if cfg.conserve_global else None,
            lo=cfg.b_min,
            hi=[self._hi_bound(w) for w in self.workers])
        if all(nb == w.batch for nb, w in zip(new_batches, self.workers)):
            return self.batches
        for w, nb in zip(self.workers, new_batches):
            w.batch = int(nb)
            w.ewma_time = None
        self._iters_since_update = 0
        self.membership_events += 1
        self.history.append(self.batches)
        self._on_update()
        return self.batches

    # ---------------------------------------------------------- membership

    def remove_worker(self, k: int) -> list[int]:
        """Drop worker k, redistributing its share over the SURVIVORS.

        Survivors keep their controller state — EWMA windows, adaptive
        ``b_max``, last-throughput history — so the controller does not
        relearn the cluster from scratch after a preemption (tentpole layer
        4).  The Σb_k invariant is preserved when ``conserve_global``.
        """
        if not (0 <= k < len(self.workers)):
            raise ValueError(f"no worker {k} in a {len(self.workers)}-cluster")
        if len(self.workers) <= 1:
            raise ValueError("cannot remove the last worker")
        departed = self.workers.pop(k)
        cfg = self.config
        self.membership_events += 1
        if not cfg.conserve_global:
            self.global_batch = sum(w.batch for w in self.workers)
            self.history.append(self.batches)
            return self.batches
        surviving = sum(w.batch for w in self.workers)
        # scale survivors up proportionally to reabsorb the departed share
        targets = [w.batch * self.global_batch / max(surviving, 1)
                   for w in self.workers]
        new_batches = largest_remainder_round(
            targets, self.global_batch, lo=cfg.b_min,
            hi=[self._hi_bound(w) for w in self.workers])
        for w, nb in zip(self.workers, new_batches):
            w.batch = int(nb)
        del departed
        self.history.append(self.batches)
        return self.batches

    def add_worker(self, batch_hint: Optional[float] = None) -> list[int]:
        """Admit a new worker (appended last) with a fresh WorkerState.

        ``batch_hint`` is the newcomer's desired share (e.g. a
        throughput-proportional estimate); existing workers shrink
        proportionally so the global batch is conserved.  Existing workers
        keep their EWMA windows and adaptive bounds.
        """
        cfg = self.config
        self.membership_events += 1
        if not cfg.conserve_global:
            b_new = max(cfg.b_min, int(round(
                batch_hint if batch_hint is not None
                else self.global_batch / max(len(self.workers), 1))))
            self.workers.append(WorkerState(batch=b_new))
            self.global_batch = sum(w.batch for w in self.workers)
            self.history.append(self.batches)
            return self.batches
        g = self.global_batch
        if batch_hint is None:
            batch_hint = g / (len(self.workers) + 1)
        b_new = min(max(float(batch_hint), float(cfg.b_min)),
                    float(g - cfg.b_min * len(self.workers)))
        shrink = (g - b_new) / g
        targets = [w.batch * shrink for w in self.workers] + [b_new]
        self.workers.append(WorkerState(batch=max(cfg.b_min, int(b_new))))
        new_batches = largest_remainder_round(
            targets, g, lo=cfg.b_min,
            hi=[self._hi_bound(w) for w in self.workers])
        for w, nb in zip(self.workers, new_batches):
            w.batch = int(nb)
        self.history.append(self.batches)
        return self.batches

    # -------------------------------------------------------------- serde

    def state_dict(self) -> dict:
        return {
            "config": dataclasses.asdict(self.config),
            "workers": [dataclasses.asdict(w) for w in self.workers],
            "global_batch": self.global_batch,
            "iters_since_update": self._iters_since_update,
            "num_updates": self.num_updates,
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "BatchController":
        ctrl = cls(
            [w["batch"] for w in state["workers"]],
            ControllerConfig(**state["config"]),
        )
        ctrl.workers = [WorkerState(**w) for w in state["workers"]]
        ctrl.global_batch = state["global_batch"]
        ctrl._iters_since_update = state["iters_since_update"]
        ctrl.num_updates = state["num_updates"]
        return ctrl
