"""Deterministic chaos-injection harness (DESIGN.md §16).

Storms compiled from a spot trace exercise *scheduled* churn; this module
injects faults at the **worst possible moments** — conditions a schedule
can't name in advance because they depend on runtime state:

  * ``preempt-during-checkpoint``   — save a checkpoint, then preempt a
    worker before the next round runs (the resume must replay the
    preemption, Session.restore's events-at-the-resume-step contract);
  * ``preempt-during-resize``       — wait for a step where the inner
    controller readjusted (or the outer loop resized B_global), then
    preempt mid-transient;
  * ``straggler-during-gns-cooldown`` — degrade a worker inside the outer
    GNS controller's post-resize cooldown window, when it is blind to new
    measurements by design.

Everything is driven by a seeded :class:`ChaosPlan` — plain data — and the
injections themselves are deterministic functions of (plan, run state), so
two identical runs under the same plan produce identical injection logs
and identical histories: chaos you can bisect.

:class:`ChaosHook` duck-types the :class:`repro_torch.api.session.Hook`
surface (on_run_start / on_membership / on_step / on_run_end) rather than
importing it — `repro_torch.api` already imports `repro_torch.het`, and
hooks are structural.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.het.simulator import WorkerSpec

FAULT_KINDS = (
    "preempt-during-checkpoint",
    "preempt-during-resize",
    "straggler-during-gns-cooldown",
)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned fault.  ``arm_step`` is when the trigger arms; the fault
    fires at the first armed step whose runtime condition holds.
    ``victim_bias`` picks the victim as ``victim_bias % k`` at fire time."""

    kind: str
    arm_step: int
    victim_bias: int
    factor: float = 4.0          # straggler slowdown
    rejoin_after: int = 5        # steps until a replacement joins
    restore_after: int = 3       # steps until a straggler recovers

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}")
        if self.arm_step < 0:
            raise ValueError("arm_step must be >= 0")


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """Seeded, replayable fault plan — plain data, ordered by arm step."""

    seed: int
    faults: tuple[Fault, ...]

    def summary(self) -> dict:
        kinds: dict[str, int] = {}
        for f in self.faults:
            kinds[f.kind] = kinds.get(f.kind, 0) + 1
        return {"seed": self.seed, "faults": len(self.faults), **kinds}


def make_fault_plan(seed: int, *, horizon: int,
                    kinds: Sequence[str] = FAULT_KINDS,
                    faults_per_kind: int = 1) -> ChaosPlan:
    """Sample a deterministic fault plan: same seed -> identical plan."""
    if horizon < 4:
        raise ValueError(f"horizon {horizon} too short for a fault plan")
    rng = np.random.default_rng([int(seed), 0xC4A05])
    lo, hi = max(1, horizon // 8), max(2, horizon - horizon // 4)
    faults = []
    for kind in kinds:
        for _ in range(max(1, faults_per_kind)):
            faults.append(Fault(
                kind=kind,
                arm_step=int(rng.integers(lo, max(hi, lo + 1))),
                victim_bias=int(rng.integers(0, 2**20)),
                factor=float(2.0 + 3.0 * rng.random())))
    faults.sort(key=lambda f: (f.arm_step, f.kind))
    return ChaosPlan(seed=int(seed), faults=tuple(faults))


class ChaosHook:
    """Session hook that executes a :class:`ChaosPlan` deterministically.

    Hook-driven actions are recorded in ``log`` as ``(step, action,
    victim)`` tuples and attached to the run result under ``"chaos_log"``.
    Preempted workers are replaced after ``rejoin_after`` steps (specs from
    ``spec_factory``), and every hook-driven membership change routes
    reallocation through ``trainer.reallocate_cost_aware()`` — same path as
    compiled churn.  ``checkpoint_path`` arms the during-checkpoint fault;
    without it that fault degrades to a plain preemption (logged as such).
    """

    def __init__(self, plan: ChaosPlan, *,
                 checkpoint_path: Optional[str] = None,
                 spec_factory: Optional[Callable[[], WorkerSpec]] = None):
        self.plan = plan
        self.checkpoint_path = checkpoint_path
        self.spec_factory = spec_factory or (
            lambda: WorkerSpec(cores=8.0, price=1.0))
        self.log: list[tuple[int, str, int]] = []
        self._armed = sorted(plan.faults, key=lambda f: (f.arm_step, f.kind))
        self._deferred: list[tuple[int, str, object]] = []
        self._seen_resizes = 0

    # --------------------------------------------------- hook surface

    def on_run_start(self, session) -> None:
        pass

    def on_membership(self, session, event) -> None:
        pass

    def on_run_end(self, session, result) -> None:
        result["chaos_log"] = list(self.log)
        result["chaos_pending"] = len(self._armed) + len(self._deferred)

    def on_step(self, session, rec) -> None:
        t = session.trainer
        step = rec.step
        # outer-resize edge detection (consumed by preempt-during-resize)
        outer = getattr(t, "outer", None)
        resized = outer is not None and outer.num_resizes > self._seen_resizes
        self._seen_resizes = outer.num_resizes if outer is not None else 0
        # deferred recoveries first: rejoins and straggler restores
        due = [d for d in self._deferred if d[0] <= step]
        self._deferred = [d for d in self._deferred if d[0] > step]
        for _, action, arg in due:
            if action == "rejoin":
                t.add_worker(arg)
                t.reallocate_cost_aware()
                self.log.append((step, "rejoin", t.k - 1))
            else:  # restore: (victim, reciprocal factor)
                victim, factor = arg
                victim = min(victim, t.k - 1)
                t.slow_worker(victim, factor)
                self.log.append((step, "restore", victim))
        still = []
        for f in self._armed:
            if step < f.arm_step or not self._fire(f, session, rec, t,
                                                   resized):
                still.append(f)
        self._armed = still

    # ------------------------------------------------------ injection

    def _preempt(self, f: Fault, t, step: int, action: str) -> bool:
        if t.k <= 1:
            return False        # cannot preempt the last worker; stay armed
        victim = f.victim_bias % t.k
        t.remove_worker(victim)
        t.reallocate_cost_aware()
        self._deferred.append(
            (step + max(f.rejoin_after, 1), "rejoin", self.spec_factory()))
        self.log.append((step, action, victim))
        return True

    def _fire(self, f: Fault, session, rec, t, resized: bool) -> bool:
        step = rec.step
        if f.kind == "preempt-during-checkpoint":
            action = f.kind
            if self.checkpoint_path is not None:
                session.save(self.checkpoint_path)
            else:
                action = "preempt-no-checkpoint"
            return self._preempt(f, t, step, action)
        if f.kind == "preempt-during-resize":
            if not (rec.adjusted or resized):
                return False    # wait for a mid-transient step
            return self._preempt(f, t, step, f.kind)
        # straggler-during-gns-cooldown
        outer = getattr(t, "outer", None)
        if outer is not None:
            cooling = (outer.last_resize_step is not None
                       and outer.step_count - outer.last_resize_step
                       < outer.config.cooldown)
            if not cooling:
                return False    # wait for the blind window
        victim = f.victim_bias % t.k
        t.slow_worker(victim, f.factor)
        self._deferred.append(
            (step + max(f.restore_after, 1), "restore",
             (victim, 1.0 / f.factor)))
        self.log.append((step, f.kind, victim))
        return True


def run_chaos(make_session, plan: ChaosPlan, *,
              checkpoint_path: Optional[str] = None,
              spec_factory=None) -> tuple[dict, ChaosHook]:
    """Build a fresh session, attach a :class:`ChaosHook`, run to the end.

    Returns ``(result, hook)``; ``result["chaos_log"]`` holds the injection
    log.  Two calls with the same plan and the same session factory produce
    identical logs and histories — the property tests/test_spot.py pins.
    """
    session = make_session()
    hook = ChaosHook(plan, checkpoint_path=checkpoint_path,
                     spec_factory=spec_factory)
    session.hooks.append(hook)
    result = session.run()
    return result, hook
