"""Session: ONE training loop, as an iterator with hooks.

A :class:`Session` is an *iterator* over
:class:`~repro_torch.train.loop.StepRecord`s: the membership *schedule*
(typed events from :mod:`repro_torch.api.cluster`) fires before the step
whose index it names, ``target_loss`` early-stopping (EWMA-smoothed) applies
in every mode, and :class:`Hook`s observe or act on the run.  ``run()``
drains the iterator and returns the result dict.

Checkpointing (``save`` / ``restore`` and the reference's CheckpointHook)
waits for the port of ``checkpoint/``.
"""

from __future__ import annotations

import time as _time
from typing import Iterator, Optional, Sequence

from repro_torch.train.loop import StepRecord
from repro_torch.train.metrics import iteration_time_stats, straggler_waste


# ------------------------------------------------------------------- hooks


class Hook:
    """Observer/actuator for a Session. Override any subset of methods.

    Per step, hooks run in registration order, after the trainer applied
    the step; ``on_membership`` fires right after a schedule event mutated
    the cluster (before the step it precedes).
    """

    def on_run_start(self, session: "Session") -> None:
        pass

    def on_membership(self, session: "Session", event) -> None:
        pass

    def on_step(self, session: "Session", record: StepRecord) -> None:
        pass

    def on_run_end(self, session: "Session", result: dict) -> None:
        pass


class LoggingHook(Hook):
    """Print a one-line progress record every ``every`` steps."""

    def __init__(self, every: int = 50, emit=print):
        self.every = max(int(every), 1)
        self.emit = emit

    def on_step(self, session, rec):
        if rec.step % self.every == 0:
            self.emit(f"  step {rec.step:4d} t={rec.sim_time:8.2f}s "
                      f"loss={rec.loss:7.4f} batches={rec.batches} "
                      f"{'<- adjusted' if rec.adjusted else ''}")

    def on_membership(self, session, event):
        self.emit(f"  membership @ step {session.trainer.step_idx}: {event}")


class EarlyStopHook(Hook):
    """Stop when ``predicate(session, record)`` is true (checked per step).

    ``target_loss`` needs no hook — it is built into the Session; use this
    for budget-style criteria (sim-time limits, loss plateaus, ...).
    """

    def __init__(self, predicate):
        self.predicate = predicate
        self.triggered = False

    def on_step(self, session, rec):
        if self.predicate(session, rec):
            self.triggered = True
            session.stop()


class MetricCollector(Hook):
    """Collects run-level metrics, including per-worker p95 iteration time.

    After the run, ``.summary`` holds aggregate iteration-time stats (the
    ``per_worker`` entry surfaces each worker's mean/p95 — the load-balance
    signal the paper's controller equalizes), mean straggler waste, and the
    adjustment count.
    """

    def __init__(self):
        self.summary: dict = {}

    def on_run_end(self, session, result):
        history = result["history"]
        if not history:
            return
        # per-worker columns are only comparable within a fixed membership:
        # restrict to records after the last membership event (a same-step
        # remove+add keeps the worker COUNT, so counting alone can't tell)
        events = result.get("membership_log") or []
        if events:
            last = max(step for step, _, _ in events)
            span = [r for r in history if r.step >= last] or history
        else:
            span = history
        stats = iteration_time_stats(history)  # aggregate: whole run
        stats["per_worker"] = iteration_time_stats(
            span, per_worker=True)["per_worker"]
        self.summary = {
            "iteration_time": stats,
            "straggler_waste": straggler_waste(history),
            "batch_adjustments": result.get("batch_adjustments", 0),
            "steps": result["steps"],
            "sim_time": result["sim_time"],
        }
        result["metrics"] = self.summary


# ----------------------------------------------------------------- session


class Session:
    """Step iterator over a built trainer + membership schedule + hooks.

    Construct via :meth:`repro_torch.api.experiment.Experiment.session` (which
    wires the workload, cluster and config together); drive it either with
    ``for record in session`` or ``session.run()``.
    """

    def __init__(self, trainer, *, schedule: Sequence = (),
                 hooks: Sequence[Hook] = (), workload=None,
                 max_steps: Optional[int] = None):
        self.trainer = trainer
        self.schedule = sorted(schedule, key=lambda e: e.step)
        self.hooks = list(hooks)
        self.workload = workload
        self.max_steps = (trainer.cfg.max_steps if max_steps is None
                          else max_steps)
        self.smoothed_loss: Optional[float] = None
        self._stop = False
        self._started = False
        self._sched_i = 0
        self._wall0: Optional[float] = None

    # -------------------------------------------------------- conveniences

    @property
    def params(self):
        return self.trainer.params

    @property
    def history(self) -> list[StepRecord]:
        return self.trainer.history

    @property
    def step_idx(self) -> int:
        return self.trainer.step_idx

    @property
    def batches(self) -> list[int]:
        return list(self.trainer.batches)

    def stop(self) -> None:
        """Request a stop; the iterator finishes after the current step."""
        self._stop = True

    @property
    def reached_target(self) -> bool:
        cfg = self.trainer.cfg
        return (cfg.target_loss is not None
                and self.smoothed_loss is not None
                and self.smoothed_loss <= cfg.target_loss)

    # ------------------------------------------------------------ stepping

    def _apply_due_events(self) -> None:
        while (self._sched_i < len(self.schedule)
               and self.schedule[self._sched_i].step
               <= self.trainer.step_idx):
            ev = self.schedule[self._sched_i]
            self._sched_i += 1
            ev.apply(self.trainer)
            for h in self.hooks:
                h.on_membership(self, ev)

    def step(self) -> StepRecord:
        """One training step: due schedule events, trainer step, smoothing
        + target check (legacy ``run()`` criterion, all sync modes), hooks."""
        if not self._started:
            self._started = True
            for h in self.hooks:
                h.on_run_start(self)
        self._apply_due_events()
        cfg = self.trainer.cfg
        rec = (self.trainer.bsp_step() if cfg.sync == "bsp"
               else self.trainer.asp_step())
        self.smoothed_loss = rec.loss if self.smoothed_loss is None else (
            cfg.loss_ewma * rec.loss
            + (1 - cfg.loss_ewma) * self.smoothed_loss)
        if cfg.target_loss is not None \
                and self.smoothed_loss <= cfg.target_loss:
            self._stop = True
        for h in self.hooks:
            h.on_step(self, rec)
        return rec

    def __iter__(self) -> Iterator[StepRecord]:
        while not self._stop and self.trainer.step_idx < self.max_steps:
            yield self.step()

    # ----------------------------------------------------------------- run

    def run(self) -> dict:
        """Drain the iterator; return the legacy-shaped result dict."""
        self._wall0 = _time.perf_counter()
        for _ in self:
            pass
        trainer = self.trainer
        result = {
            "steps": trainer.step_idx,
            "sim_time": trainer.sim.time,
            "final_loss": self.smoothed_loss,
            "reached_target": self.reached_target,
            "wall_time": _time.perf_counter() - self._wall0,
            "batch_adjustments": (trainer.controller.num_updates
                                  if trainer.controller else 0),
            "outer_resizes": (trainer.outer.num_resizes
                              if getattr(trainer, "outer", None) is not None
                              else 0),
            "history": trainer.history,
            "final_batches": list(trainer.batches),
        }
        if hasattr(trainer, "membership_log"):
            result["membership_log"] = trainer.membership_log
        for h in self.hooks:
            h.on_run_end(self, result)
        return result

    # ---------------------------------------------------------- checkpoint

    def save(self, path: str, extra_meta: Optional[dict] = None) -> None:
        raise NotImplementedError(
            "Session.save is not ported yet: it needs checkpoint/ "
            "(ROADMAP queue 1, checkpoint slice)")

    def restore(self, path: str) -> "Session":
        raise NotImplementedError(
            "Session.restore is not ported yet: it needs checkpoint/ "
            "(ROADMAP queue 1, checkpoint slice)")
