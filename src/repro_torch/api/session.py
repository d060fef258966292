"""Session: ONE training loop, as an iterator with hooks.

A :class:`Session` is an *iterator* over
:class:`~repro_torch.train.loop.StepRecord`s: the membership *schedule*
(typed events from :mod:`repro_torch.api.cluster`) fires before the step
whose index it names, ``target_loss`` early-stopping (EWMA-smoothed) applies
in every mode, and :class:`Hook`s observe or act on the run.  ``run()``
drains the iterator and returns the result dict.  ``save`` / ``restore``
(and :class:`CheckpointHook`) persist the whole session, so a resumed BSP
run continues bit for bit.
"""

from __future__ import annotations

import time as _time
from typing import Iterator, Optional, Sequence

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core import (controller_from_state_dict,
                              global_batch_from_state_dict)
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


class CheckpointHook(Hook):
    """``session.save(path)`` every N steps and (optionally) at run end."""

    def __init__(self, path: str, every: int = 100, at_end: bool = True,
                 extra_meta: Optional[dict] = None):
        self.path = path
        self.every = max(int(every), 1)
        self.at_end = at_end
        self.extra_meta = extra_meta
        self.saves = 0

    def on_step(self, session, rec):
        if (rec.step + 1) % self.every == 0:
            session.save(self.path, extra_meta=self.extra_meta)
            self.saves += 1

    def on_run_end(self, session, result):
        if self.at_end:
            session.save(self.path, extra_meta=self.extra_meta)
            self.saves += 1


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
        serve = result.get("serve")
        if serve is not None:
            # the co-located decode loop's report card (DESIGN.md §13/§17)
            # folded into the run metrics: latency, engine shape, and how
            # often the SLO policy moved training's device count
            self.summary["serve"] = {
                "engine": serve.get("engine", "batcher"),
                "requests_finished": serve["requests_finished"],
                "decode_step_ms_p95": serve["decode_step_ms"]["p95"],
                "queue_delay_p95": serve["queue_delay_steps"]["p95"],
                "charged_seconds": serve["charged_seconds"],
                "policy_moves": len(serve["policy_actions"]),
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
        if hasattr(trainer, "serve_stats"):
            # co-located serving (DESIGN.md §13): the run reports both the
            # training step times (charged with the decode interference)
            # and the decode side — latency percentiles, queue pressure
            result["serve"] = trainer.serve_stats()
        for h in self.hooks:
            h.on_run_end(self, result)
        return result

    # ---------------------------------------------------------- checkpoint

    def _require_checkpointable(self):
        """Checkpointing needs a trainer with a known state surface: the sim
        backend's (engine counters, the simulator's clock and jitter RNG) or
        the mesh backend's (``exec_state_dict``: EWMAs, rate model and
        clock, buckets visited, slice assignment, dilations)."""
        t = self.trainer
        kind = getattr(t, "backend_kind", None)
        if kind == "sim" and hasattr(t, "engine") and hasattr(t.sim, "rng"):
            return t
        if kind == "mesh" and hasattr(t, "exec_state_dict"):
            return t
        raise NotImplementedError(
            "session checkpointing is implemented for SimBackend and "
            f"MeshBackend trainers; this trainer ({type(t).__name__!r}) "
            "exposes neither state surface")

    def save(self, path: str, extra_meta: Optional[dict] = None) -> None:
        """Checkpoint the full session: params, the optimizer's state
        (Adam's moments; its step is the session's), ``batches``,
        ``smoothed_loss`` and ``step``, the controller, the engine's
        counters, the simulator's clock, iteration and jitter RNG, and the
        data source's cursors.  The mesh backend writes its
        ``exec_state_dict`` in place of the simulator's state.

        Enough for :meth:`restore` to continue a BSP run bit for bit (on the
        mesh backend, given the same measured times).  (ASP
        in-flight events and their stale parameter payloads are not
        persisted: an ASP resume redispatches all workers from the current
        params, like a real cluster restart would.)
        """
        t = self._require_checkpointable()
        session_meta = {
            "backend": t.backend_kind,
            "step": t.step_idx,
            "batches": list(t.batches),
            "smoothed_loss": self.smoothed_loss,
            "controller": (t.controller.state_dict()
                           if t.controller is not None else None),
            # the outer global-batch controller: None for the fixed kind
            "outer": (t.outer.state_dict()
                      if getattr(t, "outer", None) is not None else None),
            "engine": {
                "version": t.engine.version,
                "read_version": list(t.engine.read_version),
            },
            "workload": (self.workload.state_dict()
                         if self.workload is not None
                         and self.workload.state_dict else None),
        }
        if t.backend_kind == "sim":
            session_meta["sim"] = {
                "time": t.sim.time,
                "iteration": t.sim.iteration,
                "rng": t.sim.rng.bit_generator.state,
            }
        else:
            session_meta["mesh"] = t.exec_state_dict()
        meta = {"session": session_meta, **(extra_meta or {})}
        save_checkpoint(path, {"params": t.params, "opt_state": t.opt_state},
                        meta)

    def restore(self, path: str) -> "Session":
        """Load a :meth:`save` checkpoint into this (freshly built) session,
        on the trainer's device.

        The outer global-batch controller, if the session runs one, is
        rebuilt from the checkpoint's payload and installed with
        ``set_outer``, which also re-couples a batch-coupled LR schedule to
        the restored B_global.

        Raises ``ValueError`` when the checkpoint was written by another
        backend kind, for another worker count, at a step past part of the
        membership schedule, with an outer controller where this session
        runs the fixed kind (or without one where it does not), on another
        mesh (mesh backend), or (from the data source) with another seed;
        every check comes before the trainer's state changes.
        """
        t = self._require_checkpointable()
        tree, meta = load_checkpoint(path, t.device)
        st = meta["session"]
        ckpt_kind = st.get("backend", "sim")
        if ckpt_kind != t.backend_kind:
            raise ValueError(
                f"checkpoint was written by the {ckpt_kind!r} backend but "
                f"this session runs {t.backend_kind!r} — rebuild the "
                f"Experiment with the matching ClusterSpec(backend=...) or "
                f"point at a {t.backend_kind!r} checkpoint")
        if len(st["batches"]) != t.k:
            raise ValueError(
                f"checkpoint has {len(st['batches'])} workers, session has "
                f"{t.k} — rebuild the Experiment with the matching cluster")
        if any(ev.step < int(st["step"]) for ev in self.schedule):
            raise ValueError(
                "cannot resume past membership events: the checkpoint step "
                "is after part of the cluster schedule")
        ckpt_outer = st.get("outer")
        if (ckpt_outer is not None) != (getattr(t, "outer", None) is not None):
            raise ValueError(
                "global-batch config mismatch: the checkpoint was written "
                f"with kind={'fixed' if ckpt_outer is None else ckpt_outer['kind']!r} "
                f"but this session runs kind={t.cfg.global_batch.kind!r} — "
                "rebuild the Experiment with the matching GlobalBatchConfig")
        params = tree["params"]
        if set(params) != set(t.params):
            raise ValueError("checkpoint parameters do not match the "
                             "session's model")
        # rebuilt into locals before anything is assigned: a payload whose
        # ladder does not match its config raises here
        outer = (global_batch_from_state_dict(ckpt_outer)
                 if ckpt_outer is not None else None)
        controller = (controller_from_state_dict(st["controller"])
                      if st["controller"] is not None
                      and t.controller is not None else None)
        if t.backend_kind == "mesh":
            t.check_exec_state_dict(st["mesh"])
        # the data source's seed check is the last check and its load the
        # first change of state
        if st["workload"] is not None and self.workload is not None \
                and self.workload.load_state_dict:
            self.workload.load_state_dict(st["workload"])
        if outer is not None:
            t.set_outer(outer)
        t.params = {k: params[k].to(p.dtype) for k, p in t.params.items()}
        t.opt_state = tree["opt_state"]
        t.step_idx = int(st["step"])
        t.batches = [int(b) for b in st["batches"]]
        self.smoothed_loss = st["smoothed_loss"]
        if controller is not None:
            t.controller = controller
        if t.backend_kind == "sim":
            t.sim.time = float(st["sim"]["time"])
            t.sim.iteration = int(st["sim"]["iteration"])
            t.sim.rng.bit_generator.state = st["sim"]["rng"]
        else:
            t.load_exec_state_dict(st["mesh"])
        t.engine.version = int(st["engine"]["version"])
        t.engine.read_version = [int(v) for v in st["engine"]["read_version"]]
        # the guard above rejected any event before the checkpoint step, and
        # events scheduled AT the resume step have not fired yet
        self._sched_i = 0
        return self
