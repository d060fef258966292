"""Event-driven synchronization engine (tentpole layer 3, DESIGN.md §3).

One engine owns the per-worker event queue — ``(worker, next_done,
version)`` triples plus an opaque per-worker payload (the trainer stores
each worker's last-read parameters there for ASP staleness) — and drives
every synchronization mode:

  * **BSP**  — a degenerate event schedule: all K events of a round are
    popped together and the barrier lands at their max (``bsp_round``);
  * **ASP**  — pure event-driven: ``asp_next`` pops the earliest completion,
    reports its staleness, and reschedules the worker at its *current*
    batch size (so controller resizes take effect at the worker's next
    dispatch, exactly like the real runtime);
  * **elastic** — membership events remap the queue in place
    (``remove_worker`` / ``add_worker``) instead of rebuilding trainer
    state, which is what made the seed's ``_asp_state`` go stale after a
    mid-run membership change.

The engine never touches model state: it advances the clock and tells the
caller *which* worker acts *when*.  ``ClusterSim.asp_run`` delegates here,
so the event loop exists exactly once in the codebase — and because the
``sim`` argument is duck-typed, the mesh execution backend drives the SAME
queue with measured per-worker completion times instead of modelled ones
(``repro_torch.train.mesh._MeasuredTimeModel``, DESIGN.md §12): the engine is the
single owner of BSP/ASP/elastic ordering on both backends.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class WorkerEvent:
    """One popped completion event."""

    worker: int
    time: float          # sim-time at which the worker finished
    staleness: int       # global updates applied since this worker's read


class EventEngine:
    """(worker, next_done, version) event queue over a cluster simulator.

    ``sim`` must provide ``iteration_time(k, batch, at_time=None)``,
    ``bsp_step(batches)`` and a mutable ``time`` attribute (duck-typed —
    any ClusterSim-shaped object works).
    """

    def __init__(self, sim) -> None:
        self.sim = sim
        self.version = 0                 # global update counter (BSP + ASP)
        self.next_done: Optional[list[float]] = None   # ASP schedule (lazy)
        self.read_version: list[int] = [0] * len(sim.workers)
        self.payload: list[Any] = [None] * len(sim.workers)

    # ------------------------------------------------------------ queries

    @property
    def k(self) -> int:
        return len(self.read_version)

    @property
    def scheduled(self) -> bool:
        return self.next_done is not None

    # ---------------------------------------------------------------- BSP

    def bsp_round(self, batches: Sequence[int]) -> dict:
        """One barrier round: every worker completes, barrier at the max.

        This is the degenerate event schedule — all K events pop at once —
        so it shares the version counter with ASP and the clock model with
        the simulator (``sim.bsp_step`` remains the single source of truth
        for BSP timing).
        """
        if len(batches) != self.k:
            raise ValueError(f"{len(batches)} batches for {self.k} workers")
        info = self.sim.bsp_step(batches)
        self.version += 1
        self.read_version = [self.version] * self.k
        return info

    # ---------------------------------------------------------------- ASP

    def asp_schedule(self, batches: Sequence[int],
                     payload: Any = None) -> None:
        """(Re)build the event queue: every worker dispatched now."""
        if len(batches) != self.k:
            raise ValueError(f"{len(batches)} batches for {self.k} workers")
        self.next_done = [
            self.sim.time + self.sim.iteration_time(i, batches[i])
            for i in range(self.k)
        ]
        self.read_version = [self.version] * self.k
        if payload is not None:
            self.payload = [payload] * self.k

    def asp_next(self, batches: Sequence[int]) -> WorkerEvent:
        """Pop the earliest completion; reschedule that worker.

        The popped worker is rescheduled at its *current* batch size from
        ``batches`` (which the controller may have changed since dispatch).
        """
        if self.next_done is None:
            self.asp_schedule(batches)
        i = int(np.argmin(self.next_done))
        now = self.next_done[i]
        staleness = self.version - self.read_version[i]
        self.version += 1
        self.read_version[i] = self.version
        self.next_done[i] = now + self.sim.iteration_time(i, batches[i], now)
        self.sim.time = max(self.sim.time, now)
        return WorkerEvent(worker=i, time=now, staleness=staleness)

    def run_asp(self, batches: Sequence[int], num_updates: int) -> dict:
        """Timing-only ASP simulation (no SGD): the seed ``asp_run`` API.

        Returns the update log [(sim_time, worker, staleness)]; the final
        clock includes in-flight work (max over the remaining schedule).
        """
        self.asp_schedule(batches)
        log = []
        for _ in range(num_updates):
            ev = self.asp_next(batches)
            log.append((ev.time, ev.worker, ev.staleness))
        self.sim.time = max(self.sim.time, max(self.next_done))
        stale = [s for _, _, s in log]
        return {
            "updates": log,
            "mean_staleness": float(np.mean(stale)),
            "max_staleness": int(max(stale)),
        }

    # ---------------------------------------------------------- membership

    def remove_worker(self, k: int) -> None:
        """Drop worker k's events/payload; remaining indices shift down."""
        if not (0 <= k < self.k):
            raise ValueError(f"no worker {k} in a {self.k}-queue")
        del self.read_version[k]
        del self.payload[k]
        if self.next_done is not None:
            del self.next_done[k]

    def add_worker(self, batch: int, payload: Any = None) -> None:
        """Admit a worker (appended last): reads the current version now and,
        if an ASP schedule is live, dispatches immediately."""
        self.read_version.append(self.version)
        self.payload.append(payload)
        if self.next_done is not None:
            i = self.k - 1
            self.next_done.append(
                self.sim.time + self.sim.iteration_time(i, batch))

    # ------------------------------------------------------------- payload

    def get_payload(self, k: int) -> Any:
        return self.payload[k]

    def set_payload(self, k: int, value: Any) -> None:
        self.payload[k] = value
