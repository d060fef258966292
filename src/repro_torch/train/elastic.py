"""Elastic heterogeneous training: workers join and leave mid-run.

The paper's motivating environment is transient-VM fleets (EC2 spot, GCP
preemptible — §II-A): workers can be preempted at any time and replacements
of *different sizes* arrive later. This module extends the multislice
trainer with membership events:

  * `remove_worker(k)` — preemption. The departed worker's batch share is
    redistributed over the survivors; the global batch is preserved
    (the paper's Σb_k invariant), so training dynamics are unchanged.
  * `add_worker(spec)` — a replacement/spare joins. It starts from the
    current model (weights live on the surviving workers — no restart),
    gets a throughput-proportional slice of the global batch, and the
    controller re-equalizes iteration times from there.

Membership events *carry controller state over* (tentpole layer 4):
surviving workers keep their EWMA windows, adaptive ``b_max`` and
last-throughput history instead of getting a fresh controller, so the
control loop does not relearn the cluster after every preemption.  The
simulator mutates in place (``ClusterSim.add_worker``/``remove_worker`` —
clock and noise stream continue), and the event engine remaps its queue,
so a membership change mid-ASP-run neither crashes nor drops workers.

Membership changes are zero-cost for the model state (all-reduce data
parallelism keeps full replicas), and the data pipeline's per-(worker,
index) determinism means re-assigned streams never skip or repeat examples.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.core import cost_aware_allocation, largest_remainder_round
from repro_torch.het.simulator import ClusterSim, WorkerSpec
from repro_torch.train.loop import HeterogeneousTrainer


class ElasticTrainer(HeterogeneousTrainer):
    """HeterogeneousTrainer + dynamic worker membership."""

    def __init__(self, *, worker_specs: list[WorkerSpec] | None = None,
                 workload=None, sim_seed: int = 0, sim: ClusterSim | None = None,
                 **kw):
        if sim is None:
            if worker_specs is None or workload is None:
                raise ValueError(
                    "pass either sim= or (worker_specs=, workload=)")
            sim = ClusterSim(list(worker_specs), workload, seed=sim_seed)
        super().__init__(sim=sim, **kw)
        self.membership_log: list[tuple[int, str, int]] = []

    # ------------------------------------------------------------ events

    def _static_replan(self, total: int) -> list[int]:
        """Throughput-proportional split of the INVARIANT global batch
        (used only when no controller is attached).  ``total`` is the
        pre-event global batch — never derived from the mutated list."""
        xput = [self.sim.peek_throughput(i, max(total // self.k, 1))
                for i in range(self.k)]
        s = sum(xput)
        return largest_remainder_round([total * x / s for x in xput],
                                       total, lo=1)

    def remove_worker(self, k: int) -> None:
        """Preemption of worker k (fail-stop; its batch share survives)."""
        if self.k <= 1:
            raise ValueError("cannot remove the last worker")
        self.membership_log.append((self.step_idx, "remove", k))
        total = sum(self.batches)
        self.sim.remove_worker(k)
        self.engine.remove_worker(k)
        self.k = len(self.sim.workers)
        if self.controller is not None:
            # survivors keep EWMA windows / adaptive b_max / throughput
            # history; the departed share is reabsorbed proportionally
            self.batches = self.controller.remove_worker(k)
        else:
            self.batches = self._static_replan(total)

    def add_worker(self, spec: WorkerSpec) -> None:
        """A (possibly different-sized) replacement joins; model state is
        already replicated on survivors — no restart, no checkpoint load."""
        self.membership_log.append((self.step_idx, "add", self.k))
        total = (self.controller.global_batch if self.controller is not None
                 else sum(self.batches))
        self.sim.add_worker(spec)
        self.k = len(self.sim.workers)
        # throughput-proportional share estimate for the newcomer (RNG-free
        # peek: planning is observation, not simulated work)
        xput = [self.sim.peek_throughput(i, max(total // self.k, 1))
                for i in range(self.k)]
        hint = total * xput[-1] / sum(xput)
        if self.controller is not None:
            self.batches = self.controller.add_worker(hint)
        else:
            self.batches = self._static_replan(total)
        # the newcomer reads the CURRENT params (no staleness debt) and, if
        # an ASP schedule is live, dispatches immediately.  Only a live ASP
        # schedule reads payloads (``asp_schedule`` sets them all when it
        # starts); holding the params here otherwise would keep a full copy
        # of them alive on the card for as long as the newcomer stays
        self.engine.add_worker(
            self.batches[-1],
            payload=self.params if self.engine.scheduled else None)

    def reallocate_cost_aware(self) -> list[int]:
        """Churn replan (DESIGN.md §16): re-split the invariant global batch
        through the price/capacity-aware allocator.

        Applied by :class:`repro_torch.api.cluster.Reallocate` after every
        churn-schedule step that changed the cluster: RNG-free peek
        throughputs weigh each worker, memory-cliff capacities cap it, and
        spot prices bias the split toward cheap capacity — with controller
        state (EWMA windows, adaptive ``b_max``) carried over via
        :meth:`~repro_torch.core.control.base.BatchController.apply_allocation`.
        """
        total = (self.controller.global_batch if self.controller is not None
                 else sum(self.batches))
        probe = max(total // self.k, 1)
        xput = [self.sim.peek_throughput(i, probe) for i in range(self.k)]
        b_min = (self.controller.config.b_min
                 if self.controller is not None else 1)
        caps = [max(w.b_mem, b_min) if w.b_mem is not None else None
                for w in self.sim.workers]
        plan = cost_aware_allocation(
            xput, total, capacities=caps,
            prices=[w.price for w in self.sim.workers], b_min=b_min)
        self.membership_log.append((self.step_idx, "reallocate", -1))
        if self.controller is not None:
            self.batches = self.controller.apply_allocation(plan)
        else:
            self.batches = plan
        return self.batches

    # ------------------------------------------------------------- runs

    def run_with_events(self, events: dict[int, Callable[["ElasticTrainer"],
                                                         None]],
                        max_steps: int) -> dict:
        """events: {step: fn(trainer)} applied before that step executes."""
        for step in range(max_steps):
            if step in events:
                events[step](self)
            if self.cfg.sync == "bsp":
                self.bsp_step()
            else:
                self.asp_step()
        return {
            "steps": self.step_idx,
            "sim_time": self.sim.time,
            "final_loss": self.history[-1].loss if self.history else None,
            "final_batches": list(self.batches),
            "membership_log": self.membership_log,
            "history": self.history,
        }
