"""ClusterSpec: where to train — a declarative heterogeneous cluster.

Describes the simulated cluster (worker resources, cost model, noise,
availability traces) plus a first-class *membership schedule* of typed
events.  A spec is data: every ``build()`` returns a fresh
:class:`~repro_torch.het.simulator.ClusterSim` with a fresh jitter stream.

Not ported yet: co-located serving (``serve=``) and spot-market churn
lowering (``compile_churn`` / ``with_churn``), which belong to the serving
and churn slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

from repro_torch.het.simulator import (
    WORKLOADS,
    ClusterSim,
    WorkerSpec,
    WorkloadModel,
    hlevel_cluster,
    homogeneous_cluster,
    mixed_gpu_cpu_cluster,
)

# ------------------------------------------------------- membership events


@dataclasses.dataclass(frozen=True)
class RemoveWorker:
    """Preemption: fail-stop removal of ``worker`` before ``step`` runs.

    The departed worker's batch share is reabsorbed by the survivors (the
    paper's Σb_k invariant); surviving workers keep their controller state.
    """

    step: int
    worker: int

    def apply(self, trainer) -> None:
        trainer.remove_worker(self.worker)


@dataclasses.dataclass(frozen=True)
class AddWorker:
    """A (possibly different-sized) replacement joins before ``step`` runs.

    The newcomer starts from the current model replica and receives a
    throughput-proportional slice of the invariant global batch.
    """

    step: int
    spec: WorkerSpec

    def apply(self, trainer) -> None:
        trainer.add_worker(self.spec)


@dataclasses.dataclass(frozen=True)
class SlowWorker:
    """Multiplicative slowdown of ``worker`` (``factor`` > 1 = slower).

    Models slow-degrading spot instances and transient stragglers
    (DESIGN.md §16) — heterogeneity that changes *without* a membership
    change.  ``factor`` composes multiplicatively, so a later event with
    the reciprocal factor restores the worker exactly; `compile_churn`
    lowers a gradual degradation into a staircase of these.  On the sim
    backend this scales the worker's modelled speed; on the mesh backend
    it scales the worker's emulation dilation.
    """

    step: int
    worker: int
    factor: float

    def apply(self, trainer) -> None:
        trainer.slow_worker(self.worker, self.factor)


@dataclasses.dataclass(frozen=True)
class Reallocate:
    """Churn replan: re-split the invariant global batch through the
    price/capacity-aware allocator (`core.allocation.cost_aware_allocation`)
    while PRESERVING controller state (EWMA windows, adaptive b_max).

    Emitted by `compile_churn` after every step that changed the cluster,
    so reallocation after churn is cost-aware by construction instead of
    waiting for the inner control loop to re-learn the new fleet shape.
    """

    step: int

    def apply(self, trainer) -> None:
        trainer.reallocate_cost_aware()


@dataclasses.dataclass(frozen=True)
class At:
    """Escape hatch: run an arbitrary ``fn(trainer)`` before ``step``.

    For events the typed vocabulary doesn't cover (e.g. swapping an
    availability trace mid-run).  Prefer the typed events — they are
    inspectable data; this is an opaque callback.
    """

    step: int
    fn: Callable

    def apply(self, trainer) -> None:
        self.fn(trainer)


ClusterEvent = Union[AddWorker, RemoveWorker, SlowWorker, Reallocate, At]


# ------------------------------------------------------------ cluster spec


@dataclasses.dataclass
class ClusterSpec:
    """Declarative description of a heterogeneous cluster.

    ``workload`` names the simulator *cost model* (a ``WORKLOADS`` key or a
    :class:`WorkloadModel`) — how long an iteration takes; it is distinct
    from the API-level :class:`~repro_torch.api.workload.Workload`, which defines
    the real SGD computation.

    ``backend`` selects the execution substrate: ``None`` means
    ``SimBackend()`` on the CUDA card (iteration times from the calibrated
    simulator); ``SimBackend(device="cpu")`` runs the same experiment on the
    CPU.  The measured backend is a later slice of the port.

    """

    workers: list[WorkerSpec]
    workload: Union[str, WorkloadModel] = "mnist-cnn"
    noise: float = 0.02
    seed: int = 0
    schedule: list[ClusterEvent] = dataclasses.field(default_factory=list)
    backend: Optional[object] = None   # Backend protocol; None -> SimBackend

    # ------------------------------------------------------- constructors

    @classmethod
    def explicit(cls, workers: Sequence[WorkerSpec], **kw) -> "ClusterSpec":
        """From an explicit list of :class:`WorkerSpec`."""
        return cls(workers=list(workers), **kw)

    @classmethod
    def hlevel(cls, total_cores: int, h_level: float, k: int = 3,
               **kw) -> "ClusterSpec":
        """K CPU workers, max/min core ratio = ``h_level``, same total
        capacity (paper §IV-A)."""
        return cls(workers=hlevel_cluster(total_cores, h_level, k), **kw)

    @classmethod
    def homogeneous(cls, total_cores: int, k: int = 3, **kw) -> "ClusterSpec":
        """K equal workers — the paper's H=1 baseline."""
        return cls(workers=homogeneous_cluster(total_cores, k), **kw)

    @classmethod
    def mixed_gpu_cpu(cls, **kw) -> "ClusterSpec":
        """One P100-class GPU + one 48-core Xeon (paper §IV-B)."""
        spec_kw = {k: kw.pop(k) for k in ("flops_split", "cpu_cores",
                                          "amdahl_p") if k in kw}
        return cls(workers=mixed_gpu_cpu_cluster(**spec_kw), **kw)

    # ------------------------------------------------------- with_* methods

    def with_trace(self, worker: int, trace) -> "ClusterSpec":
        """Attach a dynamic availability trace to one worker (in place)."""
        self.workers[worker].trace = trace
        return self

    def with_schedule(self, *events: ClusterEvent) -> "ClusterSpec":
        """Append membership events; kept sorted by step (stable, so
        same-step events apply in the order given)."""
        for ev in events:
            if not hasattr(ev, "step") or not hasattr(ev, "apply"):
                raise TypeError(
                    f"schedule events need .step and .apply(trainer); got "
                    f"{ev!r} — use AddWorker/RemoveWorker/At")
        self.schedule = sorted([*self.schedule, *events],
                               key=lambda e: e.step)
        return self

    # ------------------------------------------------------------- build

    @property
    def sim_workload(self) -> WorkloadModel:
        if isinstance(self.workload, WorkloadModel):
            return self.workload
        try:
            return WORKLOADS[self.workload]
        except KeyError:
            raise ValueError(
                f"unknown simulator workload {self.workload!r}; known: "
                f"{sorted(WORKLOADS)}") from None

    def build(self) -> ClusterSim:
        """Fresh simulator: copy of the worker list, fresh jitter stream."""
        return ClusterSim(list(self.workers), self.sim_workload,
                          noise=self.noise, seed=self.seed)
