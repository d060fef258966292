"""ClusterSpec: where to train — a declarative heterogeneous cluster.

Describes the simulated cluster (worker resources, cost model, noise,
availability traces) plus a first-class *membership schedule* of typed
events.  A spec is data: every ``build()`` returns a fresh
:class:`~repro_torch.het.simulator.ClusterSim` with a fresh jitter stream.

Spot-market churn is lowered into that schedule by :func:`compile_churn`
and attached with ``ClusterSpec.with_churn``.  ``serve=`` co-locates a
continuous-batching decode loop on the measured backend's devices
(:class:`~repro_torch.serve.colocate.ServeSpec`).
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
from repro_torch.serve.colocate import ServeSpec

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


# ----------------------------------------------------- churn-trace lowering


@dataclasses.dataclass
class ChurnSchedule:
    """A spot-market churn trace lowered into typed membership events.

    ``events`` is ready for :meth:`ClusterSpec.with_schedule`; ``dropped``
    records market events the compiler had to skip (a preemption that
    would take the fleet below ``min_workers``, a degradation aimed at an
    emptied zone) so storms are auditable rather than silently truncated.
    Both backends replay the same compiled schedule, so a churn storm is
    bit-reproducible across ``SimBackend`` and ``MeshBackend``.
    """

    events: list
    trace: object        # the source repro_torch.het.spot.ChurnTrace
    dropped: list = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        kinds: dict[str, int] = {}
        for ev in self.events:
            kinds[type(ev).__name__] = kinds.get(type(ev).__name__, 0) + 1
        return {"events": len(self.events), "dropped": len(self.dropped),
                **kinds}


def compile_churn(trace, *, start_step: int = 0, min_workers: int = 1,
                  reallocate: bool = True, ramp_stairs: int = 3,
                  spec_for=None) -> ChurnSchedule:
    """Lower a :class:`repro_torch.het.spot.ChurnTrace` into the typed
    schedule.

    The compiler tracks a model of the live fleet (zone-major initial
    order, matching ``SpotMarket.initial_fleet()``) so market events keyed
    by (zone, slot) become events keyed by the *worker index valid at that
    step* — the same index arithmetic both trainers apply:

      * ``Preempt(zone)``      -> ``RemoveWorker`` of the zone's
        most-recently-acquired instance (LIFO, how spot reclaims behave);
        skipped (recorded in ``dropped``) if it would leave fewer than
        ``min_workers``;
      * ``Rejoin(zone, price)`` -> ``AddWorker`` with a spec carrying the
        rejoin-time spot price (feeds cost-aware reallocation);
      * ``Degrade``            -> a ``ramp_stairs``-deep staircase of
        multiplicative :class:`SlowWorker` events (geometric sub-factors)
        plus a full restore after the hold — the ramp composition of
        DESIGN.md §16; dropped early if the target is preempted mid-ramp;
      * ``Straggle``           -> one ``SlowWorker`` + its reciprocal.

    After every step that changed the cluster one :class:`Reallocate` is
    appended (unless ``reallocate=False``), routing the new split through
    ``cost_aware_allocation``.  ``start_step`` offsets the whole schedule,
    e.g. to replay a trace against a warm checkpoint.
    """
    zones = {z.name: z for z in trace.zones}
    if spec_for is None:
        def spec_for(zone, price):
            return WorkerSpec(cores=zone.cores, kind=zone.kind,
                              b_mem=zone.b_mem,
                              price=max(float(price), 1e-3))
    # live fleet model: (zone_name, entry_id), zone-major like initial_fleet
    fleet: list[tuple[str, int]] = []
    next_id = 0
    for z in trace.zones:
        for _ in range(z.workers):
            fleet.append((z.name, next_id))
            next_id += 1
    by_step: dict[int, list] = {}
    for ev in trace.events:
        by_step.setdefault(ev.step, []).append(ev)
    # pending slowdown staircase entries: (fire_step, entry_id, factor)
    pending: list[tuple[int, int, float]] = []
    out: list = []
    dropped: list = []

    def index_of(eid: int):
        for i, (_, e) in enumerate(fleet):
            if e == eid:
                return i
        return None

    step = 1
    while step < trace.horizon or pending:
        changed = False
        # market membership first, so a preemption this step cancels the
        # departed worker's pending slowdown entries before they fire
        for ev in by_step.get(step, ()):
            kind = type(ev).__name__
            if kind == "Preempt":
                live = [i for i, (zn, _) in enumerate(fleet)
                        if zn == ev.zone]
                if not live or len(fleet) <= min_workers:
                    dropped.append(ev)
                    continue
                idx = live[-1]          # LIFO within the zone
                _, eid = fleet.pop(idx)
                pending = [p for p in pending if p[1] != eid]
                out.append(RemoveWorker(step=start_step + step, worker=idx))
                changed = True
            elif kind == "Rejoin":
                out.append(AddWorker(step=start_step + step,
                                     spec=spec_for(zones[ev.zone],
                                                   ev.price)))
                fleet.append((ev.zone, next_id))
                next_id += 1
                changed = True
            elif kind in ("Degrade", "Straggle"):
                live = [i for i, (zn, _) in enumerate(fleet)
                        if zn == ev.zone]
                if not live:
                    dropped.append(ev)
                    continue
                eid = fleet[live[ev.slot % len(live)]][1]
                if kind == "Straggle":
                    pending.append((step, eid, float(ev.factor)))
                    pending.append((step + max(ev.hold_steps, 1), eid,
                                    1.0 / float(ev.factor)))
                else:
                    stairs = max(1, min(ramp_stairs, ev.ramp_steps))
                    sub = float(ev.factor) ** (1.0 / stairs)
                    for i in range(stairs):
                        pending.append(
                            (step + i * ev.ramp_steps // stairs, eid, sub))
                    pending.append(
                        (step + ev.ramp_steps + max(ev.hold_steps, 1), eid,
                         1.0 / float(ev.factor)))
            else:
                raise TypeError(f"unknown churn event {ev!r}")
        # slowdown staircase entries due now (for still-live workers)
        due = sorted((p for p in pending if p[0] <= step),
                     key=lambda p: p[0])
        pending = [p for p in pending if p[0] > step]
        for _, eid, factor in due:
            idx = index_of(eid)
            if idx is None:
                continue
            out.append(SlowWorker(step=start_step + step, worker=idx,
                                  factor=factor))
            changed = True
        if changed and reallocate:
            out.append(Reallocate(step=start_step + step))
        step += 1
    return ChurnSchedule(events=out, trace=trace, dropped=dropped)


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
    CPU; ``MeshBackend(...)`` runs it with measured iteration times
    (``repro_torch.train.mesh``), replaying the membership schedule through
    the mesh trainer's ``remove_worker`` / ``add_worker`` / ``slow_worker``
    / ``reallocate_cost_aware``.

    ``serve`` co-locates a continuous-batching decode loop on the same
    devices (:class:`~repro_torch.serve.colocate.ServeSpec`, DESIGN.md
    §13): it time-multiplexes the last worker's devices (shared mode, the
    batch controller re-equalizing around the decode interference) or
    owns devices withheld from training (dedicated mode, resized by the
    SLO policy); decode latency percentiles are reported in the run
    result.  Mesh backend + ``sync="bsp"`` only.
    """

    workers: list[WorkerSpec]
    workload: Union[str, WorkloadModel] = "mnist-cnn"
    noise: float = 0.02
    seed: int = 0
    schedule: list[ClusterEvent] = dataclasses.field(default_factory=list)
    backend: Optional[object] = None   # Backend protocol; None -> SimBackend
    serve: Optional[ServeSpec] = None  # co-located serving (mesh only)

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

    def with_churn(self, churn: "ChurnSchedule") -> "ClusterSpec":
        """Append a compiled spot-market churn schedule (DESIGN.md §16).

        ``churn`` comes from :func:`compile_churn` over a
        ``repro_torch.het.spot.ChurnTrace``; the spec's worker list should
        be the market's ``initial_fleet()`` so compiled indices line up."""
        return self.with_schedule(*churn.events)

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
