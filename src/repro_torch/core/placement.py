"""Worker → device-slice placement along the mesh data axis (DESIGN.md
§12-§13).

The concurrent mesh execution path (`repro_torch.train.mesh.MeshTrainer`,
the measured backend's slice of the port) gives
each of the K logical workers a *disjoint, contiguous* run of devices along
the (flattened) mesh data axis, so the workers' bucketed gradient calls
dispatch concurrently and a BSP round costs max-of-workers wall time
instead of sum-of-workers.  This module owns the assignment math:

  * a :class:`SlicePlan` is data — ``(start, length)`` per worker over a
    data axis of ``extent`` devices, allocated in whole multiples of
    ``quantum`` devices (the unit a slice may not split: 1 for a flat data
    axis; a pod's data extent when slices must not straddle pods);
  * the plan is always **disjoint** (no device serves two workers),
    **exhaustive** (every data-axis device belongs to exactly one worker),
    and **quantum-aligned** (every start/length is a multiple of
    ``quantum``) — invariants enforced at construction, so a violated plan
    cannot exist;
  * membership changes *rebalance*: :meth:`SlicePlan.remove` hands the
    departed worker's devices to the survivors proportionally to their
    current shares, :meth:`SlicePlan.add` carves an average-sized slice for
    the newcomer — both through the same largest-remainder apportionment
    (`core.allocation`) the batch planner uses, so device shares round the
    same way batch shares do.

A worker's slice length is also its *bucket quantum*: padded batches must
shard evenly over the slice, so `MeshTrainer` anchors worker k's bucket
ladder at ``lengths[k]`` (see DESIGN.md §12 for why the ladder bound is
preserved per worker).

Co-located serving (DESIGN.md §13) carves a :class:`ServeSlice` out of the
same axis via :func:`carve_serve`: either a *dedicated* run of devices
withheld from training at the top of the axis (training tiles the rest),
or a *shared* slice that time-multiplexes the last training worker's
devices — the decode loop's device time then shows up in that worker's
measured step time exactly like background-tenant interference in the
paper's experiments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.allocation import largest_remainder_round


@dataclasses.dataclass(frozen=True)
class SlicePlan:
    """Disjoint contiguous device slices tiling [0, extent) on the data axis.

    ``slices[k] = (start, length)`` in device units; worker k owns data-axis
    indices ``[start, start + length)`` (every model-axis device column at
    those indices).  Construct via :func:`plan_slices` or the
    :meth:`remove` / :meth:`add` rebalancers — the constructor validates the
    disjoint/exhaustive/aligned invariants and raises on any violation.
    """

    extent: int                              # data-axis devices
    quantum: int                             # allocation unit (devices)
    slices: tuple[tuple[int, int], ...]      # per-worker (start, length)

    def __post_init__(self) -> None:
        if self.extent < 1:
            raise ValueError(f"extent must be >= 1, got {self.extent}")
        if self.quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {self.quantum}")
        if self.extent % self.quantum:
            raise ValueError(
                f"extent {self.extent} is not a multiple of quantum "
                f"{self.quantum}")
        if not self.slices:
            raise ValueError("a plan needs at least one worker slice")
        cursor = 0
        for k, (start, length) in enumerate(self.slices):
            if start != cursor:
                raise ValueError(
                    f"slice {k} starts at {start}, expected {cursor} — "
                    f"slices must tile the axis contiguously (disjoint + "
                    f"exhaustive)")
            if length < self.quantum or length % self.quantum:
                raise ValueError(
                    f"slice {k} length {length} is not a positive multiple "
                    f"of quantum {self.quantum}")
            cursor += length
        if cursor != self.extent:
            raise ValueError(
                f"slices cover {cursor} devices, data axis has {self.extent}")

    # ------------------------------------------------------------- queries

    @property
    def k(self) -> int:
        return len(self.slices)

    @property
    def lengths(self) -> list[int]:
        return [length for _, length in self.slices]

    def devices_of(self, worker: int) -> range:
        start, length = self.slices[worker]
        return range(start, start + length)

    # --------------------------------------------------------- rebalancing

    def remove(self, worker: int) -> "SlicePlan":
        """Preemption: the departed worker's devices are reabsorbed by the
        survivors proportionally to their current shares."""
        if not (0 <= worker < self.k):
            raise ValueError(f"no worker {worker} in a {self.k}-slice plan")
        if self.k <= 1:
            raise ValueError("cannot remove the last worker's slice")
        survivors = [length for j, (_, length) in enumerate(self.slices)
                     if j != worker]
        return plan_slices(self.extent, self.k - 1, weights=survivors,
                           quantum=self.quantum)

    def add(self, weight: Optional[float] = None) -> "SlicePlan":
        """A joiner (appended last) gets an average-sized share unless a
        ``weight`` on the existing workers' length scale says otherwise."""
        lengths = self.lengths
        newcomer = float(sum(lengths)) / len(lengths) if weight is None \
            else float(weight)
        if newcomer <= 0:
            raise ValueError(f"joiner weight must be positive, got {weight}")
        return plan_slices(self.extent, self.k + 1,
                           weights=[*lengths, newcomer],
                           quantum=self.quantum)


def plan_slices(extent: int, k: int,
                weights: Optional[Sequence[float]] = None, *,
                quantum: int = 1) -> SlicePlan:
    """Apportion ``extent`` data-axis devices over ``k`` workers.

    ``weights`` bias the split (e.g. survivors' previous lengths during a
    rebalance); ``None`` means equal shares.  Every worker gets at least one
    ``quantum`` of devices, so ``k`` may not exceed ``extent // quantum`` —
    the caller (`MeshTrainer`) falls back to time-multiplexing the full
    axis when it does.
    """
    if k < 1:
        raise ValueError(f"need at least one worker, got {k}")
    if quantum < 1:
        raise ValueError(f"quantum must be >= 1, got {quantum}")
    if extent < 1 or extent % quantum:
        raise ValueError(
            f"extent {extent} must be a positive multiple of quantum "
            f"{quantum}")
    units = extent // quantum
    if k > units:
        raise ValueError(
            f"{k} workers need {k} x {quantum} devices, data axis has "
            f"{extent} — not enough for disjoint slices")
    if weights is None:
        weights = [1.0] * k
    if len(weights) != k:
        raise ValueError(f"{len(weights)} weights for {k} workers")
    if any(w <= 0 for w in weights):
        raise ValueError(f"weights must be positive, got {list(weights)}")
    total = float(sum(weights))
    unit_shares = largest_remainder_round(
        [units * w / total for w in weights], units, lo=1)
    slices, cursor = [], 0
    for u in unit_shares:
        length = u * quantum
        slices.append((cursor, length))
        cursor += length
    return SlicePlan(extent=extent, quantum=quantum, slices=tuple(slices))


# ------------------------------------------------------ multi-tenant pool


class DevicePool:
    """Shared device pool: multiple tenants lease runs of one data axis.

    The multi-tenant generalization of the single-plan model above
    (DESIGN.md §16): where a :class:`SlicePlan` tiles the axis for ONE
    training fleet, a pool arbitrates the axis between *tenants* — a
    training ``Session``, a co-located serve slice, a second experiment —
    each of which then plans its own slices inside its lease.

    Invariants (checked by :meth:`check`, property-tested in
    tests/test_placement.py):

      * leases are **disjoint** contiguous runs, **quantum-aligned**, and
        **packed** end-to-end from device 0 in lease order — free capacity
        is always one contiguous run at the top of the axis;
      * every lease keeps at least one quantum, and the sum of leases
        never exceeds ``extent``.

    Resizing or releasing a middle lease shifts later tenants down to keep
    the packing invariant; each tenant whose *start* moves counts as one
    migration (``migrations`` — callers use it to price reconfiguration,
    the pool-level analogue of the §11 recompile bound).
    """

    def __init__(self, extent: int, *, quantum: int = 1):
        if extent < 1:
            raise ValueError(f"extent must be >= 1, got {extent}")
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        if extent % quantum:
            raise ValueError(
                f"extent {extent} is not a multiple of quantum {quantum}")
        self.extent = int(extent)
        self.quantum = int(quantum)
        self._leases: dict[str, int] = {}   # tenant -> devices, lease order
        self.migrations = 0

    # ------------------------------------------------------------- queries

    @property
    def tenants(self) -> list[str]:
        return list(self._leases)

    @property
    def leased(self) -> int:
        return sum(self._leases.values())

    @property
    def free(self) -> int:
        return self.extent - self.leased

    def _starts(self) -> dict[str, int]:
        starts, cursor = {}, 0
        for tenant, n in self._leases.items():
            starts[tenant] = cursor
            cursor += n
        return starts

    def region(self, tenant: str) -> tuple[int, int]:
        """(start, length) of the tenant's current lease."""
        if tenant not in self._leases:
            raise KeyError(f"no lease for tenant {tenant!r}; "
                           f"active: {self.tenants}")
        return self._starts()[tenant], self._leases[tenant]

    def regions(self) -> dict[str, tuple[int, int]]:
        """Every tenant's (start, length) in lease order — the full packed
        layout in one pass (the serve-region snapshot
        :meth:`repro_torch.serve.slots.KVSlotManager.stats` reports, §17;
        the serving slice of the port)."""
        starts = self._starts()
        return {t: (starts[t], n) for t, n in self._leases.items()}

    def plan(self, tenant: str, k: int,
             weights: Optional[Sequence[float]] = None) -> SlicePlan:
        """A :class:`SlicePlan` over the tenant's lease (lease-local device
        coordinates — add the region start for axis-global indices)."""
        _, length = self.region(tenant)
        return plan_slices(length, k, weights, quantum=self.quantum)

    # -------------------------------------------------------------- leases

    def _validated(self, tenant: str, devices: int) -> int:
        if devices < self.quantum or devices % self.quantum:
            raise ValueError(
                f"tenant {tenant!r} lease of {devices} devices must be a "
                f"positive multiple of quantum {self.quantum}")
        return int(devices)

    def lease(self, tenant: str, devices: int) -> tuple[int, int]:
        """Grant ``devices`` to a new tenant; returns its (start, length)."""
        if tenant in self._leases:
            raise ValueError(
                f"tenant {tenant!r} already holds a lease — use resize()")
        devices = self._validated(tenant, devices)
        if devices > self.free:
            raise ValueError(
                f"tenant {tenant!r} wants {devices} devices, pool has "
                f"{self.free} free of {self.extent}")
        self._leases[tenant] = devices
        return self.region(tenant)

    def _repack(self, before: dict[str, int]) -> None:
        after = self._starts()
        self.migrations += sum(
            1 for t, s in after.items() if before.get(t, s) != s)

    def release(self, tenant: str) -> None:
        """Return the tenant's devices; later tenants shift down (packed)."""
        self.region(tenant)  # raises on unknown tenant
        before = self._starts()
        del self._leases[tenant]
        self._repack(before)

    def resize(self, tenant: str, devices: int) -> tuple[int, int]:
        """Grow or shrink a lease in place; later tenants shift to repack."""
        self.region(tenant)
        devices = self._validated(tenant, devices)
        if devices > self.free + self._leases[tenant]:
            raise ValueError(
                f"tenant {tenant!r} wants {devices} devices, pool has "
                f"{self.free + self._leases[tenant]} available")
        before = self._starts()
        self._leases[tenant] = devices
        self._repack(before)
        return self.region(tenant)

    # ----------------------------------------------------------- invariants

    def check(self) -> None:
        """Raise if any pool invariant is violated (defense in depth — the
        mutators above cannot produce a violating state)."""
        cursor = 0
        for tenant, n in self._leases.items():
            if n < self.quantum or n % self.quantum:
                raise ValueError(
                    f"lease {tenant!r}={n} violates quantum {self.quantum}")
            cursor += n
        if cursor > self.extent:
            raise ValueError(
                f"leases cover {cursor} devices, pool has {self.extent}")


# ------------------------------------------------------- co-located serving


@dataclasses.dataclass(frozen=True)
class ServeSlice:
    """Devices the co-located decode loop owns (DESIGN.md §13).

    ``[start, start + length)`` on the flattened data axis.  ``shared_with``
    names the training worker whose devices the decode loop time-multiplexes
    (its decode seconds are charged to that worker's measured step time);
    ``None`` means the slice is *dedicated* — withheld from training
    placement entirely, so interference shows up as fewer training devices
    instead of stolen device time.
    """

    start: int
    length: int
    shared_with: Optional[int] = None

    def __post_init__(self) -> None:
        if self.start < 0 or self.length < 1:
            raise ValueError(
                f"serve slice ({self.start}, {self.length}) must have a "
                f"non-negative start and positive length")

    @property
    def dedicated(self) -> bool:
        return self.shared_with is None

    def devices(self) -> range:
        return range(self.start, self.start + self.length)


def carve_serve(extent: int, k: int, serve_devices: int, *,
                mode: str = "dedicated", quantum: int = 1,
                weights: Optional[Sequence[float]] = None,
                ) -> tuple[SlicePlan, ServeSlice]:
    """Carve a serve slice out of the data axis; plan training on the rest.

    ``mode="dedicated"``: the top ``serve_devices`` devices are withheld
    from training and the K training workers tile ``extent -
    serve_devices``.  The serve slice may never consume the whole axis —
    training fully preempted is a configuration error, reported clearly
    instead of producing an empty plan.

    ``mode="shared"``: training tiles the full axis and the decode loop
    time-multiplexes the LAST worker's slice (``serve_devices`` is ignored
    beyond validation); that worker is the *contended* worker whose
    measured times absorb the decode interference (DESIGN.md §13).
    """
    if mode not in ("dedicated", "shared"):
        raise ValueError(f"mode must be 'dedicated' or 'shared', got {mode!r}")
    if serve_devices < 0:
        raise ValueError(
            f"serve_devices must be >= 0, got {serve_devices}")
    if mode == "shared":
        plan = plan_slices(extent, k, weights, quantum=quantum)
        start, length = plan.slices[-1]
        return plan, ServeSlice(start, length, shared_with=k - 1)
    if serve_devices < quantum or serve_devices % quantum:
        raise ValueError(
            f"dedicated serve slice needs a positive multiple of quantum "
            f"{quantum} devices, got {serve_devices}")
    train_extent = extent - serve_devices
    if train_extent < 1:
        raise ValueError(
            f"serve slice of {serve_devices} devices consumes the whole "
            f"{extent}-device data axis — training would be fully "
            f"preempted; shrink the serve slice or use mode='shared'")
    plan = plan_slices(train_extent, k, weights, quantum=quantum)
    return plan, ServeSlice(train_extent, serve_devices, shared_with=None)
