"""Shape-stable variable batching for SPMD workers (TPU adaptation).

The paper resizes a worker's mini-batch tensor directly (TF kill-restart).
XLA/SPMD programs need static shapes, so a worker's batch b_k is realized as

    b_k = n_k * m + r_k,   0 <= r_k < m

i.e. ``n_k`` full microbatches of fixed shape ``m`` plus one *remainder*
microbatch in which only the first ``r_k`` examples carry weight (the rest
are masked out of the loss and gradient). Changing b_k means changing two
host-side scalars — no recompilation, no kill-restart. This is the key
mechanism that makes the paper's controller zero-cost on TPU (DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class MicrobatchPlan:
    """Decomposition of one worker's batch into fixed-shape microbatches."""

    batch: int            # b_k
    microbatch: int       # m (static shape)
    n_full: int           # n_k full microbatches
    remainder: int        # r_k in [0, m)

    @property
    def n_steps(self) -> int:
        """Number of microbatch executions (incl. the masked remainder)."""
        return self.n_full + (1 if self.remainder > 0 else 0)

    @property
    def padded_examples(self) -> int:
        return self.n_steps * self.microbatch

    def masks(self) -> np.ndarray:
        """(n_steps, m) float32 validity mask; row i masks microbatch i."""
        masks = np.ones((self.n_steps, self.microbatch), dtype=np.float32)
        if self.remainder > 0:
            masks[-1, self.remainder:] = 0.0
        return masks


def plan_microbatches(batch: int, microbatch: int) -> MicrobatchPlan:
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")
    return MicrobatchPlan(
        batch=batch,
        microbatch=microbatch,
        n_full=batch // microbatch,
        remainder=batch % microbatch,
    )


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Cluster-wide plan: one MicrobatchPlan per worker + lambda weights."""

    per_worker: tuple[MicrobatchPlan, ...]

    @property
    def batches(self) -> list[int]:
        return [p.batch for p in self.per_worker]

    @property
    def global_batch(self) -> int:
        return sum(p.batch for p in self.per_worker)

    @property
    def weights(self) -> list[float]:
        g = self.global_batch
        return [p.batch / g for p in self.per_worker]


def plan_cluster(batches: Sequence[int], microbatch: int) -> BatchPlan:
    return BatchPlan(tuple(plan_microbatches(b, microbatch) for b in batches))


# ------------------------------------------------------------ bucket ladder
#
# The mesh execution backend (DESIGN.md §11) pads each worker's mini-batch
# up to a *bucketed* shape so recompiles stay bounded while the controller
# drifts b_k continuously.  Rungs grow geometrically (each rung >= growth x
# the previous) and are rounded up to a multiple of `quantum` (the mesh
# data-axis size, so every padded batch shards evenly):
#
#     r_0 = quantum * ceil(base / quantum)
#     r_{j+1} = max(r_j + quantum, quantum * ceil(r_j * growth / quantum))
#
# Because r_{j+1} >= r_j * growth, the number of distinct rungs a worker can
# visit while its batch ranges over [b_min, b_max] is at most
# ceil(log_growth(bucket(b_max) / bucket(b_min))) + 1 = O(log(b_max/b_min))
# — the compile-count bound the property tests assert.


def bucket_up(batch: int, *, base: int = 1, growth: float = 1.25,
              quantum: int = 1) -> int:
    """Smallest ladder rung >= ``batch`` (see the ladder recurrence above)."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if quantum < 1:
        raise ValueError(f"quantum must be >= 1, got {quantum}")
    if growth <= 1.0:
        raise ValueError(f"growth must be > 1, got {growth}")
    rung = quantum * -(-max(base, 1) // quantum)
    while rung < batch:
        rung = max(rung + quantum, quantum * math.ceil(rung * growth / quantum))
    return rung


def bucket_ladder(b_max: int, *, base: int = 1, growth: float = 1.25,
                  quantum: int = 1) -> list[int]:
    """All rungs up to (and covering) ``b_max`` — the set of compiled shapes
    a worker can ever see while its batch stays within [1, b_max]."""
    rungs = [bucket_up(1, base=base, growth=growth, quantum=quantum)]
    while rungs[-1] < b_max:
        rungs.append(max(rungs[-1] + quantum,
                         quantum * math.ceil(rungs[-1] * growth / quantum)))
    return rungs


def example_weight_vector(
    batches: Sequence[int], capacity_per_worker: int
) -> np.ndarray:
    """Per-example weights for the SPMD (single-program) dry-run mode.

    Returns a (K * capacity,) float32 vector where worker k's first b_k slots
    are 1.0 and the rest 0.0. Used by `spmd`-mode train_step, whose loss is a
    weighted mean — that reproduces Eq. 2-3's lambda weighting exactly.
    """
    k = len(batches)
    w = np.zeros((k, capacity_per_worker), dtype=np.float32)
    for i, b in enumerate(batches):
        if b > capacity_per_worker:
            raise ValueError(
                f"worker {i} batch {b} exceeds capacity {capacity_per_worker}"
            )
        w[i, :b] = 1.0
    return w.reshape(-1)
