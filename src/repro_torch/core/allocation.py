"""Static (open-loop) mini-batch allocation (paper §III-B).

Given a heterogeneous cluster of K workers with estimated throughputs X_k
(CPU cores for CPU-only clusters, half-precision FLOP/s for mixed clusters),
assign b_k = b0 * K * X_k / sum_i X_i so that sum_k b_k = K * b0 — the global
batch size is invariant to variable batching.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence


def largest_remainder_round(
    values: Sequence[float],
    total: Optional[int],
    lo: int = 1,
    hi: Optional[Sequence[int]] = None,
) -> list[int]:
    """Round positive reals to ints, optionally conserving an exact total.

    Largest-remainder (Hamilton) apportionment with per-entry [lo, hi_k]
    bounds. Used everywhere a real-valued batch plan must become an integer
    plan without changing the global batch size.
    """
    k = len(values)
    if k == 0:
        return []
    his = list(hi) if hi is not None else [10**12] * k
    if total is not None:
        if total < lo * k:
            raise ValueError(f"total {total} infeasible with lo={lo} x {k} workers")
        if total > sum(his):
            # bounds make the total infeasible: relax hi proportionally
            his = [max(h, math.ceil(total * h / max(sum(his), 1))) for h in his]

    floors = [max(lo, min(int(math.floor(v)), h)) for v, h in zip(values, his)]
    if total is None:
        # plain bounded rounding
        return [max(lo, min(int(round(v)), h)) for v, h in zip(values, his)]

    remainder = total - sum(floors)
    # distribute the remainder (can be negative if bounds clipped upward)
    order = sorted(
        range(k), key=lambda i: (values[i] - math.floor(values[i])), reverse=True
    )
    out = list(floors)
    step = 1 if remainder > 0 else -1
    guard = 0
    while remainder != 0:
        progressed = False
        for i in order:
            if remainder == 0:
                break
            cand = out[i] + step
            if lo <= cand <= his[i]:
                out[i] = cand
                remainder -= step
                progressed = True
        guard += 1
        if not progressed or guard > 10**6:
            raise ValueError("could not apportion batches within bounds")
    return out


def static_allocation(
    throughputs: Sequence[float],
    b0: int,
    b_min: int = 1,
    b_max: Optional[int] = None,
) -> list[int]:
    """Paper Eq: b_k = b0 * X_k / mean(X). Conserves sum(b_k) == K * b0."""
    k = len(throughputs)
    if k == 0:
        raise ValueError("need at least one worker")
    if any(x <= 0 for x in throughputs):
        raise ValueError(f"throughputs must be positive: {throughputs}")
    if b0 < 1:
        raise ValueError("b0 must be >= 1")
    total = k * b0
    s = sum(throughputs)
    ideal = [total * x / s for x in throughputs]
    his = [b_max if b_max is not None else total] * k
    return largest_remainder_round(ideal, total, lo=b_min, hi=his)


def flops_proportional_allocation(
    peak_flops: Sequence[float], b0: int, **kw
) -> list[int]:
    """Mixed CPU/GPU (paper: half-precision FLOPs as the throughput proxy)."""
    return static_allocation(peak_flops, b0, **kw)


def cores_proportional_allocation(cores: Sequence[int], b0: int, **kw) -> list[int]:
    """CPU-only clusters (paper: batch sizes proportional to core counts)."""
    return static_allocation([float(c) for c in cores], b0, **kw)


def cost_aware_allocation(
    throughputs: Sequence[float],
    total: int,
    *,
    capacities: Optional[Sequence[Optional[int]]] = None,
    prices: Optional[Sequence[float]] = None,
    b_min: int = 1,
) -> list[int]:
    """Price/capacity-aware split of ``total`` examples across K workers.

    Starts from the throughput-proportional ideal (paper §III-B), caps each
    worker at its capacity (the b_mem memory cliff — feeding past it LOWERS
    throughput, paper Fig. 5), then redistributes the capped surplus over
    workers with headroom, weighted by throughput per unit price (spot $/hr;
    uniform prices reduce to pure throughput weighting).  The final integer
    plan conserves ``total`` exactly via largest-remainder apportionment; if
    every capacity saturates, the bounds are relaxed proportionally rather
    than failing (the caller asked for that global batch).

    This is the allocator the OUTER global-batch controller routes its
    initial B_global through (DESIGN.md §15) instead of the uniform
    fallback.
    """
    k = len(throughputs)
    if k == 0:
        raise ValueError("need at least one worker")
    if any(x <= 0 for x in throughputs):
        raise ValueError(f"throughputs must be positive: {throughputs}")
    if total < b_min * k:
        raise ValueError(f"total {total} infeasible with b_min={b_min} x {k}")
    caps = [
        (int(c) if c is not None else 10**12)
        for c in (capacities if capacities is not None else [None] * k)
    ]
    if len(caps) != k:
        raise ValueError("need one capacity per worker")
    if any(c < b_min for c in caps):
        raise ValueError(f"capacities must be >= b_min={b_min}: {caps}")
    costs = list(prices) if prices is not None else [1.0] * k
    if len(costs) != k:
        raise ValueError("need one price per worker")
    if any(p <= 0 for p in costs):
        raise ValueError(f"prices must be positive: {costs}")

    s = sum(throughputs)
    vals = [min(total * x / s, float(c)) for x, c in zip(throughputs, caps)]
    remaining = total - sum(vals)
    # redistribute capped surplus by value density (throughput per dollar)
    for _ in range(k + 1):
        if remaining <= 1e-9:
            break
        weights = [
            (x / p) if v < c else 0.0
            for x, p, v, c in zip(throughputs, costs, vals, caps)
        ]
        ws = sum(weights)
        if ws <= 0:
            break  # everyone saturated; largest_remainder_round relaxes hi
        placed = 0.0
        for i in range(k):
            if weights[i] <= 0:
                continue
            take = min(remaining * weights[i] / ws, caps[i] - vals[i])
            vals[i] += take
            placed += take
        remaining -= placed
        if placed <= 1e-12:
            break
    return largest_remainder_round(vals, total, lo=b_min, hi=caps)


def gradient_weights(batches: Sequence[int]) -> list[float]:
    """lambda_k = b_k / sum_i b_i  (paper Eq. 2). sum(lambda) == 1."""
    s = sum(batches)
    if s <= 0:
        raise ValueError("global batch must be positive")
    return [b / s for b in batches]
