"""Gradient-noise-scale estimator from per-worker gradient moments.

The small-batch / large-batch critical-batch statistic (McCandlish et al.,
"An Empirical Model of Large-Batch Training"; see DESIGN.md §15): for a
worker-k mean gradient g_k over b_k examples and the lambda-weighted combine
g over B = sum_k b_k examples,

    E[|g_k|^2] = |G|^2 + S / b_k          (S = tr(Sigma), per-example noise)
    E[|g|^2]   = |G|^2 + S / B

The heterogeneity split gives us BOTH estimates for free every step: the
lambda-weighted average of the per-worker squared norms is a "small batch"
measurement with effective batch B_small = B / K,

    sum_k lambda_k E[|g_k|^2] = |G|^2 + S * sum_k (b_k/B)(1/b_k)
                              = |G|^2 + S * K / B,

and the combined gradient's squared norm is the "large batch" measurement at
B_big = B.  Solving the two linear equations:

    |G|^2_est = (B_big*S_big - B_small*S_small) / (B_big - B_small)
    S_est     = (S_small - S_big) / (1/B_small - 1/B_big)

Both single-step estimates are unbiased but extremely noisy, so each is
EWMA-smoothed SEPARATELY (the ratio of smoothed moments is far better
behaved than a smoothed ratio).  The critical batch ("noise scale") is

    b_noise = S_ewma / |G|^2_ewma,

the batch size at which gradient noise and true gradient contribute equally
— the knee of the statistical-efficiency curve the outer controller tracks.

Degenerate case K == 1: B_small == B_big and the system is singular — the
estimator simply never becomes ready (the outer controller then holds the
batch, which is the honest answer with one worker).

Pure host-side python on floats that were computed in-graph (see
`core/grad.py`'s `tree_sqnorm` side-stat paths); no jax imports.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


@dataclasses.dataclass
class GradStats:
    """One step's in-graph gradient side statistics, as host floats.

    ``per_worker_sqnorm[k]`` is |g_k|^2 of worker k's mean gradient computed
    over ``batches[k]`` examples; ``combined_sqnorm`` is |g|^2 of the
    lambda-weighted combine over sum(batches) examples.
    """

    per_worker_sqnorm: list
    batches: list
    combined_sqnorm: float


class GNSEstimator:
    """EWMA-smoothed critical-batch estimator over per-step GradStats."""

    def __init__(self, alpha: float = 0.1, min_samples: int = 4) -> None:
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0,1], got {alpha}")
        if min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self.g2_ewma: Optional[float] = None  # smoothed |G|^2 estimate
        self.s_ewma: Optional[float] = None   # smoothed tr(Sigma) estimate
        self.samples = 0                      # accepted (non-degenerate) steps

    # ------------------------------------------------------------- observe

    def observe(self, stats: GradStats) -> None:
        """Fold one step's moments into the running EWMA estimates."""
        batches = [int(b) for b in stats.batches]
        sqnorms = [float(x) for x in stats.per_worker_sqnorm]
        if len(batches) != len(sqnorms):
            raise ValueError("need one sqnorm per worker batch")
        k = len(batches)
        b_big = float(sum(batches))
        if k < 2 or b_big <= 0:
            return  # singular: one worker gives one equation for two unknowns
        b_small = b_big / k
        if b_big - b_small <= 0:
            return
        lams = [b / b_big for b in batches]
        s_small = sum(lam * sq for lam, sq in zip(lams, sqnorms))
        s_big = float(stats.combined_sqnorm)
        if not (math.isfinite(s_small) and math.isfinite(s_big)):
            return
        g2_est = (b_big * s_big - b_small * s_small) / (b_big - b_small)
        s_est = (s_small - s_big) / (1.0 / b_small - 1.0 / b_big)
        a = self.alpha
        self.g2_ewma = g2_est if self.g2_ewma is None else (
            a * g2_est + (1 - a) * self.g2_ewma)
        self.s_ewma = s_est if self.s_ewma is None else (
            a * s_est + (1 - a) * self.s_ewma)
        self.samples += 1

    # ------------------------------------------------------------- queries

    @property
    def ready(self) -> bool:
        return self.samples >= self.min_samples

    @property
    def b_noise(self) -> Optional[float]:
        """Critical-batch estimate S/|G|^2, or None before any sample.

        Single-step estimates of |G|^2 can go negative (it is a difference of
        noisy quantities); the smoothed value is floored at a small positive
        epsilon so the ratio saturates large instead of flipping sign — a
        vanishing true gradient means "noise dominates at any batch", i.e.
        grow.
        """
        if self.g2_ewma is None or self.s_ewma is None:
            return None
        s = max(self.s_ewma, 0.0)
        g2 = self.g2_ewma
        if g2 <= 0:
            return math.inf if s > 0 else 0.0
        return s / g2

    # --------------------------------------------------------------- serde

    def state_dict(self) -> dict:
        return {
            "alpha": self.alpha,
            "min_samples": self.min_samples,
            "g2_ewma": self.g2_ewma,
            "s_ewma": self.s_ewma,
            "samples": self.samples,
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "GNSEstimator":
        est = cls(alpha=state["alpha"], min_samples=state["min_samples"])
        est.g2_ewma = state["g2_ewma"]
        est.s_ewma = state["s_ewma"]
        est.samples = int(state["samples"])
        return est
