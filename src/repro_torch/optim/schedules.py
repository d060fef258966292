"""Learning-rate schedules: step -> lr as host floats.

Each schedule evaluates in float32, as the reference's do, and returns that
fp32 value as a Python float (exact).  The cosine is taken in float64 and
rounded to fp32: numpy's float32 ``cos`` is off by an ulp where the
reference's is not.

PyTorch runs eagerly, so a schedule is evaluated on the host each step and
`BatchCoupledSchedule`'s scale takes effect at the next update, with no
per-scale compiled copy of the update (the reference keeps one jitted
update per scale because jit bakes the float in at trace time).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

import numpy as np

f32 = np.float32


def step_schedule(values: Sequence[float], boundaries: Sequence[int]):
    """Piecewise-constant. The paper's ResNet schedule:
    values=[0.1, 0.01, 0.001, 0.0002] with accuracy/step boundaries."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("need len(values) == len(boundaries) + 1")
    vals = [float(f32(v)) for v in values]
    bounds = [int(b) for b in boundaries]

    def sched(step):
        return vals[sum(step >= b for b in bounds)]

    return sched


def cosine_schedule(peak: float, total_steps: int, warmup: int = 0,
                    floor: float = 0.0):
    half_range = f32(0.5 * (peak - floor))

    def sched(step):
        step = f32(step)
        if step < warmup:
            return float(f32(peak) * min(step / f32(max(warmup, 1)), f32(1)))
        prog = min(max((step - f32(warmup)) / f32(max(total_steps - warmup,
                                                      1)), f32(0)), f32(1))
        return float(f32(floor) + half_range
                     * (f32(1) + f32(math.cos(f32(np.pi) * prog))))

    return sched


class BatchCoupledSchedule:
    """Schedule wrapper whose output scales with the global-batch ratio.

    ``sched(step) = scale * base(step)`` where ``scale`` is set by the
    trainer on every outer-controller resize via :meth:`set_batch_ratio`
    (ratio = B_global / B_global_initial): ``rule="linear"`` uses the ratio
    itself, ``rule="sqrt"`` its square root.
    """

    RULES = ("linear", "sqrt")

    def __init__(self, base: Union[Callable, float], rule: str = "linear"):
        if rule not in self.RULES:
            raise ValueError(f"unknown coupling rule {rule!r}; expected {self.RULES}")
        if not callable(base):
            lr = float(f32(base))
            base = lambda step: lr  # noqa: E731
        self.base = base
        self.rule = rule
        self.scale = 1.0

    def set_batch_ratio(self, ratio: float) -> float:
        """Update the scale for a new B/B0 ratio; returns the new scale."""
        if ratio <= 0:
            raise ValueError(f"batch ratio must be positive, got {ratio}")
        self.scale = float(ratio) if self.rule == "linear" else math.sqrt(ratio)
        return self.scale

    def __call__(self, step):
        return float(f32(self.scale) * f32(self.base(step)))


def batch_coupled(base_sched: Union[Callable, float],
                  rule: str = "linear") -> BatchCoupledSchedule:
    """Couple any LR schedule (or constant) to the outer batch controller."""
    return BatchCoupledSchedule(base_sched, rule)
