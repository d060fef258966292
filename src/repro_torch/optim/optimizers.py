"""Optimizers on flat parameter dicts: sgd, momentum, adam / adamw.

Each optimizer is an (init, update) pair, as in the reference:
    state = opt.init(params)
    new_params, new_state = opt.update(params, grads, state, step)

The update rules follow the reference's arithmetic term for term, with
its scalars in fp32: the learning rate, Adam's step count and bias
corrections, and ``lr * weight_decay`` are float32 values (kept as Python
floats, which hold an fp32 value exactly, so no device sync).  New
parameter tensors are returned (the ASP engine keeps references to the
parameters a worker last read, so they must not change under it); the
moment buffers in ``state`` are updated in place, which saves one copy of
them per step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

Schedule = Callable[[int], float]  # step -> lr


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable  # (params, grads, state, step) -> (params, state)
    # the LR schedule `update` closes over (a BatchCoupledSchedule is
    # re-evaluated on outer-controller resizes)
    schedule: Optional[Callable] = None


def constant_lr(lr: float) -> Schedule:
    lr32 = float(np.float32(lr))
    return lambda step: lr32


def _sched(lr: Union[Schedule, float]) -> Schedule:
    return lr if callable(lr) else constant_lr(lr)


def _step(step) -> int:
    return int(step.item()) if isinstance(step, torch.Tensor) else int(step)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """fp32 sqrt rounded to nearest, as the reference's.  CUDA's is; the CPU
    kernel's vectorised sqrt is an ulp off on some inputs, so on the CPU it
    goes through float64 (the square root of an fp32 value, taken in
    float64 and rounded to fp32, is the correctly rounded fp32 one)."""
    return x.sqrt() if x.is_cuda else x.double().sqrt().float()


def _divisors(device: torch.device, *values: float) -> list[torch.Tensor]:
    """fp32 0-dim tensors on ``device`` to divide by, made by a fill and
    no copy from the host.  CUDA divides by a Python scalar as a multiply by
    its reciprocal, which can be an ulp off the reference's division; by a
    tensor on the card it divides."""
    return [torch.full((), v, dtype=torch.float32, device=device)
            for v in values]


def sgd(lr: Union[Schedule, float]) -> Optimizer:
    sched = _sched(lr)

    def init(params):
        return ()

    def update(params, grads, state, step):
        eta = sched(_step(step))
        return {k: p - eta * grads[k].to(p.dtype)
                for k, p in params.items()}, state

    return Optimizer("sgd", init, update, schedule=sched)


def momentum(lr: Union[Schedule, float], beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    """The paper's ResNet optimizer."""
    sched = _sched(lr)

    def init(params):
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    def update(params, grads, state, step):
        eta = sched(_step(step))
        new_p = {}
        for k, p in params.items():
            g = grads[k].float()
            m = state[k].mul_(beta).add_(g)
            u = beta * m + g if nesterov else m
            new_p[k] = (p.float() - eta * u).to(p.dtype)
        return new_p, state

    return Optimizer("momentum", init, update, schedule=sched)


def adam(lr: Union[Schedule, float], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    sched = _sched(lr)

    def init(params):
        return {"m": {k: torch.zeros_like(p, dtype=torch.float32)
                      for k, p in params.items()},
                "v": {k: torch.zeros_like(p, dtype=torch.float32)
                      for k, p in params.items()}}

    def update(params, grads, state, step):
        step = _step(step)
        eta = sched(step)
        one, t = np.float32(1), np.float32(step) + np.float32(1)
        bc1 = float(one - np.float32(b1) ** t)
        bc2 = float(one - np.float32(b2) ** t)
        eta_wd = float(np.float32(eta) * np.float32(weight_decay))
        new_p, bcs = {}, {}
        for k, p in params.items():
            g = grads[k].float()
            m = state["m"][k].mul_(b1).add_((1 - b1) * g)
            v = state["v"][k].mul_(b2).add_((1 - b2) * g.square())
            if m.device not in bcs:
                bcs[m.device] = _divisors(m.device, bc1, bc2)
            d1, d2 = bcs[m.device]
            step_ = eta * (m / d1) / (_sqrt_rn(v / d2) + eps)
            if weight_decay:
                step_ = step_ + eta_wd * p.float()
            new_p[k] = (p.float() - step_).to(p.dtype)
        return new_p, state

    return Optimizer("adam" if not weight_decay else "adamw", init, update,
                     schedule=sched)


def adamw(lr, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)

