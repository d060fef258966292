"""Optimizers on flat parameter dicts: sgd, momentum, adam / adamw, and the
factored ``adafactor_mini``.

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
import functools
from typing import Callable, NamedTuple, Optional, Union

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


def _sqrt_rn_(x: torch.Tensor) -> torch.Tensor:
    """``_sqrt_rn`` into ``x`` itself (which the caller owns)."""
    return x.sqrt_() if x.is_cuda else x.copy_(x.double().sqrt())


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


class Leaf(NamedTuple):
    """One leaf of the reference's parameter tree, as the port holds it."""

    names: tuple[str, ...]   # the port's tensors, in stacking order
    stacked: bool            # the leaf is theirs stacked on a new first axis
    transposed: bool         # each is its slice transposed (a linear's ``w``)


def adafactor_mini(lr: Union[Schedule, float], eps: float = 1e-30,
                   clip: float = 1.0, leaves=None) -> Optimizer:
    """Factored second moments (rows and columns of a matrix), no first
    moment: the reference's memory-lean optimizer for its largest configs.

    Unlike the others it is not elementwise: a leaf of two or more dims
    keeps the means of g^2 over its last dim (``r``) and over the one
    before (``c``), and the update's RMS clip is taken over the whole leaf.
    The reference runs it on its stacked leaves (a block's tensor for every
    group of layers on one leading axis), so a stacked norm scale (G, d) is
    a matrix whose ``c`` couples the layers.  ``leaves`` (from
    ``models.convert.reference_leaves``) maps each reference leaf's path to
    the port's tensors that make it up; the statistics are computed from
    the per-layer tensors, never from a stacked copy, and a transposed
    linear weight has its row and column means swapped.  Without
    ``leaves`` each tensor is a leaf of its own.  The state is the
    reference's tree: ``{"r", "c"}`` or ``{"v"}`` (fp32) at each leaf's path.
    The scalars are fp32, and on the card every division is by a tensor.

    Memory: a tensor's update is made twice, once for the leaf's RMS and
    once to apply it, so no more than one tensor's fp32 update (and its
    fp32 gradient) is alive at a time beside the parameters and gradients.
    """
    sched = _sched(lr)

    def layout(params) -> dict:
        if leaves is None:
            return {(name,): Leaf((name,), False, False) for name in params}
        return leaves

    def init(params):
        state: dict = {}
        for path, leaf in layout(params).items():
            x = params[leaf.names[0]]
            shape = list(x.shape)
            if leaf.transposed:
                shape[-2:] = shape[:-3:-1]
            if leaf.stacked:
                shape = [len(leaf.names)] + shape
            z = functools.partial(torch.zeros, dtype=torch.float32,
                                  device=x.device)
            _put(state, path, {"r": z(shape[:-1]),
                               "c": z(shape[:-2] + shape[-1:])}
                 if len(shape) >= 2 else {"v": z(shape)})
        return state

    def update(params, grads, state, step):
        step = _step(step)
        eta = sched(step)
        one = np.float32(1)
        beta = one - (np.float32(step) + one) ** np.float32(-0.8)
        beta, omb = float(beta), float(one - beta)
        new_p, new_s, consts = {}, {}, {}
        for path, leaf in layout(params).items():
            gs = [grads[n] for n in leaf.names]
            dev = gs[0].device
            if dev not in consts:
                consts[dev] = _divisors(dev, eps, clip, 1.0)
            eps_t, clip_t, one_t = consts[dev]
            s = _adafactor_state(gs, leaf, _get(state, path), beta, omb,
                                 eps_t)
            _put(new_s, path, s)
            # update clipping (RMS <= clip) over the whole leaf
            sumsq = 0.0
            for i, g in enumerate(gs):
                u = _adafactor_step(g, i, leaf, s, eps_t).reshape(-1)
                sumsq = sumsq + torch.dot(u, u)
                del u
            numel, = _divisors(dev, sum(g.numel() for g in gs))
            scale = torch.maximum(
                one_t, torch.sqrt(sumsq / numel + eps_t) / clip_t)
            for i, (name, g) in enumerate(zip(leaf.names, gs)):
                p = params[name]
                u = _adafactor_step(g, i, leaf, s, eps_t)
                u.div_(scale).mul_(eta)
                new_p[name] = torch.sub(p.float(), u, out=u).to(p.dtype)
        return new_p, new_s

    return Optimizer("adafactor-mini", init, update, schedule=sched)


def _reduced_dims(leaf) -> tuple[int, int]:
    """The dims the reference's r and c average over, in the port's
    layout (swapped for a transposed weight)."""
    return (-2, -1) if leaf.transposed else (-1, -2)


def _adafactor_state(gs, leaf, st, beta, omb, eps_t) -> dict:
    """One reference leaf's new state from its gradients ``gs`` (the port's
    tensors of the leaf, in the port's layout)."""
    def g2(g):
        return g.float().square() + eps_t

    if "v" in st:
        vs = [beta * v + omb * g2(g) for v, g in zip(
            st["v"].unbind(0) if leaf.stacked else [st["v"]], gs)]
        return {"v": torch.stack(vs) if leaf.stacked else vs[0]}
    if leaf.stacked and gs[0].dim() == 1:
        # a stack of vectors: r holds one mean a layer, c averages over
        # the layers
        g2s = [g2(g) for g in gs]
        r = beta * st["r"] + omb * torch.stack([x.mean() for x in g2s])
        c = beta * st["c"] + omb * (sum(g2s) / torch.full(
            (), float(len(g2s)), dtype=torch.float32, device=r.device))
        return {"r": r, "c": c}
    row, col = _reduced_dims(leaf)
    rs, cs = [], []
    old = zip(st["r"].unbind(0), st["c"].unbind(0)) if leaf.stacked \
        else [(st["r"], st["c"])]
    for g, (r0, c0) in zip(gs, old):
        x = g2(g)
        rs.append(beta * r0 + omb * x.mean(row))
        cs.append(beta * c0 + omb * x.mean(col))
        del x
    if leaf.stacked:
        return {"r": torch.stack(rs), "c": torch.stack(cs)}
    return {"r": rs[0], "c": cs[0]}


def _adafactor_step(g, i: int, leaf, s: dict, eps_t) -> torch.Tensor:
    """The unclipped update of the leaf's i-th tensor (gradient ``g``) under
    its new state ``s``: g / max(sqrt(the factored second moment), eps), as
    a new fp32 tensor."""
    if "v" in s:
        d = (s["v"][i] if leaf.stacked else s["v"]).clone()
    elif leaf.stacked and g.dim() == 1:
        r = s["r"]
        d = r[i] * s["c"] / torch.maximum(r.mean(-1, keepdim=True), eps_t)
    else:
        row, col = _reduced_dims(leaf)
        r, c = (s["r"][i], s["c"][i]) if leaf.stacked else (s["r"], s["c"])
        d = r.unsqueeze(row) * c.unsqueeze(col)
        d.div_(torch.maximum(r.mean(-1, keepdim=True), eps_t).unsqueeze(-1))
    d = _sqrt_rn_(d)
    torch.maximum(d, eps_t, out=d)
    return torch.div(g.float(), d, out=d)


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def get_optimizer(name: str, lr, **kw) -> Optimizer:
    return {
        "sgd": sgd,
        "momentum": momentum,
        "adam": adam,
        "adamw": adamw,
        "adafactor": adafactor_mini,
    }[name](lr, **kw)
