"""Weighted gradient combination (paper Eq. 2-3), in PyTorch.

    g_k   = lambda_k * grad_k,  lambda_k = b_k / sum_i b_i
    x_t+1 = x_t - eta * sum_k g_k

Gradients are flat ``dict[str, Tensor]`` keyed like the parameters.
``weighted_psum`` is the measured backend's masked mean: a worker's
gradient SUM over its padded bucket, added over its slice's devices,
divided once by its mask-weight sum.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

Grads = dict[str, torch.Tensor]


def loss_grads(total: torch.Tensor, leaves: dict) -> Grads:
    """d total / d leaves, with zeros for the leaves the loss does not use."""
    gs = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
    return {name: g if g is not None else torch.zeros_like(p)
            for (name, p), g in zip(leaves.items(), gs)}


def tree_sqnorm(tree: Grads) -> torch.Tensor:
    """Squared L2 norm of a gradient dict, |g|^2 = sum over leaves of sum(x^2).

    Accumulated in fp32 over the leaves in sorted-key order (the order of
    the reference's ``tree_leaves``), on the leaves' device, with no host
    sync.  Each leaf's term is one ``torch.dot`` of the flattened leaf with
    itself, so no leaf-sized temporary is made (gemma-2b's tied embedding
    alone is 2.1 GB in fp32).  This is the side statistic the
    gradient-noise-scale estimator (DESIGN.md §15) needs from each worker's
    mean gradient and from the combined gradient.
    """
    out = None
    for name in sorted(tree):
        flat = tree[name].float().reshape(-1)
        term = torch.dot(flat, flat)
        out = term if out is None else out + term
    return torch.zeros((), dtype=torch.float32) if out is None else out


def combine_weighted(grads: Sequence[Grads], batches: Sequence[int]) -> Grads:
    """Weighted average of per-worker gradient dicts with lambda_k weights."""
    if len(grads) != len(batches):
        raise ValueError("one gradient dict per worker required")
    total = float(sum(batches))
    if total <= 0:
        raise ValueError("global batch must be positive")
    lams = [b / total for b in batches]
    out = {}
    for name in grads[0]:
        acc = lams[0] * grads[0][name]
        for lam, g in zip(lams[1:], grads[1:]):
            acc = acc + lam * g[name]
        out[name] = acc
    return out


def combine_weighted_with_sqnorm(grads: Sequence[Grads],
                                 batches: Sequence[int]):
    """`combine_weighted` plus the combined gradient's squared norm.

    Returns ``(g, |g|^2)``: with the per-worker |g_k|^2 side stats, the
    large-batch half of the small-batch/large-batch critical-batch
    estimator (DESIGN.md §15).
    """
    g = combine_weighted(grads, batches)
    return g, tree_sqnorm(g)


def weighted_psum(local_grad_sum: Grads, local_weight_sum: torch.Tensor,
                  others: Sequence[tuple[Grads, torch.Tensor]] = ()) -> Grads:
    """Weighted mean of a worker's gradient over its slice of devices.

    ``local_grad_sum`` holds sum_i w_i * grad_i over the rows of the
    slice's first device and ``local_weight_sum`` the scalar sum_i w_i
    there; ``others`` holds the same pair for each further device of the
    slice, in slice order (the reference's psum over the slice's data
    axis).  The partial sums are added on the first device in slice order
    and divided once by max(total weight, 1e-8): exactly Eq. 3 with lambda
    weighting when the w_i are the bucket's validity mask.  The first
    device's sums are the caller's scratch and are accumulated and divided
    in place (no second copy of the gradient is made); the returned dict
    holds the same tensors.
    """
    wsum = local_weight_sum
    for grads, weight in others:
        wsum = wsum + weight.to(wsum.device)
        for name, g in local_grad_sum.items():
            g.add_(grads[name].to(g.device))
    denom = torch.clamp(wsum, min=1e-8)
    for g in local_grad_sum.values():
        g.div_(denom)
    return local_grad_sum


def weighted_psum_with_sqnorm(local_grad_sum: Grads,
                              local_weight_sum: torch.Tensor,
                              others: Sequence[tuple[Grads,
                                                     torch.Tensor]] = ()):
    """`weighted_psum` plus the squared norm of the worker's mean gradient:
    the |g_k|^2 side statistic of the GNS estimator (DESIGN.md §15).
    Returns ``(g, |g|^2)``."""
    g = weighted_psum(local_grad_sum, local_weight_sum, others)
    return g, tree_sqnorm(g)


def accumulate_microbatch_grads(grad_fn: Callable, params, microbatches: dict,
                                masks: torch.Tensor):
    """Gradient accumulation over stacked ``(n_steps, m, ...)`` microbatches.

    ``grad_fn(params, batch, mask) -> ((loss_sum, w_sum, aux), grads)`` with
    grads of the weighted SUM loss (Eq. 2-3 contract); ``microbatches`` is a
    dict whose tensors have leading dims ``(n_steps, m)``; ``masks`` is
    ``(n_steps, m)``.  Returns device-resident SUMS
    ``(grad_sums, loss_sum, weight_sum, aux_weighted_sum)``: the caller
    divides by the weight sum once.  The sums stay on the device, so the
    loop never waits on the host.
    """
    g_acc = None
    dev = masks.device
    l_acc = torch.zeros((), dtype=torch.float32, device=dev)
    w_acc = torch.zeros((), dtype=torch.float32, device=dev)
    a_acc = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(masks.shape[0]):
        batch = {key: x[i] for key, x in microbatches.items()}
        (loss_sum, w_sum, aux), grads = grad_fn(params, batch, masks[i])
        if g_acc is None:
            g_acc = {name: g.clone() for name, g in grads.items()}
        else:
            for name, g in grads.items():
                g_acc[name].add_(g)
        l_acc = l_acc + loss_sum
        w_acc = w_acc + w_sum
        a_acc = a_acc + aux * w_sum
    if g_acc is None:
        g_acc = {name: torch.zeros_like(p) for name, p in params.items()}
    return g_acc, l_acc, w_acc, a_acc
