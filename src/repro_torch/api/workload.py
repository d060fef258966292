"""Workload: what to train — model init, SUM-loss gradient, and a data feed.

The trainer's contract: ``loss_and_grad(params, batch, mask)`` returns the
gradient of the *weighted SUM* loss, never the mean — gradient sums are
accumulated across microbatches and divided by the total weight exactly
once, which is what makes variable per-worker batch sizes weight examples
correctly (paper Eq. 2-3).  :func:`sum_loss_adapter` implements it once.

Parameters are flat ``dict[str, Tensor]``; ``init(generator)`` draws them on
the generator's device.  ``to(device)`` (optional) moves the data feed to the
device the backend runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class Workload:
    """Bundle satisfying the trainer contract: init + SUM-loss grad + data."""

    name: str
    init: Callable
    loss_and_grad: Callable
    next_batch: Callable
    state_dict: Optional[Callable[[], dict]] = None
    load_state_dict: Optional[Callable[[dict], None]] = None
    to: Optional[Callable] = None


def _grads(total, leaves: dict) -> dict:
    """d total / d leaves, with zeros for parameters the loss does not use."""
    gs = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
    return {name: g if g is not None else torch.zeros_like(p)
            for (name, p), g in zip(leaves.items(), gs)}


def sum_loss_adapter(loss_fn: Callable, aux_weight: float = 0.0) -> Callable:
    """Trainer-contract ``loss_and_grad`` from a SUM-convention loss
    ``loss_fn(params, batch, mask) -> (loss_sum, weight_sum, aux)``.

    The gradient is of ``loss_sum + aux_weight * aux * max(weight_sum, 1)``;
    the returned metas carry the plain SUM loss (THE single implementation
    of the SUM-semantics contract)."""

    def loss_and_grad(params, batch, mask):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        ls, ws, aux = loss_fn(leaves, batch, mask)
        total = (ls + aux_weight * aux * torch.clamp(ws, min=1.0)
                 if aux_weight else ls)
        return (ls.detach(), ws.detach(), aux.detach()), _grads(total, leaves)

    return loss_and_grad


def lm_workload(model_cfg, pipe, *, aux_weight: float = 0.0,
                use_kernel: bool = False) -> Workload:
    """Decoder-only LM training (dense, ssm or hybrid family) from a model
    config + ``DataPipeline``.

    ``use_kernel=True`` sets ``use_pallas``.  In the dense family, and in
    the hybrid family's local-attention blocks, it routes attention through
    the flash kernels and derives their ``num_valid`` on the device from the
    very mask the trainer built when it padded the batch: rows the loss
    masks out are exactly the rows the kernels skip (valid rows form a
    prefix).  In the ssm family it routes the SSD scan's intra-chunk part
    through the SSD kernel pair, and in the hybrid family's recurrent
    blocks the RG-LRU scan through the RG-LRU kernel pair, forward and
    backward.  This differs from the reference on purpose: its SSD and
    RG-LRU kernel paths have no VJP, so its ``use_kernel=True`` cannot
    train those families; the port trains the same functions through its
    kernels.  ``aux_weight`` scales an auxiliary loss by the weight sum;
    the dense, ssm and hybrid families' aux is zero.
    """
    from repro_torch.models import init_lm, lm_loss

    if use_kernel:
        model_cfg = model_cfg.with_(use_pallas=True)

    def loss_fn(params, batch, mask):
        num_valid = None
        if use_kernel:
            row_w = mask if mask.dim() == 1 else mask.amax(-1)
            num_valid = (row_w > 0).sum().to(torch.int32)
        return lm_loss(params, model_cfg, batch["tokens"], batch["targets"],
                       mask, num_valid=num_valid)

    return Workload(
        name=getattr(model_cfg, "name", model_cfg.family),
        init=lambda gen: init_lm(gen, model_cfg),
        loss_and_grad=sum_loss_adapter(loss_fn, aux_weight),
        next_batch=pipe.next_batch,
        state_dict=pipe.state_dict,
        load_state_dict=pipe.load_state_dict,
        to=pipe.to,
    )
