"""Differentiable RG-LRU scan on the kernel pair: ``rglru(a, bx, h0)``.

Same contract as the reference's ``kernels/rglru_scan/ops.py::rglru`` with
its kernel: ``(h (B,L,W), hT (B,W))``.  Unlike the reference, whose kernel
path has no VJP, this is a ``torch.autograd.Function`` whose backward is the
``rglru_bwd`` kernel: it saves a, the output h and h0, and recomputes
nothing, so the port trains through the kernel pair.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan.kernel import (rglru_linear_scan,
                                                   rglru_linear_scan_bwd)
from repro_torch.models.shard_hooks import refuse_dtensor


class _RGLRU(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, bx, h0):
        h, h_t = rglru_linear_scan(a, bx, h0)
        ctx.save_for_backward(a, h, h0)
        return h, h_t

    @staticmethod
    def backward(ctx, dh, dh_t):
        a, h, h0 = ctx.saved_tensors
        return rglru_linear_scan_bwd(a, h, h0, dh.contiguous(),
                                     dh_t.contiguous())


def rglru(a, bx, h0=None):
    """a, bx (B,L,W); h0 (B,W) or None -> (h (B,L,W), hT (B,W)),
    differentiable in a, bx and h0."""
    refuse_dtensor("RG-LRU", a, bx)
    return _RGLRU.apply(a.contiguous(), bx.contiguous(),
                        None if h0 is None else h0.contiguous())
