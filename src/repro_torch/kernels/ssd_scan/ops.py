"""Differentiable SSD scan on the intra-chunk kernels: ``ssd(...)``.

Same contract as the reference's ``kernels/ssd_scan/ops.py::ssd``: the
intra-chunk part runs on ``ssd_intra_chunk`` and the cheap inter-chunk
recurrence stays plain PyTorch (``models/ssm.py::inter_chunk``, under
ordinary autograd).  Unlike the reference, whose kernel path has no VJP,
the intra-chunk part is a ``torch.autograd.Function`` whose backward is the
``ssd_intra_chunk_bwd`` kernel: it saves x, a, b and c and recomputes the
decays and scores inside the backward, so the port trains through the
kernel pair.  ``bwd_impl="oracle"`` (tests only) differentiates the plain
forward with autograd instead.

B and C come per group, (B,L,G,N) with ``H % G == 0``, head h reading
group ``h // (H // G)``; G == H is the reference's per-head layout.  No
per-head copy of them is made, saved for the backward or read by the
inter-chunk part.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import (ssd_intra_chunk,
                                                 ssd_intra_chunk_bwd,
                                                 ssd_intra_chunk_plain)
from repro_torch.models.shard_hooks import refuse_dtensor
from repro_torch.models.ssm import inter_chunk

BWD_IMPLS = ("kernel", "oracle")


class _SSDIntraChunk(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, a, b, c, bwd_impl):
        y, states = ssd_intra_chunk(x, a, b, c)
        ctx.save_for_backward(x, a, b, c)
        ctx.bwd_impl = bwd_impl
        return y, states

    @staticmethod
    def backward(ctx, dy, ds):
        x, a, b, c = ctx.saved_tensors
        dy, ds = dy.contiguous(), ds.contiguous()
        if ctx.bwd_impl == "oracle":
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (x, a, b, c)]
                outs = ssd_intra_chunk_plain(*leaves)
                grads = torch.autograd.grad(outs, leaves, (dy, ds))
        else:
            grads = ssd_intra_chunk_bwd(x, a, b, c, dy, ds)
        return (*grads, None)


def ssd(x, a_log, b, c, chunk: int, initial_state=None,
        bwd_impl: str = "kernel"):
    """x (B,L,H,P); a_log (B,L,H); b/c (B,L,G,N) ->
    (y (B,L,H,P), final_state (B,H,P,N)), differentiable in every input."""
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"unknown bwd_impl {bwd_impl!r}; expected {BWD_IMPLS}")
    refuse_dtensor("SSD", x, a_log, b, c)
    bsz, l, h, p = x.shape
    g, n = b.shape[-2:]
    if l % chunk:
        raise ValueError(f"seq {l} not divisible by chunk {chunk}")
    nc = l // chunk
    xr = x.reshape(bsz, nc, chunk, h, p).contiguous()
    ar = a_log.reshape(bsz, nc, chunk, h).contiguous()
    br = b.reshape(bsz, nc, chunk, g, n).contiguous()
    cr = c.reshape(bsz, nc, chunk, g, n).contiguous()
    y_diag, states = _SSDIntraChunk.apply(xr, ar, br, cr, bwd_impl)
    y_off, final_state = inter_chunk(cr, ar, states, initial_state)
    return (y_diag + y_off).reshape(bsz, l, h, p), final_state
