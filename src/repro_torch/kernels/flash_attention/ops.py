"""Differentiable attention on the flash kernels: ``attention(...)``.

A ``torch.autograd.Function`` whose forward is ``flash_fwd`` (saving the
(out, lse) flash residuals) and whose backward is ``flash_bwd_dq`` +
``flash_bwd_dkv``, the port of the reference's ``custom_vjp``.  The
recompute through ``attention_ref`` survives as ``bwd_impl="oracle"``, the
reference the kernel backward is tested against.

``num_valid`` (0-d int32 tensor, computed on the device from the trainer's
loss mask) gets no gradient: rows >= num_valid are padding, with exact-zero
outputs and gradients.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (flash_bwd_dkv,
                                                       flash_bwd_dq,
                                                       flash_delta,
                                                       flash_fwd)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.shard_hooks import refuse_dtensor

BWD_IMPLS = ("kernel", "oracle")


def mask_rows(x: torch.Tensor, num_valid) -> torch.Tensor:
    """Zero batch rows >= num_valid (the kernel's padded-row semantics)."""
    rows = torch.arange(x.shape[0], device=x.device).view(
        (-1,) + (1,) * (x.dim() - 1))
    return torch.where(rows < num_valid, x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, num_valid, causal, window, softcap, bwd_impl):
        out, lse = flash_fwd(q, k, v, num_valid, causal=causal, window=window,
                             softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse, num_valid)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        ctx.bwd_impl = bwd_impl
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, nv = ctx.saved_tensors
        g = g.contiguous()
        if ctx.bwd_impl == "oracle":
            with torch.enable_grad():
                qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
                o = attention_ref(qq, kk, vv, **ctx.opts)
                if nv is not None:
                    o = mask_rows(o, nv)
                dq, dk, dv = torch.autograd.grad(o, (qq, kk, vv), g)
        else:
            # delta = rowsum(dO . O), (B, H, S) f32 like lse, with no fp32
            # copy of 16-bit dO or O
            delta = flash_delta(g, out)
            dq = flash_bwd_dq(q, k, v, g, lse, delta, nv, **ctx.opts)
            dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, nv, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def attention(q, k, v, *, num_valid=None, causal: bool = True,
              window: Optional[int] = None, softcap: Optional[float] = None,
              use_kernel: bool = True, bwd_impl: str = "kernel"):
    """q (B,S,H,D), k/v (B,T,Hkv,D) -> (B,S,H,D), differentiable in q, k, v.

    ``use_kernel=False`` is the plain reference (padded rows zeroed the same
    way).  ``bwd_impl``: "kernel" (default) or "oracle".
    """
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"unknown bwd_impl {bwd_impl!r}; expected {BWD_IMPLS}")
    refuse_dtensor("flash", q, k, v)
    if num_valid is not None and not isinstance(num_valid, torch.Tensor):
        num_valid = torch.tensor(num_valid, dtype=torch.int32,
                                 device=q.device)
    if not use_kernel:
        out = attention_ref(q, k, v, causal=causal, window=window,
                            softcap=softcap)
        return mask_rows(out, num_valid) if num_valid is not None else out
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), num_valid, causal, window,
                                 softcap, bwd_impl)
