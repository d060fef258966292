"""Plain PyTorch oracle for the flash-attention kernels (the reference's
``attention_ref``)."""

from __future__ import annotations

import math
from typing import Optional

import torch


def visible_mask(s: int, t: int, *, causal: bool, window: Optional[int],
                 device=None) -> torch.Tensor:
    """(s, t) bool: which keys each query sees; queries are right-aligned
    (query i sits at key position i + t - s)."""
    qi = torch.arange(s, device=device)[:, None] + (t - s)
    kj = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & (kj > qi - window)
    return mask


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None):
    """q: (B,S,H,D), k/v: (B,T,Hkv,D), H % Hkv == 0. Returns (B,S,H,D)."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    qg = q.float().reshape(b, s, hkv, rep, d)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg, k.float()) / math.sqrt(d)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = visible_mask(s, t, causal=causal, window=window, device=q.device)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)
