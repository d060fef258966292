"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427], in
PyTorch.

Training and prefill run the linear recurrence over the whole sequence.
With ``use_pallas`` it runs on the hand-written kernel pair of
``repro_torch.kernels.rglru_scan`` (forward and backward), at any width;
otherwise on :func:`rglru_scan`, the plain associative scan.  Decode
(``cache``) carries the conv context and the hidden state
(``init_recurrent_cache``); a one-token step is ``h = a h + b x``.

Parameters follow the reference's names: ``in_x.weight``, ``in_gate.weight``
and ``out.weight`` (d_out, d_in), ``conv_w`` in the reference's (K, W)
layout, ``conv_b``, ``rglru.lam``, ``rglru.w_a.{weight,bias}``,
``rglru.w_x.{weight,bias}``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, _dense_init, linear, prefixed, sub
from repro_torch.models.ssm import _causal_conv

_RGLRU_C = 8.0

def rglru_scan(a, bx, initial=None):
    """h_t = a_t * h_{t-1} + bx_t over axis 1 of a, bx (B, L, W), by
    log-step doubling (an associative scan); differentiable by autograd."""
    if initial is not None:
        # fold the initial state into the first step
        bx = torch.cat([bx[:, :1] + a[:, :1] * initial[:, None], bx[:, 1:]],
                       dim=1)
    k = 1
    while k < a.shape[1]:
        # combine each step with the one k earlier: (a2 a1, a2 b1 + b2)
        bx = torch.cat([bx[:, :k], a[:, k:] * bx[:, :-k] + bx[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return bx


def init_rglru(gen: torch.Generator, cfg: ModelConfig) -> Params:
    w, dev = cfg.lru_width, gen.device
    # Lambda init so that a = sigmoid(lam)^c is in ~[0.9, 0.999]
    u = torch.rand((w,), generator=gen, device=dev) * (0.999 - 0.9) + 0.9
    root = u ** (1.0 / _RGLRU_C)
    p = {"lam": torch.log(root / (1 - root))}
    for name in ("w_a", "w_x"):
        p.update(prefixed(name, {
            "weight": _dense_init(gen, (w, w), cfg.p_dtype),
            "bias": torch.zeros((w,), dtype=cfg.p_dtype, device=dev)}))
    return p


def apply_rglru(p: Params, x, state=None, use_pallas: bool = False):
    """x: (B, L, W) -> (y (B, L, W), last hidden (B, W)); state: (B, W)
    initial hidden or None.  One step from a state (L == 1) is the
    recurrence itself, on every device."""
    r = torch.sigmoid(linear(sub(p, "w_a"), x).float())   # recurrence gate
    i = torch.sigmoid(linear(sub(p, "w_x"), x).float())   # input gate
    log_a = -_RGLRU_C * F.softplus(p["lam"]) * r           # (B,L,W)
    a = torch.exp(log_a)
    gated_x = i * x.float()
    # sqrt(1 - a^2) normalization (Griffin eq. 4); clamp for stability
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bx = mult * gated_x
    if x.shape[1] == 1 and state is not None:
        h = a[:, 0] * state + bx[:, 0]
        return h[:, None].to(x.dtype), h
    if use_pallas:
        from repro_torch.kernels.rglru_scan.ops import rglru

        h, h_last = rglru(a, bx, state)
        return h.to(x.dtype), h_last
    h = rglru_scan(a, bx, initial=state)
    return h.to(x.dtype), h[:, -1]


def init_recurrent_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, w, dev = cfg.d_model, cfg.lru_width, gen.device
    p = prefixed("in_x", {"weight": _dense_init(gen, (w, d), cfg.p_dtype)})
    p.update(prefixed("in_gate", {"weight": _dense_init(gen, (w, d),
                                                        cfg.p_dtype)}))
    p["conv_w"] = _dense_init(gen, (cfg.conv_kernel, w), cfg.p_dtype,
                              1.0 / math.sqrt(cfg.conv_kernel))
    p["conv_b"] = torch.zeros((w,), dtype=cfg.p_dtype, device=dev)
    p.update(prefixed("rglru", init_rglru(gen, cfg)))
    p.update(prefixed("out", {"weight": _dense_init(gen, (d, w),
                                                    cfg.p_dtype)}))
    return p


def recurrent_block(p: Params, x, cfg: ModelConfig, cache=None):
    """Griffin recurrent block: conv1d + RG-LRU branch, GeLU gate branch.
    x: (B, S, D) -> (out (B, S, D), new_cache); ``cache`` is
    {'conv': (B, K-1, W), 'h': (B, W)} or None (then new_cache is None).
    ``num_valid`` never reaches it (padded rows are plain rows here, masked
    by the loss)."""
    gate = F.gelu(linear(sub(p, "in_gate"), x), approximate="tanh")
    xb = linear(sub(p, "in_x"), x)
    xb, new_conv = _causal_conv(xb, p["conv_w"].to(x.dtype),
                                None if cache is None else cache["conv"])
    xb = xb + p["conv_b"].to(x.dtype)
    y, new_h = apply_rglru(sub(p, "rglru"), xb,
                           None if cache is None else cache["h"],
                           use_pallas=cfg.use_pallas)
    out = linear(sub(p, "out"), y * gate)
    return out, None if cache is None else {"conv": new_conv, "h": new_h}


def init_recurrent_cache(cfg: ModelConfig, batch: int, dtype,
                         device) -> Params:
    """Zero decode state: the conv's trailing context and the hidden."""
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.lru_width),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
    }
