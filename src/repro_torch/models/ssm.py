"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060], in PyTorch.

Training and prefill use the chunked SSD algorithm (quadratic within a
chunk, linear across chunks).  With ``cfg.use_pallas`` the intra-chunk part
runs on the hand-written kernel pair of ``repro_torch.kernels.ssd_scan``
(forward and backward); otherwise on :func:`ssd_chunked`, the plain
reference.  Decode (``cache``) runs the single-token recurrence on the
state ``init_ssd_cache`` makes.

Parameters follow the reference's names: ``in_proj.weight`` (d_out, d_in),
``conv_w`` in the reference's (K, C) layout, ``conv_b``, ``a_log``,
``dt_bias``, ``d_skip``, ``gate_norm.scale``, ``out_proj.weight``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Params, _dense_init, _heads,
                                       apply_norm, init_norm, linear,
                                       prefixed, sub)


def segsum(a):
    """Lower-triangular segment sums: out[..., i, j] = sum_{k=j+1..i} a[..., k],
    -inf above the diagonal (so that exp gives exact zeros there, and no
    gradient flows through the masked entries)."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, torch.full_like(out, -math.inf))


def inter_chunk(cr, ar, states, initial_state=None):
    """Steps 3-4 of the chunked scan: carry the per-chunk states across
    chunks and turn them into each chunk's off-diagonal output.

    cr (B,nc,cl,G,N) with C per group (G == H: per head), ar (B,nc,cl,H),
    states (B,nc,H,P,N) -> (y_off (B,nc,cl,H,P), final_state (B,H,P,N)).
    Head h reads group h // (H // G); the state-to-output product contracts
    per group, so no per-head C is made."""
    bsz, nc, cl, g, n = cr.shape
    h, p = states.shape[2:4]
    a_cum = torch.cumsum(ar.permute(0, 3, 1, 2), dim=-1)       # (B,H,nc,cl)
    if initial_state is None:
        initial_state = torch.zeros((bsz, h, p, n), dtype=states.dtype,
                                    device=states.device)
    st = torch.cat([initial_state[:, None].to(states.dtype), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, st)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]
    y_off = torch.einsum("bclgn,bcgrpn->bclgrp", cr,
                         prev_states.reshape(bsz, nc, g, h // g, p, n))
    y_off = y_off.reshape(bsz, nc, cl, h, p)
    y_off = y_off * torch.exp(a_cum).permute(0, 2, 3, 1)[..., None]
    return y_off, final_state


def ssd_chunked(x, a_log, b, c, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x:     (B, L, H, P)   inputs (already multiplied by dt)
    a_log: (B, L, H)      per-step log decay (dt * A, A < 0)
    b, c:  (B, L, H, N)   input/output projections (groups pre-broadcast to H)
    Returns (y: (B, L, H, P), final_state: (B, H, P, N)).
    """
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    if l % chunk:
        raise ValueError(f"seq {l} not divisible by chunk {chunk}")
    nc = l // chunk

    xr = x.reshape(bsz, nc, chunk, h, p)
    br = b.reshape(bsz, nc, chunk, h, n)
    cr = c.reshape(bsz, nc, chunk, h, n)
    ar = a_log.reshape(bsz, nc, chunk, h)
    a_cum = torch.cumsum(ar.permute(0, 3, 1, 2), dim=-1)       # (B,H,nc,cl)

    # 1. intra-chunk (diagonal block) outputs
    ltri = torch.exp(segsum(ar.permute(0, 3, 1, 2)))          # (B,H,nc,cl,cl)
    scores = torch.einsum("bclhn,bcshn->bhcls", cr, br) * ltri
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, xr)

    # 2. per-chunk final states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)          # (B,H,nc,cl)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", br, decay_states, xr)

    # 3-4. inter-chunk recurrence, state -> output
    y_off, final_state = inter_chunk(cr, ar, states, initial_state)
    return (y_diag + y_off).reshape(bsz, l, h, p), final_state


def _causal_conv(x, w, state=None):
    """Depthwise causal conv1d. x: (B, L, C), w: (K, C).

    state: (B, K-1, C) trailing context from previous tokens, or None.
    Returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else x[:, :0]
    return y, new_state


def init_ssd(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, di = cfg.d_model, cfg.d_inner
    h, n, g = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_ngroups
    conv_dim = di + 2 * g * n
    dev = gen.device
    # dt bias: softplus^-1 of dt ~ loguniform[1e-3, 1e-1]
    u = torch.rand((h,), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    p = prefixed("in_proj", {"weight": _dense_init(
        gen, (2 * di + 2 * g * n + h, d), cfg.p_dtype)})
    p["conv_w"] = _dense_init(gen, (cfg.conv_kernel, conv_dim), cfg.p_dtype,
                              1.0 / math.sqrt(cfg.conv_kernel))
    p["conv_b"] = torch.zeros((conv_dim,), dtype=cfg.p_dtype, device=dev)
    p["a_log"] = torch.log(1.0 + 15.0 * torch.rand((h,), generator=gen,
                                                   device=dev))
    p["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    p["d_skip"] = torch.ones((h,), dtype=torch.float32, device=dev)
    p.update(prefixed("gate_norm", init_norm(cfg, dev, di)))
    p.update(prefixed("out_proj", {"weight": _dense_init(
        gen, (d, di), cfg.p_dtype)}))
    return p


def ssd_block(p: Params, x, cfg: ModelConfig, cache=None):
    """x: (B, S, D) -> (out (B, S, D), new_cache).

    Without ``cache``, the chunked scan over the sequence (new_cache None);
    ``num_valid`` never reaches it (padded rows are plain rows here, masked
    by the loss).  With ``cache`` ({'conv': (B, K-1, C), 'state':
    (B, H, P, N)}), one token a row: the conv state carries the causal
    conv's context, then ``state = state * exp(dt a) + B (x dt)^T`` and
    ``y = state C``."""
    bsz, s, _ = x.shape
    if cache is not None and s != 1:
        raise ValueError(
            f"the SSD decode step takes one token per row, got {s}")
    di, h, n, g = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_ngroups
    ph = cfg.ssm_head_dim

    zxbcdt = linear(sub(p, "in_proj"), x)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * g * n]
    dt_raw = zxbcdt[..., -h:]

    xbc, new_conv = _causal_conv(xbc, p["conv_w"].to(x.dtype),
                                 None if cache is None else cache["conv"])
    xbc = F.silu(xbc + p["conv_b"].to(x.dtype))

    xs = xbc[..., :di].reshape(bsz, s, h, ph)
    bmat = xbc[..., di:di + g * n].reshape(bsz, s, g, n)
    cmat = xbc[..., di + g * n:].reshape(bsz, s, g, n)

    # softplus as log(1 + e^x) everywhere (F.softplus turns linear above 20)
    dt_in = dt_raw.float() + p["dt_bias"]
    dt = torch.logaddexp(dt_in, torch.zeros((), dtype=dt_in.dtype,
                                            device=dt_in.device))
    a_log_step = dt * -torch.exp(p["a_log"])                   # (B,S,H)
    x_dt = xs.float() * dt[..., None]

    if cache is not None:
        # single-token recurrence; groups broadcast to heads
        bh = torch.repeat_interleave(bmat[:, 0], h // g, dim=1).float()
        ch = torch.repeat_interleave(cmat[:, 0], h // g, dim=1).float()
        da = torch.exp(a_log_step[:, 0])                       # (B,H)
        state = (cache["state"] * da[..., None, None]
                 + torch.einsum("bhn,bhp->bhpn", bh, x_dt[:, 0]))
        y = torch.einsum("bhpn,bhn->bhp", state, ch)[:, None]
        new_cache = {"conv": new_conv, "state": state}
    else:
        def scan(x_dt, a_log_step, bmat, cmat):
            # flat (B, S, n * d) blocks; on each rank's heads under the
            # 'attention' rule
            bl = x_dt.shape[0]
            y = _scan(x_dt.reshape(bl, s, -1, ph), a_log_step,
                      bmat.reshape(bl, s, -1, n), cmat.reshape(bl, s, -1, n),
                      cfg)
            return y[:, :s].reshape(bl, s, -1)

        y = _heads(cfg, scan, (x_dt.reshape(bsz, s, h * ph), a_log_step,
                               bmat.reshape(bsz, s, g * n),
                               cmat.reshape(bsz, s, g * n)),
                   (h, h, g, g)).reshape(bsz, s, h, ph)
        new_cache = None

    y = y + xs.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = apply_norm(sub(p, "gate_norm"), y * F.silu(z), cfg)
    return linear(sub(p, "out_proj"), y), new_cache


def _scan(x_dt, a_log_step, bmat, cmat, cfg: ModelConfig):
    """The chunked scan over a sequence padded up to whole chunks: the
    kernel pair with ``cfg.use_pallas`` (B and C per group), else the plain
    :func:`ssd_chunked` (groups broadcast to heads, the reference's
    contract).  Returns y (B, L_padded, H, P)."""
    s, h, g = x_dt.shape[1], x_dt.shape[2], bmat.shape[2]
    pad = (-s) % cfg.ssm_chunk
    if pad:
        x_dt = F.pad(x_dt, (0, 0, 0, 0, 0, pad))
        a_log_step = F.pad(a_log_step, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    if cfg.use_pallas:
        from repro_torch.kernels.ssd_scan.ops import ssd as ssd_kernel

        # B and C per group: head i reads group i // (h // g)
        y, _ = ssd_kernel(x_dt, a_log_step, bmat.float(), cmat.float(),
                          chunk=cfg.ssm_chunk)
        return y
    y, _ = ssd_chunked(x_dt, a_log_step,
                       torch.repeat_interleave(bmat, h // g, dim=2).float(),
                       torch.repeat_interleave(cmat, h // g, dim=2).float(),
                       cfg.ssm_chunk)
    return y


def init_ssd_cache(cfg: ModelConfig, batch: int, dtype, device) -> Params:
    """Zero decode state: the conv's trailing context and the SSM state."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
    }
