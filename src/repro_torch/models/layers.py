"""Neural-net building blocks of the dense transformer family, in PyTorch.

Plain functions on tensors with explicit parameters, as in the reference.
Parameters are flat ``dict[str, Tensor]`` (state-dict style); a block takes
the sub-dict of its own names (:func:`sub`).  Linear weights use PyTorch's
``(d_out, d_in)`` layout (``models/convert.py`` maps the reference's
``(d_in, d_out)``).

This slice covers training and prefill of the dense family: the KV-cache
decode path, MLA and MoE are later slices of the port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

Params = dict[str, torch.Tensor]


def sub(params: Params, prefix: str) -> Params:
    """The entries under ``prefix.``, with the prefix stripped."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def prefixed(prefix: str, params: Params) -> Params:
    return {f"{prefix}.{k}": v for k, v in params.items()}


# --------------------------------------------------------------------- init


def _dense_init(gen: torch.Generator, shape, dtype, scale=None):
    """Normal init with std 1/sqrt(fan_in); ``shape`` is (d_out, d_in)."""
    fan_in = shape[1] if len(shape) > 1 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * std).to(dtype)


def init_linear(gen, d_in, d_out, cfg: ModelConfig, use_bias=None) -> Params:
    use_bias = cfg.use_bias if use_bias is None else use_bias
    p = {"weight": _dense_init(gen, (d_out, d_in), cfg.p_dtype)}
    if use_bias:
        p["bias"] = torch.zeros((d_out,), dtype=cfg.p_dtype, device=gen.device)
    return p


def linear(p: Params, x):
    return F.linear(x, p["weight"].to(x.dtype),
                    p["bias"].to(x.dtype) if "bias" in p else None)


# --------------------------------------------------------------------- norms


def init_norm(cfg: ModelConfig, device, d=None) -> Params:
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=cfg.p_dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=cfg.p_dtype, device=device)
    return p


def apply_norm(p: Params, x, cfg: ModelConfig):
    """Normalization with f32 statistics and dtype-preserving tensor math;
    RMSNorm multiplies by ``scale`` (not ``1 + scale``)."""
    dt = x.dtype
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        inv = torch.rsqrt(var + cfg.norm_eps)
        y = (x - mu.to(dt)) * inv.to(dt)
        return y * p["scale"].to(dt) + p["bias"].to(dt)
    ms = xf.square().mean(-1, keepdim=True)
    inv = torch.rsqrt(ms + cfg.norm_eps)
    return x * inv.to(dt) * p["scale"].to(dt)


# ---------------------------------------------------------------------- RoPE


def rope(x, positions, theta: float):
    """Rotary embedding, *interleaved* (GPT-J) pair layout: pairs (2i, 2i+1).

    x: (..., S, H, Dh) with even Dh; positions: (..., S) integer.
    """
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs    # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]            # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    xr = x.float().reshape(x.shape[:-1] + (half, 2))
    x1, x2 = xr[..., 0], xr[..., 1]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# ----------------------------------------------------------------- attention


def _softcap(logits, cap: Optional[float]):
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def attention_scores(q, k, v, mask, softcap=None):
    """q: (B,S,H,Dqk), k: (B,T,Hkv,Dqk), v: (B,T,Hkv,Dv), H % Hkv == 0.

    mask: (S,T) or (B,1,S,T) boolean.  Materializes the (S,T) scores: the
    plain path for sequences the kernel dispatch rule does not take."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    dv = v.shape[-1]
    out_dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    qg = q.reshape(b, s, hkv, h // hkv, dh)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg, k) / math.sqrt(dh)
    logits = _softcap(logits, softcap)
    mask = mask[None, None, None] if mask.dim() == 2 else mask[:, :, None]
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", probs, v)
    return out.reshape(b, s, h, dv).to(out_dtype)


def chunked_attention_scores(q, k, v, *, causal=True, window=None,
                             softcap=None, chunk=512):
    """Online-softmax attention over key/value chunks in plain PyTorch: only
    (S x chunk) score tiles materialize.  Same semantics as
    `attention_scores` with the causal / window mask."""
    b, s, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    chunk = min(chunk, t)
    assert t % chunk == 0, (t, chunk)
    qg = (q.float() / math.sqrt(dh)).reshape(b, s, hkv, rep, dh)
    q_pos = torch.arange(s, device=q.device) + (t - s)
    m = torch.full((b, hkv, rep, s), -1e30, device=q.device)
    l = torch.zeros((b, hkv, rep, s), device=q.device)
    acc = torch.zeros((b, hkv, rep, s, dh), device=q.device)
    for c0 in range(0, t, chunk):
        kb = k[:, c0:c0 + chunk].float()
        vb = v[:, c0:c0 + chunk].float()
        logits = _softcap(torch.einsum("bsgrd,bcgd->bgrsc", qg, kb), softcap)
        k_pos = c0 + torch.arange(chunk, device=q.device)
        mask = torch.ones((s, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        m_cur = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(logits - m_cur[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrsc,bcgd->bgrsd", p, vb)
        m = m_cur
    out = acc / l.clamp_min(1e-20)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(q.dtype)


def causal_mask(s: int, t: int, offset: int = 0, window: Optional[int] = None,
                device=None):
    """(s, t) boolean mask; query i is at absolute position offset + i."""
    qi = offset + torch.arange(s, device=device)[:, None]
    kj = torch.arange(t, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    return m


def init_gqa(gen, cfg: ModelConfig) -> Params:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {}
    for name, d_in, d_out in (("wq", d, h * dh), ("wk", d, hkv * dh),
                              ("wv", d, hkv * dh), ("wo", h * dh, d)):
        p.update(prefixed(name, init_linear(gen, d_in, d_out, cfg)))
    return p


def gqa_attention(p: Params, x, cfg: ModelConfig, *, positions=None,
                  window=None, softcap=None, causal=True, num_valid=None):
    """GQA/MQA/MHA self-attention over a full sequence (training / prefill).

    The kernel dispatch rule is the reference's: ``cfg.use_pallas and causal
    and s % 128 == 0`` takes the flash kernels (``num_valid`` then marks the
    bucket-padded rows they skip); otherwise the chunked or the plain scores.
    Whether the kernel or its plain version runs follows the tensors' device.
    """
    b, s, _ = x.shape
    dh = cfg.head_dim
    nh = p["wq.weight"].shape[0] // dh
    nkv = p["wk.weight"].shape[0] // dh
    q = linear(sub(p, "wq"), x).reshape(b, s, nh, dh)
    k = linear(sub(p, "wk"), x).reshape(b, s, nkv, dh)
    v = linear(sub(p, "wv"), x).reshape(b, s, nkv, dh)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cfg.use_pallas and causal and s % 128 == 0:
        from repro_torch.kernels.flash_attention.ops import attention

        out = attention(q, k, v, causal=True, window=window, softcap=softcap,
                        num_valid=num_valid)
    elif cfg.attn_chunk is not None and s % min(cfg.attn_chunk, s) == 0:
        out = chunked_attention_scores(q, k, v, causal=causal, window=window,
                                       softcap=softcap, chunk=cfg.attn_chunk)
    else:
        mask = (causal_mask(s, s, 0, window, device=x.device) if causal
                else torch.ones((s, s), dtype=torch.bool, device=x.device))
        out = attention_scores(q, k, v, mask, softcap)
    return linear(sub(p, "wo"), out.reshape(b, s, nh * dh))


# --------------------------------------------------------------------- MLPs


def init_mlp(gen, cfg: ModelConfig, d_ff=None) -> Params:
    d_ff = d_ff or cfg.d_ff
    names = (("w_gate", "w_up") if cfg.mlp in ("swiglu", "geglu")
             else ("w_up",))
    p = {}
    for name in names:
        p.update(prefixed(name, init_linear(gen, cfg.d_model, d_ff, cfg)))
    p.update(prefixed("w_down", init_linear(gen, d_ff, cfg.d_model, cfg)))
    return p


def apply_mlp(p: Params, x, cfg: ModelConfig):
    """SwiGLU / GeGLU (tanh-approximate gelu, as the reference), or plain gelu."""
    if "w_gate.weight" in p:
        gate = linear(sub(p, "w_gate"), x)
        act = (F.silu(gate) if cfg.mlp == "swiglu"
               else F.gelu(gate, approximate="tanh"))
        return linear(sub(p, "w_down"), act * linear(sub(p, "w_up"), x))
    return linear(sub(p, "w_down"),
                  F.gelu(linear(sub(p, "w_up"), x), approximate="tanh"))


# ----------------------------------------------------------- embeddings etc.


def init_embedding(gen, cfg: ModelConfig) -> Params:
    return {"table": _dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                 cfg.p_dtype, 1.0)}


def embed(p: Params, tokens, cfg: ModelConfig):
    x = p["table"][tokens].to(cfg.act_dtype)
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def unembed(p_embed: Params, p_head: Optional[Params], x, cfg: ModelConfig):
    """Logits (B,S,V); tied embeddings reuse the table."""
    if cfg.tie_embeddings:
        logits = F.linear(x, p_embed["table"].to(x.dtype))
    else:
        logits = linear(p_head, x)
    if cfg.logit_softcap is not None:
        logits = _softcap(logits.float(), cfg.logit_softcap).to(x.dtype)
    return logits


class _TokenXent(torch.autograd.Function):
    """Per-token cross-entropy with the reference's hand-written gradient
    (softmax minus the target), gathering the target logit instead of
    building a (B,S,V) one-hot."""

    @staticmethod
    def forward(ctx, logits, targets):
        lf = logits.float()
        m = lf.amax(-1)
        logz = torch.log(torch.exp(lf - m[..., None]).sum(-1)) + m
        tgt = lf.gather(-1, targets[..., None])[..., 0]
        ctx.save_for_backward(logits, targets, logz)
        return logz - tgt

    @staticmethod
    def backward(ctx, g):
        logits, targets, logz = ctx.saved_tensors
        probs = torch.exp(logits.float() - logz[..., None])
        probs.scatter_add_(-1, targets[..., None],
                           torch.full_like(targets[..., None], -1.0,
                                           dtype=probs.dtype))
        return (probs * g[..., None]).to(logits.dtype), None


def token_xent(logits, targets):
    """logits (B,S,V), targets (B,S) int64 -> per-token nll (B,S) f32."""
    return _TokenXent.apply(logits, targets)
