"""Neural-net building blocks of the dense transformer family, in PyTorch.

Plain functions on tensors with explicit parameters, as in the reference.
Parameters are flat ``dict[str, Tensor]`` (state-dict style); a block takes
the sub-dict of its own names (:func:`sub`).  Linear weights use PyTorch's
``(d_out, d_in)`` layout (``models/convert.py`` maps the reference's
``(d_in, d_out)``).

Covered: GQA self- and cross-attention with its KV-cache decode
(``gqa_attention``), DeepSeek-V2's multi-head latent attention with the
absorbed-weight decode (``mla_attention``), GShard top-k MoE with one-hot
dispatch (``apply_moe``), MLPs, norms, RoPE and sinusoidal positions.
Expert weights are bare (E, D, F) / (E, F, D) tensors, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.shard_hooks import constrain, get_rules, is_dtensor

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
    if is_dtensor(x):
        x = _sharded_attn().summed(x)
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
                  cache=None, window=None, use_rope=True, cross_kv=None,
                  softcap=None, causal=True, num_valid=None):
    """GQA/MQA/MHA self- or cross-attention, over a full sequence or one
    decode step.  Head counts follow the parameters' shapes.

    ``cross_kv``: precomputed (k, v) (B, T, Hkv, Dh) of an encoder's output;
    the queries attend to all of it through the plain scores (never the
    kernels) and ``cache`` is passed through.  ``use_rope=False`` skips RoPE
    on q and k.

    Without ``cache`` (training / prefill) the kernel dispatch rule is the
    reference's: ``cfg.use_pallas and causal and s % 128 == 0`` takes the
    flash kernels (``num_valid`` then marks the bucket-padded rows they
    skip); otherwise the chunked or the plain scores.  Whether the kernel
    or its plain version runs follows the tensors' device.  Returns ``out``.

    With ``cache`` (``init_attn_cache``: k, v (B, T, Hkv, Dh) and a per-row
    write index idx (B,)) the one new token's k and v land at ``idx % T``
    of each row (a ring for windowed caches), the query attends through
    the plain scores over the slots written so far, ``min(idx + 1, T)``,
    and every row's idx advances by one.  The cache is not written in
    place: the step returns new tensors, so a caller holding the old dict
    still holds the old state.  Returns ``(out, new_cache)``.
    """
    b, s, _ = x.shape
    if cache is not None and s != 1:
        raise ValueError(
            f"a cached attention step takes one token per row, got {s} "
            f"(every serve path feeds the cache token by token)")
    dh = cfg.head_dim
    nh = p["wq.weight"].shape[0] // dh
    nkv = p["wk.weight"].shape[0] // dh
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]

    if cache is None and cross_kv is None:
        def attend(q, k, v):
            # (B, S, n * dh) projections -> (B, S, nh * dh); on each rank's
            # heads under the 'attention' rule
            q, k, v = (t.reshape(t.shape[0], s, -1, dh) for t in (q, k, v))
            if use_rope:
                q = rope(q, positions, cfg.rope_theta)
                k = rope(k, positions, cfg.rope_theta)
            if cfg.use_pallas and causal and s % 128 == 0:
                from repro_torch.kernels.flash_attention.ops import attention

                out = attention(q, k, v, causal=True, window=window,
                                softcap=softcap, num_valid=num_valid)
            elif (cfg.attn_chunk is not None
                  and s % min(cfg.attn_chunk, s) == 0):
                out = chunked_attention_scores(
                    q, k, v, causal=causal, window=window, softcap=softcap,
                    chunk=cfg.attn_chunk)
            else:
                mask = (causal_mask(s, s, 0, window, device=x.device)
                        if causal else torch.ones((s, s), dtype=torch.bool,
                                                  device=x.device))
                out = attention_scores(q, k, v, mask, softcap)
            return out.reshape(q.shape[0], s, -1)

        qkv = tuple(linear(sub(p, n), x) for n in ("wq", "wk", "wv"))
        out = _heads(cfg, attend, qkv, (nh, nkv, nkv))
        return constrain(linear(sub(p, "wo"), out), "activations")

    q = _split_heads(linear(sub(p, "wq"), x), nh)
    if cross_kv is not None:
        k, v = cross_kv
        if use_rope:
            q = rope(q, positions, cfg.rope_theta)
        mask = torch.ones((s, k.shape[1]), dtype=torch.bool, device=x.device)
        out = linear(sub(p, "wo"), attention_scores(
            q, k, v, mask, softcap).reshape(b, s, nh * dh))
        return out if cache is None else (out, cache)

    k = _split_heads(linear(sub(p, "wk"), x), nkv)
    v = _split_heads(linear(sub(p, "wv"), x), nkv)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    idx = cache["idx"]
    t = cache["k"].shape[1]
    mesh_info = get_rules().get("decode_attn")
    if mesh_info is not None and _sharded_attn().applicable(
            cfg, b, dh, mesh_info):
        out, ck, cv = _sharded_attn().decode_attention(
            q, k, v, cache["k"], cache["v"], idx, mesh_info=mesh_info,
            softcap=softcap)
    else:
        ck = _rowwise_write(cache["k"], k, idx)
        cv = _rowwise_write(cache["v"], v, idx)
        # attend to the slots holding positions <= idx (a ring when
        # windowed)
        n_written = torch.clamp(idx + 1, max=t)                 # (B,)
        valid = (torch.arange(t, device=x.device)[None, :]
                 < n_written[:, None])
        out = attention_scores(q, ck, cv, valid[:, None, None, :],
                               softcap)
    new_cache = {"k": ck, "v": cv, "idx": idx + s}
    return linear(sub(p, "wo"), _merge_heads(out)), new_cache


def _sharded_attn():
    from repro_torch.models import sharded_attn

    return sharded_attn


def _split_heads(x, n: int):
    """(B, S, n * d) -> (B, S, n, d); a DTensor split over more ranks than
    whole heads allow (8 kv heads on 16) is gathered on that dim first."""
    if is_dtensor(x):
        x = _sharded_attn().whole_heads(x, n)
    return x.reshape(x.shape[0], x.shape[1], n, -1)


def _merge_heads(x):
    """(B, S, n, d) -> (B, S, n * d); a DTensor split on d is gathered on
    that dim first (DTensor cannot always flatten a split inner dim)."""
    if is_dtensor(x):
        x = _sharded_attn().whole_heads(x, 1)
    return x.reshape(x.shape[0], x.shape[1], -1)


def _heads(cfg: ModelConfig, fn, xs, heads):
    """``fn(*xs)``; under the 'attention' rule, on each rank's block of the
    batch and the heads (``sharded_attn.local_heads``).  A sharded program
    runs the plain paths: the hand-written kernels are refused."""
    rule = get_rules().get("attention")
    if rule is None:
        return fn(*xs)
    if cfg.use_pallas:
        raise TypeError("a sharded program runs the plain paths: set "
                        "use_pallas=False (the hand-written kernels take "
                        "one card's whole tensors)")
    return _sharded_attn().local_heads(fn, rule, xs, heads)


def init_attn_cache(cfg: ModelConfig, batch: int, length: int, dtype,
                    device) -> Params:
    """An empty KV cache of ``length`` slots a row, with per-row write
    positions (continuous batching decodes rows at different offsets in
    the same step)."""
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _rowwise_write(cache, update, idx):
    """A copy of ``cache`` (B, T, ...) with row r's one new entry
    ``update[r, 0]`` at slot ``idx[r] % T`` (the reference's per-row
    ``dynamic_update_slice``, as an out-of-place scatter: a DTensor cache
    has no in-place one)."""
    t = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    return cache.index_put((rows, (idx % t).long()),
                           update[:, 0].to(cache.dtype))


# ----------------------------------------------------------------------- MLA


def init_mla(gen, cfg: ModelConfig) -> Params:
    """DeepSeek-V2 multi-head latent attention."""
    nh = cfg.num_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    p = prefixed("wq_a", init_linear(gen, cfg.d_model, cfg.q_lora_rank, cfg,
                                     False))
    p.update(prefixed("q_norm", init_norm(cfg, gen.device, cfg.q_lora_rank)))
    p.update(prefixed("wq_b", init_linear(gen, cfg.q_lora_rank, nh * qk, cfg,
                                          False)))
    # kv_a projects to the compressed latent and the shared rotary key
    p.update(prefixed("wkv_a", init_linear(
        gen, cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim, cfg, False)))
    p.update(prefixed("kv_norm", init_norm(cfg, gen.device,
                                           cfg.kv_lora_rank)))
    p.update(prefixed("wkv_b", init_linear(
        gen, cfg.kv_lora_rank, nh * (cfg.qk_nope_dim + cfg.v_head_dim), cfg,
        False)))
    p.update(prefixed("wo", init_linear(gen, nh * cfg.v_head_dim, cfg.d_model,
                                        cfg, False)))
    return p


def mla_attention(p: Params, x, cfg: ModelConfig, *, positions=None,
                  cache=None, window=None):
    """MLA: queries from a low-rank latent, keys and values from a
    compressed KV latent plus one shared rotary key.

    Without ``cache`` the latent is expanded to per-head K/V and attends
    through the plain scores (causal, ``window``); returns ``out``.  With
    ``cache`` (``init_mla_cache``: c_kv (B, T, rank), k_rope (B, T, 1, dr),
    idx (B,)) one token a row is written at ``idx % T`` and the query
    attends in the latent space: ``wkv_b`` is folded into the query and
    output sides (absorbed weights), so the cache is never expanded.
    Returns ``(out, new_cache)``; the cache given is left as it was.
    """
    b, s, _ = x.shape
    nh = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    rank = cfg.kv_lora_rank
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]

    q = linear(sub(p, "wq_b"), apply_norm(sub(p, "q_norm"),
                                          linear(sub(p, "wq_a"), x), cfg))
    kv_a = linear(sub(p, "wkv_a"), x)
    c_kv = apply_norm(sub(p, "kv_norm"), kv_a[..., :rank], cfg)

    if cache is None:
        # full sequence: the expanded (fewest-flops) form
        def attend(q, kv, k_rope):
            # (B, S, n * d) blocks -> (B, S, nh * dv); on each rank's heads
            # under the 'attention' rule
            bl = q.shape[0]
            q = q.reshape(bl, s, -1, dn + dr)
            q = torch.cat([q[..., :dn], rope(q[..., dn:], positions,
                                             cfg.rope_theta)], dim=-1)
            k_rope = rope(k_rope.reshape(bl, s, 1, dr), positions,
                          cfg.rope_theta)
            kv = kv.reshape(bl, s, -1, dn + dv)
            k = torch.cat([kv[..., :dn], k_rope.expand(
                bl, s, kv.shape[2], dr).to(kv.dtype)], dim=-1)
            out = attention_scores(q, k, kv[..., dn:], causal_mask(
                s, s, 0, window, device=x.device))
            return out.reshape(bl, s, -1)

        kv = linear(sub(p, "wkv_b"), c_kv)
        out = _heads(cfg, attend, (q, kv, kv_a[..., rank:]), (nh, nh, None))
        return constrain(linear(sub(p, "wo"), out), "activations")

    if s != 1:
        raise ValueError(f"a cached MLA step takes one token per row, "
                         f"got {s}")
    q = q.reshape(b, s, nh, dn + dr)
    q_nope, q_rope = q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)
    k_rope = rope(kv_a[..., rank:].reshape(b, s, 1, dr), positions,
                  cfg.rope_theta)
    idx = cache["idx"]
    t = cache["c_kv"].shape[1]
    # wkv_b's weight is (nh * (dn + dv), rank): per head, dn rows of
    # W_UK then dv rows of W_UV
    w_b = p["wkv_b.weight"].reshape(nh, dn + dv, rank)
    w_uk, w_uv = w_b[:, :dn], w_b[:, dn:]
    q_eff = torch.einsum("bshd,hdr->bshr", q_nope.float(),
                         w_uk.float()).to(x.dtype)
    sm_scale = 1.0 / math.sqrt(dn + dr)
    mesh_info = get_rules().get("decode_attn")
    if mesh_info is not None and _sharded_attn().mla_applicable(
            cfg, b, mesh_info):
        out_lat, c_all, kr_all = _sharded_attn().mla_decode_attention(
            q_eff, q_rope, c_kv, k_rope, cache["c_kv"], cache["k_rope"],
            idx, mesh_info=mesh_info, sm_scale=sm_scale)
    else:
        c_all = _rowwise_write(cache["c_kv"], c_kv, idx)
        kr_all = _rowwise_write(cache["k_rope"], k_rope, idx)
        n_written = torch.clamp(idx + 1, max=t)                 # (B,)
        mask = (torch.arange(t, device=x.device)[None, :]
                < n_written[:, None])
        logits = (torch.einsum("bshr,btr->bhst", q_eff.float(),
                               c_all.float())
                  + torch.einsum("bshd,btd->bhst", q_rope.float(),
                                 kr_all[:, :, 0].float()))
        logits = logits * sm_scale
        logits = torch.where(mask[:, None, None, :], logits,
                             torch.full_like(logits, -1e30))
        probs = torch.softmax(logits, dim=-1)
        out_lat = torch.einsum("bhst,btr->bshr", probs,
                               c_all.float()).to(x.dtype)
    out = torch.einsum("bshr,hdr->bshd", out_lat.float(),
                       w_uv.float()).to(x.dtype)
    new_cache = {"c_kv": c_all, "k_rope": kr_all, "idx": idx + s}
    return linear(sub(p, "wo"), _merge_heads(out)), new_cache


def init_mla_cache(cfg: ModelConfig, batch: int, length: int, dtype,
                   device) -> Params:
    """An empty latent cache of ``length`` slots a row, with per-row write
    positions."""
    return {"c_kv": torch.zeros((batch, length, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, length, 1, cfg.qk_rope_dim),
                                  dtype=dtype, device=device),
            "idx": torch.zeros((batch,), dtype=torch.int32, device=device)}


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


# ----------------------------------------------------------------------- MoE


def init_moe(gen, cfg: ModelConfig) -> Params:
    """Router (E, D) fp32 for ``F.linear``, expert weights as bare (E, D, F)
    / (E, F, D) tensors, and the shared experts as one SwiGLU MLP of width
    ``moe_d_ff * num_shared_experts``."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    p = {"router.weight": _dense_init(gen, (e, d), torch.float32),
         "w_gate": _dense_init(gen, (e, d, f), cfg.p_dtype, 1 / math.sqrt(d)),
         "w_up": _dense_init(gen, (e, d, f), cfg.p_dtype, 1 / math.sqrt(d)),
         "w_down": _dense_init(gen, (e, f, d), cfg.p_dtype,
                               1 / math.sqrt(f))}
    if cfg.num_shared_experts:
        p.update(prefixed("shared", init_mlp(
            gen, cfg.with_(mlp="swiglu"), d_ff=f * cfg.num_shared_experts)))
    return p


def moe_capacity(group_size: int, top_k: int, num_experts: int,
                 factor: float) -> int:
    return max(int(math.ceil(group_size * top_k * factor / num_experts)), 1)


def moe_route(p: Params, xt, cfg: ModelConfig):
    """The router of :func:`apply_moe` on grouped tokens xt (ng, g, D) ->
    (probs (ng, g, E) f32, top-k indices (ng, g, k), renormalised top-k
    probabilities, their one-hot (ng, g, k, E), and each choice's position
    in its expert's buffer (ng, g, k)).

    Top-k keeps the lower expert index on a tie, as ``jax.lax.top_k``
    does (padded tokens route with exactly uniform probabilities)."""
    k = cfg.moe_top_k
    probs = torch.softmax(F.linear(xt.float(), p["router.weight"].float()),
                          dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    ng, g = xt.shape[:2]
    sel = F.one_hot(topi, cfg.num_experts).float()          # (ng, g, k, e)
    # position of each (token, choice) in its expert's buffer: the count of
    # earlier choices of that expert, tokens in order, choices within one
    sel_flat = sel.reshape(ng, g * k, -1)
    pos = ((torch.cumsum(sel_flat, dim=1) - sel_flat) * sel_flat).sum(-1)
    return probs, topi, topv, sel, pos.reshape(ng, g, k)


def apply_moe(p: Params, x, cfg: ModelConfig):
    """GShard-style top-k MoE with one-hot dispatch, as the reference.

    x (B, S, D); tokens go in groups of ``moe_group_size`` (the last one
    zero-padded), each group dispatching to per-expert buffers of
    ``moe_capacity`` slots by one-hot einsums; a choice past its expert's
    capacity is dropped (gate 0).  Returns (out, Switch aux loss).
    """
    b, s, d = x.shape
    e = cfg.num_experts
    g = min(cfg.moe_group_size, b * s)
    # the gradient comes back to (B, S, D) in the activations' placement
    tokens = constrain(x.reshape(-1, d), "activations")
    t = tokens.shape[0]
    if (-t) % g:
        tokens = F.pad(tokens, (0, 0, 0, (-t) % g))
    xt = tokens.reshape(-1, g, d)

    probs, _, topv, sel, pos = moe_route(p, xt, cfg)
    cap = moe_capacity(g, cfg.moe_top_k, e, cfg.moe_capacity_factor)
    fits = pos < cap
    gate = topv * fits                                       # dropped: 0
    # a position past capacity has no slot: an all-zero one-hot row
    pos_oh = (pos[..., None] == torch.arange(cap, device=x.device)).float()
    # a token picks an expert at most once, so each (e, c) sum over the
    # choices has one term: both are exact, whatever the order
    dispatch = torch.einsum("ngke,ngkc->ngec", sel * fits[..., None], pos_oh)
    combine = torch.einsum("ngke,ngkc->ngec", sel * gate[..., None], pos_oh)
    dt = xt.dtype

    def experts(xt, dispatch, combine, w_gate, w_up, w_down):
        # expert-major buffers, so that the expert contractions batch over
        # e without a transpose (a sharded program's local shards stay
        # contiguous); the slot is 'p' here, after 'e': einsum folds the
        # dims it sums in label order, and DTensor folds a split dim only
        # outermost
        xin = torch.einsum("ngd,ngep->enpd", xt, dispatch.to(dt))
        act = F.silu(torch.einsum("enpd,edf->enpf", xin, w_gate.to(dt)))
        up = torch.einsum("enpd,edf->enpf", xin, w_up.to(dt))
        xout = torch.einsum("enpf,efd->enpd", act * up, w_down.to(dt))
        return torch.einsum("enpd,ngep->ngd", xout, combine.to(dt))

    args = (xt, dispatch, combine, p["w_gate"], p["w_up"], p["w_down"])
    rule = get_rules().get("experts")
    out = experts(*args) if rule is None else \
        _sharded_attn().local_experts(experts, rule, *args)
    # tokens back to the activations' placement before they are (B, S, D)
    out = constrain(out.reshape(-1, d)[:t], "activations").reshape(b, s, d)

    # Switch-style load-balance loss
    aux = (probs.mean(1) * sel.sum(2).mean(1)).sum(-1).mean() * e
    if cfg.num_shared_experts:
        out = out + apply_mlp(sub(p, "shared"), x, cfg.with_(mlp="swiglu"))
    return out, aux


# ----------------------------------------------------------- embeddings etc.


def init_embedding(gen, cfg: ModelConfig) -> Params:
    return {"table": _dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                 cfg.p_dtype, 1.0)}


def embed(p: Params, tokens, cfg: ModelConfig):
    if is_dtensor(p["table"]):
        x = _sharded_attn().local_rows(p["table"], tokens)
    else:
        x = p["table"][tokens]
    x = x.to(cfg.act_dtype)
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def unembed(p_embed: Params, p_head: Optional[Params], x, cfg: ModelConfig):
    """Logits (B,S,V); tied embeddings reuse the table."""
    if cfg.tie_embeddings:
        logits = F.linear(x, p_embed["table"].to(x.dtype))
    else:
        logits = linear(p_head, x)
    logits = constrain(logits, "logits")
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
        # the target logit stays (B,S,1) until the subtraction: a DTensor
        # gather over a vocabulary-sharded dim is a masked partial, which
        # is reduced at the subtraction and cannot be indexed before
        tgt = lf.gather(-1, targets[..., None])
        ctx.save_for_backward(logits, targets, logz)
        return (logz[..., None] - tgt)[..., 0]

    @staticmethod
    def backward(ctx, g):
        logits, targets, logz = ctx.saved_tensors
        probs = torch.exp(logits.float() - logz[..., None])
        if is_dtensor(probs):
            # a scatter over a vocabulary-sharded dim has no sharding
            # strategy: subtract the reference's one-hot (the same values)
            onehot = targets[..., None] == torch.arange(
                probs.shape[-1], device=probs.device)
            probs = probs - onehot.to(probs.dtype)
        else:
            probs.scatter_add_(-1, targets[..., None],
                               torch.full_like(targets[..., None], -1.0,
                                               dtype=probs.dtype))
        return (probs * g[..., None]).to(logits.dtype), None


def token_xent(logits, targets):
    """logits (B,S,V), targets (B,S) int64 -> per-token nll (B,S) f32."""
    return _TokenXent.apply(logits, targets)


def sinusoidal_positions(length: int, d: int, device=None):
    return sinusoidal_at(torch.arange(length, device=device), d)


def sinusoidal_at(positions, d: int):
    """Sinusoidal encoding at ``positions`` (any shape; no table, so decode
    positions may be arbitrarily large) -> positions.shape + (d,) f32."""
    pos = positions[..., None].float()
    dim = torch.arange(0, d, 2, device=positions.device).float()
    ang = pos / torch.pow(torch.tensor(10000.0, device=positions.device),
                          dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
