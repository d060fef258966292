"""Decoder-only LM, dense, ssm and hybrid families (the reference's
``models/transformer.py``).

The reference stacks the layers' parameters and scans over them (over
groups of the block pattern for the hybrid family, with an unrolled tail);
PyTorch runs eagerly, so the layers are a Python loop over ``layers.{i}.*``
entries of a flat parameter dict, layer i of kind ``pattern[i % period]``.
Decode caches follow the same layout: a flat dict of ``layers.{i}.*``
tensors (``init_caches``), the batch on dim 0 of every one, where the
reference stacks them per group as ``(groups, B, ...)``.  MoE, MLA, encdec
and VLM families are later slices of the port.
"""

from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

Params = L.Params

_LATER = {
    "moe": "slice 7: MoE / MLA / encdec / vlm",
    "encdec": "slice 7: MoE / MLA / encdec / vlm",
    "vlm": "slice 7: MoE / MLA / encdec / vlm",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run."""
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
            f"{_LATER[cfg.family]}); ported: dense GQA, ssm and hybrid")
    if cfg.family in ("dense", "hybrid") and cfg.attention != "gqa":
        raise NotImplementedError(
            f"attention {cfg.attention!r} is not ported yet (ROADMAP queue 1, "
            f"{_LATER['moe']}); ported: dense GQA, ssm and hybrid")
    if cfg.remat:
        raise NotImplementedError(
            "activation checkpointing (remat) is not ported yet (ROADMAP "
            "queue 1, launch slice)")


def block_pattern(cfg: ModelConfig) -> tuple[str, ...]:
    """Kinds of the repeating block group ('attn' | 'local' | 'rec' | 'ssd')."""
    if cfg.family == "ssm":
        return ("ssd",)
    if cfg.family == "hybrid":
        return tuple(cfg.block_pattern)
    return ("attn",)


def init_block(gen, cfg: ModelConfig, kind: str) -> Params:
    p = L.prefixed("norm1", L.init_norm(cfg, gen.device))
    if kind == "ssd":  # mamba2 blocks have no separate MLP
        p.update(L.prefixed("ssd", S.init_ssd(gen, cfg)))
        return p
    if kind in ("attn", "local"):
        p.update(L.prefixed("attn", L.init_gqa(gen, cfg)))
    elif kind == "rec":
        p.update(L.prefixed("rec", R.init_recurrent_block(gen, cfg)))
    else:
        raise ValueError(f"unknown block kind {kind}")
    p.update(L.prefixed("norm2", L.init_norm(cfg, gen.device)))
    p.update(L.prefixed("mlp", L.init_mlp(gen, cfg)))
    return p


def apply_block(p: Params, x, cfg: ModelConfig, kind: str, positions,
                num_valid=None, cache=None):
    """One block -> (x, new_cache); ``num_valid`` reaches the attention
    kernels only (ssd and rec blocks ignore it, as in the reference); local
    blocks attend over ``cfg.local_window``.  ``cache`` is the block's
    decode state (``init_block_cache``), None for a full sequence (then
    new_cache is None)."""
    h = L.apply_norm(L.sub(p, "norm1"), x, cfg)
    if kind == "ssd":
        out, new_cache = S.ssd_block(L.sub(p, "ssd"), h, cfg, cache)
        return x + out, new_cache
    if kind == "rec":
        out, new_cache = R.recurrent_block(L.sub(p, "rec"), h, cfg, cache)
    else:
        window = cfg.local_window if kind == "local" else cfg.window
        out = L.gqa_attention(L.sub(p, "attn"), h, cfg, positions=positions,
                              cache=cache, window=window,
                              softcap=cfg.attn_softcap, num_valid=num_valid)
        new_cache = None
        if cache is not None:
            out, new_cache = out
    x = x + out
    return x + L.apply_mlp(L.sub(p, "mlp"),
                           L.apply_norm(L.sub(p, "norm2"), x, cfg),
                           cfg), new_cache


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, length: int,
                     dtype, device) -> Params:
    """One block's empty decode state; a local block's KV cache holds
    ``min(length, local_window)`` slots and a windowed dense block's
    ``min(length, window)`` (rings)."""
    if kind in ("attn", "local"):
        eff = min(length, cfg.local_window) if kind == "local" else (
            min(length, cfg.window) if cfg.window else length)
        return L.init_attn_cache(cfg, batch, eff, dtype, device)
    if kind == "rec":
        return R.init_recurrent_cache(cfg, batch, dtype, device)
    return S.init_ssd_cache(cfg, batch, dtype, device)


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters on ``gen``'s device, drawn from ``gen``."""
    cfg.validate()
    check_supported(cfg)
    pattern = block_pattern(cfg)
    params = L.prefixed("embed", L.init_embedding(gen, cfg))
    for i in range(cfg.num_layers):
        params.update(L.prefixed(f"layers.{i}", init_block(
            gen, cfg, pattern[i % len(pattern)])))
    params.update(L.prefixed("final_norm", L.init_norm(cfg, gen.device)))
    if not cfg.tie_embeddings:
        params.update(L.prefixed("lm_head", L.init_linear(
            gen, cfg.d_model, cfg.vocab_size, cfg, use_bias=False)))
    return params


def init_caches(cfg: ModelConfig, batch: int, length: int, dtype=None,
                device: DeviceLike = None) -> Params:
    """Empty decode caches for ``batch`` rows of ``length`` positions on
    ``device`` (the card unless the caller asks for the CPU): block i's
    state under ``layers.{i}.*``, the batch on dim 0 of every tensor."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype or cfg.act_dtype
    pattern = block_pattern(cfg)
    caches = {}
    for i in range(cfg.num_layers):
        caches.update(L.prefixed(f"layers.{i}", init_block_cache(
            cfg, pattern[i % len(pattern)], batch, length, dtype, device)))
    return caches


def apply_lm(params: Params, cfg: ModelConfig, tokens, *, positions=None,
             num_valid=None, caches=None):
    """tokens (B,S) int64 -> (logits (B,S,V), aux_loss scalar).

    num_valid: optional 0-d int32 valid-row count for bucket-padded batches,
    threaded to the attention kernels.
    caches: decode caches from :func:`init_caches` (S must be 1); then the
    result is (logits, new_caches, aux), the caches given left as they were.
    """
    check_supported(cfg)
    pattern = block_pattern(cfg)
    s = tokens.shape[1]
    if caches is not None and s != 1:
        raise ValueError(f"decode with caches takes one token per row, "
                         f"got {s}")
    x = L.embed(L.sub(params, "embed"), tokens, cfg)
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None, :]
    new_caches = {}
    for i in range(cfg.num_layers):
        name = f"layers.{i}"
        x, nc = apply_block(L.sub(params, name), x, cfg,
                            pattern[i % len(pattern)], positions, num_valid,
                            None if caches is None else L.sub(caches, name))
        if caches is not None:
            new_caches.update(L.prefixed(name, nc))
    x = L.apply_norm(L.sub(params, "final_norm"), x, cfg)
    logits = L.unembed(L.sub(params, "embed"), L.sub(params, "lm_head"), x,
                       cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return (logits, aux) if caches is None else (logits, new_caches, aux)


def lm_loss(params: Params, cfg: ModelConfig, tokens, targets, mask,
            num_valid=None):
    """Per-example-weighted cross-entropy.

    mask: (B,) example weights or (B, S) token weights.  num_valid must agree
    with mask (rows >= num_valid carry zero weight).
    Returns (weighted loss sum, weight sum, aux).
    """
    logits, aux = apply_lm(params, cfg, tokens, num_valid=num_valid)
    nll = L.token_xent(logits, targets)
    tok_w = mask[:, None].expand_as(nll) if mask.dim() == 1 else mask
    return (nll * tok_w).sum(), tok_w.sum(), aux
