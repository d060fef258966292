"""Decoder-only LM: dense, MoE, ssm, hybrid and vlm families (the
reference's ``models/transformer.py``; the encoder-decoder is
``models/encdec.py``).

The reference stacks the layers' parameters and scans over them (over
groups of the block pattern for the hybrid family, with an unrolled tail);
PyTorch runs eagerly, so the layers are a Python loop over ``layers.{i}.*``
entries of a flat parameter dict, layer i of kind ``pattern[i % period]``.
Decode caches follow the same layout: a flat dict of ``layers.{i}.*``
tensors (``init_caches``), the batch on dim 0 of every one, where the
reference stacks them per group as ``(groups, B, ...)``.  A block's
attention is GQA or MLA (``cfg.attention``), its MLP dense or MoE; the aux
loss (MoE load balance) is summed over the blocks.

``cfg.remat`` checkpoints each group of the block pattern, as the
reference's ``jax.checkpoint`` over its scan body: the group's activations
are recomputed in the backward (the hybrid tail is not checkpointed), and
``remat_policy="dots"`` keeps the outputs of the matmuls without batch
dims (``aten.mm`` / ``aten.addmm``, the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest, the flash
kernels' forward included.  Nothing is checkpointed with decode caches or
without autograd.  Recomputing changes no number.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as C

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.shard_hooks import constrain

Params = L.Params


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return C.CheckpointPolicy.MUST_SAVE
    return C.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_options(cfg: ModelConfig) -> dict:
    if cfg.remat_policy == "dots":
        return {"context_fn": functools.partial(
            C.create_selective_checkpoint_contexts, _save_dots)}
    return {}


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
        init_attn = L.init_mla if cfg.attention == "mla" else L.init_gqa
        p.update(L.prefixed("attn", init_attn(gen, cfg)))
    elif kind == "rec":
        p.update(L.prefixed("rec", R.init_recurrent_block(gen, cfg)))
    else:
        raise ValueError(f"unknown block kind {kind}")
    p.update(L.prefixed("norm2", L.init_norm(cfg, gen.device)))
    if cfg.num_experts and cfg.mlp == "moe":
        p.update(L.prefixed("moe", L.init_moe(gen, cfg)))
    else:
        p.update(L.prefixed("mlp", L.init_mlp(gen, cfg)))
    return p


def apply_block(p: Params, x, cfg: ModelConfig, kind: str, positions,
                num_valid=None, cache=None):
    """One block -> (x, new_cache, aux); ``num_valid`` reaches the GQA
    attention kernels only (ssd and rec blocks ignore it, as in the
    reference, and MLA keeps the loss-mask semantics for padded rows: the
    kernel path is GQA only); local blocks attend over ``cfg.local_window``.
    ``cache`` is the block's decode state (``init_block_cache``), None for a
    full sequence (then new_cache is None).  aux is the MoE block's
    load-balance loss, else zero."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.apply_norm(L.sub(p, "norm1"), x, cfg)
    if kind == "ssd":
        out, new_cache = S.ssd_block(L.sub(p, "ssd"), h, cfg, cache)
        return x + out, new_cache, aux
    if kind == "rec":
        out, new_cache = R.recurrent_block(L.sub(p, "rec"), h, cfg, cache)
    else:
        window = cfg.local_window if kind == "local" else cfg.window
        if cfg.attention == "mla":
            out = L.mla_attention(L.sub(p, "attn"), h, cfg,
                                  positions=positions, cache=cache,
                                  window=window)
        else:
            out = L.gqa_attention(L.sub(p, "attn"), h, cfg,
                                  positions=positions, cache=cache,
                                  window=window, softcap=cfg.attn_softcap,
                                  num_valid=num_valid)
        new_cache = None
        if cache is not None:
            out, new_cache = out
    x = x + out
    h = L.apply_norm(L.sub(p, "norm2"), x, cfg)
    if cfg.num_experts and cfg.mlp == "moe":
        y, aux = L.apply_moe(L.sub(p, "moe"), h, cfg)
        return x + y, new_cache, aux
    return x + L.apply_mlp(L.sub(p, "mlp"), h, cfg), new_cache, aux


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, length: int,
                     dtype, device) -> Params:
    """One block's empty decode state; a local block's KV cache holds
    ``min(length, local_window)`` slots and a windowed dense block's
    ``min(length, window)`` (rings)."""
    if kind in ("attn", "local"):
        eff = min(length, cfg.local_window) if kind == "local" else (
            min(length, cfg.window) if cfg.window else length)
        if cfg.attention == "mla":
            return L.init_mla_cache(cfg, batch, eff, dtype, device)
        return L.init_attn_cache(cfg, batch, eff, dtype, device)
    if kind == "rec":
        return R.init_recurrent_cache(cfg, batch, dtype, device)
    return S.init_ssd_cache(cfg, batch, dtype, device)


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters on ``gen``'s device, drawn from ``gen``."""
    cfg.validate()
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
    device = resolve_device(device)
    dtype = dtype or cfg.act_dtype
    pattern = block_pattern(cfg)
    caches = {}
    for i in range(cfg.num_layers):
        caches.update(L.prefixed(f"layers.{i}", init_block_cache(
            cfg, pattern[i % len(pattern)], batch, length, dtype, device)))
    return caches


def apply_lm(params: Params, cfg: ModelConfig, tokens, *, prefix_embeds=None,
             positions=None, num_valid=None, caches=None):
    """tokens (B,S) int64 -> (logits (B,S,V), aux_loss scalar).

    prefix_embeds: optional (B, P, D) patch embeddings (the vlm family's
    stub frontend) overwriting the first P < S positions.
    num_valid: optional 0-d int32 valid-row count for bucket-padded batches,
    threaded to the attention kernels.
    caches: decode caches from :func:`init_caches` (S must be 1); then the
    result is (logits, new_caches, aux), the caches given left as they were.
    """
    pattern = block_pattern(cfg)
    period = len(pattern)
    s = tokens.shape[1]
    if caches is not None and s != 1:
        raise ValueError(f"decode with caches takes one token per row, "
                         f"got {s}")
    x = L.embed(L.sub(params, "embed"), tokens, cfg)
    if prefix_embeds is not None:
        p = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(x.dtype), x[:, p:]], dim=1)
    x = constrain(x, "activations")
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None, :]
    new_caches = {}

    def blocks(x, aux, layers):
        for i in layers:
            name = f"layers.{i}"
            x, nc, a = apply_block(L.sub(params, name), x, cfg,
                                   pattern[i % period], positions, num_valid,
                                   None if caches is None
                                   else L.sub(caches, name))
            x = constrain(x, "activations")
            aux = aux + a
            if caches is not None:
                new_caches.update(L.prefixed(name, nc))
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    grouped = cfg.num_layers // period * period
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for first in range(0, grouped, period):
        group = range(first, first + period)
        if remat:
            x, aux = C.checkpoint(functools.partial(blocks, layers=group), x,
                                  aux, use_reentrant=False,
                                  **_remat_options(cfg))
        else:
            x, aux = blocks(x, aux, group)
    x, aux = blocks(x, aux, range(grouped, cfg.num_layers))   # the tail
    x = L.apply_norm(L.sub(params, "final_norm"), x, cfg)
    logits = L.unembed(L.sub(params, "embed"), L.sub(params, "lm_head"), x,
                       cfg)
    return (logits, aux) if caches is None else (logits, new_caches, aux)


def lm_loss(params: Params, cfg: ModelConfig, tokens, targets, mask,
            prefix_embeds=None, num_valid=None):
    """Per-example-weighted cross-entropy.

    mask: (B,) example weights or (B, S) token weights.  num_valid must agree
    with mask (rows >= num_valid carry zero weight).  With prefix_embeds
    the P patch positions carry zero weight.
    Returns (weighted loss sum, weight sum, aux).
    """
    logits, aux = apply_lm(params, cfg, tokens, prefix_embeds=prefix_embeds,
                           num_valid=num_valid)
    nll = L.token_xent(logits, targets)
    tok_w = mask[:, None].expand_as(nll) if mask.dim() == 1 else mask
    if prefix_embeds is not None:  # no loss on the patch positions
        # out of place: a DTensor has no in-place fill of a slice
        patch = torch.arange(tok_w.shape[1], device=tok_w.device) \
            < prefix_embeds.shape[1]
        tok_w = torch.where(patch, torch.zeros((), dtype=tok_w.dtype,
                                               device=tok_w.device), tok_w)
    return (nll * tok_w).sum(), tok_w.sum(), aux


def init_model(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """``init_encdec`` for the encdec family, else ``init_lm``."""
    if cfg.family == "encdec":
        from repro_torch.models.encdec import init_encdec

        return init_encdec(gen, cfg)
    return init_lm(gen, cfg)


def param_count(cfg: ModelConfig) -> int:
    """Parameter count of ``cfg``'s model, from tensors that carry shapes
    and no storage (nothing is allocated, so a 314B config counts on any
    host)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = init_model(torch.Generator(), cfg)
    return sum(p.numel() for p in params.values())
