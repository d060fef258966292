"""Encoder-decoder transformer backbone, Whisper-style [arXiv:2212.04356]
(the reference's ``models/encdec.py``).

The mel-spectrogram and conv1d frontend is a stub, as in the reference: the
encoder takes precomputed frame embeddings (B, T_enc, D).  Positions are
sinusoidal on both sides, computed at the positions asked for (no table).
Layer parameters are flat, ``enc.{i}.*`` and ``dec.{i}.*`` (the reference
stacks them on a leading layer axis and scans); decode caches are
``dec.{i}.{k,v,idx}`` with the batch on dim 0.  Attention here always takes
the plain scores: the reference's encdec route never sets ``use_pallas``.
"""

from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.shard_hooks import constrain

Params = L.Params


def init_enc_block(gen, cfg: ModelConfig) -> Params:
    p = L.prefixed("norm1", L.init_norm(cfg, gen.device))
    p.update(L.prefixed("attn", L.init_gqa(gen, cfg)))
    p.update(L.prefixed("norm2", L.init_norm(cfg, gen.device)))
    p.update(L.prefixed("mlp", L.init_mlp(gen, cfg)))
    return p


def init_dec_block(gen, cfg: ModelConfig) -> Params:
    p = L.prefixed("norm1", L.init_norm(cfg, gen.device))
    p.update(L.prefixed("self_attn", L.init_gqa(gen, cfg)))
    p.update(L.prefixed("norm_x", L.init_norm(cfg, gen.device)))
    p.update(L.prefixed("cross_attn", L.init_gqa(gen, cfg)))
    p.update(L.prefixed("norm2", L.init_norm(cfg, gen.device)))
    p.update(L.prefixed("mlp", L.init_mlp(gen, cfg)))
    return p


def init_encdec(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters on ``gen``'s device, drawn from ``gen``."""
    cfg.validate()
    params = L.prefixed("embed", L.init_embedding(gen, cfg))
    for i in range(cfg.encoder_layers):
        params.update(L.prefixed(f"enc.{i}", init_enc_block(gen, cfg)))
    params.update(L.prefixed("enc_norm", L.init_norm(cfg, gen.device)))
    for i in range(cfg.num_layers):
        params.update(L.prefixed(f"dec.{i}", init_dec_block(gen, cfg)))
    params.update(L.prefixed("final_norm", L.init_norm(cfg, gen.device)))
    return params


def encode(params: Params, cfg: ModelConfig, frames):
    """frames (B, T_enc, D) stub-frontend embeddings -> (B, T_enc, D):
    non-causal self-attention without RoPE."""
    t = frames.shape[1]
    x = frames.to(cfg.act_dtype) + L.sinusoidal_positions(
        t, cfg.d_model, device=frames.device).to(cfg.act_dtype)[None]
    for i in range(cfg.encoder_layers):
        p = L.sub(params, f"enc.{i}")
        x = x + L.gqa_attention(L.sub(p, "attn"),
                                L.apply_norm(L.sub(p, "norm1"), x, cfg), cfg,
                                use_rope=False, causal=False)
        x = x + L.apply_mlp(L.sub(p, "mlp"),
                            L.apply_norm(L.sub(p, "norm2"), x, cfg), cfg)
        x = constrain(x, "activations")
    return L.apply_norm(L.sub(params, "enc_norm"), x, cfg)


def _cross_kv(p_block: Params, cfg: ModelConfig, enc_out):
    b, t, _ = enc_out.shape
    dh = cfg.head_dim
    k = L.linear(L.sub(p_block, "cross_attn.wk"), enc_out).reshape(b, t, -1, dh)
    v = L.linear(L.sub(p_block, "cross_attn.wv"), enc_out).reshape(b, t, -1, dh)
    return k, v


def decode(params: Params, cfg: ModelConfig, tokens, enc_out, caches=None,
           positions=None):
    """tokens (B, S), enc_out (B, T_enc, D) -> (logits (B, S, V),
    new_caches): causal self-attention (through ``caches`` from
    :func:`init_dec_caches` when given, one token a row; the caches given
    are left as they were), then cross-attention on the encoder output.
    new_caches is None without caches."""
    s = tokens.shape[1]
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None, :]
    x = L.embed(L.sub(params, "embed"), tokens, cfg)
    x = x + L.sinusoidal_at(positions, cfg.d_model).to(x.dtype)
    new_caches = {}
    for i in range(cfg.num_layers):
        name = f"dec.{i}"
        p = L.sub(params, name)
        h = L.gqa_attention(L.sub(p, "self_attn"),
                            L.apply_norm(L.sub(p, "norm1"), x, cfg), cfg,
                            positions=positions, use_rope=False,
                            cache=None if caches is None
                            else L.sub(caches, name))
        if caches is not None:
            h, nc = h
            new_caches.update(L.prefixed(name, nc))
        x = x + h
        x = x + L.gqa_attention(L.sub(p, "cross_attn"),
                                L.apply_norm(L.sub(p, "norm_x"), x, cfg), cfg,
                                cross_kv=_cross_kv(p, cfg, enc_out),
                                use_rope=False)
        x = x + L.apply_mlp(L.sub(p, "mlp"),
                            L.apply_norm(L.sub(p, "norm2"), x, cfg), cfg)
        x = constrain(x, "activations")
    x = L.apply_norm(L.sub(params, "final_norm"), x, cfg)
    logits = L.unembed(L.sub(params, "embed"), None, x, cfg)
    return logits, (new_caches if caches is not None else None)


def init_dec_caches(cfg: ModelConfig, batch: int, length: int, dtype=None,
                    device: DeviceLike = None) -> Params:
    """Empty self-attention caches for ``batch`` rows of ``length``
    positions on ``device`` (the card unless the caller asks for the CPU):
    ``dec.{i}.{k,v,idx}``."""
    device = resolve_device(device)
    dtype = dtype or cfg.act_dtype
    caches = {}
    for i in range(cfg.num_layers):
        caches.update(L.prefixed(f"dec.{i}", L.init_attn_cache(
            cfg, batch, length, dtype, device)))
    return caches


def encdec_loss(params: Params, cfg: ModelConfig, frames, tokens, targets,
                mask):
    """Weighted seq2seq cross-entropy; mask (B,) or (B, S).
    Returns (weighted loss sum, weight sum, aux = 0)."""
    logits, _ = decode(params, cfg, tokens, encode(params, cfg, frames))
    nll = L.token_xent(logits, targets)
    tok_w = mask[:, None].expand_as(nll) if mask.dim() == 1 else mask
    return ((nll * tok_w).sum(), tok_w.sum(),
            torch.zeros((), dtype=torch.float32, device=logits.device))
