"""Unified model configuration covering all assigned architecture families
(the reference's ``ModelConfig``; dtypes resolve to torch dtypes)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Families: 'dense' | 'moe' | 'ssm' | 'hybrid' | 'encdec' | 'vlm'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    vocab_size: int
    # attention ('gqa' covers MHA/GQA/MQA via num_kv_heads; 'mla'; 'none')
    attention: str = "gqa"
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # sliding-window size (None = full causal)
    attn_chunk: Optional[int] = None      # online-softmax kv-chunk (None=dense)
    # mlp: 'swiglu' | 'geglu' | 'gelu' | 'moe' | 'none'
    mlp: str = "swiglu"
    d_ff: int = 0
    use_bias: bool = False
    norm: str = "rmsnorm"                  # 'rmsnorm' | 'layernorm'
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embeddings: bool = False         # gemma-style sqrt(d_model) scaling
    logit_softcap: Optional[float] = None  # grok/gemma2-style tanh soft-capping
    attn_softcap: Optional[float] = None   # attention-logit soft-capping (grok)
    # --- MoE (GShard-style one-hot dispatch; experts sharded over `model`)
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_group_size: int = 1024             # router group size (tokens)
    moe_capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- MLA (deepseek-v2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- SSM / Mamba-2 SSD
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 64
    conv_kernel: int = 4
    # --- hybrid (recurrentgemma / griffin)
    block_pattern: Tuple[str, ...] = ("attn",)   # e.g. ('rec','rec','attn')
    lru_width: int = 0
    local_window: int = 2048                     # hybrid local-attention window
    # --- encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0                          # e.g. 1500 audio frames
    # --- vlm (phi-3-vision)
    num_patches: int = 0                          # vision prefix length (stub)
    # --- numerics / kernels
    dtype: str = "float32"                        # activation/compute dtype
    param_dtype: str = "float32"
    use_pallas: bool = False                      # hand-written kernels (flash, SSD, RG-LRU)
    remat: bool = False                           # activation checkpoint per block
    remat_policy: str = "full"                    # 'full' | 'dots' (save matmuls)
    scan_unroll: int = 1                          # lax.scan unroll (cost probes)

    # ------------------------------------------------------------------

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def q_dim(self) -> int:
        if self.attention == "mla":
            return self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.num_heads * self.head_dim

    def validate(self) -> None:
        if self.family not in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm"):
            raise ValueError(f"unknown family {self.family}")
        if self.attention == "gqa":
            if self.num_heads % max(self.num_kv_heads, 1) != 0:
                raise ValueError("num_heads must be divisible by num_kv_heads")
        if self.mlp == "moe" or self.num_experts:
            if self.moe_top_k < 1 or self.moe_top_k > self.num_experts:
                raise ValueError("bad MoE top_k")
        if self.family == "ssm" and self.d_inner % self.ssm_head_dim != 0:
            raise ValueError("d_inner must be divisible by ssm_head_dim")
        if self.family == "hybrid":
            nl = self.num_layers
            if not self.block_pattern:
                raise ValueError("hybrid needs a block_pattern")

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, **extra) -> ModelConfig:
    """A tiny CPU-runnable variant of the same family (smoke tests)."""
    layers = len(cfg.block_pattern) if cfg.family == "hybrid" else 2
    layers = max(2, layers)
    kw = dict(
        num_layers=layers,
        d_model=min(cfg.d_model, 128),
        vocab_size=min(cfg.vocab_size, 512),
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=min(cfg.encoder_seq, 16) if cfg.encoder_seq else 0,
        num_patches=min(cfg.num_patches, 8) if cfg.num_patches else 0,
        moe_group_size=16,
    )
    if cfg.attention == "gqa":
        heads = min(cfg.num_heads, 4)
        ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
        kv = max(1, heads // min(ratio, heads))
        kw.update(num_heads=heads, num_kv_heads=kv, head_dim=32)
    elif cfg.attention == "mla":
        kw.update(
            num_heads=4, q_lora_rank=32, kv_lora_rank=16,
            qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        )
    if cfg.num_experts:
        kw.update(num_experts=min(cfg.num_experts, 4),
                  moe_top_k=min(cfg.moe_top_k, 2),
                  moe_d_ff=min(cfg.moe_d_ff, 64) if cfg.moe_d_ff else 0,
                  num_shared_experts=min(cfg.num_shared_experts, 1))
    if cfg.family == "ssm":
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.family == "hybrid":
        kw.update(lru_width=min(cfg.lru_width, 128) or 128, local_window=8,
                  num_layers=len(cfg.block_pattern) + min(
                      2, cfg.num_layers % len(cfg.block_pattern) or 2))
        kw.update(num_heads=2, num_kv_heads=1, head_dim=64)
    if cfg.window is not None:
        kw.update(window=8)
    kw.update(extra)
    return cfg.with_(**kw)
