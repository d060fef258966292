"""Grok-1 314B [hf:xai-org/grok-1]: 64L, d_model 6144, 48H GQA kv=8,
MoE 8 experts top-2 with expert d_ff 32768, vocab 131072, attention and
output logit soft-capping (30)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        vocab_size=131_072,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        mlp="moe",
        num_experts=8,
        moe_top_k=2,
        moe_d_ff=32_768,
        attn_softcap=30.0,
        logit_softcap=30.0,
        rope_theta=10_000.0,
    )
