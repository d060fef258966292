"""Gemma-2B [arXiv:2403.08295]: 18L, d_model 2048, 8H MQA kv=1 head_dim 256,
GeGLU d_ff 16384, vocab 256000, tied + scaled embeddings."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        num_layers=18,
        d_model=2048,
        vocab_size=256_000,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16_384,
        mlp="geglu",
        tie_embeddings=True,
        scale_embeddings=True,
        rope_theta=10_000.0,
    )
