"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct]: phi-3-mini
backbone (32L, d_model 3072, 32H MHA kv=32, SwiGLU d_ff 8192, vocab 32064)
+ CLIP vision encoder. The vision tower/projector is the stub carve-out:
the LM consumes 576 precomputed patch embeddings as a prefix."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        num_layers=32,
        d_model=3072,
        vocab_size=32_064,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        mlp="swiglu",
        num_patches=576,
        rope_theta=10_000.0,
    )
