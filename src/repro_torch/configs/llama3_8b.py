"""Llama-3 8B [arXiv:2407.21783]: 32L, d_model 4096, 32H GQA kv=8,
d_ff 14336 (SwiGLU), vocab 128256, rope theta 500k."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        vocab_size=128_256,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14_336,
        mlp="swiglu",
        rope_theta=500_000.0,
        # long_500k uses the sliding-window variant (DESIGN.md §5):
        # cfg.with_(window=4096)
    )
