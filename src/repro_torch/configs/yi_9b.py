"""Yi-9B [arXiv:2403.04652]: llama-arch, 48L, d_model 4096, 32H GQA kv=4,
d_ff 11008, vocab 64000."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        num_layers=48,
        d_model=4096,
        vocab_size=64_000,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11_008,
        mlp="swiglu",
        rope_theta=10_000.0,
    )
