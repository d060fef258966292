"""Whisper-medium [arXiv:2212.04356]: encoder-decoder, 24+24L, d_model 1024,
16H MHA kv=16, plain-GELU d_ff 4096, vocab 51865, LayerNorm + biases.
Conv/mel frontend is the stub carve-out: encoder consumes precomputed frame
embeddings (B, 1500, 1024). No long_500k decode (DESIGN.md §5)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="encdec",
        num_layers=24,
        encoder_layers=24,
        encoder_seq=1500,
        d_model=1024,
        vocab_size=51_865,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        mlp="gelu",
        norm="layernorm",
        use_bias=True,
        tie_embeddings=True,
        norm_eps=1e-5,
    )
