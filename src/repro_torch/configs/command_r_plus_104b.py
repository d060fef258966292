"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-v01 family]: 64L,
d_model 12288, 96H GQA kv=8, d_ff 33792, vocab 256000, no biases, tied
embeddings."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        num_layers=64,
        d_model=12_288,
        vocab_size=256_000,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        d_ff=33_792,
        mlp="swiglu",
        tie_embeddings=True,
        rope_theta=75_000_000.0,
    )
