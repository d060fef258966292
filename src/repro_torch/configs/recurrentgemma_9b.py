"""RecurrentGemma-9B [arXiv:2402.19427]: 38 blocks in a (rec, rec, attn)
pattern (RG-LRU recurrent blocks + local sliding-window attention, 1 attn
per 2 recurrent), d_model 4096, 16H MQA kv=1 head_dim 256, GeGLU d_ff 12288,
lru_width 4096, local window 2048, vocab 256000."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        vocab_size=256_000,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12_288,
        mlp="geglu",
        block_pattern=("rec", "rec", "local"),
        lru_width=4096,
        local_window=2048,
        conv_kernel=4,
        tie_embeddings=True,
        scale_embeddings=True,
        rope_theta=10_000.0,
    )
