"""Mamba2-1.3B [arXiv:2405.21060]: 48L attention-free SSD blocks,
d_model 2048 (d_inner 4096, 64 heads x head_dim 64), ssm_state 128,
vocab 50280, tied embeddings."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        vocab_size=50_280,
        attention="none",
        mlp="none",
        d_ff=0,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_ngroups=1,
        ssm_chunk=64,
        conv_kernel=4,
        tie_embeddings=True,
    )
