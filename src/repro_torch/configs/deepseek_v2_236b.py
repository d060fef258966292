"""DeepSeek-V2 236B [arXiv:2405.04434]: 60L, d_model 5120, MLA with 128 heads
(q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64, v_head 128), MoE with
160 routed experts top-6 + 2 shared, expert d_ff 1536, vocab 102400.

Note: the released model's first layer is a dense FFN; the assigned spec is
uniform MoE, which we follow (param count ~239B either way).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        vocab_size=102_400,
        attention="mla",
        num_heads=128,
        head_dim=0,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        mlp="moe",
        num_experts=160,
        num_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1536,
        rope_theta=10_000.0,
    )
