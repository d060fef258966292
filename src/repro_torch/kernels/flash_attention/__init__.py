from repro_torch.kernels.flash_attention.kernel import (
    LAUNCHES,
    flash_bwd_dkv,
    flash_bwd_dkv_heads_plain,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
    flash_fwd,
    flash_fwd_plain,
    reset_launches,
)
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = [
    "LAUNCHES",
    "attention",
    "attention_ref",
    "flash_bwd_dkv",
    "flash_bwd_dkv_heads_plain",
    "flash_bwd_dkv_plain",
    "flash_bwd_dq",
    "flash_bwd_dq_plain",
    "flash_fwd",
    "flash_fwd_plain",
    "reset_launches",
]
