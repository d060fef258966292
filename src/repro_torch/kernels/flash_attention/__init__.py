from repro_torch.kernels.flash_attention.kernel import (
    LAUNCHES,
    LAUNCHES_16,
    LSE_TOL,
    dkv16_splits,
    flash_bwd_dkv,
    flash_bwd_dkv_heads_plain,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
    flash_delta,
    flash_delta_plain,
    flash_fwd,
    flash_fwd_plain,
    reset_launches,
    row_error,
)
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = [
    "LAUNCHES",
    "LAUNCHES_16",
    "LSE_TOL",
    "attention",
    "attention_ref",
    "dkv16_splits",
    "flash_bwd_dkv",
    "flash_bwd_dkv_heads_plain",
    "flash_bwd_dkv_plain",
    "flash_bwd_dq",
    "flash_bwd_dq_plain",
    "flash_delta",
    "flash_delta_plain",
    "flash_fwd",
    "flash_fwd_plain",
    "reset_launches",
    "row_error",
]
