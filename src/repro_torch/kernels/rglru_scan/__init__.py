from repro_torch.kernels.rglru_scan.kernel import (
    LAUNCHES,
    reset_launches,
    rglru_linear_scan,
    rglru_linear_scan_bwd,
    rglru_linear_scan_bwd_plain,
    rglru_linear_scan_plain,
)
from repro_torch.kernels.rglru_scan.ops import rglru
from repro_torch.kernels.rglru_scan.ref import rglru_scan

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "rglru",
    "rglru_linear_scan",
    "rglru_linear_scan_bwd",
    "rglru_linear_scan_bwd_plain",
    "rglru_linear_scan_plain",
    "rglru_scan",
]
