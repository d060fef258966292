from repro_torch.kernels.ssd_scan.kernel import (
    LAUNCHES,
    reset_launches,
    ssd_intra_chunk,
    ssd_intra_chunk_bwd,
    ssd_intra_chunk_bwd_plain,
    ssd_intra_chunk_plain,
)
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "ssd",
    "ssd_chunked",
    "ssd_intra_chunk",
    "ssd_intra_chunk_bwd",
    "ssd_intra_chunk_bwd_plain",
    "ssd_intra_chunk_plain",
]
