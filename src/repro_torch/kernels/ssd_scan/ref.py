"""Oracle for the SSD kernels: the plain chunked scan from
``repro_torch.models.ssm``."""

from repro_torch.models.ssm import segsum, ssd_chunked

__all__ = ["segsum", "ssd_chunked"]
