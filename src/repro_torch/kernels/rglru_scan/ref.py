"""Oracle for the RG-LRU kernels: the associative-scan path of
``repro_torch.models.recurrent``."""

from repro_torch.models.recurrent import rglru_scan

__all__ = ["rglru_scan"]
