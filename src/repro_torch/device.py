"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Sequence, Union

import torch

DeviceLike = Union[None, str, torch.device]
DevicesLike = Union[DeviceLike, Sequence[Union[str, torch.device]]]

_NO_CARD = ("no CUDA device is available; pass device='cpu' to run on the "
            "CPU (the kernels then take their plain PyTorch versions)")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; anything else is taken as given.

    Never falls back to the CPU silently: with no card present the caller
    must ask for ``device="cpu"`` explicitly.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(_NO_CARD)
    return torch.device("cuda")


def resolve_devices(devices: DevicesLike = None) -> list[torch.device]:
    """The measured backend's data axis: one torch device a row.

    ``None`` means every visible card (raising when there is none, as
    :func:`resolve_device` does); one device is an axis of one; a list is
    taken as given.  A CUDA device may appear only once, since two workers
    on one card would each time the other's work; ``"cpu"`` may repeat.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(_NO_CARD)
        out = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (list, tuple)):
        if not devices:
            raise ValueError("the device list is empty")
        out = [torch.device(d) for d in devices]
    else:
        out = [resolve_device(devices)]
    cards = [0 if d.index is None else d.index
             for d in out if d.type == "cuda"]
    repeated = sorted({i for i in cards if cards.count(i) > 1})
    if repeated:
        raise ValueError(
            f"cuda:{repeated[0]} appears more than once in {out}: two workers "
            f"on one card would each time the other's work — give each "
            f"worker slice cards of its own ('cpu' may repeat)")
    return out
