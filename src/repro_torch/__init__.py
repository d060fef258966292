"""PyTorch / CUDA port of the ``repro`` package (heterogeneous dynamic-batch
training), mirroring its layout module for module.

The package imports torch, numpy and the standard library only.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`); on a CPU tensor every kernel
wrapper runs its plain PyTorch version, on a CUDA tensor it launches the
hand-written Hopper kernel.
"""
