"""Device meshes over the current process group (the reference's
``launch/mesh.py``).

Functions, not module constants: importing this module touches no
process-group state.  Each returns a ``DeviceMesh`` with named dimensions
over ranks ``0 .. n-1`` of the default group, which must already exist
(``compat.init_group``): a ``fake`` group of 256 or 512 ranks stands in for
the production meshes in one process (``launch/dryrun.py``), gloo ranks on
the CPU or NCCL ranks on the cards run them for real.  A mesh larger than
the group raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.compat import DeviceMesh, axis_names, axis_size

__all__ = ["data_axes", "make_data_mesh", "make_debug_mesh", "make_mesh",
           "make_production_mesh", "model_axis_size"]


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` named ``names`` over the default group's first
    ``prod(shape)`` ranks, on the cards for an NCCL group, else the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one with "
                           "repro_torch.compat.init_group first")
    n = math.prod(shape)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks; the process group has {world}")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 devices, or 2 pods = 2x16x16 = 512."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_debug_mesh(devices: int = 8) -> DeviceMesh:
    """A small (devices // 2, 2) data x model mesh for tests."""
    return make_mesh((devices // 2, 2), ("data", "model"))


def make_data_mesh(num_devices: Optional[int] = None) -> DeviceMesh:
    """A 1-D data-parallel mesh over the group (all of it by default)."""
    n = dist.get_world_size() if num_devices is None else num_devices
    return make_mesh((n,), ("data",))


def data_axes(mesh) -> tuple[str, ...]:
    """Axes carrying the batch dimension."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return axis_size(mesh, "model")
