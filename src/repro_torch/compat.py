"""The one place that imports PyTorch's distributed tensor API.

DTensor, ``DeviceMesh``, the placements, the functional collectives and the
fake store moved between releases: the public ``torch.distributed.tensor``
against the older ``torch.distributed._tensor``, and ``FakeStore`` /
the ``fake`` backend under ``torch.testing._internal``.  Import them from
here so every supported release works (the reference's ``compat.py`` does
the same for jax's ``shard_map``).

Process groups are made and destroyed only through :func:`init_group` and
:func:`destroy_group`.  A group is global to its process, so whoever makes
one destroys it in a ``finally``.  The store is a ``HashStore`` for a
single rank, a ``FileStore`` (a path) for several ranks, or a ``FakeStore``
for the ``fake`` backend, which stands in for hundreds of ranks in one
process; never TCP.

Importing this module touches no process-group state.
"""

from __future__ import annotations

import contextlib
import math
from typing import Union

import torch
import torch.distributed as dist

try:  # torch >= 2.4
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor import zeros as dtensor_zeros
except ImportError:  # older: the private home
    from torch.distributed._tensor import (DTensor,  # type: ignore
                                           Partial, Replicate, Shard)
    from torch.distributed._tensor import (  # type: ignore
        zeros as dtensor_zeros)
from torch.distributed.device_mesh import DeviceMesh
import torch.distributed._functional_collectives as funcol

try:
    from torch.distributed.tensor.experimental import implicit_replication
except ImportError:
    from torch.distributed._tensor.experimental import (  # type: ignore
        implicit_replication)

__all__ = ["DTensor", "DeviceMesh", "Partial", "Replicate", "Shard",
           "axis_names",
           "axis_size", "destroy_group", "dtensor_zeros", "from_local",
           "funcol", "greedy_redistribute_plans", "implicit_replication",
           "init_group", "local_shape", "mesh_dim", "place",
           "sharded_run", "to_placements"]


def _fake_store():
    # importing the module registers the "fake" backend where it is not
    # built in
    from torch.testing._internal.distributed.fake_pg import FakeStore

    return FakeStore()


def init_group(backend: str = "gloo", world_size: int = 1, rank: int = 0,
               store: Union[str, "dist.Store", None] = None) -> None:
    """Start this process's default group.

    ``store``: a ``dist.Store``, a path (a ``FileStore`` shared by the
    ranks) or None: a ``HashStore`` for one rank, a ``FakeStore`` for the
    ``fake`` backend.  Raises if a group already exists."""
    if dist.is_initialized():
        raise RuntimeError("a process group already exists in this process; "
                           "destroy it first (compat.destroy_group)")
    if backend == "fake":
        store = _fake_store() if store is None else store
    elif isinstance(store, str):
        store = dist.FileStore(store, world_size)
    elif store is None:
        if world_size != 1:
            raise ValueError(f"{world_size} ranks need a shared store: pass "
                             f"the path of a FileStore")
        store = dist.HashStore()
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, store=store, world_size=world_size,
                            rank=rank, **kwargs)


def destroy_group() -> None:
    """Destroy the default group (and every sub-group) if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------- DeviceMesh or jax mesh


def axis_names(mesh) -> tuple[str, ...]:
    """Axis names of a ``DeviceMesh`` or of a jax-style mesh (an object
    with ``axis_names`` and a ``shape`` mapping, as the reference's tests
    use)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_size(mesh, axis) -> int:
    """Devices along ``axis`` (a name, or a tuple of names: the product)."""
    if axis is None:
        return 1
    axes = axis if isinstance(axis, tuple) else (axis,)
    if isinstance(mesh, DeviceMesh):
        names = axis_names(mesh)
        return math.prod(mesh.size(names.index(a)) for a in axes)
    return math.prod(mesh.shape[a] for a in axes)


def mesh_dim(mesh: DeviceMesh, axis: str) -> int:
    return axis_names(mesh).index(axis)


def to_placements(spec, mesh) -> list:
    """Partition-spec entries (one per tensor dim: None, an axis name, or a
    tuple of names) -> DTensor placements (one per mesh dim).  A tuple
    entry puts ``Shard(d)`` on each of its mesh dims.  DTensor splits a dim
    sharded over several mesh dims in mesh-dim order, so for an entry such
    as ``("model", "data")`` the local shard's shape is the reference's but
    which rank holds which slice follows the mesh's order, not the
    entry's."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in entry if isinstance(entry, tuple) else (entry,):
            i = names.index(axis)
            if out[i] != Replicate():
                raise ValueError(f"spec {tuple(spec)} maps mesh axis "
                                 f"{axis!r} twice")
            out[i] = Shard(d)
    return out


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """Each device's shard shape of a ``shape`` tensor under ``spec``
    (every entry divides its dim: the rules check that)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, spec):
        n = axis_size(mesh, entry)
        if dim % n:
            raise ValueError(f"dim {dim} does not split {n} ways")
        out.append(dim // n)
    return tuple(out)


def _contiguous_strides(shape) -> tuple[int, ...]:
    strides, acc = [], 1
    for d in reversed(tuple(shape)):
        strides.append(acc)
        acc *= d
    return tuple(reversed(strides))


def from_local(local, mesh, placements, shape) -> "DTensor":
    """A DTensor of global ``shape`` from this rank's (contiguous) shard."""
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def place(x: torch.Tensor, mesh, placements) -> "DTensor":
    """A DTensor from a whole tensor that every rank holds alike: each rank
    keeps its slice (a local split, no collective)."""
    rep = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, placements)


@contextlib.contextmanager
def greedy_redistribute_plans():
    """Plan greedily every redistribution that involves no strided shard.

    DTensor takes its min-cost planner (a search over placement states,
    exponential in the mesh dims) wherever a strided shard or a shard
    order other than the mesh's is involved, both to run a redistribution
    and to price each candidate strategy: on a 2x16x16 mesh a one-layer
    program does not finish, and on 2 x 2 it is most of a train step's
    first run.  The greedy plan is sound for shard orders, which it reads
    from the mesh's order as the placements give it, but not for strided
    shards: it sizes their uneven shards from this rank's coordinate, so
    ranks plan collectives of different sizes.  Those keep the min-cost
    planner.  Plans are cached per spec pair, so the cache is cleared on
    the way in and out.  A release without the min-cost planner is left
    as it is."""
    try:
        from torch.distributed.tensor._redistribute import (
            DTensorRedistributePlanner as planner, _gen_transform_infos)
        from torch.distributed.tensor.placement_types import _StridedShard
        graph = planner.__dict__["generate_graph_based_transform_infos"]
    except (ImportError, KeyError):
        yield
        return

    def plan(self, src_spec, dst_spec, *args, **kwargs):
        if any(isinstance(p, _StridedShard)
               for p in (*src_spec.placements, *dst_spec.placements)):
            return graph(self, src_spec, dst_spec, *args, **kwargs)
        return self.generate_greedy_transform_infos(src_spec, dst_spec)

    planner.generate_graph_based_transform_infos = plan
    _gen_transform_infos.cache_clear()
    try:
        yield
    finally:
        planner.generate_graph_based_transform_infos = graph
        _gen_transform_infos.cache_clear()


@contextlib.contextmanager
def sharded_run():
    """The context every sharded program of the port runs in: plain
    tensors count as replicated (``implicit_replication``) and every
    redistribution is planned greedily (``greedy_redistribute_plans``)."""
    with implicit_replication(), greedy_redistribute_plans():
        yield
