"""Execution backends: where an Experiment's training loop runs.

  * :class:`SimBackend` — real SGD on a PyTorch device under the calibrated
    heterogeneity simulator's clock;
  * :class:`MeshBackend` — the measured backend: real SGD over a list of
    devices, workers on disjoint slices of it dispatched concurrently
    (max-of-workers BSP rounds) when there is a device a worker, ragged
    per-worker batches padded to a bucket ladder, each worker's gradient
    call timed (CUDA events on a card), and the controller fed those
    measured times (``repro_torch.train.mesh``).

The same ``Experiment`` runs unchanged on either; select with
``ClusterSpec(backend=...)``.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence, Union, runtime_checkable

from repro_torch.device import (DeviceLike, DevicesLike, resolve_device,
                                resolve_devices)
from repro_torch.train.elastic import ElasticTrainer
from repro_torch.train.mesh import MeshTrainer, dilation_from_specs


@runtime_checkable
class Backend(Protocol):
    """Builds a Session-drivable trainer for an experiment."""

    name: str

    def build_trainer(self, *, workload, cluster, optimizer, cfg):
        ...


@dataclasses.dataclass
class SimBackend:
    """Real SGD, simulated clock.

    ``device``: where parameters, gradients and batches live; ``None``
    means the CUDA card, and raises when there is none.  The backend
    carries its device to the trainer and to the workload's data feed.
    """

    device: DeviceLike = None
    name: str = dataclasses.field(default="sim", init=False)

    def build_trainer(self, *, workload, cluster, optimizer, cfg):
        if getattr(cluster, "serve", None) is not None:
            raise ValueError(
                "co-located serving (ClusterSpec.serve) needs real devices "
                "to share — use ClusterSpec(backend=MeshBackend(...)); the "
                "sim backend has no mesh to carve a serve slice from "
                "(DESIGN.md §13)")
        device = resolve_device(self.device)
        if workload.to is not None:
            workload.to(device)
        return ElasticTrainer(
            sim=cluster.build(),
            init_params=workload.init,
            loss_and_grad=workload.loss_and_grad,
            next_batch=workload.next_batch,
            optimizer=optimizer,
            cfg=cfg,
            device=device,
        )


@dataclasses.dataclass
class MeshBackend:
    """The measured backend (``repro_torch.train.mesh``).

    ``device``: the data axis, a list of torch devices (the counterpart of
    the reference's mesh); one device is an axis of one, and ``None`` takes
    every visible card, raising when there is none.  A CUDA device may
    appear once; ``"cpu"`` may repeat (its times then measure shared
    hardware).  ``dilation`` controls heterogeneity emulation:

      * ``None``        — honest measurement only (homogeneous devices give
                          near-equal times, so the controller converges to
                          near-equal batches);
      * ``"from-spec"`` — dilate worker k's measured time by the
                          ``ClusterSpec``'s declared relative speed (Amdahl
                          x flops), so the closed loop reproduces the
                          simulated heterogeneity on real hardware;
      * a sequence      — explicit per-worker factors.

    ``growth`` is the bucket-ladder ratio (warm-up reruns per worker are
    bounded by ``ceil(log_growth(b_max/b_min)) + 1``); ``time_alpha`` the
    measurement EWMA.  ``concurrent`` (default on) maps the workers onto
    disjoint slices of the devices dispatched in parallel, so a BSP round
    costs max-of-workers time; with fewer devices than workers (one card)
    the workers take the devices one after another, and
    ``concurrent=False`` forces that sequential round.  BSP, ASP, elastic
    membership and ``Session.save/restore`` are supported; a
    ``ClusterSpec.serve`` builds the co-located trainer
    (``repro_torch.train.colocate``).
    """

    dilation: Union[None, str, Sequence[float]] = None
    growth: float = 1.25
    time_alpha: float = 0.5
    device: DevicesLike = None
    concurrent: bool = True
    name: str = dataclasses.field(default="mesh", init=False)

    def build_trainer(self, *, workload, cluster, optimizer, cfg):
        devices = resolve_devices(self.device)
        dilation_for_spec = None
        if self.dilation is None:
            worker_dilation = None
        elif isinstance(self.dilation, str):
            if self.dilation != "from-spec":
                raise ValueError(
                    f"dilation must be None, 'from-spec' or a sequence; "
                    f"got {self.dilation!r}")
            worker_dilation, dilation_for_spec = dilation_from_specs(
                cluster.workers, amdahl_p=cluster.sim_workload.amdahl_p)
        else:
            worker_dilation = list(self.dilation)
        if workload.to is not None:
            workload.to(devices[0])
        kw = dict(
            num_workers=len(cluster.workers),
            init_params=workload.init,
            loss_and_grad=workload.loss_and_grad,
            next_batch=workload.next_batch,
            optimizer=optimizer,
            cfg=cfg,
            growth=self.growth,
            time_alpha=self.time_alpha,
            worker_dilation=worker_dilation,
            dilation_for_spec=dilation_for_spec,
            device=devices,
            concurrent=self.concurrent,
        )
        serve = getattr(cluster, "serve", None)
        if serve is not None:
            from repro_torch.train.colocate import ColocatedMeshTrainer

            return ColocatedMeshTrainer(serve=serve, **kw)
        return MeshTrainer(**kw)
