"""Execution backends: where an Experiment's training loop runs.

:class:`SimBackend` is real SGD on a PyTorch device under the calibrated
heterogeneity simulator's clock.  The measured backend (the reference's
``MeshBackend``: per-worker CUDA streams timed by CUDA events) is a later
slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train.elastic import ElasticTrainer


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
