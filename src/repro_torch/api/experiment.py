"""Experiment: the one front door for heterogeneous dynamic-batch training.

An Experiment is pure description — *what* to train (:class:`Workload`),
*where* (:class:`ClusterSpec`, including its membership schedule), *how*
(:class:`~repro_torch.train.loop.TrainConfig` + optimizer), and who watches
(:class:`~repro_torch.api.session.Hook`s).  ``build()`` wires the engine
(``ElasticTrainer`` over the simulated cluster), ``session()`` hands back
the unified step iterator, ``run()`` is the one-call path:

    cfg = get_config("gemma-2b", num_layers=2)
    out = Experiment(
        workload=lm_workload(cfg, DataPipeline(cfg, seq_len=1024,
                                               num_workers=3),
                             use_kernel=True),
        cluster=ClusterSpec.hlevel(39, 6.0, 3, workload="transformer"),
        optimizer=adam(1e-3),
        config=TrainConfig(b0=4, microbatch=2, batching="dynamic"),
    ).run()

With no backend on the cluster, the experiment runs on ``SimBackend()``,
i.e. on the CUDA card; ``ClusterSpec(backend=SimBackend(device="cpu"))``
runs it on the CPU.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence

from repro_torch.api.backend import SimBackend
from repro_torch.api.cluster import ClusterSpec
from repro_torch.api.session import Hook, Session
from repro_torch.api.workload import Workload
from repro_torch.optim.optimizers import Optimizer
from repro_torch.train.loop import TrainConfig


@dataclasses.dataclass
class Experiment:
    """Declarative experiment = workload + cluster + config + hooks."""

    workload: Workload
    cluster: ClusterSpec
    optimizer: Optimizer
    config: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    hooks: Sequence[Hook] = ()
    _workload_state0: Optional[dict] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def build(self):
        """Construct the engine on the cluster's execution backend.

        The default :class:`~repro_torch.api.backend.SimBackend` yields an
        ElasticTrainer over a fresh simulator.
        """
        # the workload's batch source is stateful (per-worker cursors);
        # rewind it to its state at first build so every run of this
        # Experiment replays the same seeded data stream
        if self.workload.state_dict and self.workload.load_state_dict:
            if self._workload_state0 is None:
                self._workload_state0 = copy.deepcopy(
                    self.workload.state_dict())
            else:
                self.workload.load_state_dict(
                    copy.deepcopy(self._workload_state0))
        backend = self.cluster.backend
        if backend is None:
            backend = SimBackend()
        return backend.build_trainer(
            workload=self.workload,
            cluster=self.cluster,
            optimizer=self.optimizer,
            cfg=self.config,
        )

    def session(self, hooks: Sequence[Hook] = (),
                resume_from: Optional[str] = None) -> Session:
        """A fresh Session, restored from the checkpoint at ``resume_from``
        when given."""
        session = Session(
            self.build(),
            schedule=self.cluster.schedule,
            hooks=(*self.hooks, *hooks),
            workload=self.workload,
        )
        if resume_from is not None:
            session.restore(resume_from)
        return session

    def run(self, hooks: Sequence[Hook] = (),
            resume_from: Optional[str] = None) -> dict:
        """Build, run to completion, return the summary dict (legacy keys:
        steps / sim_time / final_loss / reached_target / wall_time /
        batch_adjustments / history / final_batches, + membership_log)."""
        return self.session(hooks, resume_from=resume_from).run()
