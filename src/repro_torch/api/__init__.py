"""Public API: declarative experiments for heterogeneous dynamic batching.

  * :mod:`repro_torch.api.workload` — Workload + the SUM-gradient adapter and
    ``lm_workload``;
  * :mod:`repro_torch.api.cluster` — declarative ClusterSpec with typed
    membership-event schedules;
  * :mod:`repro_torch.api.backend` — ``SimBackend`` (simulated clock, real
    SGD on a PyTorch device);
  * :mod:`repro_torch.api.session` — the Session step iterator + hooks;
  * :mod:`repro_torch.api.experiment` — Experiment = workload + cluster +
    config, with ``run()`` / ``session()`` entry points.
"""

from repro_torch.api.backend import Backend, SimBackend
from repro_torch.api.cluster import (
    At,
    AddWorker,
    ClusterSpec,
    Reallocate,
    RemoveWorker,
    SlowWorker,
)
from repro_torch.api.experiment import Experiment
from repro_torch.api.session import (
    EarlyStopHook,
    Hook,
    LoggingHook,
    MetricCollector,
    Session,
)
from repro_torch.api.workload import Workload, lm_workload, sum_loss_adapter
from repro_torch.train.loop import TrainConfig

__all__ = [
    "AddWorker",
    "At",
    "Backend",
    "ClusterSpec",
    "EarlyStopHook",
    "Experiment",
    "Hook",
    "LoggingHook",
    "MetricCollector",
    "Reallocate",
    "RemoveWorker",
    "Session",
    "SimBackend",
    "SlowWorker",
    "TrainConfig",
    "Workload",
    "lm_workload",
    "sum_loss_adapter",
]
