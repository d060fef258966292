"""Public API: declarative experiments for heterogeneous dynamic batching.

  * :mod:`repro_torch.api.workload` — Workload + the adapters that implement
    the SUM-gradient contract once (``mean_loss_workload``,
    ``sum_loss_workload``, ``paper_workload``, ``lm_workload``);
  * :mod:`repro_torch.api.cluster` — declarative ClusterSpec with typed
    membership-event schedules, and ``compile_churn``, which lowers a
    spot-market trace into one;
  * :mod:`repro_torch.api.backend` — ``SimBackend`` (simulated clock, real
    SGD on a PyTorch device) and ``MeshBackend`` (measured times);
  * :mod:`repro_torch.api.session` — the Session step iterator + hooks
    (logging, checkpoint-every-N, early stop, metric collection);
  * :mod:`repro_torch.api.experiment` — Experiment = workload + cluster +
    config, with ``run()`` / ``session()`` entry points.
"""

from repro_torch.api.backend import Backend, MeshBackend, SimBackend
from repro_torch.api.cluster import (
    At,
    AddWorker,
    ChurnSchedule,
    ClusterSpec,
    Reallocate,
    RemoveWorker,
    SlowWorker,
    compile_churn,
)
from repro_torch.api.experiment import Experiment
from repro_torch.api.session import (
    CheckpointHook,
    EarlyStopHook,
    Hook,
    LoggingHook,
    MetricCollector,
    Session,
)
from repro_torch.api.workload import (
    CounterBatchSource,
    Workload,
    lm_workload,
    mean_loss_adapter,
    mean_loss_workload,
    paper_workload,
    sum_loss_adapter,
    sum_loss_workload,
)
from repro_torch.train.loop import TrainConfig

__all__ = [
    "AddWorker",
    "At",
    "Backend",
    "CheckpointHook",
    "ChurnSchedule",
    "ClusterSpec",
    "CounterBatchSource",
    "EarlyStopHook",
    "Experiment",
    "Hook",
    "LoggingHook",
    "MeshBackend",
    "MetricCollector",
    "Reallocate",
    "RemoveWorker",
    "Session",
    "SimBackend",
    "SlowWorker",
    "TrainConfig",
    "Workload",
    "compile_churn",
    "lm_workload",
    "mean_loss_adapter",
    "mean_loss_workload",
    "paper_workload",
    "sum_loss_adapter",
    "sum_loss_workload",
]
