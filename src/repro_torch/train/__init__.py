from repro_torch.train.engine import EventEngine, WorkerEvent
from repro_torch.train.loop import HeterogeneousTrainer, StepRecord, TrainConfig
from repro_torch.train.elastic import ElasticTrainer
from repro_torch.train import metrics

__all__ = [
    "ElasticTrainer",
    "EventEngine",
    "HeterogeneousTrainer",
    "StepRecord",
    "TrainConfig",
    "WorkerEvent",
    "metrics",
]
