from repro_torch.optim.optimizers import (
    Optimizer,
    adam,
    adamw,
    constant_lr,
    momentum,
    sgd,
)
from repro_torch.optim.schedules import (
    BatchCoupledSchedule,
    batch_coupled,
    cosine_schedule,
    step_schedule,
)

__all__ = [
    "BatchCoupledSchedule",
    "Optimizer",
    "adam",
    "adamw",
    "batch_coupled",
    "constant_lr",
    "cosine_schedule",
    "momentum",
    "sgd",
    "step_schedule",
]
