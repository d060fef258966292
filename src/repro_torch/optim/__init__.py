from repro_torch.optim.optimizers import (
    Optimizer,
    adafactor_mini,
    adam,
    adamw,
    constant_lr,
    get_optimizer,
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
    "adafactor_mini",
    "adam",
    "adamw",
    "batch_coupled",
    "constant_lr",
    "cosine_schedule",
    "get_optimizer",
    "momentum",
    "sgd",
    "step_schedule",
]
