"""Control layer: pluggable mini-batch controllers (P / PI / PID / gain).

`make_controller` is the single entry point used by the trainer, the
benchmarks, and the examples; `ControllerConfig.kind` selects the law.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.control.base import (
    BatchController,
    ControllerConfig,
    ControllerUpdate,
    WorkerState,
)
from repro_torch.core.control.gain import GainScheduledController
from repro_torch.core.control.pid import PIController, PIDController
from repro_torch.core.control.proportional import (
    DynamicBatchController,
    ProportionalController,
)

CONTROLLER_KINDS: dict[str, type[BatchController]] = {
    "p": DynamicBatchController,
    "pi": PIController,
    "pid": PIDController,
    "gain": GainScheduledController,
}


def make_controller(
    initial_batches: Sequence[int],
    config: Optional[ControllerConfig] = None,
) -> BatchController:
    """Instantiate the controller selected by ``config.kind``."""
    cfg = config or ControllerConfig()
    try:
        cls = CONTROLLER_KINDS[cfg.kind]
    except KeyError:  # pragma: no cover — ControllerConfig validates kind
        raise ValueError(f"unknown controller kind {cfg.kind!r}") from None
    return cls(initial_batches, cfg)


def controller_from_state_dict(state: dict) -> BatchController:
    """Rebuild the right controller class from a ``state_dict()``."""
    kind = state.get("config", {}).get("kind", "p")
    cls = CONTROLLER_KINDS.get(kind, DynamicBatchController)
    return cls.from_state_dict(state)


__all__ = [
    "BatchController",
    "CONTROLLER_KINDS",
    "ControllerConfig",
    "ControllerUpdate",
    "DynamicBatchController",
    "GainScheduledController",
    "PIController",
    "PIDController",
    "ProportionalController",
    "WorkerState",
    "controller_from_state_dict",
    "make_controller",
]
