"""Back-compat shim: the controller moved to the ``repro_torch.core.control``
package (pluggable P / PI / PID / gain-scheduled laws).  Import from
``repro_torch.core.control`` (or ``repro_torch.core``) in new code."""

from repro_torch.core.control import (  # noqa: F401
    BatchController,
    ControllerConfig,
    ControllerUpdate,
    DynamicBatchController,
    GainScheduledController,
    PIController,
    PIDController,
    ProportionalController,
    WorkerState,
    controller_from_state_dict,
    make_controller,
)

__all__ = [
    "BatchController",
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
