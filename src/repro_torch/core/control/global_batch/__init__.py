"""Two-level batch control: the outer B_global(t) loop (DESIGN.md §15).

`gns` holds the gradient-noise-scale estimator fed by the gradient side
stats from `core/grad.py`; `outer` holds `GlobalBatchConfig` and the
fixed / geometric / gns / bandit controllers that walk the global bucket
ladder; `policy` holds the learned DYNAMIX-style `dynamix` kind
(DESIGN.md §18), its Q-head in torch.  The paper's inner P/PI/PID law
(`core/control`) then splits each B_global across heterogeneous workers.
"""

from repro_torch.core.control.global_batch.gns import GNSEstimator, GradStats
from repro_torch.core.control.global_batch.outer import (
    GLOBAL_BATCH_KINDS,
    BanditGlobalBatch,
    FixedGlobalBatch,
    GeometricGlobalBatch,
    GlobalBatchConfig,
    GlobalBatchController,
    GNSGlobalBatch,
    global_batch_from_state_dict,
    make_global_controller,
)

__all__ = [
    "GLOBAL_BATCH_KINDS",
    "BanditGlobalBatch",
    "DynamixGlobalBatch",
    "FixedGlobalBatch",
    "GeometricGlobalBatch",
    "GlobalBatchConfig",
    "GlobalBatchController",
    "GNSEstimator",
    "GNSGlobalBatch",
    "GradStats",
    "global_batch_from_state_dict",
    "make_global_controller",
]


def __getattr__(name):
    # lazy, as in the reference: the rest of the package is numpy and pure
    # python (same lazy seam as outer._controller_cls)
    if name == "DynamixGlobalBatch":
        from repro_torch.core.control.global_batch.policy import DynamixGlobalBatch
        return DynamixGlobalBatch
    raise AttributeError(name)
