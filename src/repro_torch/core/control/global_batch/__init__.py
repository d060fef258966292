"""Two-level batch control: the outer B_global(t) loop (DESIGN.md §15).

`outer` holds `GlobalBatchConfig`, the shared ladder machinery and the
`fixed` kind.  The paper's inner P/PI/PID law (`core/control`) splits each
B_global across heterogeneous workers.  The geometric / gns / bandit /
dynamix kinds are a later slice of the port and raise `NotImplementedError`.
"""

from repro_torch.core.control.global_batch.outer import (
    GLOBAL_BATCH_KINDS,
    FixedGlobalBatch,
    GlobalBatchConfig,
    GlobalBatchController,
    global_batch_from_state_dict,
    make_global_controller,
)

__all__ = [
    "GLOBAL_BATCH_KINDS",
    "FixedGlobalBatch",
    "GlobalBatchConfig",
    "GlobalBatchController",
    "global_batch_from_state_dict",
    "make_global_controller",
]
