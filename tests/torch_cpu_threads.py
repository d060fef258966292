"""One intra-op thread for the port's tests on the CPU.

Imported first by every ``tests/test_torch_*.py``.  The port's CPU tests
run small tensors through many short ops; with pytest-xdist's workers each
holding a torch thread pool as wide as the machine, those pools fight over
the same cores and most of the time goes to waiting on them.  One thread a
worker keeps each op on its own core.  Nothing reads the thread count, and
no test's tolerance depends on it.
"""

import torch

torch.set_num_threads(1)
