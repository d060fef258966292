"""The port's Adam and AdamW on the card against the same optimizer on the
CPU.

Marked ``cuda``: it skips without a GPU.  This file imports no JAX, so it
also runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_optim_cuda.py

The CPU side stands in for the reference: ``tests/test_torch_lm.py`` holds
it within 2 ulp of the reference's optimizer over the same 200 steps.  The
card must stay within 2 ulp of it, so that its divisions by the fp32 bias
corrections round as the reference's do.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

from repro_torch.optim import optimizers

OPTIMIZERS = {"adam": dict(), "adamw": dict(weight_decay=0.05)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's rounding is the point")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_cuda_adam_long_run_within_2_ulp_of_cpu(name, cuda_device):
    """200 steps on 4096 parameters, the same Gaussian gradients on both
    devices (tests/test_torch_lm.py::test_adam_long_run_within_2_ulp_of_
    reference's inputs)."""
    opt = getattr(optimizers, name)(1e-3, **OPTIMIZERS[name])
    rng = np.random.default_rng(200)
    p0 = rng.standard_normal(4096).astype(np.float32)
    cpu = {"w": torch.from_numpy(p0.copy())}
    card = {"w": torch.from_numpy(p0.copy()).to(cuda_device)}
    s_cpu, s_card = opt.init(cpu), opt.init(card)
    for step in range(200):
        g = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
        cpu, s_cpu = opt.update(cpu, {"w": g}, s_cpu, step)
        card, s_card = opt.update(card, {"w": g.to(cuda_device)}, s_card, step)
        want = cpu["w"].numpy()
        got = card["w"].cpu().numpy()
        ulp = np.spacing(np.abs(want))
        assert (np.abs(got - want) <= 2 * ulp).all(), (
            step, float(np.max(np.abs(got - want) / ulp)))
