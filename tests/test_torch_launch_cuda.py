"""The launch slice on the card: a bf16 remat train step through the flash
kernels, adafactor, and the CLI, each against the same on the CPU.

Marked ``cuda``: it skips without a GPU.  This file imports no JAX, so it
also runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_launch_cuda.py

The CPU side stands in for the reference: ``tests/test_torch_launch.py``,
``test_torch_adafactor.py`` and ``test_torch_remat.py`` hold it against the
reference there.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.launch import steps, train
from repro_torch.models import init_lm, lm_loss, reduced
from repro_torch.models.convert import reference_leaves
from repro_torch.optim import adafactor_mini, sgd


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _llama_bf16():
    """Reduced llama3 at the dry run's overrides (bf16 parameters and
    activations, remat), through the kernels; seq 128 takes the flash
    path."""
    cfg = reduced(get_config("llama3-8b")).with_(
        param_dtype="bfloat16", dtype="bfloat16", remat=True,
        remat_policy="full", use_pallas=True)
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 128)),
             "targets": rng.integers(0, cfg.vocab_size, (4, 128)),
             "weights": np.ones(4, np.float32)}
    return cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.cuda
def test_cuda_bf16_remat_step_through_the_kernels(cuda_device):
    """Loss and gradients on the card within 1e-2 of the CPU's: the loss
    relative to itself, each gradient in norm (||card - cpu|| / ||cpu||):
    bf16 rounding on both sides in other orders.  (Element by element, one
    bf16 rounding apart: the largest difference of a gradient measured
    1.09e-2 of its largest value on an H100.)  Under remat the forward kernel launches twice a layer
    (forward and recompute), the backward kernels once; then one train
    step on the card gives a finite loss within 1e-2 of the CPU's step."""
    cfg, params, batch = _llama_bf16()
    out = {}
    for dev in ("cpu", cuda_device):
        p = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        b = {k: v.to(dev) for k, v in batch.items()}
        K.reset_launches()
        ls, ws, _ = lm_loss(p, cfg, b["tokens"], b["targets"], b["weights"])
        grads = torch.autograd.grad(ls / ws, list(p.values()))
        out[str(dev)] = ((ls / ws).item(), [g.float().cpu() for g in grads],
                         dict(K.LAUNCHES))
    (lc, gc, _), (lg, gg, launches) = out["cpu"], out[str(cuda_device)]
    assert abs(lg - lc) <= 1e-2 * abs(lc)
    for a, b in zip(gg, gc):
        assert (a - b).norm() <= 1e-2 * b.norm()
    n = cfg.num_layers
    assert launches == {"flash_fwd": 2 * n, "flash_bwd_dq": n,
                        "flash_bwd_dkv": n}
    step = steps.make_train_step(cfg, sgd(1e-2))
    losses = []
    for dev in ("cpu", cuda_device):
        p = {k: v.to(dev) for k, v in params.items()}
        new, _, m = step(p, (), 0, {k: v.to(dev) for k, v in batch.items()})
        assert all(t.dtype == torch.bfloat16 for t in new.values())
        losses.append(m["loss"].item())
    assert math.isfinite(losses[1])
    assert abs(losses[1] - losses[0]) <= 1e-2 * abs(losses[0])


@pytest.mark.cuda
def test_cuda_adafactor_matches_the_cpu(cuda_device):
    """3 steps of adafactor over reduced gemma's stacked leaves, the same
    gradients on both devices: states at rtol 1e-6, parameters at rtol
    1e-6 with an atol of 1e-6 of each tensor's largest value (the means
    sum in other orders; ``test_torch_adafactor.py`` says why)."""
    cfg = reduced(get_config("gemma-2b"))
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    opt = adafactor_mini(1e-2, leaves=reference_leaves(params, cfg))
    runs = {}
    for dev in ("cpu", cuda_device):
        p = {k: v.to(dev) for k, v in params.items()}
        s = opt.init(p)
        gen = torch.Generator().manual_seed(2)
        for step in range(3):
            g = {k: 0.1 * torch.randn(v.shape, generator=gen).to(dev)
                 for k, v in params.items()}
            p, s = opt.update(p, g, s, step)
        runs[str(dev)] = (p, s)
    (pc, sc), (pg, sg) = runs["cpu"], runs[str(cuda_device)]
    for k, b in pc.items():
        a = pg[k].cpu()
        torch.testing.assert_close(a, b, rtol=1e-6,
                                   atol=1e-6 * b.abs().max().item())

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    got = dict(leaves(sg))
    for path, b in leaves(sc):
        torch.testing.assert_close(got[path].cpu(), b, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_cuda_cli_runs_on_the_card(cuda_device):
    """The port's CLI with no ``--device``: the card, 2 BSP steps."""
    out = train.main(["--arch", "gemma-2b", "--steps", "2", "--b0", "8",
                      "--microbatch", "4", "--seq-len", "32", "--quiet"])
    assert out["steps"] == 2
    for rec in out["history"]:
        assert math.isfinite(rec.loss) and sum(rec.batches) == 24
