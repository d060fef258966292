"""The outer global-batch kinds with their model on the card.

Marked ``cuda``: it skips without a GPU.  This file imports no JAX, so it
runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_outer_cuda.py

1. ``tree_sqnorm`` of a gradient dict on the card against float64 on the
   CPU (rtol 1e-5; ``torch.dot`` sums in another order than the CPU).
2. The reference's conformance geometry (``tests/conformance_runner.py``,
   the same legs as ``tests/test_torch_slice_outer.py``) on the port alone:
   every kind, static and elastic, with linreg's parameters and gradients
   on the card, must take exactly the decisions the same legs take on the
   CPU.  The outer controllers and the dynamix Q-head are host state in
   both runs; only the side statistics and losses they read come from the
   card, and the estimator and the 1e-3 quantization of dynamix's
   features absorb their last-bit differences.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

from repro_torch import api as T
from repro_torch.core import GlobalBatchConfig, tree_sqnorm
from repro_torch.het import WorkerSpec
from repro_torch.optim import batch_coupled, sgd


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the side statistics' reductions "
                    "on the card are the point")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tree_sqnorm_on_card_matches_float64(cuda_device):
    rng = np.random.default_rng(0)
    shapes = {"embed": (4096, 512), "layers.0.w": (512, 2048),
              "layers.0.b": (2048,), "norm": (512,), "scalar": ()}
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    want = sum(float(np.sum(v.astype(np.float64) ** 2))
               for v in tree.values())
    got = tree_sqnorm({k: torch.from_numpy(v).to(cuda_device)
                       for k, v in tree.items()})
    assert got.device.type == "cuda" and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


KINDS = ("fixed", "gns", "bandit", "dynamix")


def _outer_cfg(kind):
    common = dict(warmup=4, cooldown=2, ladder_growth=2.0, max_factor=4.0,
                  seed=0)
    if kind == "fixed":
        return GlobalBatchConfig()
    if kind == "gns":
        return GlobalBatchConfig(kind="gns", gns_min_samples=2, **common)
    if kind == "bandit":
        return GlobalBatchConfig(kind="bandit", bandit_window=3,
                                 time_signal="steps", **common)
    return GlobalBatchConfig(kind="dynamix", bandit_window=3,
                             gns_min_samples=2, time_signal="steps", **common)


def _pin(trainer):
    total, k = sum(trainer.batches), trainer.k
    base, extra = divmod(total, k)
    trainer.batches = [base + (1 if i < extra else 0) for i in range(k)]


def _leg(kind, elastic, device):
    cluster = T.ClusterSpec.explicit(
        [WorkerSpec(cores=12.0), WorkerSpec(cores=8.0)], workload="linreg",
        seed=0, backend=T.SimBackend(device=device))
    if elastic:
        cluster = cluster.with_schedule(
            T.RemoveWorker(step=6, worker=1), T.At(step=6, fn=_pin),
            T.AddWorker(step=10, spec=WorkerSpec(cores=8.0)),
            T.At(step=10, fn=_pin))
    session = T.Experiment(
        workload=T.paper_workload("linreg"), cluster=cluster,
        optimizer=sgd(batch_coupled(0.05, rule="linear")),
        config=T.TrainConfig(b0=8, microbatch=4, batching="uniform",
                             max_steps=14, seed=0,
                             global_batch=_outer_cfg(kind)),
    ).session()
    out = session.run()
    assert all(p.device.type == torch.device(device).type
               for p in session.params.values())
    traj = {"batches": [list(r.batches) for r in out["history"]],
            "sim_time": [r.sim_time for r in out["history"]]}
    outer = session.trainer.outer
    if outer is not None:
        st = outer.state_dict()
        traj.update(rung=st["rung"], resize_log=st["resize_log"],
                    num_resizes=st["num_resizes"])
        if kind == "bandit":
            traj["arm_counts"] = st["extra"]["counts"]
        if kind == "dynamix":
            traj["action_log"] = st["extra"]["action_log"]
    return traj, [r.loss for r in out["history"]]


@pytest.mark.cuda
@pytest.mark.parametrize("elastic", [False, True], ids=["static", "elastic"])
@pytest.mark.parametrize("kind", KINDS)
def test_conformance_legs_on_card_decide_as_on_cpu(cuda_device, kind,
                                                   elastic):
    card, card_losses = _leg(kind, elastic, "cuda")
    cpu, cpu_losses = _leg(kind, elastic, "cpu")
    assert card == cpu
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=1e-4)
    if kind != "fixed":
        assert card["num_resizes"] > 0
