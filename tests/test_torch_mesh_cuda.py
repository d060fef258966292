"""The measured backend on the card.

Marked ``cuda``: it skips without a GPU.  This file imports no JAX, so it
runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mesh_cuda.py

1. The CUDA-event time of a gradient call at reduced gemma-2b width is
   positive, no longer than a host-synced wall clock around the same call,
   and at least half of it.
2. With the timer replaced by the host clock read through a fake clock
   (1.0 a read), the trajectory on the card equals the same run on the CPU:
   batches, worker times, buckets, reruns and engine clock ``==``; losses to
   rtol 1e-4 (the card sums in another order).
3. Bucket padding through the flash kernels: at ``num_valid`` < B the padded
   rows of every kernel output are exact zeros, and a worker's gradient over
   a padded bucket equals its gradient over the unpadded rows.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import time

import numpy as np
import pytest
import torch

from repro_torch import api as T
from repro_torch.configs import get_config
from repro_torch.core import ControllerConfig
from repro_torch.data import DataPipeline
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import init_lm, reduced
from repro_torch.optim import adam, sgd
from repro_torch.train import mesh as port_mesh


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA-event timing and the flash "
                    "kernels on the card are the point")
    return torch.device("cuda")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


def _gemma(device, steps=3, batching="dynamic"):
    """Reduced gemma-2b; its parameters are drawn on the CPU and moved, so
    the card and the CPU start from the same ones (their generators
    differ)."""
    cfg = reduced(get_config("gemma-2b"))
    wl = T.lm_workload(cfg, DataPipeline(cfg, seq_len=128, num_workers=3,
                                         device=device), use_kernel=True)
    wl.init = lambda gen: {
        k: p.to(gen.device)
        for k, p in init_lm(torch.Generator().manual_seed(0), cfg).items()}
    return T.Experiment(
        workload=wl,
        cluster=T.ClusterSpec.hlevel(
            39, 6.0, 3, workload="transformer", seed=0,
            backend=T.MeshBackend(dilation=[3.0, 1.5, 1.0], device=device)),
        optimizer=adam(1e-3),
        config=T.TrainConfig(b0=4, microbatch=2, batching=batching,
                             max_steps=steps,
                             controller=ControllerConfig(kind="p")))


def _linreg(device, steps=6):
    return T.Experiment(
        workload=T.paper_workload("linreg", seed=100),
        cluster=T.ClusterSpec.hlevel(
            39, 6, workload="mnist-cnn", seed=0,
            backend=T.MeshBackend(dilation=[3.0, 1.5, 1.0], device=device)),
        optimizer=sgd(0.05),
        config=T.TrainConfig(b0=16, microbatch=4, batching="dynamic",
                             max_steps=steps))


@pytest.mark.cuda
def test_event_time_is_bounded_by_the_host_wall(cuda_device):
    trainer = _gemma(cuda_device, batching="uniform").build()
    data = trainer.next_batch(0, 4)
    mask = (torch.arange(4, device=cuda_device) < 3).to(torch.float32)

    def call():
        return trainer._slice_call(trainer._exec[0], trainer.params,
                                   [(data, mask)])

    call()                                   # warm-up
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, dt = port_mesh._timed(call, cuda_device)
        wall = time.perf_counter() - t0
        assert 0 < dt <= wall, (dt, wall)
        assert dt >= wall / 2, (dt, wall)


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_linreg, _gemma], ids=["linreg", "gemma"])
def test_card_trajectory_equals_cpu_under_the_fake_clock(cuda_device,
                                                         monkeypatch, make):
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        monkeypatch.setattr(port_mesh, "_timed", port_mesh._host_timed)
        monkeypatch.setattr(port_mesh, "_time", FakeClock())
        FA.reset_launches()
        session = make(device).session()
        out = session.run()
        t = session.trainer
        runs.append((out, t, dict(FA.LAUNCHES)))
    (card, tc, launches), (cpu, tp, cpu_launches) = runs
    assert [(r.batches, r.worker_times, r.sim_time) for r in card["history"]] \
        == [(r.batches, r.worker_times, r.sim_time) for r in cpu["history"]]
    assert tc.exec_state_dict() == tp.exec_state_dict()
    assert tc.timing_reruns == tp.timing_reruns
    for a, b in zip(card["history"], cpu["history"]):
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4)
    assert not any(cpu_launches.values())
    if make is _gemma:
        calls = tc.accum_calls + tc.timing_reruns
        layers = reduced(get_config("gemma-2b")).num_layers
        assert launches == {k: layers * calls for k in launches}


@pytest.mark.cuda
def test_padded_rows_are_zero_through_the_flash_kernels(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    b, s, h, hkv, d, nv = 7, 256, 8, 1, 256, 5
    q, do = (torch.randn((b, s, h, d), generator=g, device=cuda_device)
             for _ in range(2))
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=cuda_device)
            for _ in range(2))
    nvt = torch.tensor(nv, dtype=torch.int32, device=cuda_device)
    out, lse = FA.flash_fwd(q, k, v, nvt, causal=True)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    dq = FA.flash_bwd_dq(q, k, v, do, lse, delta, nvt, causal=True)
    dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta, nvt, causal=True)
    for x in (out, lse, dq, dk, dv):
        assert bool((x[nv:] == 0).all())
    out_p, _ = FA.flash_fwd_plain(q, k, v, nvt, causal=True)
    torch.testing.assert_close(out[:nv], out_p[:nv], atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_padded_bucket_gradient_equals_unpadded(cuda_device):
    """b = 6 rides bucket 7 (ladder 2, 3, 4, 5, 7 at microbatch 2): the
    kernels run at num_valid 6 < B 7, and the worker's mean gradient equals
    the gradient over the 6 real rows alone."""
    trainer = _gemma(cuda_device, batching="uniform").build()
    assert trainer.bucket_for(0, 6) == 7
    fetched = []
    inner = trainer.next_batch

    def recorded(worker, n):
        fetched.append(inner(worker, n))
        return fetched[-1]

    trainer.next_batch = recorded
    FA.reset_launches()
    g, _, ws, dt = trainer._measured_worker_grad(0, 6)
    assert ws == 6 * 128 and dt > 0     # token weights: 6 rows of seq 128
    assert all(n > 0 for n in FA.LAUNCHES.values())
    (padded,) = fetched
    rows = {key: x[:6] for key, x in padded.items()}
    (_, w, _), g_sum = trainer._loss_and_grad(
        trainer.params, rows, torch.ones(6, device=cuda_device))
    for name, x in g.items():
        ref = g_sum[name] / w
        scale = ref.abs().max().clamp_min(1e-30)
        assert ((x - ref).abs().max() / scale).item() <= 1e-4, name
