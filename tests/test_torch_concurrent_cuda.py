"""The measured backend over several devices on the card: the concurrent
round over ``["cuda:0", "cpu"]``, the card and the host CPU computing at
once.

Marked ``cuda``: it skips without a GPU.  This file imports no JAX, so it
runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_concurrent_cuda.py

1. Reduced gemma-2b through the flash kernels on the card and their plain
   versions on the CPU: after every step the CPU replica is bit-equal to
   the card's master, and each flash kernel launched ``layers`` times for
   each of the card worker's gradient calls and for none of the CPU
   worker's.
2. The card worker's CUDA-event time of a concurrent call is positive, no
   longer than a host-synced wall around the same call, and at least half
   of it.
3. With every timer replaced by the host clock through a fake clock (1.0 a
   read) and the completion stamps fixed by worker, the trajectory over
   ``["cuda:0", "cpu"]`` equals the same run over ``["cpu", "cpu"]``:
   batches, worker times, buckets, reruns and engine clock ``==``; losses
   to rtol 1e-4.
4. A flash kernel launched from a worker thread equals its plain version.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import time
from concurrent.futures import ThreadPoolExecutor

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

SEQ = 128


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card and the host CPU as two "
                    "devices of one concurrent round are the point")
    return torch.device("cuda", 0)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


def _gemma(devices, steps=3):
    """Reduced gemma-2b on two workers; its parameters are drawn on the CPU
    and moved, so every run starts from the same ones."""
    cfg = reduced(get_config("gemma-2b"))
    wl = T.lm_workload(cfg, DataPipeline(cfg, seq_len=SEQ, num_workers=2,
                                         device=devices[0]), use_kernel=True)
    wl.init = lambda gen: {
        k: p.to(gen.device)
        for k, p in init_lm(torch.Generator().manual_seed(0), cfg).items()}
    return T.Experiment(
        workload=wl,
        cluster=T.ClusterSpec.hlevel(
            20, 2.0, 2, workload="transformer", seed=0,
            backend=T.MeshBackend(device=devices)),
        optimizer=adam(1e-3),
        config=T.TrainConfig(b0=4, microbatch=2, batching="dynamic",
                             max_steps=steps,
                             controller=ControllerConfig(kind="p")))


def _linreg(devices, steps=6):
    return T.Experiment(
        workload=T.paper_workload("linreg", seed=100),
        cluster=T.ClusterSpec.hlevel(
            20, 2.0, 2, workload="mnist-cnn", seed=0,
            backend=T.MeshBackend(dilation=[2.0, 1.0], device=devices)),
        optimizer=sgd(0.05),
        config=T.TrainConfig(b0=16, microbatch=4, batching="dynamic",
                             max_steps=steps))


@pytest.mark.cuda
def test_cpu_replica_and_kernel_launches(card):
    session = _gemma([card, "cpu"]).session()
    t = session.trainer
    assert t.concurrent and t.slice_plan.slices == ((0, 1), (1, 1))
    calls = {"cuda": 0, "cpu": 0}
    inner = t._slice_call

    def counted(rec, params, shards):
        calls[t.devices[rec.rows[0]].type] += 1
        return inner(rec, params, shards)

    t._slice_call = counted
    FA.reset_launches()
    for _rec in session:
        replica = t._replicas[1]
        for name, x in t.params.items():
            assert torch.equal(replica[name], x.cpu()), name
    layers = reduced(get_config("gemma-2b")).num_layers
    assert calls["cuda"] > 0 and calls["cpu"] > 0
    assert FA.LAUNCHES == {k: layers * calls["cuda"] for k in FA.LAUNCHES}


@pytest.mark.cuda
def test_card_worker_event_time_is_bounded_by_the_host_wall(card):
    t = _gemma([card, "cpu"]).build()
    t._await_pool()
    for _ in range(3):
        rec, shards, fresh = t._prepare(0, 4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = t._start(0, rec, shards, fresh)
        done = port_mesh._ready_timestamp(d)
        wall = done - t0
        _out, events = d.call.result()
        dt = port_mesh._call_seconds(events, d.t0, done)
        assert 0 < dt <= wall, (dt, wall)
        assert dt >= wall / 2, (dt, wall)


def _fixed_stamp(d):
    d.call.result()
    return d.t0 + 1.0 + 0.25 * d.worker


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_linreg, _gemma], ids=["linreg", "gemma"])
def test_card_and_cpu_trajectory_equals_two_cpus(card, monkeypatch, make):
    monkeypatch.setattr(port_mesh, "_timed", port_mesh._host_timed)
    monkeypatch.setattr(port_mesh, "_ready_timestamp", _fixed_stamp)
    monkeypatch.setattr(port_mesh, "_call_seconds",
                        lambda events, t0, done: done - t0)
    runs = []
    for devices in ([card, "cpu"], ["cpu", "cpu"]):
        monkeypatch.setattr(port_mesh, "_time", FakeClock())
        session = make(devices).session()
        out = session.run()
        runs.append((out, session.trainer))
    (mixed, tm), (cpus, tc) = runs
    assert tm.concurrent and tc.concurrent
    assert [(r.batches, r.worker_times, r.sim_time)
            for r in mixed["history"]] == \
        [(r.batches, r.worker_times, r.sim_time) for r in cpus["history"]]
    assert tm.exec_state_dict() == tc.exec_state_dict()
    assert tm.timing_reruns == tc.timing_reruns
    assert tm.last_round_stamps == tc.last_round_stamps
    for a, b in zip(mixed["history"], cpus["history"]):
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4)


@pytest.mark.cuda
def test_flash_kernel_from_a_worker_thread_equals_plain(card):
    g = torch.Generator(device=card).manual_seed(0)
    b, s, h, hkv, d, nv = 3, 256, 8, 1, 256, 2
    q = torch.randn((b, s, h, d), generator=g, device=card)
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=card)
            for _ in range(2))
    nvt = torch.tensor(nv, dtype=torch.int32, device=card)
    FA.reset_launches()

    def launch():
        with torch.cuda.device(card):
            out, lse = FA.flash_fwd(q, k, v, nvt, causal=True)
            torch.cuda.current_stream(card).synchronize()
            return out, lse

    with ThreadPoolExecutor(1) as pool:
        out, lse = pool.submit(launch).result(timeout=120)
    assert FA.LAUNCHES["flash_fwd"] == 1
    want, want_lse = FA.flash_fwd_plain(q, k, v, nvt, causal=True)
    torch.testing.assert_close(out[:nv], want[:nv], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse[:nv], want_lse[:nv], atol=1e-4, rtol=1e-4)
    assert bool((out[nv:] == 0).all())
