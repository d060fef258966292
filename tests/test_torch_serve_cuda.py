"""The serving slice on the card.

Marked ``cuda``: it skips without a GPU.  This file imports no JAX, so it
runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serve_cuda.py

1. ``ContinuousBatcher`` and ``KVSlotManager`` on the card against the same
   objects on the CPU with the same parameters: token streams ``==``, and
   teacher-forced decode logits through the caches within 1e-4 (abs and
   rel to max|logits|; the card sums in another order).
2. A warm-up in the middle of a run on the card leaves every stream as an
   undisturbed run's.
3. A decode step's host wall is at least the CUDA-event time of the same
   step: the step reads its tokens back to the host, which waits for the
   card (were it not to wait, the end event would wait for the queued
   work and the event time would exceed the wall).  50 us cover the
   card's lag in processing the end event after it is enqueued.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import apply_lm, init_caches, init_lm, reduced
from repro_torch.serve import (ContinuousBatcher, KVSlotManager, LMShard,
                               PrefillProgram, Request)

ARCHS = ["gemma-2b", "mamba2-1.3b", "recurrentgemma-9b"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: decode on the card against the "
                    "CPU is the point")
    return torch.device("cuda")


def _model(arch):
    """Reduced config and CPU parameters (the card gets copies)."""
    cfg = reduced(get_config(arch))
    return cfg, init_lm(torch.Generator().manual_seed(0), cfg)


def _prompts(cfg, lens=(4, 7, 3, 5), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


def _batcher_streams(params, cfg, prompts, device, warm_every=0):
    b = ContinuousBatcher(params, cfg, slots=2, cache_len=32, device=device)
    for uid, p in enumerate(prompts):
        b.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
    n = 0
    while not b.idle:
        b.step()
        n += 1
        if warm_every and n % warm_every == 0:
            b.warmup()
    return [(r.uid, r.tokens) for r in b.finished]


def _manager_streams(params, cfg, prompts, device):
    mgr = KVSlotManager(
        [LMShard(params, cfg, slots=2, cache_len=32, device=device)],
        PrefillProgram(params, cfg, cache_len=32, device=device),
        cache_len=32, extent=1, prefills_per_step=2)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        mgr.submit(r)
    mgr.run_until_idle()
    mgr.check()
    return [r.tokens for r in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_and_manager_on_card_match_cpu(cuda_device, arch):
    cfg, params = _model(arch)
    prompts = _prompts(cfg)
    card = {k: v.to(cuda_device) for k, v in params.items()}
    assert _batcher_streams(card, cfg, prompts, cuda_device) == \
        _batcher_streams(params, cfg, prompts, "cpu")
    assert _manager_streams(card, cfg, prompts, cuda_device) == \
        _manager_streams(params, cfg, prompts, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    logits = {}
    for dev, p in (("cpu", params), (cuda_device, card)):
        caches, out = init_caches(cfg, 2, 12, device=dev), []
        with torch.no_grad():
            for i in range(12):
                lg, caches, _ = apply_lm(
                    p, cfg, torch.from_numpy(toks[:, i:i + 1]).to(dev),
                    caches=caches,
                    positions=torch.full((2, 1), i, device=dev))
                out.append(lg.cpu())
        logits[str(dev)] = torch.cat(out, dim=1)
    want = logits["cpu"]
    err = (logits[str(cuda_device)] - want).abs().max().item()
    assert err <= 1e-4 * max(1.0, want.abs().max().item()), err


@pytest.mark.cuda
def test_midflight_warmup_on_card_leaves_streams(cuda_device):
    cfg, params = _model("gemma-2b")
    card = {k: v.to(cuda_device) for k, v in params.items()}
    prompts = _prompts(cfg, seed=2)
    assert _batcher_streams(card, cfg, prompts, cuda_device, warm_every=2) \
        == _batcher_streams(card, cfg, prompts, cuda_device)


@pytest.mark.cuda
def test_decode_step_host_wall_covers_its_device_time(cuda_device):
    cfg, params = _model("gemma-2b")
    card = {k: v.to(cuda_device) for k, v in params.items()}
    b = ContinuousBatcher(card, cfg, slots=4, cache_len=64,
                          device=cuda_device)
    for uid, p in enumerate(_prompts(cfg, lens=(8, 8, 8, 8), seed=3)):
        b.submit(Request(uid=uid, prompt=p, max_new_tokens=16))
    b.step()                       # admission: prefill inside the step
    torch.cuda.synchronize()
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        b.step()
        end.record()
        wall = time.perf_counter() - t0
        end.synchronize()
        event = start.elapsed_time(end) / 1e3
        assert 0 < event <= wall + 50e-6, (event, wall)
