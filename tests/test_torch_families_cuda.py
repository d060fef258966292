"""Slice 7's families on the card against the same computation on the CPU.

Marked ``cuda``: it skips without a GPU.  This file imports no JAX, so it
runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_families_cuda.py

Reduced MoE (grok-1: GQA with softcaps; deepseek-v2: MLA + MoE), vlm
(phi-3-vision with its patch prefix) and encdec (whisper) configs: the same
parameters (drawn on the CPU, then copied) and inputs give the loss and
every gradient on the card within 1e-4 of the CPU's (relative, gradients
to each tensor's max |value|; a key bias's, zero but for round-off, to the
model's largest gradient), with the flash kernels on the card where
the config takes them (seq 128, ``use_pallas``) and their plain versions
on the CPU.  MoE configs run at capacity 8.0 (no drops) and at their own
1.25, where the two devices must drop the same choices.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import (encdec_loss, init_model, layers, lm_loss,
                                reduced)

# arch, capacity factor (None: the config's), seq
CASES = [("grok-1-314b", 8.0, 128), ("grok-1-314b", None, 128),
         ("deepseek-v2-236b", 8.0, 128), ("deepseek-v2-236b", None, 64),
         ("phi-3-vision-4.2b", None, 128), ("whisper-medium", None, 32)]
IDS = ["grok-cap8", "grok-cap1.25", "deepseek-cap8", "deepseek-cap1.25",
       "phi3v", "whisper"]
TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's side of the comparison")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _loss_and_grads(cfg, params, batch, device):
    leaves = {k: v.to(device).requires_grad_() for k, v in params.items()}
    b = {k: v.to(device) for k, v in batch.items()}
    if cfg.family == "encdec":
        ls, ws, aux = encdec_loss(leaves, cfg, b["prefix"], b["tokens"],
                                  b["targets"], b["mask"])
    else:
        ls, ws, aux = lm_loss(leaves, cfg, b["tokens"], b["targets"],
                              b["mask"], prefix_embeds=b.get("prefix"),
                              num_valid=b["num_valid"] if cfg.use_pallas
                              else None)
    total = ls + 0.01 * aux * torch.clamp(ws, min=1.0)
    grads = torch.autograd.grad(total, list(leaves.values()),
                                allow_unused=True)
    return ls.item(), ws.item(), dict(zip(leaves, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,factor,seq", CASES, ids=IDS)
def test_loss_and_grads_on_card_match_cpu(arch, factor, seq, cuda_device,
                                          monkeypatch):
    cfg = reduced(get_config(arch)).with_(use_pallas=True)
    if factor is not None:
        cfg = cfg.with_(moe_capacity_factor=factor)
    gen = torch.Generator().manual_seed(0)
    params = init_model(gen, cfg)
    b = 4
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, seq),
                                     generator=gen),
             "targets": torch.randint(0, cfg.vocab_size, (b, seq),
                                      generator=gen),
             "mask": torch.tensor([1.0, 1.0, 0.5, 0.0]),
             "num_valid": torch.tensor(3, dtype=torch.int32)}
    n = {"vlm": cfg.num_patches, "encdec": cfg.encoder_seq}.get(cfg.family)
    if n:
        batch["prefix"] = 0.02 * torch.randn((b, n, cfg.d_model),
                                             generator=gen)
    fits = []
    route = layers.moe_route

    def recording(p, xt, c):
        out = route(p, xt, c)
        cap = layers.moe_capacity(xt.shape[1], c.moe_top_k, c.num_experts,
                                  c.moe_capacity_factor)
        fits.append((out[1].cpu(), (out[4] < cap).cpu()))
        return out

    monkeypatch.setattr(layers, "moe_route", recording)
    FA.reset_launches()
    ls_c, ws_c, g_c = _loss_and_grads(cfg, params, batch, "cpu")
    cpu_routes, fits[:] = list(fits), []
    assert not any(FA.LAUNCHES.values())
    ls_g, ws_g, g_g = _loss_and_grads(cfg, params, batch, cuda_device)
    takes_kernel = cfg.family != "encdec" and cfg.attention == "gqa" \
        and seq % 128 == 0
    assert bool(FA.LAUNCHES["flash_fwd"]) == takes_kernel
    assert len(fits) == len(cpu_routes) == (
        cfg.num_layers if cfg.num_experts else 0)
    for (ti, fi), (tc, fc) in zip(fits, cpu_routes):
        assert torch.equal(ti, tc) and torch.equal(fi, fc)
    assert ws_g == ws_c
    assert abs(ls_g - ls_c) <= TOL * abs(ls_c)
    largest = max(g.abs().max().item() for g in g_c.values() if g is not None)
    for k, gc in g_c.items():
        gg = g_g[k]
        if gc is None:
            assert gg is None, k
            continue
        # a key bias shifts all of a row's scores alike, which the softmax
        # ignores: its gradient is zero but for round-off, so it is held
        # to the model's largest gradient
        scale = largest if k.endswith("wk.bias") else gc.abs().max().item()
        err = (gg.cpu() - gc).abs().max().item()
        assert err <= TOL * max(scale, 1e-30), (k, err, scale)
