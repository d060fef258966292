"""Remat (activation checkpointing per block group) in the port, against the
same runs without it and against the reference's remat run.

``cfg.remat`` wraps each group of the block pattern in
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` over its
scan body), and ``remat_policy="dots"`` keeps the matmuls' outputs.
Recomputing changes no number, so on the CPU the loss and every gradient
are ``==`` the run without remat, for all ten reduced archs under both
policies, through the kernels' plain versions (``use_pallas``).  Against
the reference's remat run the tolerances are the reference's own
(tests/test_models.py): 1e-5 on the loss, 1e-4 on the gradients.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_get_config
from repro.models import init_lm as ref_init_lm
from repro.models import lm_loss as ref_lm_loss
from repro.models import reduced as ref_reduced
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.models import (apply_lm, encdec_loss, init_caches,
                                init_model, lm_loss, params_from_jax,
                                params_to_jax, reduced)
from repro_torch.models import transformer as T

SEQ = 128   # a multiple of 128, so GQA attention takes the flash path


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (2, SEQ)),
         "targets": rng.integers(0, cfg.vocab_size, (2, SEQ)),
         "mask": np.array([1.0, 0.5], np.float32)}
    if cfg.num_patches:
        b["prefix"] = 0.02 * rng.standard_normal(
            (2, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder_seq:
        b["frames"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _loss_and_grads(params, cfg, batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    if cfg.family == "encdec":
        ls, ws, aux = encdec_loss(leaves, cfg, t["frames"], t["tokens"],
                                  t["targets"], t["mask"])
    else:
        ls, ws, aux = lm_loss(leaves, cfg, t["tokens"], t["targets"],
                              t["mask"], prefix_embeds=t.get("prefix"))
    total = ls + 0.01 * aux
    grads = torch.autograd.grad(total, list(leaves.values()),
                                allow_unused=True)
    return total.detach(), dict(zip(leaves, grads))


class _MatmulCount(TorchDispatchMode):
    """Counts the aten matmuls that run while it is entered."""

    def __init__(self):
        super().__init__()
        self.mm = self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        elif func is torch.ops.aten.bmm.default:
            self.bmm += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def deterministic():
    """The embedding's backward (an accumulating index_put) adds rows in
    another order from run to run on the CPU's threads, remat or not; its
    deterministic version fixes the order."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_remat_changes_no_number(arch, policy, monkeypatch, deterministic):
    """Loss and gradients ``==`` without remat; the checkpointed groups'
    blocks run again in the backward (whisper's encdec never reads remat,
    as the reference's, and the hybrid tail is not checkpointed)."""
    cfg = reduced(get_config(arch)).with_(use_pallas=True)
    params = init_model(torch.Generator().manual_seed(0), cfg)
    batch = _batch(cfg)
    calls = []
    apply_block = T.apply_block
    monkeypatch.setattr(T, "apply_block",
                        lambda *a, **k: calls.append(1) or apply_block(*a,
                                                                       **k))
    want = _loss_and_grads(params, cfg, batch)
    plain_calls, calls[:] = len(calls), []
    got = _loss_and_grads(params, cfg.with_(remat=True, remat_policy=policy),
                          batch)
    assert got[0] == want[0]
    for name, g in want[1].items():
        assert (g is None and got[1][name] is None) or torch.equal(
            got[1][name], g), name
    period = len(T.block_pattern(cfg))
    grouped = cfg.num_layers // period * period
    assert plain_calls == (0 if cfg.family == "encdec" else cfg.num_layers)
    assert len(calls) == plain_calls + (0 if cfg.family == "encdec"
                                        else grouped)


def test_dots_policy_keeps_the_matmuls():
    """In the backward, "full" recomputes every matmul of a group; "dots"
    reuses the saved 2-d matmuls (aten.mm / addmm) and recomputes only the
    batched ones (aten.bmm: the attention scores)."""
    cfg = reduced(get_config("gemma-2b")).with_(use_pallas=True)
    params = init_model(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(_batch(cfg)["tokens"])
    counts = {}
    for policy in (None, "full", "dots"):
        c = cfg if policy is None else cfg.with_(remat=True,
                                                 remat_policy=policy)
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        ls, _, _ = lm_loss(leaves, c, tokens, tokens, torch.ones(2))
        with _MatmulCount() as n:
            torch.autograd.grad(ls, list(leaves.values()))
        counts[policy] = (n.mm, n.bmm)
    assert counts["dots"][0] == counts[None][0] < counts["full"][0]
    assert counts["dots"][1] == counts["full"][1] > counts[None][1]


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-9b"])
def test_remat_matches_the_reference_remat_run(arch):
    """The same parameters and batch through both packages' remat path
    (the reference's ``jax.checkpoint`` with its dots policy)."""
    ref_cfg = ref_reduced(ref_get_config(arch)).with_(remat=True,
                                                      remat_policy="dots")
    cfg = reduced(get_config(arch)).with_(remat=True, remat_policy="dots")
    p0 = jax.tree_util.tree_map(np.asarray,
                                ref_init_lm(jax.random.PRNGKey(0), ref_cfg))
    batch = _batch(cfg)

    def ref_total(p):
        ls, _, aux = ref_lm_loss(p, ref_cfg, jnp.asarray(batch["tokens"]),
                                 jnp.asarray(batch["targets"]),
                                 jnp.asarray(batch["mask"]))
        return ls + 0.01 * aux

    loss_j, grads_j = jax.jit(jax.value_and_grad(ref_total))(p0)
    loss, grads = _loss_and_grads(params_from_jax(p0, cfg, device="cpu"),
                                  cfg, batch)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    back = params_to_jax({k: g for k, g in grads.items()}, cfg)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path(grads_j)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max(),
                                   rtol=1e-4, err_msg=str(path))


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-9b"])
def test_decode_with_a_remat_config_is_unchanged(arch):
    """Decode never checkpoints: token by token through the caches, a
    remat config gives the same logits and caches as one without."""
    cfg = reduced(get_config(arch))
    params = init_model(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(_batch(cfg)["tokens"][:, :6])
    outs = {}
    for c in (cfg, cfg.with_(remat=True, remat_policy="dots")):
        caches, logits = init_caches(c, 2, 8, device="cpu"), []
        for i in range(toks.shape[1]):
            lg, caches, _ = apply_lm(params, c, toks[:, i:i + 1],
                                     caches=caches,
                                     positions=torch.full((2, 1), i))
            logits.append(lg)
        outs[c.remat] = (torch.cat(logits, 1), caches)
    assert torch.equal(outs[True][0], outs[False][0])
    assert all(torch.equal(v, outs[False][1][k])
               for k, v in outs[True][1].items())
