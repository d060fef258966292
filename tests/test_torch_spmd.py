"""The port's sharded programs run for real over four gloo CPU processes
(``tests/torch_spmd_runner.py``, a 2 x 2 ``("data", "model")`` mesh, one
``FileStore``), held against the reference's plain decode and the port's
plain decode and unsharded train step, computed here.

One module fixture starts the runner in a fresh interpreter with a time
limit; it starts its four ranks, each of which makes and destroys its own
group.  No process group is made in this process.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_spmd_runner as runner
from repro.configs import get_config as ref_get_config
from repro.models import apply_lm as ref_apply_lm
from repro.models import init_caches as ref_init_caches
from repro.models import init_lm as ref_init_lm
from repro.models import reduced as ref_reduced
from repro_torch.launch.steps import make_train_step
from repro_torch.models import (apply_lm, init_caches, init_model,
                                params_from_jax)

HERE = os.path.dirname(__file__)
RUNNER_TIMEOUT = 240


@pytest.fixture(autouse=True)
def no_process_group():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _ref_decode_config(arch):
    cfg = ref_reduced(ref_get_config(arch))
    if cfg.attention == "mla":
        cfg = cfg.with_(kv_lora_rank=16, qk_rope_dim=8)
    if cfg.num_experts:
        cfg = cfg.with_(moe_capacity_factor=8.0)
    return cfg


def _flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _decode_inputs():
    """The reference's parameters and tokens of each decode arch (as
    ``tests/spmd_decode_runner.py`` makes them)."""
    inputs, trees = {}, {}
    b, s = runner.DECODE_B, runner.DECODE_S
    for arch in runner.DECODE_ARCHS:
        cfg = _ref_decode_config(arch)
        key = jax.random.PRNGKey(0)
        params = ref_init_lm(key, cfg)
        toks = jax.random.randint(key, (b, s), 0, cfg.vocab_size)
        trees[arch] = (cfg, params, toks)
        inputs.update(_flatten(params, f"decode/{arch}"))
        inputs[f"decode/{arch}/tokens"] = np.asarray(toks)
    return inputs, trees


def _ref_decode(cfg, params, toks):
    b, s = toks.shape
    caches = ref_init_caches(cfg, b, s)
    outs = []
    for i in range(s):
        lg, caches, _ = ref_apply_lm(params, cfg, toks[:, i:i + 1],
                                     caches=caches,
                                     positions=jnp.full((b, 1), i,
                                                        jnp.int32))
        outs.append(np.asarray(lg))
    return np.concatenate(outs, axis=1)


def _port_decode(arch, tree, toks):
    cfg = runner.decode_config(arch)
    params = params_from_jax(tree, cfg, device="cpu")
    toks = torch.from_numpy(np.asarray(toks).astype(np.int64))
    b, s = toks.shape
    caches = init_caches(cfg, b, s, device="cpu")
    outs = []
    with torch.no_grad():
        for i in range(s):
            lg, caches, _ = apply_lm(params, cfg, toks[:, i:i + 1],
                                     caches=caches,
                                     positions=torch.full((b, 1), i))
            outs.append(lg)
    return torch.cat(outs, 1).numpy()


def _port_train(name):
    cfg = runner.train_config(name)
    params = init_model(torch.Generator().manual_seed(0), cfg)
    opt = runner.train_optimizer()
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    batch = runner.train_batch(cfg)
    losses = []
    for i in range(runner.TRAIN_STEPS):
        params, state, metrics = step(params, state, i, batch)
        losses.append(metrics["loss"].item())
        if i == 0:
            after0 = {k: v.clone() for k, v in params.items()}
    return losses, after0


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    work = tmp_path_factory.mktemp("spmd")
    inputs, trees = _decode_inputs()
    np.savez(work / "inputs.npz", **inputs)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_spmd_runner.py"),
         str(work), str(work / "inputs.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": os.path.join(HERE, "..", "src")})
    try:
        # the references, while the ranks run
        ref = {arch: _ref_decode(cfg, params, toks)
               for arch, (cfg, params, toks) in trees.items()}
        plain = {arch: _port_decode(arch, params, toks)
                 for arch, (_, params, toks) in trees.items()}
        unsharded = {name: _port_train(name) for name in runner.TRAIN_CASES}
        out, err = proc.communicate(timeout=RUNNER_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith("{")]
    results = {(ln["name"], ln["rank"]): ln for ln in lines}
    arrays = dict(np.load(work / "out.npz"))
    return {"results": results, "arrays": arrays, "ref": ref,
            "plain": plain, "unsharded": unsharded}


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-5,
                               atol=1e-5 * float(np.abs(b).max()))


@pytest.mark.parametrize("arch", runner.DECODE_ARCHS)
def test_sharded_decode_matches_reference_plain_decode(spmd, arch):
    """8 one-token steps for a batch of 4: the logits against the
    reference's plain ``apply_lm(caches=)`` on the same parameters, and
    against the port's plain decode."""
    got = spmd["arrays"][f"decode/{arch}/logits"]
    assert got.shape == spmd["ref"][arch].shape
    _close(got, spmd["ref"][arch])
    _close(got, spmd["plain"][arch])


@pytest.mark.parametrize("arch", runner.DECODE_ARCHS)
def test_sharded_decode_one_logits_all_reduce_per_layer(spmd, arch):
    """On every rank: exactly one all-reduce per layer per step (the
    partial logits over ``model``), no op replicated, and the caches still
    (batch over data, the head / latent / rope dim over model)."""
    for rank in range(runner.WORLD):
        res = spmd["results"][(f"decode/{arch}", rank)]["result"]
        c = res["collectives"]
        assert c["all-reduce_count"] == res["layers"] * res["steps"]
        assert c["reduce-scatter_count"] == c["all-to-all_count"] == 0
        assert res["replicated_ops"] == 0
        assert res["cache_placements"] in (
            ["(Shard(dim=0), Shard(dim=3))"],
            ["(Shard(dim=0), Shard(dim=2))", "(Shard(dim=0), Shard(dim=3))"])


@pytest.mark.parametrize("arch", list(runner.TRAIN_CASES))
def test_sharded_train_step_matches_unsharded(spmd, arch):
    """Loss and the parameters after step 0 within rtol 1e-5 of the
    unsharded port step; the loss falls over 3 steps; 6 of 8 rows carry
    weight (``tests/spmd_runner.py``'s assertions)."""
    losses, after0 = spmd["unsharded"][arch]
    got = spmd["arrays"][f"train/{arch}/loss"]
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    assert got[0] > got[1] > got[2]
    for name, want in after0.items():
        have = spmd["arrays"][f"train/{arch}/params0/{name}"]
        np.testing.assert_allclose(have, want.float().numpy(), rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()),
                                   err_msg=name)
    for rank in range(runner.WORLD):
        res = spmd["results"][(f"train/{arch}", rank)]["result"]
        assert res["weight_sum"] == 6 * runner.TRAIN_S
        assert res["losses"] == list(got)
        assert res["replicated_ops"] == 0
