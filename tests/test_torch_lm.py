"""The port's dense LM stack and optimizers against the reference, on the
same numpy parameters and batches: parameter conversion is exact, the layer
functions and ``lm_loss`` (with its gradients) agree in fp32, on a reduced
gemma-2b whose seq 128 puts the reference on its Pallas kernel branch (in
interpret mode)."""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import reduced as ref_reduced
from repro.models.transformer import init_lm as ref_init_lm
from repro.models.transformer import lm_loss as ref_lm_loss
from repro.optim import optimizers as ref_optim
from repro.optim import schedules as ref_sched
from repro_torch.configs import get_config
from repro_torch.models import (layers, lm_loss, params_from_jax,
                                params_to_jax, reduced)
from repro_torch.optim import optimizers, schedules

RNG = np.random.default_rng(11)


def _cfgs(**kw):
    return (reduced(get_config("gemma-2b")).with_(**kw),
            ref_reduced(ref_get_config("gemma-2b")).with_(**kw))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def ref_params():
    _, ref_cfg = _cfgs()
    return jax.tree_util.tree_map(np.asarray,
                                  ref_init_lm(jax.random.PRNGKey(0), ref_cfg))


def test_params_roundtrip_exact(ref_params):
    cfg, _ = _cfgs()
    ours = params_from_jax(ref_params, cfg, device="cpu")
    assert ours["layers.1.attn.wq.weight"].shape == (
        cfg.num_heads * cfg.head_dim, cfg.d_model)
    back = _flat(params_to_jax(ours, cfg))
    want = _flat(ref_params)
    assert back.keys() == want.keys()
    for key in want:
        assert back[key].dtype == want[key].dtype
        assert np.array_equal(back[key], want[key]), key


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _layer_pair(name):
    """(port output, reference output) of one layer function."""
    cfg, ref_cfg = _cfgs()
    d, v = cfg.d_model, cfg.vocab_size
    x = RNG.standard_normal((2, 16, d)).astype(np.float32)
    if name == "rope":
        h = RNG.standard_normal((2, 16, 4, 32)).astype(np.float32)
        pos = np.arange(16)[None]
        return (layers.rope(_t(h), _t(pos), 10_000.0),
                ref_layers.rope(jnp.asarray(h), jnp.asarray(pos), 10_000.0))
    if name == "rmsnorm":
        scale = RNG.standard_normal(d).astype(np.float32)
        return (layers.apply_norm({"scale": _t(scale)}, _t(x), cfg),
                ref_layers.apply_norm({"scale": scale}, jnp.asarray(x),
                                      ref_cfg))
    if name == "linear":
        w = RNG.standard_normal((d, 24)).astype(np.float32)
        b = RNG.standard_normal(24).astype(np.float32)
        return (layers.linear({"weight": _t(w.T.copy()), "bias": _t(b)},
                              _t(x)),
                ref_layers.linear({"w": w, "b": b}, jnp.asarray(x)))
    if name == "geglu":
        p = {n: RNG.standard_normal(s).astype(np.float32) / 8 for n, s in
             (("w_gate", (d, 64)), ("w_up", (d, 64)), ("w_down", (64, d)))}
        ours = {f"{n}.weight": _t(w.T.copy()) for n, w in p.items()}
        return (layers.apply_mlp(ours, _t(x), cfg),
                ref_layers.apply_mlp({n: {"w": w} for n, w in p.items()},
                                     jnp.asarray(x), ref_cfg))
    table = RNG.standard_normal((v, d)).astype(np.float32)
    if name == "embed":
        tok = RNG.integers(0, v, (2, 16))
        return (layers.embed({"table": _t(table)}, _t(tok), cfg),
                ref_layers.embed({"table": table}, jnp.asarray(tok), ref_cfg))
    if name == "unembed":
        return (layers.unembed({"table": _t(table)}, None, _t(x), cfg),
                ref_layers.unembed({"table": table}, None, jnp.asarray(x),
                                   ref_cfg))
    q, k, vv = (RNG.standard_normal(s).astype(np.float32) for s in
                ((2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32)))
    if name == "attention_scores":
        mask = np.tril(np.ones((64, 64), bool))
        return (layers.attention_scores(_t(q), _t(k), _t(vv), _t(mask), 20.0),
                ref_layers.attention_scores(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(vv),
                                            jnp.asarray(mask), 20.0))
    if name == "chunked_attention":
        kw = dict(causal=True, window=24, softcap=None, chunk=16)
        return (layers.chunked_attention_scores(_t(q), _t(k), _t(vv), **kw),
                ref_layers.chunked_attention_scores(
                    jnp.asarray(q), jnp.asarray(k), jnp.asarray(vv), **kw))
    assert name == "causal_mask"
    return (layers.causal_mask(8, 12, offset=4, window=3),
            ref_layers.causal_mask(8, 12, offset=4, window=3))


@pytest.mark.parametrize("name", ["rope", "rmsnorm", "linear", "geglu",
                                  "embed", "unembed", "attention_scores",
                                  "chunked_attention", "causal_mask"])
def test_layer_matches_reference(name):
    ours, ref = _layer_pair(name)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_rope_is_interleaved_not_halves():
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0                         # pair (0, 1) rotates together
    y = layers.rope(x, torch.tensor([[1]]), 10_000.0)
    assert y[..., 1].abs().item() > 0.5 and y[..., 2].item() == 0.0


def test_token_xent_and_gradient_match_reference():
    logits = RNG.standard_normal((2, 8, 40)).astype(np.float32) * 3
    tgt = RNG.integers(0, 40, (2, 8))
    g = RNG.standard_normal((2, 8)).astype(np.float32)
    lt = _t(logits).requires_grad_()
    nll = layers.token_xent(lt, _t(tgt))
    (nll * _t(g)).sum().backward()
    ref_nll, ref_vjp = jax.vjp(
        lambda l_: ref_layers.sharded_xent(l_, jnp.asarray(tgt)),
        jnp.asarray(logits))
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(ref_nll),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(),
                               np.asarray(ref_vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seq,kernel", [(128, True), (64, False)],
                         ids=["kernel-branch", "plain-branch"])
def test_lm_loss_and_grads_match_reference(ref_params, seq, kernel):
    cfg, ref_cfg = _cfgs(use_pallas=kernel)
    tok = RNG.integers(0, cfg.vocab_size, (4, seq))
    tgt = RNG.integers(0, cfg.vocab_size, (4, seq))
    mask = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    nv = 3 if kernel else None

    def ref_loss(p):
        ls, ws, _ = ref_lm_loss(p, ref_cfg, jnp.asarray(tok),
                                jnp.asarray(tgt), jnp.asarray(mask),
                                num_valid=None if nv is None else jnp.int32(nv))
        return ls

    ref_val, ref_grads = jax.value_and_grad(ref_loss)(
        jax.tree_util.tree_map(jnp.asarray, ref_params))
    leaves = {k: v.requires_grad_() for k, v in
              params_from_jax(ref_params, cfg, device="cpu").items()}
    ls, ws, _ = lm_loss(leaves, cfg, _t(tok), _t(tgt), _t(mask),
                        num_valid=None if nv is None
                        else torch.tensor(nv, dtype=torch.int32))
    grads = dict(zip(leaves, torch.autograd.grad(ls, list(leaves.values()))))
    assert ws.item() == 3 * seq
    np.testing.assert_allclose(ls.item(), float(ref_val), rtol=1e-5)
    want = _flat(jax.tree_util.tree_map(np.asarray, ref_grads))
    got = _flat(params_to_jax(grads, cfg))
    assert got.keys() == want.keys()
    for key in want:
        scale = np.abs(want[key]).max()
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=str(key))


OPTIMIZERS = {
    "sgd": dict(),
    "momentum": dict(beta=0.9),
    "nesterov": dict(beta=0.8, nesterov=True),
    "adam": dict(),
    "adamw": dict(weight_decay=0.05),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_reference(name):
    kw = OPTIMIZERS[name]
    make = "momentum" if name == "nesterov" else name
    ours = getattr(optimizers, make)(3e-2, **kw)
    ref = getattr(ref_optim, make)(3e-2, **kw)
    p0 = {"w": RNG.standard_normal((5, 3)).astype(np.float32),
          "b": RNG.standard_normal(3).astype(np.float32)}
    p, s = {k: _t(v.copy()) for k, v in p0.items()}, None
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    s, rs = ours.init(p), ref.init(rp)
    for step in range(4):
        g = {k: RNG.standard_normal(v.shape).astype(np.float32)
             for k, v in p0.items()}
        p, s = ours.update(p, {k: _t(v) for k, v in g.items()}, s, step)
        rp, rs = ref.update(rp, {k: jnp.asarray(v) for k, v in g.items()}, rs,
                            jnp.asarray(step))
    for k in p0:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(rp[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_adam_long_run_within_2_ulp_of_reference(name):
    """200 steps on 4096 parameters, the same Gaussian gradients on both
    sides: the bias corrections, lr and lr * weight_decay are fp32 as in the
    reference, so every parameter stays within 2 ulp of the reference's
    (a float64 bias correction drifts to ~1e-6 by step 200)."""
    kw = OPTIMIZERS[name]
    ours, ref = getattr(optimizers, name)(1e-3, **kw), \
        getattr(ref_optim, name)(1e-3, **kw)
    rng = np.random.default_rng(200)
    p0 = rng.standard_normal(4096).astype(np.float32)
    p, rp = {"w": _t(p0.copy())}, {"w": jnp.asarray(p0)}
    s, rs = ours.init(p), ref.init(rp)
    for step in range(200):
        g = rng.standard_normal(4096).astype(np.float32)
        p, s = ours.update(p, {"w": _t(g)}, s, step)
        rp, rs = ref.update(rp, {"w": jnp.asarray(g)}, rs, jnp.asarray(step))
        want = np.asarray(rp["w"])
        ulp = np.spacing(np.abs(want))
        assert (np.abs(p["w"].numpy() - want) <= 2 * ulp).all(), step


def test_cosine_schedule_fp32_matches_reference():
    """1000 steps, warmup 100: the port's fp32 evaluation equals the
    reference's, or is one ulp off."""
    ours = schedules.cosine_schedule(1e-3, 1000, warmup=100)
    ref = ref_sched.cosine_schedule(1e-3, 1000, warmup=100)
    for step in range(1000):
        got = np.float32(ours(step))
        want = np.asarray(ref(jnp.asarray(step)), np.float32)
        assert float(got) == ours(step)  # an fp32 value, exactly
        assert abs(got - want) <= np.spacing(np.abs(want)), step


def test_schedules_match_reference():
    pairs = [
        (schedules.step_schedule([0.1, 0.01, 0.001], [3, 6]),
         ref_sched.step_schedule([0.1, 0.01, 0.001], [3, 6])),
        (schedules.cosine_schedule(0.1, 20, warmup=4, floor=0.01),
         ref_sched.cosine_schedule(0.1, 20, warmup=4, floor=0.01)),
    ]
    ours_c = schedules.batch_coupled(0.05, rule="sqrt")
    ref_c = ref_sched.batch_coupled(0.05, rule="sqrt")
    assert ours_c.set_batch_ratio(4.0) == ref_c.set_batch_ratio(4.0)
    pairs.append((ours_c, ref_c))
    for ours, ref in pairs:
        for step in range(0, 25, 2):
            assert math.isclose(ours(step), float(ref(jnp.asarray(step))),
                                rel_tol=1e-6)
