"""The port's MoE layer (``init_moe`` / ``moe_capacity`` / ``apply_moe``)
against the JAX package's, on the CPU.

Shared inputs: numpy-seeded parameters in the reference's layout (router
``w`` (D, E), experts (E, D, F) / (E, F, D)), the router transposed into
the port's (E, D) as ``params_from_jax`` does, and numpy-seeded tokens.
The reduced deepseek-v2 config (4 experts, top-2, group 16, one shared
expert) runs at capacity factor 8.0 (nothing drops) and 0.5 (choices drop),
with and without the shared expert, and with a token count that is no
multiple of the group (the last group zero-padded).

Routing is compared exactly: the top-k expert indices and which choices
drop.  Each test first asserts that every real token's k-th routing
probability exceeds its (k+1)-th by more than 1e-4, so a near-tie, whose
routing may differ with the summation order of the router product, fails
loudly instead of hiding.  Padded tokens have exact ties (uniform
probabilities); both packages keep the lower expert index.  Outputs and
the aux loss agree to rtol 1e-5, gradients (``jax.grad``) to rtol 1e-4.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import reduced as ref_reduced
from repro_torch.configs import get_config
from repro_torch.models import layers, reduced

# name: (capacity factor, shared experts, batch, seq)
CASES = {
    "cap8-shared": (8.0, 1, 2, 16),
    "cap8-no-shared": (8.0, 0, 2, 16),
    "cap0.5-shared": (0.5, 1, 2, 16),
    "cap0.5-no-shared": (0.5, 0, 2, 16),
    "cap8-group-padding": (8.0, 1, 2, 12),
    "cap0.5-group-padding": (0.5, 0, 3, 9),
}
MARGIN = 1e-4


def _cfgs(factor, shared):
    kw = dict(moe_capacity_factor=factor, num_shared_experts=shared)
    return (reduced(get_config("deepseek-v2-236b")).with_(**kw),
            ref_reduced(ref_get_config("deepseek-v2-236b")).with_(**kw))


def _ref_params(cfg, seed):
    rng = np.random.default_rng(seed)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    p = {"router": {"w": w(d, e, fan_in=d)}, "w_gate": w(e, d, f, fan_in=d),
         "w_up": w(e, d, f, fan_in=d), "w_down": w(e, f, d, fan_in=f)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {"w_gate": {"w": w(d, fs, fan_in=d)},
                       "w_up": {"w": w(d, fs, fan_in=d)},
                       "w_down": {"w": w(fs, d, fan_in=fs)}}
    return p


def _port_params(ref):
    """The reference's MoE tree in the port's names and layouts (what
    ``params_from_jax`` does to a block's ``moe`` subtree)."""
    out = {"router.weight": torch.from_numpy(ref["router"]["w"].T.copy())}
    for name in ("w_gate", "w_up", "w_down"):
        out[name] = torch.from_numpy(ref[name].copy())
        if "shared" in ref:
            out[f"shared.{name}.weight"] = torch.from_numpy(
                ref["shared"][name]["w"].T.copy())
    return out


def _ref_routing(p, x, cfg):
    """The reference's (top-k indices, choice fits) per grouped token, by
    the operations of its ``apply_moe``."""
    b, s, d = x.shape
    g = min(cfg.moe_group_size, b * s)
    tokens = x.reshape(-1, d)
    tokens = jnp.pad(tokens, ((0, (-tokens.shape[0]) % g), (0, 0)))
    xt = tokens.reshape(-1, g, d)
    probs = jax.nn.softmax(xt @ p["router"]["w"], axis=-1)
    _, topi = jax.lax.top_k(probs, cfg.moe_top_k)
    sel = jax.nn.one_hot(topi, cfg.num_experts).reshape(
        xt.shape[0], g * cfg.moe_top_k, -1)
    pos = ((jnp.cumsum(sel, axis=1) - sel) * sel).sum(-1).reshape(topi.shape)
    cap = ref_layers.moe_capacity(g, cfg.moe_top_k, cfg.num_experts,
                                  cfg.moe_capacity_factor)
    return np.asarray(topi), np.asarray(pos < cap)


def _case(name):
    factor, shared, b, s = CASES[name]
    cfg, ref_cfg = _cfgs(factor, shared)
    seed = sorted(CASES).index(name)
    ref_p = _ref_params(ref_cfg, seed)
    x = np.random.default_rng(100 + seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return cfg, ref_cfg, ref_p, _port_params(ref_p), x


def _sorted_probs(probs, n_real):
    """(n_real, E): each real token's routing probabilities, largest
    first."""
    e = probs.shape[-1]
    return torch.sort(probs.reshape(-1, e), dim=-1,
                      descending=True).values[:n_real]


@pytest.mark.parametrize("name", list(CASES))
def test_routing_and_drops_match_reference_exactly(name):
    cfg, ref_cfg, ref_p, p, x = _case(name)
    b, s, d = x.shape
    g = min(cfg.moe_group_size, b * s)
    tokens = torch.nn.functional.pad(torch.from_numpy(x).reshape(-1, d),
                                     (0, 0, 0, (-b * s) % g))
    probs, topi, topv, sel, pos = layers.moe_route(p, tokens.reshape(-1, g, d),
                                                   cfg)
    k = cfg.moe_top_k
    top = _sorted_probs(probs, b * s)
    margin = (top[:, k - 1] - top[:, k]).min().item()
    assert margin > MARGIN, f"router near-tie ({margin:.3g}): pick new inputs"
    ref_topi, ref_fits = _ref_routing(ref_p, jnp.asarray(x), ref_cfg)
    assert np.array_equal(topi.numpy(), ref_topi)
    cap = layers.moe_capacity(g, k, cfg.num_experts, cfg.moe_capacity_factor)
    assert cap == ref_layers.moe_capacity(g, k, cfg.num_experts,
                                          cfg.moe_capacity_factor)
    fits = (pos < cap).numpy()
    assert np.array_equal(fits, ref_fits)
    real = fits.reshape(-1, k)[:b * s]
    if cfg.moe_capacity_factor < 1:
        assert not real.all(), "capacity 0.5 should drop some choices"
    else:
        assert real.all()
    np.testing.assert_allclose(topv.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert torch.equal(sel.argmax(-1), topi)


@pytest.mark.parametrize("name", list(CASES))
def test_apply_moe_matches_reference(name):
    cfg, ref_cfg, ref_p, p, x = _case(name)
    out, aux = layers.apply_moe(p, torch.from_numpy(x), cfg)
    ref_out, ref_aux = ref_layers.apply_moe(ref_p, jnp.asarray(x), ref_cfg)
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(ref_out)).max())
    np.testing.assert_allclose(aux.item(), float(ref_aux), rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_apply_moe_gradients_match_jax_grad(name):
    cfg, ref_cfg, ref_p, p, x = _case(name)
    cot = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def ref_loss(params, xx):
        out, aux = ref_layers.apply_moe(params, xx, ref_cfg)
        return (out * cot).sum() + 3.0 * aux

    ref_gp, ref_gx = jax.grad(ref_loss, argnums=(0, 1))(ref_p, jnp.asarray(x))
    leaves = {k: v.requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = layers.apply_moe(leaves, xt, cfg)
    total = (out * torch.from_numpy(cot)).sum() + 3.0 * aux
    grads = torch.autograd.grad(total, [xt, *leaves.values()])
    got = dict(zip(["x", *leaves], grads))
    want = {"x": np.asarray(ref_gx)}
    want.update(_port_params(jax.tree_util.tree_map(np.asarray, ref_gp)))
    assert got.keys() == want.keys()
    for key, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-6),
                                   err_msg=key)


def test_moe_capacity_matches_reference():
    for g, k, e, f in [(16, 2, 4, 1.25), (1024, 6, 160, 1.25), (3, 2, 8, 0.1),
                       (512, 6, 160, 160 / 6), (1024, 2, 8, 4.0)]:
        assert layers.moe_capacity(g, k, e, f) == ref_layers.moe_capacity(
            g, k, e, f)


def test_init_moe_layout():
    cfg, _ = _cfgs(1.25, 1)
    p = layers.init_moe(torch.Generator().manual_seed(0), cfg)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    assert p["router.weight"].shape == (e, d)
    assert p["router.weight"].dtype == torch.float32
    assert p["w_gate"].shape == p["w_up"].shape == (e, d, f)
    assert p["w_down"].shape == (e, f, d)
    assert p["shared.w_gate.weight"].shape == (f, d)
    out, aux = layers.apply_moe(p, torch.randn(2, 5, d), cfg)
    assert out.shape == (2, 5, d) and torch.isfinite(out).all()
    assert torch.isfinite(aux)
