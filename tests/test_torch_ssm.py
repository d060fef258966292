"""The port's ssm family (Mamba-2) against the reference, on the same numpy
parameters and inputs: parameter conversion is exact, ``ssd_block`` and
``lm_loss`` agree in fp32 on a reduced mamba2-1.3b (chunk 8), with one
group or two, and at a sequence length that needs padding to the chunk.

The port runs its kernel path (``use_pallas``: the SSD ``autograd.Function``,
whose wrappers take their plain versions on the CPU).  Forward values are
held against the reference's kernel path (its Pallas kernel in interpret
mode), gradients against ``jax.grad`` of its plain path, the one it trains
with (its kernel path has no VJP).  Tolerance: the reference's SSD 5e-4,
gradients 5e-4 x max|g| per leaf.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import reduced as ref_reduced
from repro.models import ssm as ref_ssm
from repro.models.transformer import init_lm as ref_init_lm
from repro.models.transformer import lm_loss as ref_lm_loss
from repro_torch.configs import get_config
from repro_torch.models import (lm_loss, params_from_jax, params_to_jax,
                                reduced, ssd_block)
from repro_torch.models import ssm
from repro_torch.models.layers import sub

TOL = 5e-4
RNG = np.random.default_rng(13)
# variant -> (config overrides, sequence length)
VARIANTS = {"base": ({}, 16), "ngroups2": ({"ssm_ngroups": 2}, 16),
            "padded": ({}, 20)}


def _cfgs(use_pallas=False, **kw):
    return (reduced(get_config("mamba2-1.3b")).with_(use_pallas=use_pallas,
                                                     **kw),
            ref_reduced(ref_get_config("mamba2-1.3b")).with_(
                use_pallas=use_pallas, **kw))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _ref_params(**kw):
    _, ref_cfg = _cfgs(**kw)
    return jax.tree_util.tree_map(np.asarray,
                                  ref_init_lm(jax.random.PRNGKey(0), ref_cfg))


def _assert_grads_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        scale = np.abs(want[key]).max()
        err = np.abs(got[key] - want[key]).max()
        assert err <= TOL * scale, (key, err, scale)


@pytest.mark.parametrize("variant", ["base", "ngroups2"])
def test_params_roundtrip_exact(variant):
    kw, _ = VARIANTS[variant]
    cfg, _ = _cfgs(**kw)
    tree = _ref_params(**kw)
    ours = params_from_jax(tree, cfg, device="cpu")
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    assert ours["layers.1.ssd.conv_w"].shape == (cfg.conv_kernel, conv_dim)
    assert ours["layers.0.ssd.in_proj.weight"].shape[1] == cfg.d_model
    back = _flat(params_to_jax(ours, cfg))
    want = _flat(tree)
    assert back.keys() == want.keys()
    for key in want:
        assert back[key].dtype == want[key].dtype
        assert np.array_equal(back[key], want[key]), key


def test_init_matches_reference_structure():
    cfg, _ = _cfgs()
    from repro_torch.models import init_lm

    ours = init_lm(torch.Generator().manual_seed(0), cfg)
    tree = _flat(params_to_jax(ours, cfg))
    want = _flat(_ref_params())
    assert {k: v.shape for k, v in tree.items()} == {
        k: v.shape for k, v in want.items()}


def test_segsum_and_causal_conv_match_reference():
    a = RNG.standard_normal((2, 3, 8)).astype(np.float32)
    ours = ssm.segsum(torch.from_numpy(a)).numpy()
    ref = np.asarray(ref_ssm.segsum(jnp.asarray(a)))
    assert np.array_equal(np.isinf(ours), np.isinf(ref))
    np.testing.assert_allclose(ours[np.isfinite(ref)], ref[np.isfinite(ref)],
                               rtol=1e-6, atol=1e-6)
    x = RNG.standard_normal((2, 10, 6)).astype(np.float32)
    w = RNG.standard_normal((4, 6)).astype(np.float32)
    st = RNG.standard_normal((2, 3, 6)).astype(np.float32)
    for state in (None, st):
        y, new = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                  None if state is None
                                  else torch.from_numpy(state))
        ry, rnew = ref_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                        None if state is None
                                        else jnp.asarray(state))
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(new.numpy(), np.asarray(rnew))


def _block_inputs(kw, seq):
    cfg, ref_cfg = _cfgs(use_pallas=True, **kw)
    tree = _ref_params(**kw)
    block = jax.tree_util.tree_map(lambda v: v[0], tree["groups"]["b0"]["ssd"])
    ours = sub(params_from_jax(tree, cfg, device="cpu"), "layers.0.ssd")
    x = (RNG.standard_normal((2, seq, cfg.d_model)) * 0.5).astype(np.float32)
    return cfg, ref_cfg, block, ours, x


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ssd_block_forward_matches_reference(variant):
    kw, seq = VARIANTS[variant]
    cfg, ref_cfg, block, ours, x = _block_inputs(kw, seq)
    out, cache = ssd_block(ours, torch.from_numpy(x), cfg)
    ref_out, _ = ref_ssm.ssd_block(block, jnp.asarray(x), ref_cfg)
    assert cache is None and out.shape == (2, seq, cfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=TOL,
                               rtol=TOL)
    plain, _ = ssd_block(ours, torch.from_numpy(x), cfg.with_(use_pallas=False))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ssd_block_grads_match_reference(variant):
    kw, seq = VARIANTS[variant]
    cfg, ref_cfg, block, ours, x = _block_inputs(kw, seq)
    g_out = RNG.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    ref_cfg = ref_cfg.with_(use_pallas=False)

    def ref_loss(p, xx):
        y, _ = ref_ssm.ssd_block(p, xx, ref_cfg)
        return jnp.sum(y * g_out)

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, block), jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in ours.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = ssd_block(leaves, xt, cfg)
    grads = torch.autograd.grad((out * torch.from_numpy(g_out)).sum(),
                                [xt, *leaves.values()])
    gx, gp = grads[0], dict(zip(leaves, grads[1:]))
    assert np.abs(gx.numpy() - np.asarray(want_x)).max() <= \
        TOL * np.abs(np.asarray(want_x)).max()
    got = {k: v.numpy().T if k.endswith("weight") else v.numpy()
           for k, v in gp.items()}
    want = {".".join(k).replace(".w", ".weight"): v
            for k, v in _flat(jax.tree_util.tree_map(np.asarray,
                                                     want_p)).items()}
    _assert_grads_close(got, want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_lm_loss_and_grads_match_reference(variant):
    kw, seq = VARIANTS[variant]
    cfg, ref_cfg = _cfgs(use_pallas=True, **kw)
    tree = _ref_params(**kw)
    tok = RNG.integers(0, cfg.vocab_size, (4, seq))
    tgt = RNG.integers(0, cfg.vocab_size, (4, seq))
    mask = np.array([1.0, 1.0, 1.0, 0.0], np.float32)

    def ref_loss(p, c):
        ls, _, _ = ref_lm_loss(p, c, jnp.asarray(tok), jnp.asarray(tgt),
                               jnp.asarray(mask))
        return ls

    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ref_kernel_val = ref_loss(jtree, ref_cfg)
    ref_val, ref_grads = jax.value_and_grad(ref_loss)(
        jtree, ref_cfg.with_(use_pallas=False))
    leaves = {k: v.requires_grad_() for k, v in
              params_from_jax(tree, cfg, device="cpu").items()}
    ls, ws, _ = lm_loss(leaves, cfg, torch.from_numpy(tok),
                        torch.from_numpy(tgt), torch.from_numpy(mask),
                        num_valid=torch.tensor(3, dtype=torch.int32))
    grads = dict(zip(leaves, torch.autograd.grad(ls, list(leaves.values()))))
    assert ws.item() == 3 * seq
    np.testing.assert_allclose(ls.item(), float(ref_kernel_val), rtol=1e-5)
    np.testing.assert_allclose(ls.item(), float(ref_val), rtol=1e-5)
    _assert_grads_close(_flat(params_to_jax(grads, cfg)),
                        _flat(jax.tree_util.tree_map(np.asarray, ref_grads)))


@pytest.mark.parametrize("variant", ["base", "ngroups2"])
def test_ssd_block_kernel_branch_passes_b_and_c_per_group(variant,
                                                          monkeypatch):
    """The kernel branch hands the intra-chunk kernels B and C per group
    (ssm_ngroups 1, and 1 < G < H), never repeated to heads, and still
    equals the plain branch."""
    from repro_torch.kernels.ssd_scan import ops

    kw, seq = VARIANTS[variant]
    cfg, _, _, ours, x = _block_inputs(kw, seq)
    assert 1 <= cfg.ssm_ngroups < cfg.ssm_nheads
    seen = []
    real = ops.ssd_intra_chunk

    def spy(xx, aa, bb, cc):
        seen.append((tuple(xx.shape), tuple(bb.shape), tuple(cc.shape)))
        return real(xx, aa, bb, cc)

    monkeypatch.setattr(ops, "ssd_intra_chunk", spy)
    out, _ = ssd_block(ours, torch.from_numpy(x), cfg)
    ((xs, bs, cs),) = seen
    assert xs[3] == cfg.ssm_nheads
    assert bs == cs == (*xs[:3], cfg.ssm_ngroups, cfg.ssm_state)
    plain, _ = ssd_block(ours, torch.from_numpy(x), cfg.with_(use_pallas=False))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-5,
                               rtol=1e-5)
