"""The port's hybrid family (RecurrentGemma) against the reference, on the
same numpy parameters and inputs: parameter conversion is exact over the
group and tail layout, and ``apply_rglru``, ``recurrent_block`` and
``lm_loss`` agree in fp32 on a reduced recurrentgemma-9b (5 layers: one
rec-rec-local group and a rec-rec tail; d_model 128, lru_width 128, local
window 8).

The port runs its kernel path (``use_pallas``: the RG-LRU ``autograd.Function``
and, at seq 128, the flash one, whose wrappers take their plain versions on
the CPU).  Forward values are held against the reference's kernel path (its
Pallas kernels in interpret mode) and its plain path, gradients against
``jax.grad`` of its plain path, the one it trains with (its RG-LRU kernel
path has no VJP).  Tolerances: forward 1e-5 abs and rel (the reference's
RG-LRU tolerance; the loss 1e-5 relative), gradients 1e-4 x max|g| per leaf
(fp32 through five layers, other summation orders).  Sequences of 16 and
128 are longer than the window of 8, so the local blocks mask.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import recurrent as ref_rec
from repro.models import reduced as ref_reduced
from repro.models.transformer import init_lm as ref_init_lm
from repro.models.transformer import lm_loss as ref_lm_loss
from repro_torch.configs import get_config
from repro_torch.models import (apply_rglru, init_lm, lm_loss,
                                params_from_jax, params_to_jax,
                                recurrent_block, reduced)
from repro_torch.models.layers import sub

TOL = 1e-5
GRAD_TOL = 1e-4
RNG = np.random.default_rng(15)


def _cfgs(**kw):
    return (reduced(get_config("recurrentgemma-9b")).with_(**kw),
            ref_reduced(ref_get_config("recurrentgemma-9b")).with_(**kw))


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


@pytest.fixture(scope="module")
def ref_params():
    return _ref_params()


def _assert_grads_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        scale = np.abs(want[key]).max()
        err = np.abs(got[key] - want[key]).max()
        assert err <= GRAD_TOL * scale, (key, err, scale)


@pytest.mark.parametrize("layers", [5, 7], ids=["group+2tail", "2groups+1tail"])
def test_params_roundtrip_exact(layers):
    cfg, _ = _cfgs(num_layers=layers)
    tree = _ref_params(num_layers=layers)
    assert set(tree["tail"]) == {f"t{i}" for i in range(layers % 3)}
    ours = params_from_jax(tree, cfg, device="cpu")
    period = 3
    for i in range(layers):
        kind = cfg.block_pattern[i % period]
        assert (f"layers.{i}.rec.rglru.lam" in ours) == (kind == "rec")
        assert (f"layers.{i}.attn.wq.weight" in ours) == (kind == "local")
    assert ours["layers.0.rec.conv_w"].shape == (cfg.conv_kernel,
                                                 cfg.lru_width)
    assert ours["layers.0.rec.in_x.weight"].shape == (cfg.lru_width,
                                                      cfg.d_model)
    # the tail's first block is layer 3 * n_groups, group 1's block 0 layer 3
    tail0 = tree["tail"]["t0"]["rec"]["rglru"]["lam"]
    assert np.array_equal(
        ours[f"layers.{layers // period * period}.rec.rglru.lam"].numpy(),
        tail0)
    if layers > 6:
        assert np.array_equal(
            ours["layers.3.rec.in_x.weight"].numpy(),
            tree["groups"]["b0"]["rec"]["in_x"]["w"][1].T)
    back = _flat(params_to_jax(ours, cfg))
    want = _flat(tree)
    assert back.keys() == want.keys()
    for key in want:
        assert back[key].dtype == want[key].dtype
        assert np.array_equal(back[key], want[key]), key


def test_params_from_jax_rejects_blocks_outside_the_layout(ref_params):
    cfg, _ = _cfgs()
    for where, key in (("groups", "b3"), ("tail", "t2"), ("groups", "x0")):
        tree = dict(ref_params)
        tree[where] = {**ref_params[where],
                       key: ref_params[where]["b0" if where == "groups"
                                              else "t0"]}
        with pytest.raises(ValueError, match="unexpected block key"):
            params_from_jax(tree, cfg, device="cpu")


def test_init_matches_reference_structure(ref_params):
    cfg, _ = _cfgs()
    ours = init_lm(torch.Generator().manual_seed(0), cfg)
    tree = _flat(params_to_jax(ours, cfg))
    want = _flat(ref_params)
    assert {k: v.shape for k, v in tree.items()} == {
        k: v.shape for k, v in want.items()}
    lam = ours["layers.0.rec.rglru.lam"]
    a = torch.sigmoid(lam) ** 8.0      # a = sigmoid(lam)^c in ~[0.9, 0.999]
    assert a.min() >= 0.9 - 1e-6 and a.max() <= 0.999 + 1e-6


def _rec_block(tree, i=0):
    """Layer 0's rec-block parameters: reference sub-tree and port dict."""
    cfg, _ = _cfgs()
    block = jax.tree_util.tree_map(lambda v: v[0],
                                   tree["groups"][f"b{i}"]["rec"])
    ours = sub(params_from_jax(tree, cfg, device="cpu"), f"layers.{i}.rec")
    return block, ours


@pytest.mark.parametrize("width,with_state", [(128, False), (128, True),
                                              (96, True)],
                         ids=["kernel", "kernel-h0", "kernel-w96-h0"])
def test_apply_rglru_matches_reference(ref_params, width, with_state):
    """The port takes its kernel pair at every width; the reference takes
    its Pallas kernel (interpret mode) only at W % 128 == 0, else its plain
    scan.  Held against both of the reference's paths."""
    block, ours = _rec_block(ref_params)
    p_ref = jax.tree_util.tree_map(lambda v: v[..., :width] if v.ndim == 1
                                   else v[:width, :width], block["rglru"])
    p_ours = {k: (v[:width] if v.dim() == 1 else v[:width, :width])
              .contiguous() for k, v in sub(ours, "rglru").items()}
    x = RNG.standard_normal((2, 24, width)).astype(np.float32)
    st = RNG.standard_normal((2, width)).astype(np.float32)
    state = st if with_state else None
    y, h_last = apply_rglru(p_ours, torch.from_numpy(x),
                            None if state is None else torch.from_numpy(state),
                            use_pallas=True)
    for use_pallas in (True, False):
        ry, rh = ref_rec.apply_rglru(p_ref, jnp.asarray(x),
                                     None if state is None
                                     else jnp.asarray(state),
                                     use_pallas=use_pallas)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(rh), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("seq", [16, 40])
def test_recurrent_block_forward_and_grads_match_reference(ref_params, seq):
    cfg, ref_cfg = _cfgs(use_pallas=True)
    block, ours = _rec_block(ref_params, i=1)
    x = (RNG.standard_normal((2, seq, cfg.d_model)) * 0.5).astype(np.float32)
    g_out = RNG.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    out, cache = recurrent_block(ours, torch.from_numpy(x), cfg)
    assert cache is None and out.shape == (2, seq, cfg.d_model)
    ref_out, _ = ref_rec.recurrent_block(block, jnp.asarray(x), ref_cfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=TOL, rtol=TOL)
    plain_cfg = ref_cfg.with_(use_pallas=False)

    def ref_loss(p, xx):
        y, _ = ref_rec.recurrent_block(p, xx, plain_cfg)
        return jnp.sum(y * g_out)

    want_p, want_x = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, block), jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in ours.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = recurrent_block(leaves, xt, cfg)
    grads = torch.autograd.grad((out * torch.from_numpy(g_out)).sum(),
                                [xt, *leaves.values()])
    gx, gp = grads[0], dict(zip(leaves, grads[1:]))
    assert np.abs(gx.numpy() - np.asarray(want_x)).max() <= \
        GRAD_TOL * np.abs(np.asarray(want_x)).max()
    got = {k: v.numpy().T if k.endswith("weight") else v.numpy()
           for k, v in gp.items()}
    leaf = {"w": "weight", "b": "bias"}
    want = {".".join(k[:-1] + (leaf.get(k[-1], k[-1]),)): v
            for k, v in _flat(jax.tree_util.tree_map(np.asarray,
                                                     want_p)).items()}
    _assert_grads_close(got, want)


@pytest.mark.parametrize("seq,nv", [(16, None), (128, 3)],
                         ids=["plain-attention", "flash-branch"])
def test_lm_loss_and_grads_match_reference(ref_params, seq, nv):
    cfg, ref_cfg = _cfgs(use_pallas=True)
    tok = RNG.integers(0, cfg.vocab_size, (4, seq))
    tgt = RNG.integers(0, cfg.vocab_size, (4, seq))
    mask = np.array([1.0, 1.0, 1.0, 0.0], np.float32)

    def ref_loss(p, c):
        ls, _, _ = ref_lm_loss(p, c, jnp.asarray(tok), jnp.asarray(tgt),
                               jnp.asarray(mask),
                               num_valid=None if nv is None else jnp.int32(nv))
        return ls

    jtree = jax.tree_util.tree_map(jnp.asarray, ref_params)
    ref_kernel_val = jax.jit(ref_loss, static_argnums=1)(jtree, ref_cfg)
    ref_val, ref_grads = jax.jit(jax.value_and_grad(ref_loss),
                                 static_argnums=1)(
        jtree, ref_cfg.with_(use_pallas=False))
    leaves = {k: v.requires_grad_() for k, v in
              params_from_jax(ref_params, cfg, device="cpu").items()}
    ls, ws, _ = lm_loss(leaves, cfg, torch.from_numpy(tok),
                        torch.from_numpy(tgt), torch.from_numpy(mask),
                        num_valid=None if nv is None
                        else torch.tensor(nv, dtype=torch.int32))
    grads = dict(zip(leaves, torch.autograd.grad(ls, list(leaves.values()))))
    assert ws.item() == 3 * seq
    np.testing.assert_allclose(ls.item(), float(ref_kernel_val), rtol=TOL)
    np.testing.assert_allclose(ls.item(), float(ref_val), rtol=TOL)
    _assert_grads_close(_flat(params_to_jax(grads, cfg)),
                        _flat(jax.tree_util.tree_map(np.asarray, ref_grads)))


def test_local_window_masks(ref_params):
    """At seq 16 > window 8 a token's loss does not depend on tokens more
    than 8 back through the local block alone, but does through the
    recurrence: perturbing token 0 moves the last position's logits, and
    with the recurrent layers' input gates zeroed it no longer does."""
    cfg, _ = _cfgs()
    params = params_from_jax(ref_params, cfg, device="cpu")
    tok = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (1, 16)))
    moved = tok.clone()
    moved[0, 0] = (tok[0, 0] + 1) % cfg.vocab_size
    from repro_torch.models import apply_lm

    def last_logits(p, t):
        return apply_lm(p, cfg, t)[0][0, -1]

    assert not torch.equal(last_logits(params, tok),
                           last_logits(params, moved))
    cut = {k: (torch.zeros_like(v) if ".rec.rglru.w_x." in k
               or k.endswith(".rec.in_x.weight") else v)
           for k, v in params.items()}
    assert torch.equal(last_logits(cut, tok), last_logits(cut, moved))
