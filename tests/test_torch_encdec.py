"""The port's encoder-decoder (``models/encdec.py``) and sinusoidal
positions against the JAX package's, on the CPU.

Parameters are the reference's (reduced whisper-medium: LayerNorm, biases,
plain GELU; ``init_encdec`` at PRNGKey 0) carried over by
``params_from_jax``; frames and tokens come from a seeded numpy generator.
``encode``, ``decode`` (full and step by step through the caches, whose
``dec.{i}.*`` tensors convert both ways), ``encdec_loss`` and its gradients
agree with the reference's at rtol 1e-5 (gradients 1e-4).  The positions
agree to atol max(1e-6, 2^-22 x the largest position): the two packages'
``10000 ** (i / d)`` may differ in the last bit, which moves an angle of
1500 rad by up to ~1e-4 rad.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import encdec_decode as ref_decode
from repro.models import encdec_encode as ref_encode
from repro.models import encdec_loss as ref_encdec_loss
from repro.models import init_dec_caches as ref_init_dec_caches
from repro.models import init_encdec as ref_init_encdec
from repro.models import layers as ref_layers
from repro.models import reduced as ref_reduced
from repro_torch.configs import get_config
from repro_torch.models import (caches_from_jax, caches_to_jax,
                                encdec_decode, encdec_encode, encdec_loss,
                                init_dec_caches, init_encdec, layers,
                                params_from_jax, params_to_jax, reduced)

B, S = 2, 10
CPU = dict(device="cpu")
RNG_SEED = 5


def _cfgs():
    return (reduced(get_config("whisper-medium")),
            ref_reduced(ref_get_config("whisper-medium")))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def params():
    cfg, ref_cfg = _cfgs()
    rp = _np(ref_init_encdec(jax.random.PRNGKey(0), ref_cfg))
    return rp, params_from_jax(rp, cfg, **CPU)


def _inputs(cfg, seed=RNG_SEED):
    rng = np.random.default_rng(seed)
    frames = (0.02 * rng.standard_normal(
        (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    tgts = rng.integers(0, cfg.vocab_size, (B, S))
    return frames, toks, tgts


def _close(ours, ref, rtol=1e-5, err=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1.0),
                               err_msg=err)


def _angle_tol(max_pos):
    return max(1e-6, 2.0 ** -22 * float(max_pos))


@pytest.mark.parametrize("length,d", [(16, 32), (1500, 1024), (7, 6)])
def test_sinusoidal_positions_match_reference(length, d):
    ours = layers.sinusoidal_positions(length, d)
    assert ours.shape == (length, d) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(
        ref_layers.sinusoidal_positions(length, d)), rtol=0,
        atol=_angle_tol(length - 1))


def test_sinusoidal_at_matches_reference():
    pos = np.array([[0, 3, 500_000], [7, 1, 2]])
    np.testing.assert_allclose(
        layers.sinusoidal_at(torch.from_numpy(pos), 64).numpy(),
        np.asarray(ref_layers.sinusoidal_at(jnp.asarray(pos), 64)),
        rtol=0, atol=_angle_tol(pos.max()))


def test_params_roundtrip_exact(params):
    cfg, _ = _cfgs()
    rp, p = params
    assert {k.split(".")[0] for k in p} == {"embed", "enc", "enc_norm",
                                           "dec", "final_norm"}
    assert f"enc.{cfg.encoder_layers - 1}.attn.wq.bias" in p
    assert f"dec.{cfg.num_layers - 1}.cross_attn.wk.weight" in p
    ours = init_encdec(torch.Generator().manual_seed(0), cfg)
    assert ours.keys() == p.keys()
    assert all(ours[k].shape == p[k].shape for k in p)
    back, want = _flat(params_to_jax(p, cfg)), _flat(rp)
    assert back.keys() == want.keys()
    for key in want:
        assert back[key].dtype == want[key].dtype
        assert np.array_equal(back[key], want[key]), key


def test_encode_matches_reference(params):
    cfg, ref_cfg = _cfgs()
    rp, p = params
    frames, _, _ = _inputs(cfg)
    enc = encdec_encode(p, cfg, torch.from_numpy(frames))
    assert enc.shape == (B, cfg.encoder_seq, cfg.d_model)
    _close(enc, ref_encode(rp, ref_cfg, jnp.asarray(frames)))


def test_decode_full_matches_reference(params):
    cfg, ref_cfg = _cfgs()
    rp, p = params
    frames, toks, _ = _inputs(cfg)
    enc = ref_encode(rp, ref_cfg, jnp.asarray(frames))
    logits, caches = encdec_decode(p, cfg, torch.from_numpy(toks),
                                   torch.from_numpy(np.array(enc)))
    ref_logits, _ = ref_decode(rp, ref_cfg, jnp.asarray(toks), enc)
    assert caches is None and logits.shape == (B, S, cfg.vocab_size)
    _close(logits, ref_logits)


def test_decode_with_caches_matches_reference_and_full_pass(params):
    cfg, ref_cfg = _cfgs()
    rp, p = params
    frames, toks, _ = _inputs(cfg, seed=6)
    enc = ref_encode(rp, ref_cfg, jnp.asarray(frames))
    enc_t = torch.from_numpy(np.array(enc))
    step = jax.jit(lambda pp, t, e, c, pos: ref_decode(
        pp, ref_cfg, t, e, caches=c, positions=pos))
    ref_c = ref_init_dec_caches(ref_cfg, B, S)
    caches = init_dec_caches(cfg, B, S, **CPU)
    assert caches.keys() == {f"dec.{i}.{n}" for i in range(cfg.num_layers)
                             for n in ("k", "v", "idx")}
    outs = []
    with torch.no_grad():
        full, _ = encdec_decode(p, cfg, torch.from_numpy(toks), enc_t)
        for i in range(S):
            pos = np.full((B, 1), i, np.int32)
            ref_lg, ref_c = step(rp, jnp.asarray(toks[:, i:i + 1]), enc,
                                 ref_c, jnp.asarray(pos))
            lg, caches = encdec_decode(p, cfg,
                                       torch.from_numpy(toks[:, i:i + 1]),
                                       enc_t, caches=caches,
                                       positions=torch.from_numpy(pos))
            _close(lg, ref_lg, err=f"step {i}")
            want = caches_from_jax(_np(ref_c), cfg, **CPU)
            assert want.keys() == caches.keys()
            for key, t in caches.items():
                assert t.dtype == want[key].dtype
                if key.endswith(".idx"):
                    assert torch.equal(t, want[key])
                else:
                    _close(t, want[key].numpy(), err=key)
            outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=2e-4, rtol=2e-3)
    back = _flat(caches_to_jax(caches_from_jax(_np(ref_c), cfg, **CPU), cfg))
    want = _flat(_np(ref_c))
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k], want[k]) for k in want)


@pytest.mark.parametrize("mask_kind", ["rows", "tokens"])
def test_encdec_loss_and_gradients_match_reference(params, mask_kind):
    cfg, ref_cfg = _cfgs()
    rp, p = params
    frames, toks, tgts = _inputs(cfg, seed=7)
    mask = (np.array([1.0, 0.0], np.float32) if mask_kind == "rows" else
            (np.random.default_rng(8).random((B, S)) > 0.3).astype(np.float32))

    def ref_loss(pp):
        ls, ws, _ = ref_encdec_loss(pp, ref_cfg, jnp.asarray(frames),
                                    jnp.asarray(toks), jnp.asarray(tgts),
                                    jnp.asarray(mask))
        return ls, ws

    (ref_ls, ref_ws), ref_g = jax.value_and_grad(ref_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, rp))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    ls, ws, aux = encdec_loss(leaves, cfg, torch.from_numpy(frames),
                              torch.from_numpy(toks), torch.from_numpy(tgts),
                              torch.from_numpy(mask))
    assert aux.item() == 0.0
    assert ws.item() == float(ref_ws)
    np.testing.assert_allclose(ls.item(), float(ref_ls), rtol=1e-5)
    grads = dict(zip(leaves, torch.autograd.grad(ls, list(leaves.values()))))
    got, want = _flat(params_to_jax(grads, cfg)), _flat(_np(ref_g))
    assert got.keys() == want.keys()
    for key in want:
        _close(torch.from_numpy(got[key]), want[key], rtol=1e-4, err=key)
