"""The port's multi-head latent attention (``init_mla`` / ``mla_attention``
/ ``init_mla_cache``) against the JAX package's, on the CPU.

Parameters are the reference's (reduced deepseek-v2, ``init_lm`` at
PRNGKey 0) carried over by ``params_from_jax``; inputs come from a seeded
numpy generator.  The full-sequence (expanded) form and the absorbed-weight
decode agree with the reference's to rtol 1e-5 (atol 1e-5 x max|out|),
step by step, with the latent caches (c_kv, k_rope) to 1e-5 and the write
indices exactly; rings (a cache shorter than the sequence, windowed) are
included.  The decode also agrees with the port's own full pass at the
reference's decode tolerance (atol 2e-4, rtol 2e-3), and the MLA caches of
the whole model convert both ways through ``caches_from_jax`` /
``caches_to_jax``.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import apply_lm as ref_apply_lm
from repro.models import init_caches as ref_init_caches
from repro.models import init_lm as ref_init_lm
from repro.models import layers as ref_layers
from repro.models import reduced as ref_reduced
from repro_torch.configs import get_config
from repro_torch.models import (apply_lm, caches_from_jax, caches_to_jax,
                                init_caches, layers, params_from_jax,
                                reduced)

B, S = 2, 10
CPU = dict(device="cpu")


def _cfgs(**kw):
    kw.setdefault("moe_capacity_factor", 8.0)
    return (reduced(get_config("deepseek-v2-236b")).with_(**kw),
            ref_reduced(ref_get_config("deepseek-v2-236b")).with_(**kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    cfg, ref_cfg = _cfgs()
    rp = _np(ref_init_lm(jax.random.PRNGKey(0), ref_cfg))
    return rp, params_from_jax(rp, cfg, **CPU)


def _attn(params):
    rp, p = params
    ref = jax.tree_util.tree_map(lambda x: x[0], rp["groups"]["b0"]["attn"])
    return ref, layers.sub(p, "layers.0.attn")


def _x(cfg, s=S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)


def _close(ours, ref, err=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5 * max(np.abs(ref).max(), 1.0),
                               err_msg=err)


def test_init_mla_names_and_shapes(params):
    cfg, _ = _cfgs()
    p = layers.init_mla(torch.Generator().manual_seed(0), cfg)
    _, ported = _attn(params)
    assert p.keys() == ported.keys()
    for k in p:
        assert p[k].shape == ported[k].shape, k
    nh, dn, dv = cfg.num_heads, cfg.qk_nope_dim, cfg.v_head_dim
    assert p["wkv_b.weight"].shape == (nh * (dn + dv), cfg.kv_lora_rank)


@pytest.mark.parametrize("window", [None, 4])
def test_full_sequence_matches_reference(params, window):
    cfg, ref_cfg = _cfgs()
    ref_p, p = _attn(params)
    x = _x(cfg)
    out = layers.mla_attention(p, torch.from_numpy(x), cfg, window=window)
    ref_out, _ = ref_layers.mla_attention(ref_p, jnp.asarray(x), ref_cfg,
                                          window=window)
    _close(out, ref_out)


def _ref_steps(ref_p, ref_cfg, x, length):
    cache = ref_layers.init_mla_cache(ref_cfg, B, length, jnp.float32)
    step = jax.jit(lambda c, xx, pos: ref_layers.mla_attention(
        ref_p, xx, ref_cfg, positions=pos, cache=c))
    out = []
    for i in range(x.shape[1]):
        o, cache = step(cache, jnp.asarray(x[:, i:i + 1]),
                        jnp.full((B, 1), i, jnp.int32))
        out.append((np.asarray(o), _np(cache)))
    return out


def _steps(p, cfg, x, length):
    cache = layers.init_mla_cache(cfg, B, length, torch.float32, "cpu")
    out = []
    with torch.no_grad():
        for i in range(x.shape[1]):
            o, cache = layers.mla_attention(
                p, torch.from_numpy(x[:, i:i + 1]), cfg,
                positions=torch.full((B, 1), i), cache=cache)
            out.append((o, cache))
    return out


@pytest.mark.parametrize("length", [S, 4], ids=["full-cache", "ring-4"])
def test_absorbed_decode_matches_reference_step_by_step(params, length):
    cfg, ref_cfg = _cfgs()
    ref_p, p = _attn(params)
    x = _x(cfg, seed=1)
    for i, ((o, c), (ro, rc)) in enumerate(zip(
            _steps(p, cfg, x, length), _ref_steps(ref_p, ref_cfg, x, length))):
        _close(o, ro, f"step {i}")
        assert c.keys() == rc.keys() == {"c_kv", "k_rope", "idx"}
        assert c["c_kv"].shape == (B, length, cfg.kv_lora_rank)
        assert c["k_rope"].shape == (B, length, 1, cfg.qk_rope_dim)
        _close(c["c_kv"], rc["c_kv"], f"c_kv step {i}")
        _close(c["k_rope"], rc["k_rope"], f"k_rope step {i}")
        assert c["idx"].dtype == torch.int32
        assert np.array_equal(c["idx"].numpy(), rc["idx"])


@pytest.mark.parametrize("window", [None, 4])
def test_absorbed_decode_matches_own_full_pass(params, window):
    """The latent-space decode (``wkv_b`` folded into the query and output
    sides) == the expanded full pass; with a window the cache is a ring of
    ``window`` slots."""
    cfg, _ = _cfgs()
    _, p = _attn(params)
    x = _x(cfg, seed=2)
    with torch.no_grad():
        full = layers.mla_attention(p, torch.from_numpy(x), cfg,
                                    window=window)
    steps = _steps(p, cfg, x, window or S)
    dec = torch.cat([o for o, _ in steps], dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=2e-4,
                               rtol=2e-3)


def test_cached_step_takes_one_token(params):
    cfg, _ = _cfgs()
    _, p = _attn(params)
    cache = layers.init_mla_cache(cfg, B, S, torch.float32, "cpu")
    with pytest.raises(ValueError, match="one token"):
        layers.mla_attention(p, torch.zeros(B, 2, cfg.d_model), cfg,
                             cache=cache)


def test_model_decode_and_caches_match_reference(params):
    """The whole reduced deepseek-v2 (MLA + MoE) decoded through
    ``apply_lm(caches=)`` against the reference's, caches through
    ``caches_from_jax`` each step, and back through ``caches_to_jax``."""
    cfg, ref_cfg = _cfgs()
    rp, p = params
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    step = jax.jit(lambda c, t, pos, pp: ref_apply_lm(
        pp, ref_cfg, t, caches=c, positions=pos)[:2])
    ref_c = ref_init_caches(ref_cfg, B, S)
    caches = init_caches(cfg, B, S, **CPU)
    assert caches.keys() == caches_from_jax(_np(ref_c), cfg, **CPU).keys()
    with torch.no_grad():
        for i in range(S):
            ref_lg, ref_c = step(ref_c, jnp.asarray(toks[:, i:i + 1]),
                                 jnp.full((B, 1), i, jnp.int32), rp)
            lg, caches, _ = apply_lm(p, cfg, torch.from_numpy(toks[:, i:i + 1]),
                                     caches=caches,
                                     positions=torch.full((B, 1), i))
            _close(lg, ref_lg, f"logits step {i}")
            want = caches_from_jax(_np(ref_c), cfg, **CPU)
            assert want.keys() == caches.keys()
            for key, t in caches.items():
                assert t.dtype == want[key].dtype, key
                if key.endswith(".idx"):
                    assert torch.equal(t, want[key]), key
                else:
                    _close(t, want[key].numpy(), f"{key} step {i}")
    back = caches_to_jax(caches, cfg)
    flat = jax.tree_util.tree_leaves_with_path(back)
    ref_flat = dict(jax.tree_util.tree_leaves_with_path(_np(ref_c)))
    assert {k for k, _ in flat} == set(ref_flat)
    exact = caches_to_jax(caches_from_jax(_np(ref_c), cfg, **CPU), cfg)
    for path, x in jax.tree_util.tree_leaves_with_path(exact):
        assert x.dtype == ref_flat[path].dtype
        assert np.array_equal(x, ref_flat[path]), path
