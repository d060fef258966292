"""The port's KV-cache decode (the cache branches of ``gqa_attention``,
``ssd_block`` and ``recurrent_block``, ``init_caches`` and
``apply_lm(caches=)``) against its own full pass and against the JAX
package's decode, on the CPU.

Inputs are shared: the reference's parameters (``init_lm``, PRNGKey 0)
carried over by ``params_from_jax``, token ids from a seeded numpy
generator.  Decode against the full pass uses the reference's own
tolerance (``tests/test_models.py``: atol 2e-4, rtol 2e-3).  Step by step
against the reference's ``apply_lm(caches=)`` the logits agree to rtol
1e-5 with atol 1e-5 x max|logits| (the logits reach ~140, and the full
forward of the reduced mamba2 already differs by up to 3e-5 absolute from
the reference's, another summation order), the caches to rtol and atol
1e-5, and the write indices exactly.  Each reference decode runs once per
configuration (module-scoped).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import apply_lm as ref_apply_lm
from repro.models import init_caches as ref_init_caches
from repro.models import init_lm as ref_init_lm
from repro.models import reduced as ref_reduced
from repro_torch.configs import get_config
from repro_torch.models import (apply_lm, caches_from_jax, caches_to_jax,
                                init_caches, params_from_jax, reduced,
                                recurrent_block, ssd_block)
from repro_torch.models.layers import gqa_attention, init_attn_cache, sub

ARCHS = ["gemma-2b", "mamba2-1.3b", "recurrentgemma-9b"]
# (arch, window): the sliding-window variants decode through ring caches
CONFIGS = {
    "gemma-2b": ("gemma-2b", None),
    "mamba2-1.3b": ("mamba2-1.3b", None),
    "recurrentgemma-9b": ("recurrentgemma-9b", None),
    "gemma-2b-window4": ("gemma-2b", 4),
    "recurrentgemma-9b-window4": ("recurrentgemma-9b", 4),
}
B, S = 2, 10
CPU = dict(device="cpu")


def _cfgs(arch, window=None):
    ref_cfg, cfg = ref_reduced(ref_get_config(arch)), reduced(get_config(arch))
    if window is not None:
        kw = dict(window=window)
        if cfg.family == "hybrid":
            kw["local_window"] = window
        ref_cfg, cfg = ref_cfg.with_(**kw), cfg.with_(**kw)
    return ref_cfg, cfg


def _tokens(cfg, b=B, s=S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(name, ref cfg, port cfg, ref params, port params, tokens, the
    reference's decode: logits and caches after every step)."""
    arch, window = CONFIGS[request.param]
    ref_cfg, cfg = _cfgs(arch, window)
    rp = ref_init_lm(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_jax(_np(rp), cfg, **CPU)
    toks = _tokens(cfg)
    step = jax.jit(lambda p, t, c, pos: ref_apply_lm(
        p, ref_cfg, t, caches=c, positions=pos)[:2])
    caches, steps = ref_init_caches(ref_cfg, B, S), []
    for i in range(S):
        lg, caches = step(rp, jnp.asarray(toks[:, i:i + 1]), caches,
                          jnp.full((B, 1), i, jnp.int32))
        steps.append((np.asarray(lg), _np(caches)))
    return request.param, ref_cfg, cfg, rp, params, toks, steps


def _decode(params, cfg, toks, cache_len=S):
    caches, out = init_caches(cfg, toks.shape[0], cache_len, **CPU), []
    with torch.no_grad():
        for i in range(toks.shape[1]):
            lg, caches, _ = apply_lm(
                params, cfg, torch.from_numpy(toks[:, i:i + 1]),
                caches=caches,
                positions=torch.full((toks.shape[0], 1), i))
            out.append((lg, caches))
    return out


# ------------------------------------------------ decode against full pass


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_pass(arch):
    """``tests/test_models.py::test_decode_matches_prefill`` on the port."""
    _, cfg = _cfgs(arch)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import init_lm

    params = init_lm(gen, cfg)
    toks = _tokens(cfg, seed=1)
    with torch.no_grad():
        full, _ = apply_lm(params, cfg, torch.from_numpy(toks))
    dec = torch.cat([lg for lg, _ in _decode(params, cfg, toks)], dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=2e-4,
                               rtol=2e-3)


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-9b"])
def test_sliding_window_decode(arch):
    """Windowed attention decode through a ring cache (4 slots for 12
    tokens) == the windowed full pass (``tests/test_models.py``)."""
    _, cfg = _cfgs(arch, window=4)
    from repro_torch.models import init_lm

    params = init_lm(torch.Generator().manual_seed(0), cfg)
    toks = _tokens(cfg, b=1, s=12, seed=2)
    with torch.no_grad():
        full, _ = apply_lm(params, cfg, torch.from_numpy(toks))
    steps = _decode(params, cfg, toks, cache_len=12)
    attn = [k for k in steps[0][1] if k.endswith(".k")]
    assert attn and all(steps[0][1][k].shape[1] == 4 for k in attn)
    dec = torch.cat([lg for lg, _ in steps], dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=2e-4,
                               rtol=2e-3)


# -------------------------------------------- step by step against the JAX


def test_teacher_forced_decode_matches_reference(pair):
    name, ref_cfg, cfg, _, params, toks, steps = pair
    ours = _decode(params, cfg, toks)
    for i, ((lg, caches), (ref_lg, ref_caches)) in enumerate(
            zip(ours, steps)):
        np.testing.assert_allclose(
            lg.numpy(), ref_lg, rtol=1e-5,
            atol=1e-5 * np.abs(ref_lg).max(), err_msg=f"{name} step {i}")
        want = caches_from_jax(ref_caches, cfg, **CPU)
        assert want.keys() == caches.keys()
        for key, x in caches.items():
            assert x.dtype == want[key].dtype, key
            if key.endswith(".idx"):
                assert torch.equal(x, want[key]), (key, i)
            else:
                np.testing.assert_allclose(
                    x.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-5,
                    err_msg=f"{name} step {i} {key}")


def test_init_caches_match_reference(pair):
    """Fresh caches: the same leaves, shapes, dtypes and zeros, the ring
    lengths of windowed blocks included."""
    _, ref_cfg, cfg, *_ = pair
    want = caches_from_jax(_np(ref_init_caches(ref_cfg, 3, 7)), cfg, **CPU)
    got = init_caches(cfg, 3, 7, **CPU)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == want[key].dtype, key
        assert not got[key].any(), key


def test_caches_round_trip_exactly(pair):
    name, _, cfg, _, _, _, steps = pair
    ref = steps[-1][1]
    port = caches_from_jax(ref, cfg, **CPU)
    back = caches_to_jax(port, cfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, ref)
    again = caches_from_jax(back, cfg, **CPU)
    assert all(torch.equal(again[k], port[k]) for k in port), name


def test_decode_leaves_the_given_caches_alone(pair):
    """A decode step returns new tensors; the dict it read still holds the
    old state (what warm-up snapshots rely on)."""
    _, _, cfg, _, params, toks, _ = pair
    caches = _decode(params, cfg, toks[:, :3])[-1][1]
    before = {k: v.clone() for k, v in caches.items()}
    with torch.no_grad():
        _, new, _ = apply_lm(params, cfg, torch.from_numpy(toks[:, 3:4]),
                             caches=caches, positions=torch.full((B, 1), 3))
    assert all(torch.equal(caches[k], before[k]) for k in caches)
    assert all(new[k].data_ptr() != caches[k].data_ptr() for k in caches)


def test_decode_ignores_the_kernel_switch():
    """Decode never reaches a kernel: with ``use_pallas`` the one-token
    steps equal the plain ones bit for bit (the RG-LRU step is its
    recurrence, the SSD step its update, attention the plain scores)."""
    for arch in ARCHS:
        _, cfg = _cfgs(arch)
        from repro_torch.models import init_lm

        params = init_lm(torch.Generator().manual_seed(3), cfg)
        toks = _tokens(cfg, s=4, seed=3)
        plain = _decode(params, cfg, toks)
        kern = _decode(params, cfg.with_(use_pallas=True), toks)
        for (a, _), (b, _) in zip(plain, kern):
            assert torch.equal(a, b), arch


# ------------------------------------------------------------ block level


def test_more_than_one_token_with_a_cache_raises():
    _, cfg = _cfgs("gemma-2b")
    from repro_torch.models import init_lm

    params = init_lm(torch.Generator().manual_seed(0), cfg)
    attn = sub(params, "layers.0.attn")
    x = torch.zeros(2, 3, cfg.d_model)
    cache = init_attn_cache(cfg, 2, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="one token"):
        gqa_attention(attn, x, cfg, cache=cache)
    with pytest.raises(ValueError, match="one token"):
        apply_lm(params, cfg, torch.zeros(2, 3, dtype=torch.int64),
                 caches=init_caches(cfg, 2, 8, **CPU))
    _, mcfg = _cfgs("mamba2-1.3b")
    mparams = sub(init_lm(torch.Generator().manual_seed(0), mcfg),
                  "layers.0.ssd")
    with pytest.raises(ValueError, match="one token"):
        ssd_block(mparams, torch.zeros(1, 2, mcfg.d_model), mcfg,
                  cache=sub(init_caches(mcfg, 1, 4, **CPU), "layers.0"))


def test_rows_decode_at_their_own_offsets():
    """Per-row write indices: a row whose cache is two tokens ahead gives
    the logits its own solo decode gives (continuous batching)."""
    _, cfg = _cfgs("gemma-2b")
    from repro_torch.models import init_lm

    params = init_lm(torch.Generator().manual_seed(4), cfg)
    toks = _tokens(cfg, b=1, s=5, seed=4)
    solo = _decode(params, cfg, toks)
    late = _decode(params, cfg, toks[:, :3])
    # row 0 has decoded 5 tokens, row 1 only 3: stack their caches
    caches = {k: torch.cat([solo[3][1][k], late[2][1][k]])
              for k in solo[3][1]}
    tok = torch.from_numpy(np.concatenate([toks[:, 4:5], toks[:, 3:4]]))
    with torch.no_grad():
        lg, _, _ = apply_lm(params, cfg, tok, caches=caches,
                            positions=torch.tensor([[4], [3]]))
    solo4 = solo[4][0]
    solo3 = _decode(params, cfg, toks[:, :4])[3][0]
    np.testing.assert_allclose(lg[0:1].numpy(), solo4.numpy(), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(lg[1:2].numpy(), solo3.numpy(), rtol=1e-6,
                               atol=1e-5)


def test_recurrent_block_cache_over_a_sequence():
    """The RG-LRU block with a cache over several tokens at once carries
    its state like a token-by-token run (the reference's branch takes any
    length there)."""
    _, cfg = _cfgs("recurrentgemma-9b")
    from repro_torch.models import init_lm

    rec = sub(init_lm(torch.Generator().manual_seed(5), cfg), "layers.0.rec")
    x = torch.randn(2, 6, cfg.d_model, generator=torch.Generator()
                    .manual_seed(6))
    cache = sub(init_caches(cfg, 2, 6, **CPU), "layers.0")
    with torch.no_grad():
        whole, c_whole = recurrent_block(rec, x, cfg, cache)
        outs, c = [], cache
        for i in range(6):
            o, c = recurrent_block(rec, x[:, i:i + 1], cfg, c)
            outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(),
                               rtol=1e-5, atol=1e-5)
    for key in c:
        np.testing.assert_allclose(c[key].numpy(), c_whole[key].numpy(),
                                   rtol=1e-5, atol=1e-5)
