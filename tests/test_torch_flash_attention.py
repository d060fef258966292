"""The port's flash attention against the reference's Pallas kernels (run in
interpret mode, as the reference's own tests run them on the CPU).

On the CPU the port's wrappers take their plain PyTorch versions; the same
numpy-seeded inputs go through both packages.  Tolerances are the
reference's own: 2e-5 forward (test_kernels.py), atol 5e-4 / rtol 5e-3
backward (test_kernel_ragged.py).  The kernel-vs-plain check on the card is
marked ``cuda`` and skips without one; it needs no JAX, so a machine with
the card and without JAX runs this file with ``-m cuda``.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.kernels.flash_attention import (flash_attention,
                                               flash_attention_bwd)
    from repro.kernels.flash_attention.kernel import _bwd_call, _pad_lanes
    from repro.models import init_lm as ref_init_lm
    from repro.models import layers as ref_layers
    from repro.models import reduced as ref_reduced
except ImportError:  # the card's machine has no JAX: run it with -m cuda
    jnp = None
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.flash_attention import (attention, flash_bwd_dkv,
                                                 flash_bwd_dkv_heads_plain,
                                                 flash_bwd_dkv_plain,
                                                 flash_bwd_dq,
                                                 flash_bwd_dq_plain,
                                                 flash_delta,
                                                 flash_delta_plain,
                                                 flash_fwd, flash_fwd_plain)
from repro_torch.models import layers as L
from repro_torch.models import params_from_jax, reduced

CASES = [
    # (b, s, t, h, hkv, d, causal, window, softcap, num_valid)
    (2, 128, 128, 4, 4, 64, True, None, None, None),    # MHA, rep 1
    (3, 128, 128, 4, 1, 32, True, None, None, 2),       # MQA rep 4, ragged
    (1, 128, 128, 4, 1, 256, True, None, None, None),   # gemma head_dim 256
    (1, 256, 256, 4, 4, 32, True, 64, None, None),      # sliding window
    (2, 128, 128, 4, 1, 64, True, None, 30.0, 1),       # softcap, ragged
    (1, 128, 256, 4, 1, 32, True, None, None, None),    # S < T
    (2, 128, 128, 4, 4, 32, False, None, None, None),   # bidirectional
]
IDS = ["mha", "mqa-ragged", "d256", "window", "softcap-ragged", "s-lt-t",
       "bidirectional"]


def _inputs(case, seed=0):
    b, s, t, h, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d),
                          (b, s, h, d))]


def _opts(case):
    return dict(causal=case[6], window=case[7], softcap=case[8])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_matches_pallas_reference(case):
    q, k, v, _ = _inputs(case)
    nv = case[9]
    out_j, lse_j = flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        num_valid=None if nv is None else jnp.int32(nv), interpret=True,
        return_lse=True, **_opts(case))
    out, lse = flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), nv, **_opts(case))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=2e-5,
                               rtol=2e-5)
    if nv is not None:
        assert (out[nv:] == 0).all() and (lse[nv:] == 0).all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_matches_pallas_backward(case):
    q, k, v, do = _inputs(case, seed=1)
    nv = case[9]
    out_j, lse_j = flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        num_valid=None if nv is None else jnp.int32(nv), interpret=True,
        return_lse=True, **_opts(case))
    grads_j = flash_attention_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do),
        out_j, lse_j, num_valid=None if nv is None else jnp.int32(nv),
        interpret=True, **_opts(case))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attention(qt, kt, vt, num_valid=nv, **_opts(case))
    out.backward(torch.from_numpy(do))
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                                   rtol=5e-3)
    if nv is not None:
        for g in (qt.grad, kt.grad, vt.grad):
            assert (g[nv:] == 0).all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_per_head_dkv_sums_to_the_grouped_and_reference_outputs(case):
    """The decomposition the dk/dv kernel relies on: per-query-head dk/dv
    (``flash_bwd_dkv_heads_plain``), summed over each kv head's group, equal
    ``flash_bwd_dkv_plain``; per head and summed, they equal the reference's
    per-head ``_dkv_kernel`` outputs (``_bwd_call``, interpret mode).  fp32
    in another summation order: 1e-5 of the largest value, and relative."""
    q, k, v, do = _inputs(case, seed=4)
    b, s, t, h, hkv, d = case[:6]
    nv = case[9]
    nvj = None if nv is None else jnp.int32(nv)
    out_j, lse_j = flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_valid=nvj,
        interpret=True, return_lse=True, **_opts(case))
    delta = (np.asarray(out_j) * do).sum(-1).transpose(0, 2, 1)
    _, dk_j, dv_j = _bwd_call(
        *(_pad_lanes(jnp.asarray(x)) for x in (q, k, v, do)), lse_j,
        jnp.asarray(delta), nvj, sm_scale=1.0 / np.sqrt(d),
        block_q=min(128, s), block_k=min(128, t), interpret=True,
        **_opts(case))
    args = [torch.from_numpy(np.array(x, dtype=np.float32))
            for x in (q, k, v, do, np.asarray(lse_j), delta)]
    dk_h, dv_h = flash_bwd_dkv_heads_plain(*args, nv, **_opts(case))
    dk, dv = flash_bwd_dkv_plain(*args, nv, **_opts(case))
    assert dk_h.shape == dv_h.shape == (b, t, h, d)
    for heads, grouped, ref in ((dk_h, dk, dk_j), (dv_h, dv, dv_j)):
        summed = heads.reshape(b, t, hkv, h // hkv, d).sum(3)
        scale = grouped.abs().max().item()
        torch.testing.assert_close(summed, grouped, atol=1e-5 * scale,
                                   rtol=1e-5)
        ref = np.asarray(ref)[..., :d]
        atol = 1e-5 * np.abs(ref).max()
        np.testing.assert_allclose(heads.numpy(), ref, atol=atol, rtol=1e-5)
        np.testing.assert_allclose(
            summed.numpy(), ref.reshape(b, t, hkv, h // hkv, d).sum(3),
            atol=atol, rtol=1e-5)
        if nv is not None:
            assert (heads[nv:] == 0).all()


@pytest.mark.parametrize("case", [CASES[1], CASES[4]], ids=["mqa", "softcap"])
def test_kernel_backward_matches_oracle_backward(case):
    """bwd_impl="oracle" (autograd through attention_ref) is the reference
    the kernel backward is held to, as in the reference package."""
    q, k, v, do = _inputs(case, seed=2)
    grads = {}
    for impl in ("kernel", "oracle"):
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = attention(*xs, num_valid=case[9], bwd_impl=impl, **_opts(case))
        out.backward(torch.from_numpy(do))
        grads[impl] = [x.grad for x in xs]
    for a, b in zip(grads["kernel"], grads["oracle"]):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=5e-3)


def test_use_kernel_false_is_the_masked_reference():
    case = CASES[1]
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(case))
    ref = attention(q, k, v, num_valid=2, use_kernel=False)
    ker = attention(q, k, v, num_valid=2)
    torch.testing.assert_close(ker, ref, atol=2e-5, rtol=2e-5)
    assert (ref[2:] == 0).all()
    with pytest.raises(ValueError, match="bwd_impl"):
        attention(q, k, v, bwd_impl="pallas")


def _bf16_attention_grads(port: bool, x32, p32, do32,
                          dtype: str = "bfloat16"):
    """Reduced gemma's first attention layer in ``dtype`` (bf16 or fp16)
    with ``use_pallas`` (seq 128, so the kernel path is taken; two of three
    rows valid): output and the gradients of x and of wq, wk, wv, as fp32
    numpy."""
    if port:
        dt = getattr(torch, dtype)
        cfg = reduced(get_config("gemma-2b")).with_(
            dtype=dtype, param_dtype=dtype, use_pallas=True)
        params = params_from_jax(p32, cfg, device="cpu")
        p = {k: v.to(dt).requires_grad_()
             for k, v in L.sub(params, "layers.0.attn").items()}
        x = torch.from_numpy(x32).to(dt).requires_grad_()
        out = L.gqa_attention(p, x, cfg, num_valid=2)
        out.backward(torch.from_numpy(do32).to(dt))
        grads = [x.grad] + [p[f"{w}.weight"].grad.T for w in ("wq", "wk",
                                                              "wv")]
        return [t.float().numpy() for t in [out.detach()] + grads]
    dt = getattr(jnp, dtype)
    cfg = ref_reduced(ref_get_config("gemma-2b")).with_(
        dtype=dtype, param_dtype=dtype, use_pallas=True)
    p = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a[0], dt), p32["groups"]["b0"]["attn"])

    def f(x, p):
        return ref_layers.gqa_attention(p, x, cfg,
                                        num_valid=jnp.int32(2))[0]

    out, vjp = jax.vjp(f, jnp.asarray(x32, dt), p)
    gx, gp = vjp(jnp.asarray(do32, dt))
    return [np.asarray(t, np.float32) for t in
            (out, gx, gp["wq"]["w"], gp["wk"]["w"], gp["wv"]["w"])]


def test_bf16_gqa_attention_with_use_pallas_matches_reference():
    """Repair of the dtype fault: bf16 through the flash path, against the
    reference's Pallas kernels (interpret mode) in bf16, on the same
    bf16-rounded inputs.  Both compute attention in fp32 and store in bf16,
    but the projections around it round to bf16 (8 mantissa bits, 3.9e-3
    of a value) in another summation order, and the reference casts each
    query head's dk / dv to bf16 before summing over the group where the
    port sums in fp32 and casts once: 1e-2 of each tensor's largest value.
    Padded rows are exact zeros on both sides."""
    cfg = ref_reduced(ref_get_config("gemma-2b"))
    p32 = jax.tree_util.tree_map(np.asarray,
                                 ref_init_lm(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(5)
    x32 = rng.standard_normal((3, 128, cfg.d_model)).astype(np.float32)
    do32 = rng.standard_normal((3, 128, cfg.d_model)).astype(np.float32)
    got = _bf16_attention_grads(True, x32, p32, do32)
    want = _bf16_attention_grads(False, x32, p32, do32)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max()
    assert (got[0][2:] == 0).all() and (got[1][2:] == 0).all()


def test_fp16_gqa_attention_with_use_pallas_matches_reference():
    """The fp16 twin of the bf16 test above: fp16 through the flash path
    (its plain versions on the CPU, the 16-bit kernels on the card), against
    the reference's Pallas kernels (interpret mode) in fp16 on the same
    fp16-rounded inputs; 1e-2 of each tensor's largest value (fp16 keeps 11
    bits where bf16 keeps 8, so the bf16 test's reasons hold with room),
    padded rows exact zeros on both sides."""
    cfg = ref_reduced(ref_get_config("gemma-2b"))
    p32 = jax.tree_util.tree_map(np.asarray,
                                 ref_init_lm(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(6)
    x32 = rng.standard_normal((3, 128, cfg.d_model)).astype(np.float32)
    do32 = rng.standard_normal((3, 128, cfg.d_model)).astype(np.float32)
    got = _bf16_attention_grads(True, x32, p32, do32, "float16")
    want = _bf16_attention_grads(False, x32, p32, do32, "float16")
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max()
    assert (got[0][2:] == 0).all() and (got[1][2:] == 0).all()


def test_head_dim_above_256_runs_plain_on_the_cpu():
    """D 320: the CPU takes the plain version, which has no head-dim limit
    (the card refuses it, a deliberate difference: ROADMAP queue 3)."""
    case = (1, 128, 128, 2, 1, 320, True, None, None, 1)
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(case, seed=6))
    out, lse = flash_fwd(q, k, v, 1)
    out_j, lse_j = flash_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), num_valid=jnp.int32(1), interpret=True,
        return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=2e-5,
                               rtol=2e-5)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    assert flash_bwd_dq(q, k, v, do, lse, delta, 1).shape == q.shape
    assert flash_bwd_dkv(q, k, v, do, lse, delta, 1)[0].shape == k.shape


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# on the card only: the gemma main path's shape, and ragged shapes whose S
# and T are no multiples of the kernels' 32- and 64-row tiles; head_dim 96
# (phi-3-vision; the emulator's cases of tools/cuda_emu/run_flash.py at their
# shapes, then phi-3's own) and head dims the wrapper zero-pads (80 -> 96,
# 48 -> 64, 200 -> 256)
CUDA_CASES = [
    (2, 1024, 1024, 8, 1, 256, True, None, None, 1),
    (2, 200, 200, 4, 2, 64, True, None, None, 1),
    (1, 77, 150, 4, 1, 128, True, 40, 20.0, None),
    (2, 70, 70, 4, 2, 96, True, None, None, 1),
    (1, 96, 96, 4, 1, 96, True, 20, 30.0, None),
    (1, 37, 70, 2, 2, 96, True, None, None, None),
    (2, 1024, 1024, 8, 8, 96, True, None, None, 1),
    (2, 130, 130, 4, 2, 80, True, None, None, 1),
    (1, 128, 128, 4, 1, 48, True, 64, 30.0, None),
    (2, 96, 96, 2, 1, 200, True, None, None, 1),
]
CUDA_IDS = ["gemma-main", "ragged-200", "ragged-s-lt-t-window-softcap",
            "d96-gqa-ragged", "d96-window-softcap", "d96-mha-s-lt-t",
            "d96-phi3", "d80-padded-ragged", "d48-padded-window-softcap",
            "d200-padded-ragged"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + CUDA_CASES, ids=IDS + CUDA_IDS)
def test_cuda_kernels_match_plain_versions(case, cuda_device):
    q, k, v, do = (torch.from_numpy(x).to(cuda_device)
                   for x in _inputs(case, seed=3))
    nv = case[9]
    nvt = None if nv is None else torch.tensor(nv, dtype=torch.int32,
                                               device=cuda_device)
    kw = _opts(case)
    out, lse = flash_fwd(q, k, v, nvt, **kw)
    out_p, lse_p = flash_fwd_plain(q, k, v, nvt, **kw)
    torch.testing.assert_close(out, out_p, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)
    assert out.shape == q.shape and out.is_contiguous()
    if nv is not None:
        assert (out[nv:] == 0).all() and (lse[nv:] == 0).all()
    delta = (do * out_p).sum(-1).transpose(1, 2).contiguous()
    got = [flash_bwd_dq(q, k, v, do, lse_p, delta, nvt, **kw),
           *flash_bwd_dkv(q, k, v, do, lse_p, delta, nvt, **kw)]
    want = [flash_bwd_dq_plain(q, k, v, do, lse_p, delta, nvt, **kw),
            *flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, nvt, **kw)]
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.is_contiguous()
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()
        if nv is not None:
            assert (a[nv:] == 0).all()
    # the GQA group-sum has a fixed order, and each dq block owns its rows:
    # a second launch of either backward kernel is bit-equal
    again = flash_bwd_dkv(q, k, v, do, lse_p, delta, nvt, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, got[1:]))
    assert torch.equal(flash_bwd_dq(q, k, v, do, lse_p, delta, nvt, **kw),
                       got[0])


# the gemma main path's shapes, in both 16-bit types
HALF_CASES = [(2, 1024, 1024, 8, 1, 256, True, None, None, nv)
              for nv in (1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("case", HALF_CASES, ids=["nv1", "nv2"])
def test_cuda_kernels_take_16_bit_inputs(case, dtype, cuda_device):
    """16-bit q, k, v and dO go to the 16-bit kernels as they are, which
    hand back out, dq, dk and dv in the inputs' dtype (lse f32), as the
    plain versions do: within 1e-2 of each tensor's largest value (16-bit
    outputs, and the kernels round P and dS to 16 bits before their
    products), padded rows exact zeros."""
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x).to(cuda_device, dt)
                   for x in _inputs(case, seed=7))
    nv = torch.tensor(case[9], dtype=torch.int32, device=cuda_device)
    out, lse = flash_fwd(q, k, v, nv)
    out_p, lse_p = flash_fwd_plain(q, k, v, nv)
    delta = (do.float() * out_p.float()).sum(-1).transpose(1, 2).contiguous()
    got = [out, lse, flash_bwd_dq(q, k, v, do, lse_p, delta, nv),
           *flash_bwd_dkv(q, k, v, do, lse_p, delta, nv)]
    want = [out_p, lse_p, flash_bwd_dq_plain(q, k, v, do, lse_p, delta, nv),
            *flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, nv)]
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype == (torch.float32 if i == 1 else dt)
        assert a.shape == b.shape and a.is_contiguous()
        assert (a.float() - b.float()).abs().max() <= \
            1e-2 * b.float().abs().max()
        assert (a[case[9]:] == 0).all()


# the CUDA_CASES shapes, llama3-8b's (phase 14(b)'s step), grok-1's heads
# with its softcap 30, and the hybrid's local blocks (D 256, H 16, Hkv 1)
# with a window that bites, 16-bit; then the forward's tile configurations
# (128 query rows a block; 128-key tiles up to D 128, 64 at D 256) at 3 or
# more key tiles: D 32 and 64, a softcap with a window, S < T at D 128 and
# 256, ragged num_valid over several q tiles, and whole (unmasked) tiles
# without causality
HALF_CUDA_CASES = CASES + CUDA_CASES + [
    (2, 2048, 2048, 32, 8, 128, True, None, None, None),
    (2, 1024, 1024, 48, 8, 128, True, None, 30.0, 1),
    (2, 2048, 2048, 16, 1, 256, True, 1024, None, 1),
    (2, 640, 640, 4, 1, 32, True, None, None, 1),
    (1, 512, 512, 8, 2, 64, True, None, None, None),
    (1, 512, 512, 8, 2, 128, True, 200, 30.0, None),
    (1, 300, 700, 4, 1, 128, True, None, None, None),
    (1, 200, 520, 4, 2, 256, True, None, None, None),
    (3, 400, 400, 8, 2, 128, True, None, None, 2),
    (1, 384, 384, 4, 2, 128, False, None, None, None)]
HALF_CUDA_IDS = IDS + CUDA_IDS + [
    "llama3-8b", "grok-softcap", "hybrid-window", "d32-ragged-5-tiles",
    "d64-gqa-4-tiles", "d128-window-softcap-4-tiles", "d128-s-lt-t",
    "d256-s-lt-t", "d128-ragged-4-q-tiles", "d128-bidirectional-3-tiles"]


def _peak_new_bytes(fn):
    """fn()'s result and the bytes it allocated on the card at its peak."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("case", HALF_CUDA_CASES, ids=HALF_CUDA_IDS)
def test_cuda_16_bit_kernels_match_plain_versions(case, dtype, cuda_device):
    """The 16-bit entries (wgmma + TMA forward and backward, the delta
    kernel) against the plain versions on the same 16-bit inputs:
    within 1e-2 of each tensor's largest value (16-bit outputs; P and dS
    rounded to 16 bits before their products, ROADMAP queue 3), each row of
    out, dq, dk and dv within ``row_error``'s limit (a few units in the
    last place of the row's own largest value), lse within ``LSE_TOL`` of
    its largest and delta within 1e-5 (fp32 sums of exact products).
    Padded rows are exact zeros; a second forward, dq and dk/dv launch is
    bit-equal;
    every call launched its 16-bit entry alone (``LAUNCHES_16`` moved with
    ``LAUNCHES``) and allocated no more than its outputs, its scratch (for
    dk/dv the fp32 partials of the splits ``dkv16_splits`` cuts each GQA
    group into, none where a group runs in one block) and the zero-padded
    copies of a head dim that is not built, plus 1 MiB, so no fp32 copy of
    an input was made."""
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x).to(cuda_device, dt)
                   for x in _inputs(case, seed=8))
    b, s, t, h, hkv, d, nv = *case[:6], case[9]
    nvt = None if nv is None else torch.tensor(nv, dtype=torch.int32,
                                               device=cuda_device)
    kw = _opts(case)
    dp = next(x for x in (32, 64, 96, 128, 256) if x >= d)
    qs, ks = b * s * h, b * t * hkv  # rows of q (and dO), of k (and v)
    out_p, lse_p = flash_fwd_plain(q, k, v, nvt, **kw)
    delta = flash_delta_plain(do, out_p)
    FA.reset_launches()
    (out, lse), new_fwd = _peak_new_bytes(
        lambda: flash_fwd(q, k, v, nvt, **kw))
    dq, new_dq = _peak_new_bytes(
        lambda: flash_bwd_dq(q, k, v, do, lse_p, delta, nvt, **kw))
    (dk, dv), new_dkv = _peak_new_bytes(
        lambda: flash_bwd_dkv(q, k, v, do, lse_p, delta, nvt, **kw))
    got_delta = flash_delta(do, out)
    assert {k_: v_ for k_, v_ in FA.LAUNCHES.items() if v_} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    assert {k_: v_ for k_, v_ in FA.LAUNCHES_16.items() if v_} == {
        "flash_fwd_16": 1, "flash_bwd_dq_16": 1, "flash_bwd_dkv_16": 1,
        "flash_delta_16": 1}
    # 2 bytes an element: the outputs, then (d not built) the padded copies
    # of the inputs and the padded outputs that are sliced back
    padded = 0 if dp == d else 2 * dp
    splits = FA.dkv16_splits(b, t, h, hkv, dp)
    scratch = 2 * b * t * hkv * splits * dp * 4 if splits > 1 else 0
    slack = 1 << 20
    assert new_fwd <= (2 * qs * d + b * h * s * 4
                       + padded * (qs + 2 * ks + qs) + slack)
    assert new_dq <= 2 * qs * d + padded * (2 * qs + 2 * ks + qs) + slack
    assert new_dkv <= (2 * 2 * ks * d + scratch
                       + padded * (2 * qs + 2 * ks + 2 * ks) + slack)
    want = [out_p, lse_p,
            flash_bwd_dq_plain(q, k, v, do, lse_p, delta, nvt, **kw),
            *flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, nvt, **kw)]
    for i, (a, w) in enumerate(zip([out, lse, dq, dk, dv], want)):
        assert a.dtype == w.dtype == (torch.float32 if i == 1 else dt)
        assert a.shape == w.shape and a.is_contiguous()
        assert (a.float() - w.float()).abs().max() <= \
            1e-2 * w.float().abs().max()
        if i == 1:
            assert (a - w).abs().max() <= FA.LSE_TOL * w.abs().max()
        else:
            assert FA.row_error(a, w) <= 1
        if nv is not None:
            assert (a[nv:] == 0).all()
    ref_delta = flash_delta_plain(do, out)
    assert (got_delta - ref_delta).abs().max() <= \
        1e-5 * ref_delta.abs().max()
    again = flash_fwd(q, k, v, nvt, **kw)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    again = flash_bwd_dkv(q, k, v, do, lse_p, delta, nvt, **kw)
    assert all(torch.equal(a, w) for a, w in zip(again, (dk, dv)))
    assert torch.equal(flash_bwd_dq(q, k, v, do, lse_p, delta, nvt, **kw),
                       dq)


@pytest.mark.cuda
def test_cuda_mixed_dtypes_raise(cuda_device):
    """q, k, v (and dO) must share one dtype: the wrappers no longer cast,
    so a mix raises instead of taking either entry."""
    q = torch.zeros((1, 64, 2, 64), device=cuda_device, dtype=torch.bfloat16)
    k = torch.zeros((1, 64, 1, 64), device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 64), device=cuda_device)
    with pytest.raises(TypeError, match="one dtype"):
        flash_fwd(q, k.float(), k)
    with pytest.raises(TypeError, match="one dtype"):
        flash_fwd(q.half(), k, k)
    with pytest.raises(TypeError, match="one dtype"):
        flash_bwd_dq(q, k, k, q.float(), lse, lse)
    with pytest.raises(TypeError, match="one dtype"):
        flash_bwd_dkv(q, k, k, q.half(), lse, lse)
    with pytest.raises(TypeError, match="16-bit"):
        flash_delta(q, q.float())


@pytest.mark.cuda
def test_cuda_head_dim_above_256_raises(cuda_device):
    """The kernels are built up to head_dim 256; 320 is refused, a
    deliberate difference from the reference (ROADMAP queue 3)."""
    q = torch.zeros((1, 128, 2, 320), device=cuda_device)
    k = torch.zeros((1, 128, 1, 320), device=cuda_device)
    with pytest.raises(ValueError, match="deliberate difference, ROADMAP "
                                         "queue 3"):
        flash_fwd(q, k, k)
