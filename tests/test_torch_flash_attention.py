"""The port's flash attention against the reference's Pallas kernels (run in
interpret mode, as the reference's own tests run them on the CPU).

On the CPU the port's wrappers take their plain PyTorch versions; the same
numpy-seeded inputs go through both packages.  Tolerances are the
reference's own: 2e-5 forward (test_kernels.py), atol 5e-4 / rtol 5e-3
backward (test_kernel_ragged.py).  The kernel-vs-plain check on the card is
marked ``cuda`` and skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention, flash_attention_bwd
from repro_torch.kernels.flash_attention import (attention, flash_bwd_dkv,
                                                 flash_bwd_dkv_plain,
                                                 flash_bwd_dq,
                                                 flash_bwd_dq_plain,
                                                 flash_fwd, flash_fwd_plain)

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
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
    delta = (do * out_p).sum(-1).transpose(1, 2).contiguous()
    got = [flash_bwd_dq(q, k, v, do, lse_p, delta, nvt, **kw),
           *flash_bwd_dkv(q, k, v, do, lse_p, delta, nvt, **kw)]
    want = [flash_bwd_dq_plain(q, k, v, do, lse_p, delta, nvt, **kw),
            *flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, nvt, **kw)]
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()
        if nv is not None:
            assert (a[nv:] == 0).all()
