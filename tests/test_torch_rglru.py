"""The port's RG-LRU scan against the reference's (its Pallas kernel in
interpret mode, as the reference's own tests run it on the CPU, and its
plain associative scan).

On the CPU the port's wrappers take their plain PyTorch versions, inside
the same ``autograd.Function`` that runs the CUDA kernel pair on the card;
the same numpy-seeded inputs go through both packages.  Forward tolerance:
the reference's own for RG-LRU, 1e-5 abs and rel (``tests/test_kernels.py``).
Gradients are held to 1e-5 x max|g| against ``jax.grad`` of the reference's
``rglru_scan``, the function it trains with (its kernel path has no VJP):
fp32, another summation order over at most 128 steps.  The kernel-vs-plain
check on the card lives in ``test_torch_rglru_cuda.py``, which imports no
JAX.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import rglru_linear_scan as ref_linear_scan
from repro.kernels.rglru_scan import rglru_scan as ref_rglru_scan
from repro_torch.kernels.rglru_scan import (LAUNCHES, rglru,
                                            rglru_linear_scan,
                                            rglru_linear_scan_bwd,
                                            rglru_linear_scan_bwd_plain,
                                            rglru_linear_scan_plain,
                                            rglru_scan)

TOL = 1e-5
GRAD_TOL = 1e-5
# (b, l, w): tests/test_kernels.py::RGLRU_CASES
RGLRU_CASES = [(2, 32, 128), (1, 64, 256), (3, 16, 128), (1, 128, 512)]
IDS = ["b2-l32", "b1-l64", "b3-l16", "b1-l128"]


def _inputs(case, seed=0):
    """a in (0, 1) as sigmoid of a normal (the reference tests' gates),
    bx, h0 and the cotangents dh, dhT standard normal."""
    b, l, w = case
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, l, w))))
    arrays = (a, rng.standard_normal((b, l, w)), rng.standard_normal((b, w)),
              rng.standard_normal((b, l, w)), rng.standard_normal((b, w)))
    return [x.astype(np.float32) for x in arrays]


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("case", RGLRU_CASES, ids=IDS)
def test_forward_matches_pallas_reference_and_scan(case, with_h0):
    a, bx, h0, _, _ = _inputs(case)
    h0 = h0 if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    h_k, hT_k = ref_linear_scan(jnp.asarray(a), jnp.asarray(bx), jh0,
                                interpret=True)
    h_s = ref_rglru_scan(jnp.asarray(a), jnp.asarray(bx), initial=jh0)
    ours = {"plain": rglru_linear_scan_plain(_t(a), _t(bx), _t(h0)),
            "wrapper": rglru_linear_scan(_t(a), _t(bx), _t(h0)),
            "ops": rglru(_t(a), _t(bx), _t(h0))}
    for name, (h, h_t) in ours.items():
        for label, want in (("pallas", h_k), ("scan", h_s)):
            np.testing.assert_allclose(h.numpy(), np.asarray(want), atol=TOL,
                                       rtol=TOL, err_msg=f"{name} vs {label}")
        np.testing.assert_allclose(h_t.numpy(), np.asarray(hT_k), atol=TOL,
                                   rtol=TOL, err_msg=f"{name} hT")
        np.testing.assert_array_equal(h_t.numpy(), h[:, -1].numpy())
    np.testing.assert_allclose(rglru_scan(_t(a), _t(bx), _t(h0)).numpy(),
                               np.asarray(h_s), atol=TOL, rtol=TOL)


def _ref_vjp(a, bx, h0, dh, dh_t):
    """jax.grad of the reference's plain scan for the loss
    sum(h * dh) + sum(h[:, -1] * dhT)."""

    def loss(aa, bb, hh):
        h = ref_rglru_scan(aa, bb, initial=hh)
        return jnp.sum(h * dh) + jnp.sum(h[:, -1] * dh_t)

    args = [jnp.asarray(x) for x in (a, bx, h0) if x is not None]
    if h0 is None:
        return [*jax.jit(jax.grad(lambda aa, bb: loss(aa, bb, None),
                                  argnums=(0, 1)))(*args), None]
    return list(jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args))


def _close_to_max(got, want, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= GRAD_TOL * np.abs(want).max(), (what, err,
                                                  np.abs(want).max())


@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("case", RGLRU_CASES, ids=IDS)
def test_plain_vjp_matches_jax_grad_and_autograd(case, with_h0):
    a, bx, h0, dh, dh_t = _inputs(case, seed=1)
    h0 = h0 if with_h0 else None
    want_jax = _ref_vjp(a, bx, h0, dh, dh_t)
    leaves = [_t(x).requires_grad_() for x in (a, bx, h0) if x is not None]
    h = rglru_scan(*leaves[:2], initial=leaves[2] if with_h0 else None)
    want_torch = torch.autograd.grad(
        (h * _t(dh)).sum() + (h[:, -1] * _t(dh_t)).sum(), leaves)
    h_plain, _ = rglru_linear_scan_plain(_t(a), _t(bx), _t(h0))
    got = rglru_linear_scan_bwd_plain(_t(a), h_plain, _t(h0), _t(dh),
                                      _t(dh_t))
    assert (got[2] is None) == (h0 is None)
    for i, name in enumerate(("da", "dbx", "dh0")[:len(leaves)]):
        _close_to_max(got[i].numpy(), want_jax[i], f"{name} vs jax.grad")
        _close_to_max(got[i].numpy(), want_torch[i].numpy(),
                      f"{name} vs autograd")
    # the CPU wrapper is the plain backward, and so is ops.rglru's backward
    wrapped = rglru_linear_scan_bwd(_t(a), h_plain, _t(h0), _t(dh), _t(dh_t))
    leaves = [_t(x).requires_grad_() for x in (a, bx, h0) if x is not None]
    h, h_t = rglru(*leaves[:2], leaves[2] if with_h0 else None)
    through_ops = torch.autograd.grad(
        (h * _t(dh)).sum() + (h_t * _t(dh_t)).sum(), leaves)
    for i in range(len(leaves)):
        assert torch.equal(wrapped[i], got[i])
        assert torch.equal(through_ops[i], got[i])


def test_plain_versions_match_the_scan_in_float64():
    """In float64 the sequential plain versions and the doubling scan agree
    to rounding: both are exact algebra of the same recurrence."""
    a, bx, h0, dh, dh_t = (x.astype(np.float64) for x in
                           _inputs(RGLRU_CASES[3], seed=2))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (a, bx, h0)]
    h = rglru_scan(*leaves[:2], initial=leaves[2])
    want = torch.autograd.grad((h * torch.from_numpy(dh)).sum()
                               + (h[:, -1] * torch.from_numpy(dh_t)).sum(),
                               leaves)
    h_p, h_t = rglru_linear_scan_plain(*(torch.from_numpy(x)
                                         for x in (a, bx, h0)))
    assert h_p.dtype == torch.float64
    torch.testing.assert_close(h_p, h.detach(), atol=1e-12, rtol=1e-12)
    got = rglru_linear_scan_bwd_plain(
        torch.from_numpy(a), h_p, torch.from_numpy(h0), torch.from_numpy(dh),
        torch.from_numpy(dh_t))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-12, rtol=1e-12)


def test_cpu_tensors_make_no_launch():
    a, bx, h0, dh, dh_t = (_t(x) for x in _inputs(RGLRU_CASES[2]))
    before = dict(LAUNCHES)
    a.requires_grad_()
    h, h_t = rglru(a, bx, h0)
    (h.sum() + h_t.sum()).backward()
    rglru_linear_scan(a.detach(), bx)
    rglru_linear_scan_bwd(a.detach(), h.detach(), None, dh, dh_t)
    assert a.grad is not None and LAUNCHES == before


def test_shape_rule_raises_on_cpu():
    a = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="one shape"):
        rglru_linear_scan(a, torch.zeros(2, 8, 8))
    with pytest.raises(ValueError, match="h0 must be"):
        rglru_linear_scan(a, a, torch.zeros(2, 8))
    with pytest.raises(ValueError, match="non-empty"):
        rglru_linear_scan(torch.zeros(2, 0, 16), torch.zeros(2, 0, 16))
    with pytest.raises(ValueError, match="dhT must be"):
        rglru_linear_scan_bwd(a, a, None, a, torch.zeros(2, 8))
    with pytest.raises(ValueError, match="dh "):
        rglru_linear_scan_bwd(a, a, None, torch.zeros(2, 4, 16),
                              torch.zeros(2, 16))
