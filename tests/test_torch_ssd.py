"""The port's SSD scan against the reference's (its Pallas kernel in
interpret mode, as the reference's own tests run it on the CPU, and its
plain chunked scan).

On the CPU the port's wrappers take their plain PyTorch versions, inside
the same ``autograd.Function`` that runs the CUDA kernel pair on the card;
the same numpy-seeded inputs go through both packages.  Tolerances are the
reference's own for SSD (5e-4 abs and rel, ``tests/test_kernels.py``);
gradients are held to 5e-4 x max|g| against ``jax.grad`` of
``ssd_chunked``, the function the reference trains with (its kernel path
has no VJP).  The kernel-vs-plain check on the card lives in
``test_torch_ssd_cuda.py``, which imports no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd as ref_ssd
from repro.kernels.ssd_scan import ssd_chunked as ref_ssd_chunked
from repro_torch.kernels.ssd_scan import (LAUNCHES, ssd, ssd_chunked,
                                          ssd_intra_chunk,
                                          ssd_intra_chunk_bwd,
                                          ssd_intra_chunk_bwd_plain,
                                          ssd_intra_chunk_plain)

TOL = 5e-4
# (b, l, h, p, n, chunk): tests/test_kernels.py::SSD_CASES
SSD_CASES = [
    (2, 64, 4, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (2, 256, 8, 64, 32, 64),
    (1, 128, 64, 64, 128, 64),   # mamba2-1.3b head geometry
]
IDS = ["small", "mid", "wide", "mamba2"]


def _inputs(case, seed=0, decay=0.1):
    b, l, h, p, n, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((b, l, h))) * decay).astype(np.float32)
    bm = rng.standard_normal((b, l, h, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, h, n)).astype(np.float32)
    return x, a, bm, cm


def _chunked(arrays, chunk):
    """(B,L,...) numpy inputs -> the intra-chunk kernel's (B,nc,cl,...)."""
    x, a, bm, cm = (torch.from_numpy(v) for v in arrays)
    b, l, h, p = x.shape
    nc = l // chunk
    return (x.reshape(b, nc, chunk, h, p), a.reshape(b, nc, chunk, h),
            bm.reshape(b, nc, chunk, h, -1), cm.reshape(b, nc, chunk, h, -1))


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("case", SSD_CASES, ids=IDS)
def test_ssd_matches_pallas_reference_and_chunked(case):
    chunk = case[-1]
    arrays = _inputs(case)
    y_k, s_k = ref_ssd(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)
    y_c, s_c = ref_ssd_chunked(*map(jnp.asarray, arrays), chunk)
    y, s = ssd(*map(torch.from_numpy, arrays), chunk=chunk)
    y_p, s_p = ssd_chunked(*map(torch.from_numpy, arrays), chunk)
    for name, got, want in (("y vs pallas", y, y_k), ("state vs pallas", s, s_k),
                            ("y vs chunked", y, y_c),
                            ("state vs chunked", s, s_c),
                            ("plain y", y_p, y_c), ("plain state", s_p, s_c)):
        _close(got.numpy(), want, what=name)


def test_ssd_initial_state_carry():
    """Chunked scan with a carried initial state == one long scan, in the
    port and against the reference's carry."""
    case = (1, 64, 2, 8, 4, 16)
    chunk = case[-1]
    x, a, bm, cm = (torch.from_numpy(v) for v in _inputs(case, seed=1))
    y_full, s_full = ssd(x, a, bm, cm, chunk=chunk)
    half = x.shape[1] // 2
    y1, s1 = ssd(x[:, :half], a[:, :half], bm[:, :half], cm[:, :half],
                 chunk=chunk)
    y2, s2 = ssd(x[:, half:], a[:, half:], bm[:, half:], cm[:, half:],
                 chunk=chunk, initial_state=s1)
    _close(torch.cat([y1, y2], 1).numpy(), y_full.numpy())
    _close(s2.numpy(), s_full.numpy())
    ref_y2, ref_s2 = ref_ssd(*(jnp.asarray(v[:, half:].numpy())
                               for v in (x, a, bm, cm)), chunk=chunk,
                             initial_state=jnp.asarray(s1.numpy()),
                             interpret=True)
    _close(y2.numpy(), ref_y2)
    _close(s2.numpy(), ref_s2)


@pytest.mark.parametrize("case", SSD_CASES, ids=IDS)
def test_ssd_grads_match_jax_grad_of_ssd_chunked(case):
    b, l, h, p, n, chunk = case
    arrays = _inputs(case, seed=2)
    rng = np.random.default_rng(3)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    gy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    gs = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def ref_loss(x, a, bm, cm, s0_):
        y, s = ref_ssd_chunked(x, a, bm, cm, chunk, initial_state=s0_)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, arrays), jnp.asarray(s0))
    leaves = [torch.from_numpy(v).requires_grad_() for v in (*arrays, s0)]
    y, s = ssd(*leaves[:4], chunk=chunk, initial_state=leaves[4])
    loss = (y * torch.from_numpy(gy)).sum() + (s * torch.from_numpy(gs)).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(("x", "a_log", "b", "c", "initial_state"), got,
                          want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        assert err <= TOL * np.abs(w).max(), (name, err, np.abs(w).max())


@pytest.mark.parametrize("case", SSD_CASES, ids=IDS)
def test_intra_chunk_bwd_plain_matches_autograd(case):
    chunk = case[-1]
    leaves = [t.clone().requires_grad_() for t in
              _chunked(_inputs(case, seed=4, decay=0.5), chunk)]
    y, s = ssd_intra_chunk_plain(*leaves)
    rng = np.random.default_rng(5)
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    ds = torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32))
    want = torch.autograd.grad((y, s), leaves, (dy, ds))
    got = ssd_intra_chunk_bwd_plain(*(t.detach() for t in leaves), dy, ds)
    for name, g, w in zip(("dx", "da", "db", "dc"), got, want):
        assert g.shape == w.shape, name
        err = (g - w).abs().max().item()
        assert err <= 1e-5 * w.abs().max().item(), (name, err)


def test_kernel_and_oracle_backward_agree():
    case = SSD_CASES[1]
    arrays = _inputs(case, seed=6)
    grads = {}
    for impl in ("kernel", "oracle"):
        leaves = [torch.from_numpy(v).requires_grad_() for v in arrays]
        y, s = ssd(*leaves, chunk=case[-1], bwd_impl=impl)
        grads[impl] = torch.autograd.grad(y.square().sum() + s.sum(), leaves)
    for g, w in zip(grads["kernel"], grads["oracle"]):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def test_upper_triangle_never_overflows():
    """Steep decays make exp(a_cum_i - a_cum_j) overflow above the diagonal;
    the port never evaluates it there, so values and gradients stay finite
    and equal to the plain scan's."""
    case = (1, 128, 2, 16, 8, 64)
    x, a, bm, cm = (torch.from_numpy(v) for v in _inputs(case, seed=7))
    a = (a - 40.0).requires_grad_()        # segment sums reach ~2500
    y, s = ssd(x, a, bm, cm, chunk=64)
    (g,) = torch.autograd.grad(y.sum() + s.sum(), a)
    y_p, s_p = ssd_chunked(x, a.detach(), bm, cm, 64)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert torch.isfinite(g).all()
    _close(y.detach().numpy(), y_p.numpy())
    _close(s.detach().numpy(), s_p.numpy())


@pytest.mark.parametrize("shape", [(1, 2, 128, 2, 16, 8),
                                   (1, 2, 64, 2, 128, 8),
                                   (1, 2, 64, 2, 16, 256)],
                         ids=["chunk-128", "head_dim-128", "state-256"])
def test_unsupported_shapes_raise_on_every_device(shape):
    b, nc, cl, h, p, n = shape
    x = torch.zeros(b, nc, cl, h, p)
    a = torch.zeros(b, nc, cl, h)
    bm = torch.zeros(b, nc, cl, h, n)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        ssd_intra_chunk(x, a, bm, bm)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        ssd(x.reshape(b, nc * cl, h, p), a.reshape(b, nc * cl, h),
            bm.reshape(b, nc * cl, h, n), bm.reshape(b, nc * cl, h, n),
            chunk=cl)


def test_ssd_argument_errors():
    x, a, bm, cm = (torch.from_numpy(v) for v in _inputs(SSD_CASES[0]))
    with pytest.raises(ValueError, match="not divisible"):
        ssd(x[:, :60], a[:, :60], bm[:, :60], cm[:, :60], chunk=16)
    with pytest.raises(ValueError, match="bwd_impl"):
        ssd(x, a, bm, cm, chunk=16, bwd_impl="pallas")


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    case = SSD_CASES[0]
    before = dict(LAUNCHES)
    xs = _chunked(_inputs(case), case[-1])
    y, s = ssd_intra_chunk(*xs)
    y_p, s_p = ssd_intra_chunk_plain(*xs)
    assert torch.equal(y, y_p) and torch.equal(s, s_p)
    ssd_intra_chunk_bwd(*xs, y, s)
    assert LAUNCHES == before
    from repro_torch.kernels.ssd_scan.kernel import _check_cuda

    with pytest.raises(ValueError, match="CUDA"):
        _check_cuda("ssd_fwd", *xs)


# (b, nc, cl, h, p, n): tests/test_torch_ssd_cuda.py's ragged cases, whose
# cl, P and N are no multiples of the kernel's mma tiles
RAGGED = [(1, 3, 40, 3, 20, 12), (1, 2, 13, 3, 7, 9), (1, 1, 1, 1, 1, 1)]


@pytest.mark.parametrize("case", RAGGED, ids=["ragged-40", "odd", "one-step"])
def test_intra_chunk_bwd_plain_matches_jax_grad_at_ragged_shapes(case):
    """The CPU half of the card's ragged cases: with each chunk a sequence of
    its own, the reference's ``ssd_chunked`` returns the chunk's y_diag and
    state, so ``jax.grad`` of it is the VJP that
    ``ssd_intra_chunk_bwd_plain`` (and ``ssd_bwd`` on the card) computes."""
    b, nc, cl, h, p, n = case
    rng = np.random.default_rng(8)
    x, bm, cm, dy = (rng.standard_normal(shape).astype(np.float32) for shape
                     in ((b, nc, cl, h, p), (b, nc, cl, h, n),
                         (b, nc, cl, h, n), (b, nc, cl, h, p)))
    a = (-np.abs(rng.standard_normal((b, nc, cl, h))) * 0.1).astype(
        np.float32)
    ds = rng.standard_normal((b, nc, h, p, n)).astype(np.float32)
    rows = b * nc

    def ref_loss(x_, a_, bm_, cm_):
        y, s = ref_ssd_chunked(x_.reshape(rows, cl, h, p),
                               a_.reshape(rows, cl, h),
                               bm_.reshape(rows, cl, h, n),
                               cm_.reshape(rows, cl, h, n), cl)
        return (jnp.sum(y * dy.reshape(rows, cl, h, p))
                + jnp.sum(s * ds.reshape(rows, h, p, n)))

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, a, bm, cm)))
    got = ssd_intra_chunk_bwd_plain(*map(torch.from_numpy,
                                         (x, a, bm, cm, dy, ds)))
    for name, g, w in zip(("dx", "da", "db", "dc"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max()
        assert err <= TOL * np.abs(w).max(), (name, err, np.abs(w).max())
