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

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
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


# (b, l, h, g, p, n, chunk): B and C for one group of all heads (the
# mamba2 configs' layout), for 1 < G < H, and per head (G == H, the
# reference's layout)
GROUPED = [(2, 64, 4, 1, 16, 8, 16), (1, 128, 6, 2, 16, 16, 32),
           (2, 64, 4, 4, 16, 8, 16)]
GROUP_IDS = ["g1", "g2-of-6", "g-eq-h"]


def _grouped_inputs(case, seed):
    b, l, h, g, p, n, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((b, l, h))) * 0.1).astype(np.float32)
    bm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return x, a, bm, cm


def _heads(t, h):
    """(..., G, N) -> (..., H, N), head i reading group i // (H // G)."""
    return torch.repeat_interleave(t, h // t.shape[-2], dim=-2)


@pytest.mark.parametrize("case", GROUPED, ids=GROUP_IDS)
def test_grouped_ssd_matches_per_head_and_reference(case):
    """``ssd`` with B and C per group against itself on B and C repeated to
    heads, against the reference's Pallas ``ssd`` on ``jnp.repeat``'d B and
    C, and its gradients against ``jax.grad`` of ``ssd_chunked`` with the
    repeat inside the loss (so the reference's db and dc are per group)."""
    b, l, h, g, p, n, chunk = case
    arrays = _grouped_inputs(case, seed=9)
    rng = np.random.default_rng(10)
    gy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    gs = rng.standard_normal((b, h, p, n)).astype(np.float32)
    rep = lambda v: jnp.repeat(v, h // g, axis=2)  # noqa: E731
    jx, ja, jb, jc = map(jnp.asarray, arrays)
    y_k, s_k = ref_ssd(jx, ja, rep(jb), rep(jc), chunk=chunk, interpret=True)

    def ref_loss(x, a, bm, cm):
        y, s = ref_ssd_chunked(x, a, rep(bm), rep(cm), chunk)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(jx, ja, jb, jc)
    out, grads = {}, {}
    for layout in ("group", "head"):
        leaves = [torch.from_numpy(v).requires_grad_() for v in arrays]
        bc = leaves[2:] if layout == "group" else [_heads(t, h)
                                                  for t in leaves[2:]]
        y, s = ssd(*leaves[:2], *bc, chunk=chunk)
        loss = (y * torch.from_numpy(gy)).sum() + (s * torch.from_numpy(gs)
                                                   ).sum()
        out[layout] = (y.detach(), s.detach())
        grads[layout] = torch.autograd.grad(loss, leaves)
    _close(out["group"][0].numpy(), y_k, what="y vs pallas")
    _close(out["group"][1].numpy(), s_k, what="state vs pallas")
    for got, per_head in zip(out["group"], out["head"]):
        _close(got.numpy(), per_head.numpy(), tol=1e-5, what="vs per head")
    for name, gg, gh, w in zip(("x", "a_log", "b", "c"), grads["group"],
                               grads["head"], want):
        w = np.asarray(w)
        assert gg.shape == w.shape, name
        err = np.abs(gg.numpy() - w).max()
        assert err <= TOL * np.abs(w).max(), (name, err, np.abs(w).max())
        assert (gg - gh).abs().max() <= 1e-5 * gh.abs().max(), name


@pytest.mark.parametrize("case", GROUPED, ids=GROUP_IDS)
def test_grouped_intra_chunk_plain_equals_per_head(case):
    """The plain intra-chunk forward and backward with B and C per group
    equal the same functions on B and C repeated to heads, with db and dc
    summed over each group's heads, to the bit; and the backward matches
    ``jax.grad`` of the reference's ``ssd_chunked`` on each chunk alone,
    with the repeat inside the loss."""
    b, l, h, g, p, n, chunk = case
    nc = l // chunk
    x, a, bm, cm = (torch.from_numpy(v) for v in _grouped_inputs(case, 11))
    xs = (x.reshape(b, nc, chunk, h, p), a.reshape(b, nc, chunk, h),
          bm.reshape(b, nc, chunk, g, n), cm.reshape(b, nc, chunk, g, n))
    heads = (*xs[:2], _heads(xs[2], h), _heads(xs[3], h))
    y, s = ssd_intra_chunk_plain(*xs)
    y_h, s_h = ssd_intra_chunk_plain(*heads)
    assert torch.equal(y, y_h) and torch.equal(s, s_h)
    rng = np.random.default_rng(12)
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    ds = torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32))
    got = ssd_intra_chunk_bwd_plain(*xs, dy, ds)
    per_head = ssd_intra_chunk_bwd_plain(*heads, dy, ds)
    assert torch.equal(got[0], per_head[0]) and torch.equal(got[1],
                                                            per_head[1])
    for gg, gh in zip(got[2:], per_head[2:]):
        assert gg.shape == (b, nc, chunk, g, n)
        assert torch.equal(gg, gh.reshape(b, nc, chunk, g, h // g, n).sum(4))
    assert torch.equal(got[0], ssd_intra_chunk_bwd(*xs, dy, ds)[0])
    rows = b * nc

    def ref_loss(x_, a_, bm_, cm_):
        yy, ss = ref_ssd_chunked(
            x_.reshape(rows, chunk, h, p), a_.reshape(rows, chunk, h),
            jnp.repeat(bm_.reshape(rows, chunk, g, n), h // g, axis=2),
            jnp.repeat(cm_.reshape(rows, chunk, g, n), h // g, axis=2), chunk)
        return (jnp.sum(yy * dy.numpy().reshape(rows, chunk, h, p))
                + jnp.sum(ss * ds.numpy().reshape(rows, h, p, n)))

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(t.numpy()) for t in xs))
    for name, gg, w in zip(("dx", "da", "db", "dc"), got, want):
        w = np.asarray(w)
        err = np.abs(gg.numpy() - w).max()
        assert err <= TOL * np.abs(w).max(), (name, err, np.abs(w).max())


def test_group_count_that_does_not_divide_heads_raises():
    x = torch.zeros(1, 2, 8, 6, 4)
    a = torch.zeros(1, 2, 8, 6)
    bm = torch.zeros(1, 2, 8, 4, 3)
    ds = torch.zeros(1, 2, 6, 4, 3)
    for fn, args in ((ssd_intra_chunk, (x, a, bm, bm)),
                     (ssd_intra_chunk_plain, (x, a, bm, bm)),
                     (ssd_intra_chunk_bwd, (x, a, bm, bm, x, ds)),
                     (ssd_intra_chunk_bwd_plain, (x, a, bm, bm, x, ds))):
        with pytest.raises(ValueError, match="do not divide"):
            fn(*args)
    with pytest.raises(ValueError, match="do not divide"):
        ssd(x.reshape(1, 16, 6, 4), a.reshape(1, 16, 6),
            bm.reshape(1, 16, 4, 3), bm.reshape(1, 16, 4, 3), chunk=8)
