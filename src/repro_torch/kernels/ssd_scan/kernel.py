"""Wrappers around the CUDA SSD intra-chunk kernels, with their plain
PyTorch versions beside them.

``ssd_intra_chunk`` ports the reference's Pallas ``ssd_intra_chunk``
(``_ssd_kernel``); ``ssd_intra_chunk_bwd`` is its vector-Jacobian product,
which the reference does not have (its kernel path cannot be
differentiated) and the port's training path needs.  The tensor's device
picks the implementation: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel (built from ``csrc/ssd_scan.cu`` on first use)
or raises.  Each launch adds one to ``LAUNCHES[name]``; nothing else does.

Per (batch, chunk, head h), with ``a_cum = cumsum(a)`` over the chunk,
``L_ij = exp(a_cum_i - a_cum_j)`` for i >= j (0 above the diagonal, never
computed there: the exponent is positive and may overflow) and
``w_j = exp(a_cum_last - a_cum_j)``:

    y_diag = ((C B^T) o L) X          state = X^T (B o w)

where B and C are those of h's group, ``h // (H // G)``.  Layouts: x
(B,nc,cl,H,P), a (B,nc,cl,H), b/c (B,nc,cl,G,N) with ``H % G == 0``,
y_diag (B,nc,cl,H,P), states (B,nc,H,P,N), all float32; G == H is the
reference's layout (B and C per head).  The backward returns db and dc in
the inputs' layout, summed over the heads of each group.  Both devices
enforce the kernel's shape rule (cl <= 64, P <= 64, N <= 128, G divides H)
with ``ValueError``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 64, 64, 128
SOURCE = Path(__file__).with_name("csrc") / "ssd_scan.cu"
# library name -> source, for ``build.load_all``
SOURCES = {"ssd_scan": SOURCE}

LAUNCHES = {"ssd_fwd": 0, "ssd_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_shapes(name: str, x, a, b, c, dy=None, ds=None) -> None:
    """Raise ``ValueError`` for shapes the kernel does not take, on either
    device, so that the CPU tests meet the card's rule."""
    if x.dim() != 5 or a.dim() != 4 or b.dim() != 5 or b.shape != c.shape:
        raise ValueError(
            f"{name}: want x (B,nc,cl,H,P), a (B,nc,cl,H), b/c (B,nc,cl,G,N);"
            f" got {tuple(x.shape)}, {tuple(a.shape)}, {tuple(b.shape)}, "
            f"{tuple(c.shape)}")
    bsz, nc, cl, h, p = x.shape
    grp, n = b.shape[3], b.shape[4]
    if tuple(a.shape) != (bsz, nc, cl, h) or tuple(b.shape[:3]) != (
            bsz, nc, cl):
        raise ValueError(f"{name}: x {tuple(x.shape)}, a {tuple(a.shape)} "
                         f"and b {tuple(b.shape)} do not match")
    if min(bsz, nc, cl, h, p, grp, n) == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}, b "
                         f"{tuple(b.shape)}")
    if h % grp:
        raise ValueError(f"{name}: {grp} groups of B and C do not divide "
                         f"{h} heads")
    if cl > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(
            f"{name}: chunk {cl}, head_dim {p}, state {n} outside the "
            f"kernel's range (chunk <= {MAX_CHUNK}, head_dim <= "
            f"{MAX_HEAD_DIM}, state <= {MAX_STATE})")
    if dy is not None and dy.shape != x.shape:
        raise ValueError(f"{name}: dy {tuple(dy.shape)} != x {tuple(x.shape)}")
    if ds is not None and tuple(ds.shape) != (bsz, nc, h, p, n):
        raise ValueError(f"{name}: ds must be {(bsz, nc, h, p, n)}, got "
                         f"{tuple(ds.shape)}")


# ------------------------------------------------------------ plain versions


def _decays(a):
    """(L (B,nc,H,cl,cl) with exact zeros above the diagonal,
    w (B,nc,cl,H)) from a (B,nc,cl,H)."""
    cl = a.shape[2]
    acum = torch.cumsum(a.float(), dim=2)                      # (B,nc,cl,H)
    at = acum.permute(0, 1, 3, 2)                              # (B,nc,H,cl)
    seg = at[..., :, None] - at[..., None, :]
    mask = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=a.device))
    ltri = torch.exp(torch.where(mask, seg, torch.full_like(seg, -torch.inf)))
    w = torch.exp(acum[:, :, -1:, :] - acum)
    return ltri, w


def _per_head(t, heads: int):
    """(B,nc,cl,G,N) -> (B,nc,cl,H,N): head h reads group h // (H // G)."""
    rep = heads // t.shape[3]
    return t if rep == 1 else torch.repeat_interleave(t, rep, dim=3)


def _per_group(t, groups: int):
    """(B,nc,cl,H,N) -> (B,nc,cl,G,N): the sum over each group's heads."""
    bsz, nc, cl, h, n = t.shape
    return t if groups == h else t.reshape(bsz, nc, cl, groups, h // groups,
                                           n).sum(4)


def ssd_intra_chunk_plain(x, a, b, c):
    """-> (y_diag (B,nc,cl,H,P), states (B,nc,H,P,N)), differentiable."""
    check_shapes("ssd_intra_chunk_plain", x, a, b, c)
    b, c = _per_head(b, x.shape[3]), _per_head(c, x.shape[3])
    ltri, w = _decays(a)
    scores = torch.einsum("bcihn,bcjhn->bchij", c, b) * ltri
    y = torch.einsum("bchij,bcjhp->bcihp", scores, x)
    states = torch.einsum("bcjhp,bcjhn->bchpn", x, b * w[..., None])
    return y, states


def ssd_intra_chunk_bwd_plain(x, a, b, c, dy, ds):
    """VJP of :func:`ssd_intra_chunk_plain` for cotangents dy (of y_diag)
    and ds (of states), written out as the kernel computes it:

        dX = Sc^T dY + (B o w) dS^T        dSc = dY X^T (lower triangle)
        dG = dSc o L   dC = dG B           dB = dG^T C + w o (X dS)
        d a_cum_i += sum_j dSc_ij Sc_ij,  d a_cum_j -= sum_i dSc_ij Sc_ij
        d a_cum_last += sum_j w_j q_j,    d a_cum_j -= w_j q_j
        with q_j = sum_n (X dS)_jn B_jn;  dA = reverse cumsum of d a_cum

    where Sc = (C B^T) o L, B and C repeated to heads.  -> (dx, da, db, dc)
    in the inputs' layouts (db and dc summed over each group's heads)."""
    check_shapes("ssd_intra_chunk_bwd_plain", x, a, b, c, dy, ds)
    cl, groups = x.shape[2], b.shape[3]
    b, c = _per_head(b, x.shape[3]), _per_head(c, x.shape[3])
    ltri, w = _decays(a)
    sc = torch.einsum("bcihn,bcjhn->bchij", c, b) * ltri       # (B,nc,H,i,j)
    mask = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=x.device))
    dsc = torch.einsum("bcihp,bcjhp->bchij", dy, x) * mask
    dg = dsc * ltri
    t = torch.einsum("bcjhn,bchpn->bcjhp", b, ds)              # (B dS^T)
    dx = torch.einsum("bchij,bcihp->bcjhp", sc, dy) + t * w[..., None]
    xds = torch.einsum("bcjhp,bchpn->bcjhn", x, ds)            # X dS
    dc = torch.einsum("bchij,bcjhn->bcihn", dg, b)
    db = torch.einsum("bchij,bcihn->bcjhn", dg, c) + xds * w[..., None]
    dseg = dsc * sc
    dacum = (dseg.sum(-1) - dseg.sum(-2)).permute(0, 1, 3, 2)  # (B,nc,cl,H)
    wq = w * (x * t).sum(-1)                                   # w_j q_j
    dacum = dacum - wq
    dacum[:, :, -1] += wq.sum(2)
    da = torch.flip(torch.cumsum(torch.flip(dacum, [2]), dim=2), [2])
    return dx, da, _per_group(db, groups), _per_group(dc, groups)


# ------------------------------------------------------------------- kernels

_P, _I = ctypes.c_void_p, ctypes.c_int
# B, nc, cl, H, G, P, N, stream
_GEOM = [_I] * 7 + [_P]
_SIGNATURES = {
    "ssd_fwd": [_P] * 6 + [_I] + _GEOM,
    "ssd_bwd": [_P] * 10 + _GEOM,
}
# ssd_fwd's run of heads of one group per block (PERF.md section 6)
FWD_HEADS = 8


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE, "ssd_scan")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, *xs) -> None:
    dev = xs[0].device
    for x in xs:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _geom(x, b):
    return [*x.shape[:4], b.shape[3], x.shape[4], b.shape[4],
            torch.cuda.current_stream(x.device).cuda_stream]


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (code {rc})")


def ssd_intra_chunk(x, a, b, c):
    """-> (y_diag (B,nc,cl,H,P), states (B,nc,H,P,N)), not differentiable
    by itself (``ops.ssd`` wraps it with its backward)."""
    if x.device.type == "cpu":
        return ssd_intra_chunk_plain(x, a, b, c)
    check_shapes("ssd_intra_chunk", x, a, b, c)
    _check_cuda("ssd_intra_chunk", x, a, b, c)
    bsz, nc, cl, h, p = x.shape
    y = torch.empty_like(x)
    states = torch.empty((bsz, nc, h, p, b.shape[-1]), dtype=torch.float32,
                         device=x.device)
    rc = _lib().ssd_fwd(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                        c.data_ptr(), y.data_ptr(), states.data_ptr(),
                        FWD_HEADS, *_geom(x, b))
    _raise_on("ssd_fwd", rc)
    LAUNCHES["ssd_fwd"] += 1
    return y, states


def ssd_bwd_per_head(x, a, b, c, dy, ds):
    """The ``ssd_bwd`` launch alone, on the card: (dx, da, db, dc) with db
    and dc per head, (B,nc,cl,H,N), whatever b's and c's group count."""
    check_shapes("ssd_intra_chunk_bwd", x, a, b, c, dy, ds)
    _check_cuda("ssd_intra_chunk_bwd", x, a, b, c, dy, ds)
    dx, da = torch.empty_like(x), torch.empty_like(a)
    per_head = (*x.shape[:4], b.shape[4])
    db, dc = (torch.empty(per_head, dtype=torch.float32, device=x.device)
              for _ in range(2))
    rc = _lib().ssd_bwd(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                        c.data_ptr(), dy.data_ptr(), ds.data_ptr(),
                        dx.data_ptr(), da.data_ptr(), db.data_ptr(),
                        dc.data_ptr(), *_geom(x, b))
    _raise_on("ssd_bwd", rc)
    LAUNCHES["ssd_bwd"] += 1
    return dx, da, db, dc


def ssd_intra_chunk_bwd(x, a, b, c, dy, ds):
    """(dx, da, db, dc) for cotangents dy (B,nc,cl,H,P) and ds (B,nc,H,P,N);
    db and dc in b's and c's (B,nc,cl,G,N).  The kernel writes them per
    head; with G < H a reduction on the device then sums each group's
    heads."""
    if x.device.type == "cpu":
        return ssd_intra_chunk_bwd_plain(x, a, b, c, dy, ds)
    dx, da, db, dc = ssd_bwd_per_head(x, a, b, c, dy, ds)
    groups = b.shape[3]
    return dx, da, _per_group(db, groups), _per_group(dc, groups)
