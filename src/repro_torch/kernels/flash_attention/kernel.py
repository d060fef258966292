"""Wrappers around the CUDA flash-attention kernels, with their plain
PyTorch versions beside them.

``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` port the reference's
Pallas ``flash_attention`` and ``flash_attention_bwd`` (the dq and dk/dv
kernels).  The tensor's device picks the implementation: a CPU tensor takes
the plain version, a CUDA tensor launches a kernel or raises.  The inputs'
dtype picks the kernel: float32 launches the fp32 entry (3xTF32 products,
built from ``csrc/flash_attention.cu``), bfloat16 and float16 the 16-bit
one (``csrc/flash_attention_16.cu``: ``wgmma`` + TMA forward and
backward kernels that read the 16-bit tensors as they are, accumulate in
fp32 and store in the inputs' dtype, as the reference's kernels load 16-bit
blocks, widen them and store in the input dtype).  Each launch adds one to
``LAUNCHES[name]`` whichever entry ran, and a 16-bit one also to
``LAUNCHES_16[name + "_16"]``; nothing else does.
``flash_delta`` is the backward's ``delta = rowsum(dO * O)`` on 16-bit
inputs (a kernel of its own, so that no fp32 copy of dO or O is made).

Semantics shared by kernel and plain version: q (B,S,H,D), k/v (B,T,Hkv,D)
(and dO) of one dtype, float32, bfloat16 or float16 (mixed dtypes raise
``TypeError``); outputs in that dtype, lse and delta f32; queries
right-aligned when S < T; optional sliding ``window`` and tanh
``softcap``; ``num_valid`` (a 0-d int32 tensor on the inputs' device, or
None for all rows) marks batch rows >= num_valid as padding, whose outputs
and gradients are exact zeros.  The backward takes the forward's lse and
``delta = rowsum(dO * O)`` as (B,H,S) f32, and returns dk/dv per kv head
(summed over the query heads that share it).  Like the reference, the fp32
dk/dv kernel computes them per query head (``flash_bwd_dkv_heads_plain`` is
that step's plain version) into (B,T,H,D) fp32 scratch, then sums each
group in a fixed order; the 16-bit one sums each group inside its blocks,
in fp32 registers, and cuts a group into splits with fp32 partials
(``dkv16_splits``) only where the card would otherwise idle.  The 16-bit
kernels round P and dS to the inputs' dtype before the products that take
them (the plain versions and the reference keep them fp32): a deliberate
difference, ROADMAP queue 3.

The kernels are built for the head dims in ``HEAD_DIMS``.  Any other head
dim up to the largest is zero-padded (in the inputs' dtype) to the next of
them and the outputs sliced back, as the reference pads to its 128 lanes;
``sm_scale`` stays ``1/sqrt(true D)``.  Padding lanes are inert: a zero
lane adds nothing to q.k, to dO.v or to delta, and the padded columns of
out, dq, dk and dv come out as P.0 = 0 and are dropped.  A head dim above
the largest is refused, a deliberate difference (ROADMAP queue 3): the
reference pads any head dim to a multiple of 128, but the fp32 forward's
tiles at D 512 (a 64-row Q tile and two stages of 32-row K and V tiles)
would need 384 KB of shared memory, against sm_90's 227 KB a block.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import visible_mask

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 128, 256)
SOURCE = Path(__file__).with_name("csrc") / "flash_attention.cu"
SOURCE_16 = SOURCE.with_name("flash_attention_16.cu")
# library name -> source, for ``build.load_all``
SOURCES = {"flash_attention": SOURCE, "flash_attention_16": SOURCE_16}

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
# the launches of the 16-bit entries alone (also counted in LAUNCHES)
LAUNCHES_16 = {"flash_fwd_16": 0, "flash_bwd_dq_16": 0,
               "flash_bwd_dkv_16": 0, "flash_delta_16": 0}
_HALF = {torch.bfloat16: 0, torch.float16: 1}  # the 16-bit entries' dtype


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_16):
        for name in counts:
            counts[name] = 0


# ------------------------------------------------------------ plain versions


def _valid_rows(b: int, num_valid, device) -> Optional[torch.Tensor]:
    """(B,) bool of rows < num_valid, or None when every row is valid."""
    if num_valid is None:
        return None
    return torch.arange(b, device=device) < num_valid


def _zero_padded(x: torch.Tensor, valid: Optional[torch.Tensor]):
    if valid is None:
        return x
    return torch.where(valid.view((-1,) + (1,) * (x.dim() - 1)), x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _scores(q, k, softcap, causal, window):
    """Grouped scores (B,Hkv,rep,S,T) after scale and softcap, and the mask."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, hkv, h // hkv, d)
    sc = torch.einsum("bsgrd,btgd->bgrst", qg, k.float()) * (1.0 / math.sqrt(d))
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    return sc, visible_mask(s, t, causal=causal, window=window,
                            device=q.device)


def flash_fwd_plain(q, k, v, num_valid=None, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """-> (out (B,S,H,D) in q's dtype, lse (B,H,S) f32)."""
    b, s, h, d = q.shape
    sc, mask = _scores(q, k, softcap, causal, window)
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(-1)
    p = torch.exp(sc - m[..., None])
    l_safe = p.sum(-1).clamp_min(1e-20)
    out = torch.einsum("bgrst,btgd->bsgrd", p, v.float()) \
        / l_safe.permute(0, 3, 1, 2)[..., None]
    lse = (m + torch.log(l_safe)).reshape(b, h, s)
    valid = _valid_rows(b, num_valid, q.device)
    out = _zero_padded(out.reshape(b, s, h, d), valid).to(q.dtype)
    return out, _zero_padded(lse, valid)


def _bwd_plain(q, k, v, do, lse, delta, causal, window, softcap):
    """Per-pair p and ds (B,Hkv,rep,S,T), as the reference's _bwd_tile."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    s_soft, mask = _scores(q, k, softcap, causal, window)
    p = torch.exp(s_soft - lse.reshape(b, hkv, rep, s)[..., None])
    p = torch.where(mask, p, torch.zeros((), device=q.device))
    dog = do.float().reshape(b, s, hkv, rep, d)
    dp = torch.einsum("bsgrd,btgd->bgrst", dog, v.float())
    ds = p * (dp - delta.reshape(b, hkv, rep, s)[..., None])
    if softcap is not None:
        ds = ds * (1.0 - torch.square(s_soft / softcap))
    return p, ds, dog


def flash_bwd_dq_plain(q, k, v, do, lse, delta, num_valid=None, *,
                       causal: bool = True, window: Optional[int] = None,
                       softcap: Optional[float] = None):
    """-> dq (B,S,H,D)."""
    b, s, h, d = q.shape
    _, ds, _ = _bwd_plain(q, k, v, do, lse, delta, causal, window, softcap)
    dq = torch.einsum("bgrst,btgd->bsgrd", ds, k.float()) * (1.0 / math.sqrt(d))
    valid = _valid_rows(b, num_valid, q.device)
    return _zero_padded(dq.reshape(b, s, h, d), valid).to(q.dtype)


def flash_bwd_dkv_heads_plain(q, k, v, do, lse, delta, num_valid=None, *,
                              causal: bool = True,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None):
    """-> (dk, dv), each (B,T,H,D): per query head, before the group-sum
    (the reference's ``_dkv_kernel`` outputs)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    p, ds, dog = _bwd_plain(q, k, v, do, lse, delta, causal, window, softcap)
    qg = q.float().reshape(dog.shape)
    dk = torch.einsum("bgrst,bsgrd->btgrd", ds, qg) * (1.0 / math.sqrt(d))
    dv = torch.einsum("bgrst,bsgrd->btgrd", p, dog)
    valid = _valid_rows(b, num_valid, q.device)
    return (_zero_padded(dk.reshape(b, t, h, d), valid),
            _zero_padded(dv.reshape(b, t, h, d), valid))


def flash_delta_plain(do, out):
    """-> delta = rowsum(dO * O), (B,H,S) f32, of (B,S,H,D) tensors."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


# The 16-bit kernels against their plain versions, a row at a time: P and
# dS are rounded to 16 bits before their products, so each (B,S,H) row of
# out, dq, dk and dv may sit a few units in the last place of the row's own
# largest value from the plain version; a row of values near zero is held to ROW_ATOL x the tensor's largest value.  lse is
# fp32 from fp32 sums of exact products, held to LSE_TOL x its largest.
ROW_ULPS = 4
ROW_ATOL = 1e-4
LSE_TOL = 1e-5


def row_error(x, ref) -> float:
    """The largest over the (B,S,H) rows of (B,S,H,D) ``x`` of max|x - ref|
    over the row's limit, ROW_ULPS x eps(ref.dtype) x the row's max|ref| +
    ROW_ATOL x the tensor's max|ref|: at most 1 passes."""
    ref = ref.float()
    mag = ref.abs()
    lim = (ROW_ULPS * torch.finfo(x.dtype).eps * mag.amax(-1)
           + ROW_ATOL * mag.max()).clamp_min(torch.finfo(torch.float32).tiny)
    return ((x.float() - ref).abs().amax(-1) / lim).max().item()


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, num_valid=None, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """-> (dk, dv), each (B,T,Hkv,D), summed over each kv head's q heads."""
    b, s, h, d = q.shape
    p, ds, dog = _bwd_plain(q, k, v, do, lse, delta, causal, window, softcap)
    qg = q.float().reshape(dog.shape)
    dk = torch.einsum("bgrst,bsgrd->btgd", ds, qg) * (1.0 / math.sqrt(d))
    dv = torch.einsum("bgrst,bsgrd->btgd", p, dog)
    valid = _valid_rows(b, num_valid, q.device)
    return (_zero_padded(dk, valid).to(k.dtype),
            _zero_padded(dv, valid).to(v.dtype))


# ------------------------------------------------------------------- kernels

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# B, S, T, H, Hkv, D, causal, window, softcap, sm_scale, stream
_GEOM = [_I] * 8 + [_F, _F, _P]
_SIGNATURES = {
    "flash_fwd": [_P] * 6 + _GEOM,
    "flash_bwd_dq": [_P] * 8 + _GEOM,
    "flash_bwd_dkv": [_P] * 11 + _GEOM,
}
# the 16-bit entries take the dtype (0 bfloat16, 1 float16) first
SIGNATURES_16 = {
    "flash_fwd_16": [_I] + _SIGNATURES["flash_fwd"],
    "flash_bwd_dq_16": [_I] + _SIGNATURES["flash_bwd_dq"],
    "flash_bwd_dkv_16": [_I] + _SIGNATURES["flash_bwd_dkv"],
    # dtype, dO, O, delta, B, S, H, D, stream
    "flash_delta_16": [_I] + [_P] * 3 + [_I] * 4 + [_P],
    # B, T, H, Hkv, D
    "flash_bwd_dkv_16_splits": [_I] * 5,
}


_TYPED: dict[str, ctypes.CDLL] = {}  # library name -> lib, signatures set


def _load(source: Path, name: str, signatures: dict) -> ctypes.CDLL:
    lib = _TYPED.get(name)
    if lib is None:
        lib = build.load(source, name)
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _TYPED[name] = lib
    return lib


def _lib() -> ctypes.CDLL:
    return _load(SOURCE, "flash_attention", _SIGNATURES)


def _lib16() -> ctypes.CDLL:
    return _load(SOURCE_16, "flash_attention_16", SIGNATURES_16)


def _on_card(name, *xs):
    for x in xs:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned (the "
                             "kernels copy 16-byte chunks)")


def _check(name, q, k, v, *rest):
    """q, k, v (and dO) on the card, of one dtype the kernels take."""
    _on_card(name, q, k, v, *rest)
    dtypes = {x.dtype for x in (q, k, v, *rest)}
    if len(dtypes) > 1:
        raise TypeError(f"{name}: q, k, v (and dO) must share one dtype, got "
                        f"{sorted(map(str, dtypes))}")
    if q.dtype != torch.float32 and q.dtype not in _HALF:
        raise TypeError(f"{name}: the kernels take float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q (B,S,H,D), k/v (B,T,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")
    if d > HEAD_DIMS[-1]:
        raise ValueError(f"{name}: head_dim {d} is above the largest the "
                         f"kernels are built for, {HEAD_DIMS[-1]} (a "
                         f"deliberate difference, ROADMAP queue 3)")
    if b == 0 or s == 0 or k.shape[1] == 0:
        raise ValueError(f"{name}: empty input {tuple(q.shape)}")


def _check_bwd(name, q, do, lse, delta):
    b, s, h, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"{name}: dO {tuple(do.shape)} != q {tuple(q.shape)}")
    _on_card(name, lse, delta)
    for x, what in ((lse, "lse"), (delta, "delta")):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {x.dtype}")
        if x.shape != (b, h, s):
            raise ValueError(f"{name}: {what} must be {(b, h, s)}, got "
                             f"{tuple(x.shape)}")


def _nv_ptr(num_valid, device):
    """(pointer, keep-alive tensor) for num_valid on the device."""
    if num_valid is None:
        return None, None
    if not isinstance(num_valid, torch.Tensor):
        num_valid = torch.tensor(num_valid, dtype=torch.int32)
    nv = num_valid
    if nv.dtype != torch.int32 or nv.device != device or nv.dim():
        nv = nv.to(device=device, dtype=torch.int32).reshape(())
    return nv.data_ptr(), nv


def _padded_dim(d: int) -> int:
    """The smallest instantiated head dim >= d."""
    return next(dp for dp in HEAD_DIMS if dp >= d)


def _pad(xs, dp: int):
    """Each tensor zero-padded on its last dim to dp (the same tensors when
    that is their width already)."""
    return [x if x.shape[-1] == dp else
            torch.nn.functional.pad(x, (0, dp - x.shape[-1])).contiguous()
            for x in xs]


def _geom(q, k, causal, window, softcap, d):
    """Launch geometry of padded q, k; ``d`` is the true head dim, which
    alone sets sm_scale."""
    b, s, h, dp = q.shape
    return [b, s, k.shape[1], h, k.shape[2], dp, int(bool(causal)),
            int(window or 0), float(softcap or 0.0), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream]


def _narrow(x, d: int):
    """A kernel's output cut back to the true head dim ``d`` (the same
    tensor when that is its width)."""
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (code {rc})")


def _launch(name: str, dtype, args) -> None:
    """Launch entry ``name`` (fp32) or its 16-bit twin for ``dtype``; raises
    if the launch fails, counts it if not."""
    if dtype == torch.float32:
        rc = getattr(_lib(), name)(*args)
    else:
        rc = getattr(_lib16(), f"{name}_16")(_HALF[dtype], *args)
    _raise_on(name, rc)
    LAUNCHES[name] += 1
    if dtype != torch.float32:
        LAUNCHES_16[f"{name}_16"] += 1


def flash_fwd(q, k, v, num_valid=None, *, causal: bool = True,
              window: Optional[int] = None, softcap: Optional[float] = None):
    """Forward: -> (out (B,S,H,D), lse (B,H,S) f32)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, num_valid, causal=causal,
                               window=window, softcap=softcap)
    _check("flash_fwd", q, k, v)
    b, s, h, d = q.shape
    q, k, v = _pad((q, k, v), _padded_dim(d))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    nv, _keep = _nv_ptr(num_valid, q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), nv, out.data_ptr(),
            lse.data_ptr(), *_geom(q, k, causal, window, softcap, d))
    _launch("flash_fwd", q.dtype, args)
    return _narrow(out, d), lse


def flash_bwd_dq(q, k, v, do, lse, delta, num_valid=None, *,
                 causal: bool = True, window: Optional[int] = None,
                 softcap: Optional[float] = None):
    """dq (B,S,H,D) from the forward's lse and delta = rowsum(dO * O)."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, num_valid,
                                  causal=causal, window=window,
                                  softcap=softcap)
    _check("flash_bwd_dq", q, k, v, do)
    _check_bwd("flash_bwd_dq", q, do, lse, delta)
    d = q.shape[3]
    q, k, v, do = _pad((q, k, v, do), _padded_dim(d))
    dq = torch.empty_like(q)
    nv, _keep = _nv_ptr(num_valid, q.device)
    _launch("flash_bwd_dq", q.dtype,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), nv, dq.data_ptr(),
             *_geom(q, k, causal, window, softcap, d)))
    return _narrow(dq, d)


def dkv16_splits(b: int, t: int, h: int, hkv: int, d: int) -> int:
    """How many splits the 16-bit dk/dv kernel cuts each kv head's group of
    query heads into at these shapes on the current card: 1 keeps a group
    in one block (no scratch); past 1 each split stores an fp32 partial,
    (B,T,Hkv * splits,D) for dk and for dv, that a second kernel adds."""
    rc = _lib16().flash_bwd_dkv_16_splits(b, t, h, hkv, _padded_dim(d))
    if rc < 1:
        raise RuntimeError(f"flash_bwd_dkv_16_splits failed (code {rc})")
    return rc


def flash_bwd_dkv(q, k, v, do, lse, delta, num_valid=None, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None):
    """(dk, dv), each (B,T,Hkv,D), group-summed over the query heads.

    With H > Hkv the fp32 kernel writes per-query-head partials into
    (B,T,H,D) scratch and a second kernel adds each group in a fixed order;
    the 16-bit kernel sums a group in its blocks, and writes fp32 partials
    of (B,T,Hkv * splits,D) only where ``dkv16_splits`` cuts the group.
    Every sum has a fixed order, so two calls on the same inputs agree bit
    for bit."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, num_valid,
                                   causal=causal, window=window,
                                   softcap=softcap)
    _check("flash_bwd_dkv", q, k, v, do)
    _check_bwd("flash_bwd_dkv", q, do, lse, delta)
    d = q.shape[3]
    q, k, v, do = _pad((q, k, v, do), _padded_dim(d))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    b, t, h, hkv, dp = k.shape[0], k.shape[1], q.shape[2], k.shape[2], \
        q.shape[3]
    parts = h if q.dtype == torch.float32 else \
        hkv * dkv16_splits(b, t, h, hkv, dp)
    heads = (None, None)
    if parts > hkv:
        heads = tuple(torch.empty((b, t, parts, dp), dtype=torch.float32,
                                  device=q.device) for _ in range(2))
    nv, _keep = _nv_ptr(num_valid, q.device)
    _launch("flash_bwd_dkv", q.dtype,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), nv, dk.data_ptr(),
             dv.data_ptr(), *(x if x is None else x.data_ptr()
                              for x in heads),
             *_geom(q, k, causal, window, softcap, d)))
    return _narrow(dk, d), _narrow(dv, d)


def flash_delta(do, out):
    """delta = rowsum(dO * O), (B,H,S) f32, of (B,S,H,D) dO and O of one
    dtype.  On 16-bit CUDA tensors a kernel sums the products, each exact
    in fp32, in fp32, as the reference's rowsum of the widened tensors
    (``flash_delta_plain``), without writing fp32 copies of either; float32
    inputs have nothing to widen and take the plain version on any device,
    as CPU tensors do."""
    if do.device.type == "cpu" or (do.dtype == out.dtype == torch.float32):
        return flash_delta_plain(do, out)
    _on_card("flash_delta", do, out)
    if do.dtype not in _HALF or out.dtype != do.dtype:
        raise TypeError(f"flash_delta: want dO and O of one dtype, float32 "
                        f"or 16-bit, got {do.dtype} and {out.dtype}")
    if do.dim() != 4 or out.shape != do.shape:
        raise ValueError(f"flash_delta: want dO and O of one (B,S,H,D) "
                         f"shape, got {tuple(do.shape)}, {tuple(out.shape)}")
    b, s, h, d = do.shape
    delta = torch.empty((b, h, s), dtype=torch.float32, device=do.device)
    rc = _lib16().flash_delta_16(
        _HALF[do.dtype], do.data_ptr(), out.data_ptr(), delta.data_ptr(), b,
        s, h, d, torch.cuda.current_stream(do.device).cuda_stream)
    _raise_on("flash_delta", rc)
    LAUNCHES_16["flash_delta_16"] += 1
    return delta
