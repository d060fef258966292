"""Wrappers around the CUDA flash-attention kernels, with their plain
PyTorch versions beside them.

``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` port the reference's
Pallas ``flash_attention`` and ``flash_attention_bwd`` (the dq and dk/dv
kernels).  The tensor's device picks the implementation: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel (built from
``csrc/flash_attention.cu`` on first use) or raises.  Each launch adds one to
``LAUNCHES[name]``; nothing else does.

Semantics shared by kernel and plain version: q (B,S,H,D), k/v (B,T,Hkv,D)
of any floating dtype, computed in fp32 (the kernels take fp32: the
wrapper casts q, k, v and dO up and hands out, dq, dk and dv back in the
inputs' dtypes, as the reference's kernels load in f32 and store in the
input dtype; lse and delta stay f32); queries right-aligned when S < T;
optional sliding ``window`` and tanh ``softcap``; ``num_valid`` (a 0-d
int32 tensor on the inputs' device, or None for all rows) marks batch rows
>= num_valid as padding, whose outputs and gradients are exact zeros.  The backward takes the forward's lse and
``delta = rowsum(dO * O)`` as (B,H,S) f32, and returns dk/dv per kv head
(summed over the query heads that share it).  Like the reference, the dk/dv
kernel computes them per query head (``flash_bwd_dkv_heads_plain`` is that
step's plain version) into (B,T,H,D) scratch, then sums each group in a
fixed order.

The kernels are built for the head dims in ``HEAD_DIMS``.  Any other head
dim up to the largest is zero-padded to the next of them and the outputs
sliced back, as the reference pads to its 128 lanes; ``sm_scale`` stays
``1/sqrt(true D)``.  Padding lanes are inert: a zero lane adds nothing to
q.k, to dO.v or to delta, and the padded columns of out, dq, dk and dv come
out as P.0 = 0 and are dropped.  A head dim above the largest is refused,
a deliberate difference (ROADMAP queue 3): the reference pads any head dim
to a multiple of 128, but the forward's tiles at D 512 (a 64-row Q tile
and two stages of 32-row K and V tiles) would need 384 KB of shared memory,
against sm_90's 227 KB a block.
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

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE, "flash_attention")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(name, q, k, v, *rest):
    for x in (q, k, v, *rest):
        if x.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned (the "
                             "kernels copy 16-byte chunks)")
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
    for x, what in ((lse, "lse"), (delta, "delta")):
        if x.shape != (b, h, s):
            raise ValueError(f"{name}: {what} must be {(b, h, s)}, got "
                             f"{tuple(x.shape)}")


def _nv_ptr(num_valid, device):
    """(pointer, keep-alive tensor) for num_valid on the device."""
    if num_valid is None:
        return None, None
    if not isinstance(num_valid, torch.Tensor):
        num_valid = torch.tensor(num_valid, dtype=torch.int32)
    nv = num_valid.to(device=device, dtype=torch.int32).reshape(())
    return nv.data_ptr(), nv


def _padded_dim(d: int) -> int:
    """The smallest instantiated head dim >= d."""
    return next(dp for dp in HEAD_DIMS if dp >= d)


def _f32(xs):
    """Each tensor as a contiguous float32 one (the same tensors when they
    are float32 already: those must come contiguous, as ``_check`` says)."""
    return [x if x.dtype == torch.float32 else x.float().contiguous()
            for x in xs]


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


def _narrow(x, d: int, dtype):
    """A kernel's fp32 output cut back to the true head dim ``d`` and cast
    to ``dtype`` (the same tensor when neither changes anything)."""
    if x.shape[-1] != d:
        x = x[..., :d]
    return x.to(dtype).contiguous()


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (code {rc})")


def flash_fwd(q, k, v, num_valid=None, *, causal: bool = True,
              window: Optional[int] = None, softcap: Optional[float] = None):
    """Forward: -> (out (B,S,H,D), lse (B,H,S) f32)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, num_valid, causal=causal,
                               window=window, softcap=softcap)
    dtype = q.dtype
    q, k, v = _f32((q, k, v))
    _check("flash_fwd", q, k, v)
    b, s, h, d = q.shape
    q, k, v = _pad((q, k, v), _padded_dim(d))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    nv, _keep = _nv_ptr(num_valid, q.device)
    rc = _lib().flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), nv,
                          out.data_ptr(), lse.data_ptr(),
                          *_geom(q, k, causal, window, softcap, d))
    _raise_on("flash_fwd", rc)
    LAUNCHES["flash_fwd"] += 1
    return _narrow(out, d, dtype), lse


def flash_bwd_dq(q, k, v, do, lse, delta, num_valid=None, *,
                 causal: bool = True, window: Optional[int] = None,
                 softcap: Optional[float] = None):
    """dq (B,S,H,D) from the forward's lse and delta = rowsum(dO * O)."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, num_valid,
                                  causal=causal, window=window,
                                  softcap=softcap)
    dtype = q.dtype
    q, k, v, do = _f32((q, k, v, do))
    _check("flash_bwd_dq", q, k, v, do, lse, delta)
    _check_bwd("flash_bwd_dq", q, do, lse, delta)
    d = q.shape[3]
    q, k, v, do = _pad((q, k, v, do), _padded_dim(d))
    dq = torch.empty_like(q)
    nv, _keep = _nv_ptr(num_valid, q.device)
    rc = _lib().flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                             nv, dq.data_ptr(),
                             *_geom(q, k, causal, window, softcap, d))
    _raise_on("flash_bwd_dq", rc)
    LAUNCHES["flash_bwd_dq"] += 1
    return _narrow(dq, d, dtype)


def flash_bwd_dkv(q, k, v, do, lse, delta, num_valid=None, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None):
    """(dk, dv), each (B,T,Hkv,D), group-summed over the query heads.

    With H > Hkv the kernel writes per-query-head partials into (B,T,H,D)
    scratch and a second kernel adds each group in a fixed order, so two
    calls on the same inputs agree bit for bit."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, num_valid,
                                   causal=causal, window=window,
                                   softcap=softcap)
    dtypes = k.dtype, v.dtype
    q, k, v, do = _f32((q, k, v, do))
    _check("flash_bwd_dkv", q, k, v, do, lse, delta)
    _check_bwd("flash_bwd_dkv", q, do, lse, delta)
    d = q.shape[3]
    q, k, v, do = _pad((q, k, v, do), _padded_dim(d))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    heads = (None, None)
    if q.shape[2] > k.shape[2]:
        b, t, h, dp = k.shape[0], k.shape[1], q.shape[2], q.shape[3]
        heads = tuple(torch.empty((b, t, h, dp), dtype=torch.float32,
                                  device=q.device) for _ in range(2))
    nv, _keep = _nv_ptr(num_valid, q.device)
    rc = _lib().flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              do.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), nv, dk.data_ptr(),
                              dv.data_ptr(),
                              *(x if x is None else x.data_ptr()
                                for x in heads),
                              *_geom(q, k, causal, window, softcap, d))
    _raise_on("flash_bwd_dkv", rc)
    LAUNCHES["flash_bwd_dkv"] += 1
    return _narrow(dk, d, dtypes[0]), _narrow(dv, d, dtypes[1])
