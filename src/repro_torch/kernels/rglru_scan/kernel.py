"""Wrappers around the CUDA RG-LRU scan kernels, with their plain PyTorch
versions beside them.

``rglru_linear_scan`` ports the reference's Pallas ``rglru_linear_scan``
(``_rglru_kernel``); ``rglru_linear_scan_bwd`` is its vector-Jacobian
product, which the reference does not have (its kernel path cannot be
differentiated) and the port's training path needs.  The tensor's device
picks the implementation: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel (built from ``csrc/rglru_scan.cu`` on first use)
or raises.  Each launch adds one to ``LAUNCHES[name]``; nothing else does.

Per (batch, column), with ``h_{-1} = h0`` (0 when h0 is None):

    h_t = a_t * h_{t-1} + bx_t            hT = h_{L-1}

and for cotangents dh (of h) and dhT (of hT):

    g_{L-1} = dh_{L-1} + dhT      g_t = dh_t + a_{t+1} g_{t+1}
    da_t = g_t h_{t-1}            dbx_t = g_t           dh0 = a_0 g_0

Layouts are the reference's: a, bx, h (B,L,W); h0, hT (B,W); float32.
Kernel and plain version round every product and sum on its own, in the
same order, so they agree to the bit.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).with_name("csrc") / "rglru_scan.cu"
# library name -> source, for ``build.load_all``
SOURCES = {"rglru_scan": SOURCE}

LAUNCHES = {"rglru_fwd": 0, "rglru_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_shapes(name: str, a, bx, h0=None, dh=None, dhT=None) -> None:
    """Raise ``ValueError`` for shapes the kernels do not take, on either
    device, so that the CPU tests meet the card's rule.  ``bx`` stands for
    any (B,L,W) operand (h in the backward)."""
    if a.dim() != 3 or bx.shape != a.shape or min(a.shape) == 0:
        raise ValueError(f"{name}: want non-empty a and bx of one shape "
                         f"(B,L,W); got {tuple(a.shape)}, {tuple(bx.shape)}")
    row = (a.shape[0], a.shape[2])
    for label, x in (("h0", h0), ("dhT", dhT)):
        if x is not None and tuple(x.shape) != row:
            raise ValueError(f"{name}: {label} must be {row}, got "
                             f"{tuple(x.shape)}")
    if dh is not None and dh.shape != a.shape:
        raise ValueError(f"{name}: dh {tuple(dh.shape)} != a "
                         f"{tuple(a.shape)}")


# ------------------------------------------------------------ plain versions


def rglru_linear_scan_plain(a, bx, h0=None):
    """-> (h (B,L,W), hT (B,W)): the sequential recurrence, differentiable."""
    check_shapes("rglru_linear_scan_plain", a, bx, h0)
    carry = torch.zeros_like(bx[:, 0]) if h0 is None else h0
    hs = []
    for t in range(a.shape[1]):
        carry = a[:, t] * carry + bx[:, t]
        hs.append(carry)
    return torch.stack(hs, dim=1), carry


def rglru_linear_scan_bwd_plain(a, h, h0, dh, dhT):
    """VJP of :func:`rglru_linear_scan_plain` written out as the kernel
    computes it (module docstring): -> (da, dbx, dh0), dh0 None when h0 is
    None."""
    check_shapes("rglru_linear_scan_bwd_plain", a, h, h0, dh, dhT)
    first = torch.zeros_like(dhT) if h0 is None else h0
    da, dbx = torch.empty_like(a), torch.empty_like(a)
    c = dhT
    for t in reversed(range(a.shape[1])):
        g = dh[:, t] + c
        da[:, t] = g * (h[:, t - 1] if t > 0 else first)
        dbx[:, t] = g
        c = a[:, t] * g
    return da, dbx, (None if h0 is None else c)


# ------------------------------------------------------------------- kernels

_P, _I = ctypes.c_void_p, ctypes.c_int
# B, L, W, stream
_GEOM = [_I] * 3 + [_P]
_SIGNATURES = {
    "rglru_fwd": [_P] * 5 + _GEOM,
    "rglru_bwd": [_P] * 8 + _GEOM,
}


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE, "rglru_scan")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, *xs) -> None:
    dev = xs[0].device
    for x in xs:
        if x is None:
            continue
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def _geom(a):
    return [*a.shape, torch.cuda.current_stream(a.device).cuda_stream]


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (code {rc})")


def rglru_linear_scan(a, bx, h0=None):
    """-> (h (B,L,W), hT (B,W)), not differentiable by itself (``ops.rglru``
    wraps it with its backward)."""
    if a.device.type == "cpu":
        return rglru_linear_scan_plain(a, bx, h0)
    check_shapes("rglru_linear_scan", a, bx, h0)
    _check_cuda("rglru_linear_scan", a, bx, h0)
    h = torch.empty_like(a)
    h_t = torch.empty_like(a[:, 0])
    rc = _lib().rglru_fwd(a.data_ptr(), bx.data_ptr(), _ptr(h0), h.data_ptr(),
                          h_t.data_ptr(), *_geom(a))
    _raise_on("rglru_fwd", rc)
    LAUNCHES["rglru_fwd"] += 1
    return h, h_t


def rglru_linear_scan_bwd(a, h, h0, dh, dhT):
    """(da, dbx, dh0) for cotangents dh (B,L,W) and dhT (B,W); dh0 is None
    when h0 is None."""
    if a.device.type == "cpu":
        return rglru_linear_scan_bwd_plain(a, h, h0, dh, dhT)
    check_shapes("rglru_linear_scan_bwd", a, h, h0, dh, dhT)
    _check_cuda("rglru_linear_scan_bwd", a, h, h0, dh, dhT)
    da, dbx = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    rc = _lib().rglru_bwd(a.data_ptr(), h.data_ptr(), _ptr(h0), dh.data_ptr(),
                          dhT.data_ptr(), da.data_ptr(), dbx.data_ptr(),
                          _ptr(dh0), *_geom(a))
    _raise_on("rglru_bwd", rc)
    LAUNCHES["rglru_bwd"] += 1
    return da, dbx, dh0
