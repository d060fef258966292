"""Run the flash-attention CUDA kernels on the CPU, through an emulator, and
hold them against their plain PyTorch versions.

    PYTHONPATH=src python tools/cuda_emu/run_flash.py [case ...]

A rehearsal for machines without a GPU or nvcc: it rewrites
``csrc/flash_attention.cu`` and ``csrc/flash_attention_16.cu`` for g++
(``gxx.py``: the inline PTX of ``mma.sync``, ``ldmatrix`` and ``cp.async``
becomes calls into ``cuda_runtime.h`` here, ``<<<...>>>`` launches become
``emu_launch``), builds them into ``build/cuda_emu/`` and calls their C
entry points with CPU tensors: the fp32 trio at each case, then, in bf16
and in fp16, ``flash_delta_16``.  The 16-bit forward and backward
(``flash_fwd_16``, ``flash_bwd_dq_16``, ``flash_bwd_dkv_16``) are ``wgmma``
+ TMA kernels, which have no emulation here (the source leaves them out
under ``CUDA_EMU``): they are checked on the card only.  It checks
indexing, fragment layouts, masks, padded rows, copy groups and barriers at
small shapes; it says nothing about the card's rounding or speed, which
only a run on the card measures.  Exits 1 if a case disagrees.
"""

from __future__ import annotations

import math
import sys

import torch

from gxx import ROOT, build

sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402

TOL = 1e-4  # relative to max(1, max |plain|): the 3xTF32 products
DELTA_TOL = 1e-5  # relative to max |plain|: fp32 sums in another order
CASES = {
    # name: (B, S, T, H, Hkv, D, causal, window, softcap, num_valid)
    "small-mqa": (2, 40, 40, 2, 1, 32, True, None, None, 1),
    "s-lt-t-ragged": (1, 37, 70, 4, 2, 64, True, None, None, None),
    "window-softcap": (1, 96, 96, 2, 1, 32, True, 20, 30.0, None),
    "bidirectional": (1, 33, 33, 2, 2, 32, False, None, None, None),
    "d128": (1, 70, 70, 2, 1, 128, True, None, None, None),
    "d256-padded": (2, 72, 72, 4, 1, 256, True, None, None, 1),
    "local-window": (1, 160, 160, 2, 1, 64, True, 64, None, None),
    "d96-gqa-ragged": (2, 70, 70, 4, 2, 96, True, None, None, 1),
    "d96-window-softcap": (1, 96, 96, 4, 1, 96, True, 20, 30.0, None),
    "d96-mha-s-lt-t": (1, 37, 70, 2, 2, 96, True, None, None, None),
}


def run_case(lib, name, case) -> bool:
    b, s, t, h, hkv, d, causal, window, cap, nv = case
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=g) for shape in
                   ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d),
                    (b, s, h, d)))
    nvt = None if nv is None else torch.tensor(nv, dtype=torch.int32)
    kw = dict(causal=causal, window=window, softcap=cap)
    out_p, lse_p = K.flash_fwd_plain(q, k, v, nvt, **kw)
    delta = (do * out_p).sum(-1).transpose(1, 2).contiguous()
    want = {"out": out_p, "lse": lse_p,
            "dq": K.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, nvt, **kw)}
    want["dk"], want["dv"] = K.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta,
                                                   nvt, **kw)
    got = {key: torch.full(x.shape, float("nan")) for key, x in want.items()}
    heads = [torch.full((b, t, h, d), float("nan")) for _ in range(2)]
    geom = [b, s, t, h, hkv, d, int(causal), int(window or 0),
            float(cap or 0.0), 1.0 / math.sqrt(d), None]
    p = lambda x: x.data_ptr()  # noqa: E731
    nvp = None if nvt is None else p(nvt)
    rcs = [lib.flash_fwd(p(q), p(k), p(v), nvp, p(got["out"]),
                         p(got["lse"]), *geom),
           lib.flash_bwd_dq(p(q), p(k), p(v), p(do), p(lse_p), p(delta), nvp,
                            p(got["dq"]), *geom),
           lib.flash_bwd_dkv(p(q), p(k), p(v), p(do), p(lse_p), p(delta),
                             nvp, p(got["dk"]), p(got["dv"]), p(heads[0]),
                             p(heads[1]), *geom)]
    errs = {key: (got[key] - want[key]).abs().max().item() for key in want}
    ok = not any(rcs) and all(
        err <= TOL * max(1.0, want[key].abs().max().item())
        for key, err in errs.items())
    if nv is not None:
        ok = ok and all(bool((x[nv:] == 0).all()) for x in got.values())
    print(f"{name}: {'ok' if ok else 'FAILED'} (codes {rcs}) "
          + ", ".join(f"{key} {err:.2g}" for key, err in errs.items()))
    return ok


def run_delta16(lib, name, case, dtype) -> bool:
    """``flash_delta_16`` at ``case`` on ``dtype`` inputs (dO, and O from
    the plain forward) against ``flash_delta_plain``."""
    b, s, t, h, hkv, d, causal, window, cap, nv = case
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(shape, generator=g).to(dtype) for shape in
                   ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d),
                    (b, s, h, d)))
    nvt = None if nv is None else torch.tensor(nv, dtype=torch.int32)
    out_p, _ = K.flash_fwd_plain(q, k, v, nvt, causal=causal, window=window,
                                 softcap=cap)
    out_p = out_p.contiguous()  # the raw entries take contiguous tensors
    delta = K.flash_delta_plain(do, out_p)
    got = torch.full(delta.shape, float("nan"))
    rc = lib.flash_delta_16(K._HALF[dtype], do.data_ptr(), out_p.data_ptr(),
                            got.data_ptr(), b, s, h, d, None)
    err = (got - delta).abs().max().item()
    ok = rc == 0 and err <= DELTA_TOL * delta.abs().max().item()
    print(f"{name} {str(dtype)[6:]}: {'ok' if ok else 'FAILED'} (code {rc}) "
          f"delta {err:.2g}")
    return ok


def main() -> int:
    names = sys.argv[1:] or list(CASES)
    lib = build(K.SOURCE, "flash_attention", K._SIGNATURES)
    results = [run_case(lib, name, CASES[name]) for name in names]
    lib16 = build(K.SOURCE_16, "flash_attention_16",
                  {"flash_delta_16": K.SIGNATURES_16["flash_delta_16"]})
    results += [run_delta16(lib16, name, CASES[name], dtype)
                for dtype in (torch.bfloat16, torch.float16)
                for name in names]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
