"""Run the RG-LRU forward and backward kernels on the CPU, through an
emulator, and hold them to their plain PyTorch versions bit for bit.

    PYTHONPATH=src python tools/cuda_emu/run_rglru.py [case ...]

A rehearsal for machines without a GPU or nvcc, as ``run_ssd.py`` is for
the SSD kernels: ``csrc/rglru_scan.cu`` rewritten for g++ (``gxx.py``) and
``rglru_fwd`` and ``rglru_bwd`` called with CPU tensors, twice each, their
outputs filled with NaN beforehand so that an entry a kernel leaves
unwritten shows.  Its
``cp.async`` copies land only at the wait that covers them and shared
memory starts as NaN, so a stage read before its wait, or a ring slot
refilled while a lane still reads it, shows as a NaN or a wrong value.
Kernel and plain version round every sum and product alike, so they must
agree to the bit (g++ builds with ``-ffp-contract=off``).  Cases: L no
multiple of a ring's stage, L shorter than one stage or than a ring, L
that wraps both rings several times, W no multiple of 32 or of 4 (4-byte
copies), with and without h0.  Exits 1
if a case disagrees.
"""

from __future__ import annotations

import sys

import torch

from gxx import ROOT, build

sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.rglru_scan import kernel as K  # noqa: E402

CASES = {
    # name: (B, L, W, h0)
    "ragged-l": (2, 53, 64, True),
    "ragged-l-no-h0": (2, 53, 64, False),
    "w200": (2, 100, 200, True),
    "odd-w": (3, 37, 33, True),
    "short": (1, 5, 36, True),
    "one-ring": (1, 64, 32, False),
    "one-step": (1, 1, 8, True),
    "long-ragged": (2, 301, 68, True),
    "long-odd-w-no-h0": (1, 203, 37, False),
}


def nan_like(t):
    return None if t is None else torch.full_like(t, float("nan"))


def ptr(t):
    return None if t is None else t.data_ptr()


def same(got, want) -> bool:
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(got, want))


def max_err(got, want) -> str:
    return ", ".join("none" if y is None else f"{(x - y).abs().max().item():.2g}"
                     for x, y in zip(got, want))


def run_case(lib, name, case) -> bool:
    b, l, w, with_h0 = case
    g = torch.Generator().manual_seed(0)
    a = torch.sigmoid(torch.randn((b, l, w), generator=g))
    bx, h0, dh, dh_t = (torch.randn(shape, generator=g) for shape in
                        ((b, l, w), (b, w), (b, l, w), (b, w)))
    h0 = h0 if with_h0 else None
    fwd_want = K.rglru_linear_scan_plain(a, bx, h0)
    h = fwd_want[0]
    bwd_want = K.rglru_linear_scan_bwd_plain(a, h, h0, dh, dh_t)
    fwd, bwd = [], []
    for _ in range(2):
        got = [nan_like(a), nan_like(a[:, 0])]
        rc = lib.rglru_fwd(ptr(a), ptr(bx), ptr(h0), *map(ptr, got), b, l, w,
                           None)
        fwd.append((rc, got))
        got = [nan_like(a), nan_like(a), nan_like(h0)]
        rc = lib.rglru_bwd(ptr(a), ptr(h), ptr(h0), ptr(dh), ptr(dh_t),
                           *map(ptr, got), b, l, w, None)
        bwd.append((rc, got))
    ok = all(rc == 0 and same(got, fwd_want) for rc, got in fwd) and all(
        rc == 0 and same(got, bwd_want) for rc, got in bwd)
    print(f"{name}: {'ok' if ok else 'FAILED'} (codes "
          f"{[o[0] for o in fwd + bwd]}) max |kernel - plain| h, hT "
          f"{max_err(fwd[0][1], fwd_want)}; da, dbx, dh0 "
          f"{max_err(bwd[0][1], bwd_want)}")
    return ok


def main() -> int:
    names = sys.argv[1:] or list(CASES)
    lib = build(K.SOURCE, "rglru_scan", K._SIGNATURES)
    results = [run_case(lib, name, CASES[name]) for name in names]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
