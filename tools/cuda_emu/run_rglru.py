"""Run the RG-LRU backward kernel on the CPU, through an emulator, and hold
it to its plain PyTorch version bit for bit.

    PYTHONPATH=src python tools/cuda_emu/run_rglru.py [case ...]

A rehearsal for machines without a GPU or nvcc, as ``run_ssd.py`` is for
the SSD kernels: ``csrc/rglru_scan.cu`` rewritten for g++ (``gxx.py``) and
``rglru_bwd`` called with CPU tensors, its outputs filled with NaN
beforehand so that an entry the kernel leaves unwritten shows.  Its
``cp.async`` copies land only at the wait that covers them and shared
memory starts as NaN, so a stage read before its wait, or a ring slot
refilled while a lane still reads it, shows as a NaN or a wrong value.
Kernel and plain version round every sum and product alike, so they must
agree to the bit (g++ builds with ``-ffp-contract=off``).  Cases: L no
multiple of the ring's stage, L shorter than one stage or than the ring,
W no multiple of 32 or of 4 (4-byte copies), with and without h0.  Exits 1
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
}


def run_case(lib, name, case) -> bool:
    b, l, w, with_h0 = case
    g = torch.Generator().manual_seed(0)
    a = torch.sigmoid(torch.randn((b, l, w), generator=g))
    h, h0, dh, dh_t = (torch.randn(shape, generator=g) for shape in
                       ((b, l, w), (b, w), (b, l, w), (b, w)))
    h0 = h0 if with_h0 else None
    want = K.rglru_linear_scan_bwd_plain(a, h, h0, dh, dh_t)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    outs = []
    for _ in range(2):
        got = [torch.full_like(a, float("nan")), torch.full_like(a, float("nan")),
               None if h0 is None else torch.full_like(h0, float("nan"))]
        rc = lib.rglru_bwd(ptr(a), ptr(h), ptr(h0), ptr(dh), ptr(dh_t),
                           *map(ptr, got), b, l, w, None)
        outs.append((rc, got))
    ok = True
    for rc, got in outs:
        ok = ok and rc == 0 and all(
            (x is None and y is None) or torch.equal(x, y)
            for x, y in zip(got, want))
    errs = [("none" if y is None else f"{(x - y).abs().max().item():.2g}")
            for x, y in zip(outs[0][1], want)]
    print(f"{name}: {'ok' if ok else 'FAILED'} (codes {[o[0] for o in outs]})"
          f" max |kernel - plain| da {errs[0]}, dbx {errs[1]}, dh0 {errs[2]}")
    return ok


def main() -> int:
    names = sys.argv[1:] or list(CASES)
    lib = build(K.SOURCE, "rglru_scan", K._SIGNATURES)
    results = [run_case(lib, name, CASES[name]) for name in names]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
