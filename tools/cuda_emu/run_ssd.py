"""Run the SSD intra-chunk CUDA kernels on the CPU, through an emulator, and
hold them against their plain PyTorch versions.

    PYTHONPATH=src python tools/cuda_emu/run_ssd.py [case ...]

A rehearsal for machines without a GPU or nvcc, as ``run_flash.py`` is for
the flash kernels: ``csrc/ssd_scan.cu`` rewritten for g++ (``gxx.py``) and
called with CPU tensors, its outputs filled with NaN beforehand so that an
entry the kernel leaves unwritten shows.  The emulator reports three SMs,
so the persistent ``ssd_bwd`` walks several (b, c, h) items a block and
both stages of its B and C buffers; ``ssd_fwd`` runs at its own run of
heads and at a run of 2 (so that every head passes through all three X
stages even at small H), and each kernel is launched twice to check that
it repeats bit for bit.  Checks indexing, fragment layouts,
the lower-triangle tiles, ragged and padded tiles, copy groups and barriers
at small shapes; it says nothing about the card's rounding or speed.
Exits 1 if a case disagrees.
"""

from __future__ import annotations

import sys

import torch

from gxx import ROOT, build

sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.ssd_scan import kernel as K  # noqa: E402

TOL = 1e-4  # forward abs and rel; backward x max |plain| (the 3xTF32 products)
CASES = {
    # name: (B, nc, cl, H, G, P, N, shift of a); G groups of B and C (G == H:
    # per head); a shift of -40 makes every exp above the diagonal overflow,
    # and dA the difference of equal terms (rounding noise near 1e-17 on
    # both sides), so there dA is only held to be finite
    "cell-tiles": (1, 2, 64, 3, 3, 64, 128, 0.0),
    "ragged": (1, 3, 40, 3, 3, 20, 12, 0.0),
    "odd-p-n": (1, 2, 13, 3, 3, 7, 9, 0.0),
    "chunk16": (2, 2, 16, 2, 2, 16, 8, 0.0),
    "one-step": (1, 1, 1, 1, 1, 1, 1, 0.0),
    "steep-decay": (1, 2, 64, 2, 2, 16, 8, -40.0),
    # B and C per group: one group of 12 heads (a run of 8, then of 4), two
    # groups of 3 at ragged cl, P and N, 4-byte copies, one step, steep decay
    "g1": (1, 2, 64, 12, 1, 64, 128, 0.0),
    "g2-ragged": (1, 2, 40, 6, 2, 20, 12, 0.0),
    "g3-odd": (1, 1, 13, 6, 3, 7, 9, 0.0),
    "g1-one-step": (1, 1, 1, 2, 1, 1, 1, 0.0),
    "g1-steep-decay": (1, 2, 64, 4, 1, 16, 8, -40.0),
}


def run_case(lib, name, case) -> bool:
    b, nc, cl, h, grp, p, n, shift = case
    g = torch.Generator().manual_seed(0)
    x = torch.randn((b, nc, cl, h, p), generator=g)
    a = -torch.randn((b, nc, cl, h), generator=g).abs() * 0.1 + shift
    bm, cm = (torch.randn((b, nc, cl, grp, n), generator=g) for _ in range(2))
    dy = torch.randn((b, nc, cl, h, p), generator=g)
    ds = torch.randn((b, nc, h, p, n), generator=g)
    want = dict(zip(("y", "state"), K.ssd_intra_chunk_plain(x, a, bm, cm)))
    want.update(zip(("dx", "da", "db", "dc"),
                    K.ssd_intra_chunk_bwd_plain(x, a, bm, cm, dy, ds)))
    # the kernel writes db and dc per head, as the wrapper has it do, and
    # their sums over each group's heads are compared
    shapes = {k: v.shape for k, v in want.items()}
    shapes["db"] = shapes["dc"] = (b, nc, cl, h, n)

    def nans(keys):
        return {k: torch.full(shapes[k], float("nan")) for k in keys}

    fwd_keys, bwd_keys = ("y", "state"), ("dx", "da", "db", "dc")
    runs = [nans(fwd_keys) for _ in range(3)]
    bwds = [nans(bwd_keys) for _ in range(2)]
    geom = [b, nc, cl, h, grp, p, n, None]
    ptr = lambda t: t.data_ptr()  # noqa: E731
    ins = [ptr(t) for t in (x, a, bm, cm)]
    rcs = [lib.ssd_fwd(*ins, ptr(out["y"]), ptr(out["state"]), run, *geom)
           for out, run in zip(runs, (K.FWD_HEADS, K.FWD_HEADS, 2))]
    for out in bwds:
        rcs.append(lib.ssd_bwd(*ins, ptr(dy), ptr(ds),
                               *(ptr(out[k]) for k in bwd_keys), *geom))
        out["db"], out["dc"] = (K._per_group(out[k], grp) for k in ("db",
                                                                    "dc"))
    got = {**runs[0], **bwds[0]}
    errs, ok = {}, not any(rcs)
    errs["y run 2"] = (runs[2]["y"] - want["y"]).abs().max().item()
    errs["state run 2"] = (runs[2]["state"] - want["state"]).abs().max().item()
    ok = ok and all(torch.allclose(runs[2][k], want[k], atol=TOL, rtol=TOL)
                    for k in fwd_keys)
    for key, ref in want.items():
        errs[key] = (got[key] - ref).abs().max().item()
        ok = ok and bool(torch.isfinite(got[key]).all())
        if key == "da" and shift:
            continue
        if key in ("y", "state"):
            ok = ok and torch.allclose(got[key], ref, atol=TOL, rtol=TOL)
        else:
            ok = ok and errs[key] <= TOL * ref.abs().max().item()
    repeats = (all(torch.equal(runs[0][k], runs[1][k]) for k in fwd_keys)
               and all(torch.equal(bwds[0][k], bwds[1][k]) for k in bwd_keys))
    ok = ok and repeats
    print(f"{name}: {'ok' if ok else 'FAILED'} (codes {rcs}) "
          + ", ".join(f"{key} {err:.2g}" for key, err in errs.items())
          + f", repeats bit for bit {repeats}")
    return ok


def main() -> int:
    names = sys.argv[1:] or list(CASES)
    lib = build(K.SOURCE, "ssd_scan", K._SIGNATURES)
    results = [run_case(lib, name, CASES[name]) for name in names]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
