#!/usr/bin/env python3
"""Time design variants of three of the port's CUDA kernels on the card, to
pick their tuning constants.

    python3 tools/kernel_variants.py [--out DIR]

Needs one CUDA card and nvcc, as ``chip_smoke.py`` does.

* ``ssd_fwd``: the run of heads of one group that a block takes (a launch
  argument, ``kernel.FWD_HEADS``): 2, 4, 8 and 16 at the mamba2-1.3b cell
  (B 2, nc 32, cl 64, H 64, P 64, N 128) with B and C for its one group and
  per head (G = H).
* ``rglru_bwd``: warps per block and the ring's stages and steps
  (compile-time constants ``BWD_WARPS``, ``STAGES``, ``STEPS``): each
  variant is ``csrc/rglru_scan.cu`` with those constants replaced, built by
  nvcc under ``build/variants/``, at the recurrentgemma-9b cell (B 2, L
  2048, W 4096, no h0).
* ``rglru_fwd``: the forward ring's stages and steps (``FWD_STAGES``,
  ``FWD_STEPS``), built and timed the same way at the same shapes.

Every variant is first held to the plain version (the SSD tolerance 1e-4
abs and rel; RG-LRU bit-equality) and then timed with CUDA events over 20
launches after two warm-ups, each variant twice in turn.  Prints the card
and one JSON object; exits 1 if a variant disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SSD_RUNS = (2, 4, 8, 16)
# (warps per block, stages, steps a stage)
RGLRU_RINGS = ((1, 4, 16), (1, 8, 16), (1, 4, 32), (1, 8, 32), (2, 4, 16),
               (1, 3, 16))
# (stages, steps a stage) of the forward's ring
RGLRU_FWD_RINGS = ((4, 16), (3, 16), (5, 16), (6, 16), (4, 8), (8, 8),
                   (12, 8), (3, 32))


def ssd_variants() -> dict:
    import torch
    from chip_smoke import ssd_inputs, time_ms
    from repro_torch.kernels.ssd_scan import kernel as K

    dev = torch.device("cuda")
    out, default = {}, K.FWD_HEADS
    for grp in (1, 64):
        case = ("cell", 2, 32, 64, 64, grp, 64, 128)
        x, a, bm, cm, _, _ = ssd_inputs(case, dev, seed=0)
        want = K.ssd_intra_chunk_plain(x, a, bm, cm)
        times = {run: [] for run in SSD_RUNS}
        for _ in range(2):
            for run in SSD_RUNS:
                K.FWD_HEADS = run
                got = K.ssd_intra_chunk(x, a, bm, cm)
                for g_, w_ in zip(got, want):
                    if not torch.allclose(g_, w_, atol=1e-4, rtol=1e-4):
                        raise AssertionError(f"ssd_fwd run {run} G {grp} "
                                             "disagrees with its plain version")
                times[run].append(time_ms(
                    lambda: K.ssd_intra_chunk(x, a, bm, cm), 20))
        out[f"G={grp}"] = times
    K.FWD_HEADS = default
    return out


def rglru_variant_lib(consts: dict) -> ctypes.CDLL:
    """``csrc/rglru_scan.cu`` with the compile-time constants in ``consts``
    (name -> value) replaced, built by nvcc under ``build/variants/``."""
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru_scan import kernel as K

    src = K.SOURCE.read_text()
    for name, val in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {val};", src)
        assert n == 1, name
    header = (K.SOURCE.parent / "../../csrc/mma_tf32.cuh").resolve()
    src = src.replace('#include "../../csrc/mma_tf32.cuh"',
                      f'#include "{header}"')
    tag = "_".join(f"{k.lower()}{v}" for k, v in consts.items())
    path = build.BUILD_DIR.parent / "variants" / f"rglru_scan_{tag}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    lib = ctypes.CDLL(str(build.build(path, path.stem)))
    for name in ("rglru_fwd", "rglru_bwd"):
        getattr(lib, name).argtypes = K._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def time_rglru_rings(rings: dict, launch, check) -> dict:
    """Each ring's library (label -> lib) held to its plain version by
    ``check()`` after ``launch(lib)``, then timed, all twice in turn."""
    import torch
    from chip_smoke import time_ms

    times = {label: [] for label in rings}
    for _ in range(2):
        for label, lib in rings.items():
            launch(lib)
            torch.cuda.synchronize()
            if not check():
                raise AssertionError(f"RG-LRU variant {label} is not "
                                     "bit-equal to its plain version")
            times[label].append(time_ms(lambda: launch(lib), 20))
    return times


def rglru_variants() -> dict:
    import torch
    from chip_smoke import RGLRU_CASES, rglru_inputs
    from repro_torch.kernels.rglru_scan import kernel as K

    dev = torch.device("cuda")
    a, bx, h0, dh, dh_t = rglru_inputs(RGLRU_CASES[0], dev, seed=0)
    h_p, h_t_p = K.rglru_linear_scan_plain(a, bx, h0)
    da_p, dbx_p, _ = K.rglru_linear_scan_bwd_plain(a, h_p, h0, dh, dh_t)
    h, h_t = torch.empty_like(a), torch.empty_like(h_t_p)
    da, dbx = torch.empty_like(a), torch.empty_like(a)
    stream = torch.cuda.current_stream().cuda_stream

    def fwd(lib):
        rc = lib.rglru_fwd(a.data_ptr(), bx.data_ptr(), None, h.data_ptr(),
                           h_t.data_ptr(), *a.shape, stream)
        if rc:
            raise RuntimeError(f"rglru_fwd variant launch failed ({rc})")

    def bwd(lib):
        rc = lib.rglru_bwd(a.data_ptr(), h_p.data_ptr(), None, dh.data_ptr(),
                           dh_t.data_ptr(), da.data_ptr(), dbx.data_ptr(),
                           None, *a.shape, stream)
        if rc:
            raise RuntimeError(f"rglru_bwd variant launch failed ({rc})")

    fwd_libs = {f"stages {s}, steps {t}": rglru_variant_lib(
        {"FWD_STAGES": s, "FWD_STEPS": t}) for s, t in RGLRU_FWD_RINGS}
    bwd_libs = {f"warps {w}, stages {s}, steps {t}": rglru_variant_lib(
        {"BWD_WARPS": w, "STAGES": s, "STEPS": t}) for w, s, t in RGLRU_RINGS}
    return {
        "rglru_fwd_ms": time_rglru_rings(
            fwd_libs, fwd,
            lambda: torch.equal(h, h_p) and torch.equal(h_t, h_t_p)),
        "rglru_bwd_ms": time_rglru_rings(
            bwd_libs, bwd,
            lambda: torch.equal(da, da_p) and torch.equal(dbx, dbx_p)),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import gpu_line

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"gpu": gpu_line(), "ssd_fwd_ms": ssd_variants(),
           **rglru_variants()}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "kernel_variants.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(res["gpu"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
