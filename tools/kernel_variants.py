#!/usr/bin/env python3
"""Time design variants of the port's CUDA kernels on the card, to pick
their tuning constants.

    python3 tools/kernel_variants.py [--flash16] [--out DIR]

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
* ``--flash16`` (alone): the 16-bit backward's tile shapes, ring depths
  and GQA splits (``Dq16Cfg``, ``Dkv16Cfg`` and ``dkv16_splits`` in
  ``csrc/flash_attention_16.cu``): each variant is the source with
  ``FLASH16_VARIANTS``' text replacements, built by nvcc under
  ``build/variants/`` in parallel, held to the plain versions in bf16 at
  the gemma-2b, llama3-8b and phi-3-vision shapes (1e-2 x max), then timed
  at those shapes by CUDA events and by torch.profiler's device time.

Every variant is first held to the plain version (the SSD tolerance 1e-4
abs and rel; RG-LRU bit-equality; flash 1e-2 x max) and then timed with CUDA events over 20
launches after two warm-ups, each variant twice in turn (a flash variant
that disagrees is recorded and left untimed).  Prints the card and one JSON
object; exits 1 if a variant disagrees.
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


# variant -> text replacements of csrc/flash_attention_16.cu ("chosen" is the
# source as it stands): the backward's tile shapes (dq's key tile, both
# rings' depth) and how the dk/dv launcher splits the GQA groups
FLASH16_VARIANTS = {
    "chosen": [],
    "dq two warpgroups and 128-key tiles at D 96": [
        ("static constexpr int NWG = D == 128 ? 2 : 1;    // consumer warpgroups",
         "static constexpr int NWG = D == 128 || D == 96 ? 2 : 1;"),
        ("static constexpr int MINB = D <= 96 ? 2 : 1;    // blocks an SM",
         "static constexpr int MINB = D <= 64 ? 2 : 1;"),
        ("static constexpr int BK = D == 128 ? 128 : 64;  // keys of a K/V tile",
         "static constexpr int BK = D == 128 || D == 96 ? 128 : 64;")],
    "dq one warpgroup, 64-key tiles, two blocks an SM at D 128": [
        ("static constexpr int NWG = D == 128 ? 2 : 1;    // consumer warpgroups",
         "static constexpr int NWG = 1;"),
        ("static constexpr int MINB = D <= 96 ? 2 : 1;    // blocks an SM",
         "static constexpr int MINB = D <= 128 ? 2 : 1;"),
        ("static constexpr int BK = D == 128 ? 128 : 64;  // keys of a K/V tile",
         "static constexpr int BK = 64;")],
    "dk/dv two warpgroups a block at D 96, 128": [
        ("static constexpr int NWG = ROLES || D <= 64 ? 2 : 1;  // consumer warpgroups",
         "static constexpr int NWG = 2;")],
    "dk/dv one warpgroup a block at D <= 64": [
        ("static constexpr int NWG = ROLES || D <= 64 ? 2 : 1;  // consumer warpgroups",
         "static constexpr int NWG = ROLES ? 2 : 1;")],
    "dk/dv ring of 3 Q/dO stages at D 96, 128": [
        ("static constexpr int STAGES = NWG == 2 && !ROLES ? 3 : 2;  // ring's tiles",
         "static constexpr int STAGES = ROLES ? 2 : 3;")],
    "dQ, dK, dV wgmmas of 32 columns": [
        ("static constexpr int RS_N = rs_width<D>();      // columns of a dQ wgmma",
         "static constexpr int RS_N = 32;"),
        ("static constexpr int RS_N = rs_width<D>();    // columns of a dK, dV wgmma",
         "static constexpr int RS_N = 32;")],
    "dk/dv splits filling twice the SMs": [
        ("while (s < rep && (rep % s || blocks * s < sms)) ++s;",
         "while (s < rep && (rep % s || blocks * s < 2 * sms)) ++s;")],
}
FLASH16_SHAPES = (("gemma", 2, 1024, 8, 1, 256), ("llama3", 2, 2048, 32, 8, 128),
                  ("phi3", 2, 1024, 32, 32, 96), ("d64", 2, 2048, 32, 8, 64))


def flash16_variant_libs() -> dict:
    """Each ``FLASH16_VARIANTS`` entry built (in parallel) and loaded."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as K

    src = K.SOURCE_16.read_text()
    for inc in ("../../csrc/mma_16.cuh", "flash_common.cuh"):
        src = src.replace(f'#include "{inc}"',
                          f'#include "{(K.SOURCE_16.parent / inc).resolve()}"')
    paths = {}
    for i, (label, reps) in enumerate(FLASH16_VARIANTS.items()):
        text = src
        for old, new in reps:
            assert old in text, (label, old)
            text = text.replace(old, new)
        path = build.BUILD_DIR.parent / "variants" / f"flash16_v{i}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        paths[label] = path
    with ThreadPoolExecutor(len(paths)) as pool:
        built = dict(zip(paths, pool.map(lambda p: build.build(p, p.stem),
                                         paths.values())))
    libs = {}
    for label, path in built.items():
        lib = ctypes.CDLL(str(path))
        for name, argtypes in K.SIGNATURES_16.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs[label] = lib
    return libs


def flash16_variants() -> dict:
    import torch
    from chip_smoke import FLASH16, HALF_TOL, device_ms, time_ms
    from repro_torch.kernels.flash_attention import kernel as K

    dev = torch.device("cuda")
    libs = flash16_variant_libs()
    chosen = K._lib16
    out = {label: {} for label in libs}
    try:
        for rnd in range(2):
            for label_s, b, s, h, hkv, d in FLASH16_SHAPES:
                g = torch.Generator(device=dev).manual_seed(0)
                q, k, v, do = (torch.randn(x, generator=g, device=dev)
                               .to(torch.bfloat16)
                               for x in ((b, s, h, d), (b, s, hkv, d),
                                         (b, s, hkv, d), (b, s, h, d)))
                out_p, lse = K.flash_fwd_plain(q, k, v)
                delta = K.flash_delta_plain(do, out_p)
                want = {"flash_fwd": out_p,
                        "flash_bwd_dq": K.flash_bwd_dq_plain(q, k, v, do, lse,
                                                             delta),
                        "flash_bwd_dkv": torch.cat([x.flatten() for x in
                                                    K.flash_bwd_dkv_plain(
                                                        q, k, v, do, lse,
                                                        delta)])}
                calls = {
                    "flash_fwd": lambda: K.flash_fwd(q, k, v)[0],
                    "flash_bwd_dq": lambda: K.flash_bwd_dq(q, k, v, do, lse,
                                                           delta),
                    "flash_bwd_dkv": lambda: torch.cat(
                        [x.flatten() for x in K.flash_bwd_dkv(
                            q, k, v, do, lse, delta)])}
                for label, lib in libs.items():
                    K._lib16 = lambda lib=lib: lib
                    rec = out[label].setdefault(label_s, {})
                    for name, fn in calls.items():
                        if rnd == 0:
                            err = (fn().float() - want[name].float()).abs() \
                                .max().item()
                            if not err <= HALF_TOL * want[name].float() \
                                    .abs().max().item():
                                # recorded and left untimed; main exits 1
                                rec[f"{name}_disagrees"] = err
                        if f"{name}_disagrees" in rec:
                            continue
                        rec.setdefault(f"{name}_ms", []).append(
                            time_ms(fn, 20))
                        rec.setdefault(f"{name}_device_ms", []).append(
                            device_ms(fn, FLASH16[f"{name}_16"]))
    finally:
        K._lib16 = chosen
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    ap.add_argument("--flash16", action="store_true",
                    help="time the 16-bit flash kernels' variants alone")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import gpu_line

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.flash16:
        res = {"gpu": gpu_line(), "flash16": flash16_variants()}
        name = "kernel_variants_flash16.json"
        bad = sorted(f"{label} at {shape}: {key}"
                     for label, shapes in res["flash16"].items()
                     for shape, rec in shapes.items()
                     for key in rec if key.endswith("_disagrees"))
    else:
        res = {"gpu": gpu_line(), "ssd_fwd_ms": ssd_variants(),
               **rglru_variants()}
        name = "kernel_variants.json"
        bad = []
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(res, f, indent=1)
    print(res["gpu"])
    print(json.dumps(res))
    if bad:
        print("variants that disagree with the plain versions: "
              + "; ".join(bad), file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
