#!/usr/bin/env python3
"""Time design variants of the port's CUDA kernels on the card, to pick
their tuning constants.

    python3 tools/kernel_variants.py [--flash16 | --flash16-fwd |
                                      --flash16-fwd-probes |
                                      --flash16-fwd-trees TREE ...
                                      [--rounds N]] [--out DIR]

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
* ``--flash16-fwd`` (alone): the 16-bit forward's tile shapes, ring depth,
  P V width, warpgroup schedule, swizzle and softmax (``Fwd16Cfg`` and
  ``fwd_softmax_of``), built the same way from ``FLASH16_FWD_VARIANTS``,
  held to ``flash_fwd_plain`` in bf16 (1e-2 x max, each row within
  ``row_error``'s limit, lse within ``LSE_TOL``) and timed at the
  gemma-2b, llama3-8b, phi-3-vision (D 96) and grok-1 (softcap 30) shapes.
* ``--flash16-fwd-probes`` (alone): the forward with parts taken out
  (``FLASH16_FWD_PROBES``: the softmax and O's rescale, the K/V refills),
  timed at the llama3-8b and gemma-2b shapes to show what each part costs;
  their results are wrong by design, so they are not held to the plain
  version (a probe that fails to build is recorded and the tool exits 1).
* ``--flash16-fwd-trees TREE ...`` (alone): this checkout's 16-bit forward
  against the one in each other checkout (e.g. a ``git archive`` of another
  commit, unpacked under ``build/``), each held to ``flash_fwd_plain`` at
  the gemma-2b, llama3-8b, phi-3-vision and grok-1 shapes, then timed
  through ``chip_smoke.time_kernels`` in turn, ``--rounds`` times: every
  reading of the profiler's device ms and of CUDA events kept.

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


# variant -> text replacements of csrc/flash_attention_16.cu for the
# forward ("chosen" is the source as it stands): its tiles, ring, P V width,
# warpgroup schedule, swizzle and softmax
FWD_CFG = {
    "bq": "static constexpr int BQ = 128;                  // query rows of a block",
    "bk": "static constexpr int BK = D <= 128 ? 128 : 64;  // keys of a K/V tile",
    "stages": "static constexpr int STAGES = 2;                // K/V tiles in the ring",
    "rs": "static constexpr int RS_N = D;                  // columns of a P V wgmma",
    "swizzle": "static constexpr int SW = D % 64 == 0 ? 128 : 64;",
}
# the warpgroups issue their products as they come, without turns
_LOCKSTEP = [
    ("void turn_begin(int wg) { named_sync(1 + wg, 256); }",
     "void turn_begin(int wg) {}"),
    ("  if (!(wg == 1 && last)) named_arrive(2 - wg, 256);\n", ""),
    ("  if (wg == 1) named_arrive(1, 256);  // warpgroup 0 goes first\n", "")]
# P_{i-1} V_{i-1} issued before S_i, both stages released before S_i's
# softmax (which then runs under no product of its warpgroup)
_PV_FIRST = [(
    "    // S_i, then P_{i-1} V_{i-1}, which runs under S_i's softmax\n"
    "    fwd_qk<T, D, BQ, BK, SW>(s, q_base, k0_base + st * C::kv_bytes);\n"
    "    wg_commit();\n"
    "    rs_product<T, D, BK, C::RS_N, SW>(o, pf, v0_base + prev * C::kv_bytes);\n"
    "    wg_commit();\n"
    "    turn_end(wg, false);\n"
    "    wg_wait<1>();  // S_i has landed; P_{i-1} V_{i-1} may still run\n"
    "    release(&tm_k, Ks, k_full, k_empty, i);\n"
    "    fence_regs(s);\n"
    "    fwd_softmax<BK>(s, m, l, alpha, whole, qrow, k_first, g);\n"
    "    wg_wait<0>();\n"
    "    release(&tm_v, Vs, v_full, v_empty, i - 1);\n",
    "    rs_product<T, D, BK, C::RS_N, SW>(o, pf, v0_base + prev * C::kv_bytes);\n"
    "    wg_commit();\n"
    "    fwd_qk<T, D, BQ, BK, SW>(s, q_base, k0_base + st * C::kv_bytes);\n"
    "    wg_commit();\n"
    "    turn_end(wg, false);\n"
    "    wg_wait<1>();\n"
    "    release(&tm_v, Vs, v_full, v_empty, i - 1);\n"
    "    wg_wait<0>();\n"
    "    release(&tm_k, Ks, k_full, k_empty, i);\n"
    "    fence_regs(s);\n"
    "    fwd_softmax<BK>(s, m, l, alpha, whole, qrow, k_first, g);\n")]
FLASH16_FWD_VARIANTS = {
    "chosen": [],
    "64-byte swizzle (32-column atoms)": [
        (FWD_CFG["swizzle"], "static constexpr int SW = 64;")],
    "P V first, stages released before the softmax": _PV_FIRST,
    "warpgroups in lockstep (no turns)": _LOCKSTEP,
    "one warpgroup, 64-row q tiles": _LOCKSTEP + [
        (FWD_CFG["bq"], "static constexpr int BQ = 64;")],
    "64-key tiles at D 96, 128": [
        (FWD_CFG["bk"], "static constexpr int BK = D <= 64 ? 128 : 64;")],
    "ring of 3 stages up to D 128": [
        (FWD_CFG["stages"], "static constexpr int STAGES = D <= 128 ? 3 : 2;")],
    "P V of 64 columns a wgmma": [
        (FWD_CFG["rs"], "static constexpr int RS_N = D % 64 ? 32 : 64;")],
    "P V of 32 columns a wgmma, 64-byte swizzle (PR 30's)": [
        (FWD_CFG["rs"], "static constexpr int RS_N = 32;"),
        (FWD_CFG["swizzle"], "static constexpr int SW = 64;")],
    "P V of 128 columns at D 256": [
        (FWD_CFG["rs"], "static constexpr int RS_N = D == 256 ? 128 : D;")],
    "softmax tests softcap and mask per element": [
        ("const float f = CAP ? 1.f : g.sm_scale * LOG2E;",
         "const float f = g.softcap > 0.f ? 1.f : g.sm_scale * LOG2E;"),
        ("    if constexpr (CAP)\n      x = g.softcap",
         "    if (g.softcap > 0.f)\n      x = g.softcap"),
        ("if (MASK && !pair_visible(qrow", "if (!pair_visible(qrow")],
    "exp2f for the exponentials": [
        ("const float p = ex2(fmaf(s[e], f, -m[hh]));",
         "const float p = exp2f(fmaf(s[e], f, -m[hh]));"),
        ("alpha[hh] = ex2(m[hh] - m_cur);", "alpha[hh] = exp2f(m[hh] - m_cur);")],
}
# (label, B, S, H, Hkv, D, softcap), causal, S = T
FLASH16_FWD_SHAPES = (("gemma", 2, 1024, 8, 1, 256, None),
                      ("llama3", 2, 2048, 32, 8, 128, None),
                      ("phi3", 2, 1024, 32, 32, 96, None),
                      ("grok-softcap", 2, 1024, 48, 8, 128, 30.0))


# probes of the forward (``--flash16-fwd-probes``): text replacements that
# take work out of the kernel (the softmax, the O rescale, the K/V
# refills), so that their results are wrong by design; they are timed, not
# held to the plain version, to show what each part of the kernel costs
_NO_SOFTMAX = ("fwd_softmax<BK>(s, m, l, alpha, whole, qrow, k_first, g);", "")
_NO_RESCALE = (
    "      for (int e = 0; e < 16; ++e) o[a][e] *= alpha[(e >> 1) & 1];",
    "      for (int e = 0; e < 16; ++e) o[a][e] += 0.f;")
_NO_REFILLS = [  # the ring's first tiles only, read again for every tile
    ("    mbar_wait(&k_full[st], (i / ST) & 1);\n"
     "    mbar_wait(&v_full[prev], ((i - 1) / ST) & 1);",
     "    if (i < ST) mbar_wait(&k_full[st], 0);\n"
     "    if (i - 1 < ST) mbar_wait(&v_full[prev], 0);"),
    ("  mbar_wait(&v_full[(n - 1) % ST], ((n - 1) / ST) & 1);",
     "  if (n - 1 < ST) mbar_wait(&v_full[(n - 1) % ST], 0);"),
    ("    if (loader && i + ST < n) {", "    if (false) {")]
FLASH16_FWD_PROBES = {
    "chosen": [],
    "no softmax, no O rescale": [_NO_SOFTMAX, _NO_RESCALE],
    "no K/V refills": _NO_REFILLS,
    "no K/V refills, no softmax, no O rescale": _NO_REFILLS + [_NO_SOFTMAX,
                                                               _NO_RESCALE],
}


def flash16_variant_libs(variants: dict, tag: str) -> dict:
    """Each entry of ``variants`` (label -> text replacements) built (in
    parallel, as ``build/variants/<tag>_v<i>.cu``) and loaded."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as K

    src = K.SOURCE_16.read_text()
    for inc in ("../../csrc/mma_16.cuh", "flash_common.cuh"):
        src = src.replace(f'#include "{inc}"',
                          f'#include "{(K.SOURCE_16.parent / inc).resolve()}"')
    paths = {}
    for i, (label, reps) in enumerate(variants.items()):
        text = src
        for old, new in reps:
            assert old in text, (label, old)
            text = text.replace(old, new)
        path = build.BUILD_DIR.parent / "variants" / f"{tag}_v{i}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        paths[label] = path
    return build_libs16(paths)


def build_libs16(paths: dict) -> dict:
    """Each 16-bit flash source in ``paths`` (label -> .cu) built by nvcc in
    parallel (as ``<stem>``) and loaded with the 16-bit entries' signatures;
    a source that fails to build maps to the tail of its error instead."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as K

    def build_one(path):
        try:
            return build.build(path, path.stem)
        except RuntimeError as e:  # recorded; main exits 1
            return str(e)[-2000:]

    with ThreadPoolExecutor(len(paths)) as pool:
        built = dict(zip(paths, pool.map(build_one, paths.values())))
    libs = {}
    for label, path in built.items():
        if isinstance(path, str):
            libs[label] = path
            continue
        lib = ctypes.CDLL(str(path))
        for name, argtypes in K.SIGNATURES_16.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs[label] = lib
    return libs


def ptxas_lines(log: str, frag: str) -> list:
    """ptxas's registers, spills and shared memory lines for each entry
    function whose (mangled) name holds ``frag``, from ``-Xptxas -v``."""
    out, take = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            take = frag in line
            if take:
                out.append(line.split("'")[1][:80])
        elif take and ("Used" in line or "spill" in line
                       or "arning" in line):
            out.append(line.split(":", 1)[-1].strip())
    return out


def flash16_variants() -> dict:
    import torch
    from chip_smoke import FLASH16, HALF_TOL, device_ms, time_ms
    from repro_torch.kernels.flash_attention import kernel as K

    dev = torch.device("cuda")
    libs = flash16_variant_libs(FLASH16_VARIANTS, "flash16")
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
                    rec = out[label].setdefault(label_s, {})
                    if isinstance(lib, str):
                        rec["build_disagrees"] = lib
                        continue
                    K._lib16 = lambda lib=lib: lib
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


def flash16_fwd_variants() -> dict:
    import torch
    from chip_smoke import FLASH16, HALF_TOL, device_ms, time_ms
    from repro_torch.kernels.flash_attention import kernel as K

    dev = torch.device("cuda")
    from repro_torch.kernels import build

    libs = flash16_variant_libs(FLASH16_FWD_VARIANTS, "flash16_fwd")
    chosen = K._lib16
    out = {label: {"ptxas": ptxas_lines(build.BUILD_LOG.get(
        f"flash16_fwd_v{i}", ""), "fwd16_kernel")}
        for i, label in enumerate(libs)}
    try:
        for rnd in range(2):
            for label_s, b, s, h, hkv, d, cap in FLASH16_FWD_SHAPES:
                g = torch.Generator(device=dev).manual_seed(0)
                q, k, v = (torch.randn(x, generator=g, device=dev)
                           .to(torch.bfloat16)
                           for x in ((b, s, h, d), (b, s, hkv, d),
                                     (b, s, hkv, d)))
                want, lse_w = K.flash_fwd_plain(q, k, v, softcap=cap)

                def fn():
                    return K.flash_fwd(q, k, v, softcap=cap)

                for label, lib in libs.items():
                    rec = out[label].setdefault(label_s, {})
                    if isinstance(lib, str):
                        rec["build_disagrees"] = lib
                        continue
                    K._lib16 = lambda lib=lib: lib
                    if rnd == 0:
                        got, lse = fn()
                        err = (got.float() - want.float()).abs().max().item()
                        lse_err = (lse - lse_w).abs().max().item()
                        rec["max_abs_err"] = err
                        rec["row_error"] = K.row_error(got, want)
                        if not (err <= HALF_TOL * want.float().abs().max()
                                .item() and rec["row_error"] <= 1
                                and lse_err <= K.LSE_TOL
                                * lse_w.abs().max().item()):
                            # recorded and left untimed; main exits 1
                            rec["flash_fwd_disagrees"] = err
                    if "flash_fwd_disagrees" in rec:
                        continue
                    rec.setdefault("ms", []).append(time_ms(fn, 20))
                    rec.setdefault("device_ms", []).append(
                        device_ms(fn, FLASH16["flash_fwd_16"]))
    finally:
        K._lib16 = chosen
    return out


def flash16_fwd_probes() -> dict:
    """Each ``FLASH16_FWD_PROBES`` entry's device ms at the llama3-8b and
    gemma-2b shapes, twice in turn, and its largest error against the
    plain version (large by design, but for "chosen")."""
    import torch
    from chip_smoke import FLASH16, device_ms
    from repro_torch.kernels.flash_attention import kernel as K

    dev = torch.device("cuda")
    libs = flash16_variant_libs(FLASH16_FWD_PROBES, "flash16_probe")
    chosen = K._lib16
    out = {label: {} for label in libs}
    try:
        for rnd in range(2):
            for label_s, b, s, h, hkv, d, cap in FLASH16_FWD_SHAPES[:2]:
                g = torch.Generator(device=dev).manual_seed(0)
                q, k, v = (torch.randn(x, generator=g, device=dev)
                           .to(torch.bfloat16)
                           for x in ((b, s, h, d), (b, s, hkv, d),
                                     (b, s, hkv, d)))
                want = K.flash_fwd_plain(q, k, v)[0].float() if rnd == 0 \
                    else None

                def fn():
                    return K.flash_fwd(q, k, v)

                for label, lib in libs.items():
                    rec = out[label].setdefault(label_s, {})
                    if isinstance(lib, str):
                        rec["build_failed"] = lib
                        continue
                    K._lib16 = lambda lib=lib: lib
                    if rnd == 0:
                        rec["max_abs_err"] = (fn()[0].float() - want).abs() \
                            .max().item()
                    rec.setdefault("device_ms", []).append(
                        device_ms(fn, FLASH16["flash_fwd_16"]))
    finally:
        K._lib16 = chosen
    return out


# (label, B, S, T, H, Hkv, D, window, softcap) of ``chip_smoke.FLASH_TIMED``
# that ``--flash16-fwd-trees`` times: gemma's, llama3-8b's, phi-3's, grok's
def _tree_shapes():
    from chip_smoke import FLASH_TIMED, FLASH_TIMED_16

    return [FLASH_TIMED_16[0], FLASH_TIMED_16[1], FLASH_TIMED[2],
            FLASH_TIMED[3]]


def flash16_fwd_trees(trees: list, rounds: int) -> dict:
    """The 16-bit forward of this checkout ("this tree") against the same
    entry built from each other tree (a checkout's root, its own
    ``src/repro_torch/kernels``), in turn ``rounds`` times (the trees'
    order reversed every other round) through ``chip_smoke.time_kernels``
    in bf16 at ``_tree_shapes()``: every reading of ``flash_fwd_16``'s
    device ms (the profiler's) and events ms, SDPA's default call's device
    ms beside them, and each tree's largest error, row error and lse error
    against ``flash_fwd_plain`` (a tree that disagrees is recorded and
    left untimed)."""
    import torch
    from chip_smoke import HALF_TOL, peaks, time_kernels
    from repro_torch.kernels.flash_attention import kernel as K

    rel = K.SOURCE_16.relative_to(ROOT)
    paths = {"this tree": K.SOURCE_16}
    for i, tree in enumerate(trees):
        src = Path(tree).resolve() / rel
        # a copy named apart, beside the tree's own headers
        path = src.with_name(f"flash16_tree{i}.cu")
        path.write_text(src.read_text())
        paths[str(tree)] = path
    libs = build_libs16(paths)
    peak = peaks(torch.cuda.get_device_name(0))[1]
    chosen = K._lib16
    out = {label: {} for label in libs}
    dev = torch.device("cuda")
    try:
        for shape in _tree_shapes():  # each tree held to the plain version
            label_s, b, s, t, h, hkv, d, window, cap = shape
            g = torch.Generator(device=dev).manual_seed(0)
            q, k, v = (torch.randn(x, generator=g, device=dev)
                       .to(torch.bfloat16)
                       for x in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d)))
            want, lse_w = K.flash_fwd_plain(q, k, v, softcap=cap)
            for label, lib in libs.items():
                rec = out[label].setdefault(label_s, {})
                if isinstance(lib, str):
                    rec["build_failed"] = lib
                    continue
                K._lib16 = lambda lib=lib: lib
                got, lse = K.flash_fwd(q, k, v, softcap=cap)
                err = (got.float() - want.float()).abs().max().item()
                rec["max_abs_err"] = err
                rec["row_error"] = K.row_error(got, want)
                rec["lse_err"] = (lse - lse_w).abs().max().item()
                if not (err <= HALF_TOL * want.float().abs().max().item()
                        and rec["row_error"] <= 1
                        and rec["lse_err"] <= K.LSE_TOL
                        * lse_w.abs().max().item()):
                    rec["flash_fwd_disagrees"] = err  # main exits 1
        for rnd in range(rounds):
            order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
            for shape in _tree_shapes():
                for label in order:
                    rec = out[label][shape[0]]
                    if "build_failed" in rec or "flash_fwd_disagrees" in rec:
                        continue
                    K._lib16 = lambda lib=libs[label]: lib
                    tm = time_kernels(peak, {}, shape,
                                      dtype="bfloat16")["flash_fwd_16"]
                    for key in ("device_ms", "ms", "sdpa_default_device_ms"):
                        rec.setdefault(key, []).append(tm[key])
                    rec["bound_ms"] = tm["bound_ms"]
    finally:
        K._lib16 = chosen
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--flash16", action="store_true",
                      help="time the 16-bit flash backward's variants alone")
    what.add_argument("--flash16-fwd", action="store_true",
                      help="time the 16-bit flash forward's variants alone")
    what.add_argument("--flash16-fwd-probes", action="store_true",
                      help="time the 16-bit forward with parts taken out")
    what.add_argument("--flash16-fwd-trees", nargs="+", metavar="TREE",
                      help="time the 16-bit forward against other "
                           "checkouts' (their roots), in turn")
    ap.add_argument("--rounds", type=int, default=3,
                    help="turns of --flash16-fwd-trees")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import gpu_line

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.flash16_fwd_trees:
        res = {"gpu": gpu_line(), "flash16_fwd_trees": flash16_fwd_trees(
            args.flash16_fwd_trees, args.rounds)}
        name = "kernel_variants_flash16_fwd_trees.json"
        bad = sorted(f"{label} at {shape}: {k}"
                     for label, shapes in res["flash16_fwd_trees"].items()
                     for shape, rec in shapes.items()
                     for k in rec if k in ("build_failed",
                                           "flash_fwd_disagrees"))
    elif args.flash16_fwd_probes:
        res = {"gpu": gpu_line(), "flash16_fwd_probes": flash16_fwd_probes()}
        name = "kernel_variants_flash16_fwd_probes.json"
        bad = sorted(f"{label}: {rec['build_failed'][-300:]}"
                     for label, shapes in res["flash16_fwd_probes"].items()
                     for rec in shapes.values() if "build_failed" in rec)
    elif args.flash16 or args.flash16_fwd:
        key = "flash16" if args.flash16 else "flash16_fwd"
        sweep = flash16_variants if args.flash16 else flash16_fwd_variants
        res = {"gpu": gpu_line(), key: sweep()}
        name = f"kernel_variants_{key}.json"
        bad = sorted(f"{label} at {shape}: {k}"
                     for label, shapes in res[key].items()
                     for shape, rec in shapes.items() if shape != "ptxas"
                     for k in rec if k.endswith("_disagrees"))
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
