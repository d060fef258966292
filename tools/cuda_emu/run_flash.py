"""Run the flash-attention CUDA kernels on the CPU, through an emulator, and
hold them against their plain PyTorch versions.

    PYTHONPATH=src python tools/cuda_emu/run_flash.py [case ...]

A rehearsal for machines without a GPU or nvcc: it rewrites
``csrc/flash_attention.cu`` for g++ (the inline PTX of ``mma.sync``,
``ldmatrix`` and ``cp.async`` becomes calls into ``cuda_runtime.h`` here,
``<<<...>>>`` launches become ``emu_launch``), builds it into
``build/cuda_emu/`` and calls its C entry points with CPU tensors.  It
checks indexing, fragment layouts, masks, padded rows and barriers at small
shapes; it says nothing about the card's rounding or speed, which only a
run on the card measures.  Exits 1 if a case disagrees.
"""

from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402

TOL = 1e-4  # relative to max(1, max |plain|): the 3xTF32 products
CASES = {
    # name: (B, S, T, H, Hkv, D, causal, window, softcap, num_valid)
    "small-mqa": (2, 40, 40, 2, 1, 32, True, None, None, 1),
    "s-lt-t-ragged": (1, 37, 70, 4, 2, 64, True, None, None, None),
    "window-softcap": (1, 96, 96, 2, 1, 32, True, 20, 30.0, None),
    "bidirectional": (1, 33, 33, 2, 2, 32, False, None, None, None),
    "d128": (1, 70, 70, 2, 1, 128, True, None, None, None),
    "d256-padded": (2, 72, 72, 4, 1, 256, True, None, None, 1),
    "local-window": (1, 160, 160, 2, 1, 64, True, 64, None, None),
}
# device functions whose bodies are inline PTX, and their emulations
EMULATED = {
    "mma_tf32": "  emu_mma(c, a, b);",
    "ldsm_x4": "  emu_ldsm(r, 4, p);",
    "ldsm_x2": "  emu_ldsm(r, 2, p);",
    "cp_async16": "  if (bytes) memcpy(dst, src, 16); else memset(dst, 0, 16);",
    "cp_async4": "  if (bytes) memcpy(dst, src, 4); else memset(dst, 0, 4);",
    "cp_commit": "",
    "cp_wait_all": "",
}


def for_gxx(src: str) -> str:
    for name, body in EMULATED.items():
        m = re.search(r"__device__ __forceinline__ [^\n]*\b" + name
                      + r"\([^{]*\{", src)
        if m is None:
            raise ValueError(f"no device function {name} to emulate")
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            i += 1
        src = src[:m.end()] + "\n" + body + "\n}" + src[i:]
    src = re.sub(r"extern __shared__ (?:__align__\(16\) )?float (\w+)\[\];",
                 r"float* \1 = (float*)emu_dyn_smem;", src)

    def launch(m):
        grid, threads, smem = [p.strip() for p in
                               re.split(r",(?![^(]*\))", m.group(2))][:3]
        return (f"emu_launch(dim3({grid}), {threads}, {smem}, [&] "
                f"{{ {m.group(1)}({m.group(3)}); }});")

    return re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\((.*?)\);", launch, src,
                  flags=re.S)


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "cuda_emu"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_attention.cpp").write_text(for_gxx(K.SOURCE.read_text()))
    lib = out / "libflash_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-fPIC", "-shared",
                    "-pthread", "-Wno-unknown-pragmas", f"-I{HERE}", "-o",
                    str(lib), str(out / "flash_attention.cpp"),
                    str(HERE / "emu.cpp")], check=True)
    dll = ctypes.CDLL(str(lib))
    for name, argtypes in K._SIGNATURES.items():
        getattr(dll, name).argtypes = argtypes
        getattr(dll, name).restype = ctypes.c_int
    return dll


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


def main() -> int:
    names = sys.argv[1:] or list(CASES)
    lib = build()
    results = [run_case(lib, name, CASES[name]) for name in names]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
