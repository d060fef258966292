"""Rewrite one of the port's CUDA sources for g++ and build it against the
emulator in this directory (``cuda_runtime.h``, ``emu.cpp``).

The source's local ``#include "..."`` headers are inlined; device functions
whose bodies are inline PTX (``mma.sync``, ``ldmatrix``, ``cp.async``)
become calls into the emulator; ``<<<...>>>`` launches become
``emu_launch``.  g++ builds with ``CUDA_EMU`` defined, under which a source
leaves out what has no emulation (``wgmma``, TMA, ``mbarrier``).  Used by
``run_flash.py``, ``run_ssd.py`` and ``run_rglru.py``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]

# the headers' device functions whose bodies are inline PTX, and their
# emulations: a source that includes a header must define each of its
# functions
EMULATED = {
    "mma_tf32.cuh": {
        "mma_tf32": "  emu_mma(c, a, b);",
        "ldsm_x4": "  emu_ldsm(r, 4, p);",
        "ldsm_x2": "  emu_ldsm(r, 2, p);",
        "cp_async16": "  emu_cp_async(dst, src, 16, bytes);",
        "cp_async4": "  emu_cp_async(dst, src, 4, bytes);",
        "cp_commit": "  emu_cp_commit();",
        "cp_wait": "  emu_cp_wait(N);",
    },
}


def inline_includes(path: Path) -> tuple[str, set[str]]:
    """The source with each local ``#include "..."`` replaced by its file
    (once; ``#pragma once`` dropped), and the names of the files inlined."""
    seen: set[Path] = set()

    def expand(p: Path) -> str:
        def sub(m):
            inc = (p.parent / m.group(1)).resolve()
            if inc in seen:
                return ""
            seen.add(inc)
            return expand(inc)

        text = p.read_text().replace("#pragma once\n", "")
        return re.sub(r'^#include "([^"]+)"$', sub, text, flags=re.M)

    return expand(Path(path)), {inc.name for inc in seen}


def for_gxx(src: str, headers: set[str]) -> str:
    """``src``, whose local includes are ``headers``, rewritten for g++."""
    for header in sorted(headers & EMULATED.keys()):
        for name, body in EMULATED[header].items():
            m = re.search(r"__device__ __forceinline__ [^\n]*\b" + name
                          + r"\([^{]*\{", src)
            if m is None:
                raise ValueError(f"no device function {name} of {header} "
                                 f"to emulate")
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

    return re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\((.*?)\);", launch, src,
                  flags=re.S)


def build(source: Path, name: str, signatures: dict) -> ctypes.CDLL:
    """``source`` built for the emulator into ``build/cuda_emu/``, loaded,
    with ``signatures`` (entry point -> ctypes argtypes) applied."""
    out = ROOT / "build" / "cuda_emu"
    out.mkdir(parents=True, exist_ok=True)
    cpp = out / f"{name}.cpp"
    cpp.write_text(for_gxx(*inline_includes(source)))
    lib = out / f"lib{name}_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-fPIC", "-shared",
                    "-DCUDA_EMU", "-pthread", "-ffp-contract=off",
                    "-Wno-unknown-pragmas",
                    f"-I{HERE}", "-o", str(lib), str(cpp),
                    str(HERE / "emu.cpp")], check=True)
    dll = ctypes.CDLL(str(lib))
    for fn, argtypes in signatures.items():
        getattr(dll, fn).argtypes = argtypes
        getattr(dll, fn).restype = ctypes.c_int
    return dll
