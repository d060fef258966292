"""Three-term roofline of one step program on NVIDIA H100 cards.

    compute term    = FLOPs / peak FLOP/s              (per card)
    memory term     = bytes / HBM bandwidth            (per card)
    collective term = collective bytes / link bandwidth (per card)

A record carries the keys of the reference's dry-run results: ``arch``,
``shape``, ``mesh``, ``status``, ``devices``, ``params``, the per-device
``flops_scanned`` / ``bytes_scanned`` or a ``probe`` with
``flops_total``, ``bytes_accessed_total`` and ``collective_bytes_total``,
and the memory sizes.

MODEL_FLOPS = 6*N*D for training (three matmul passes), 2*N*D for
forward-only (prefill / decode), with N the *active* parameters for MoE.
MODEL_FLOPS / (FLOPs * devices) shows how much of the counted compute is
useful (remat recompute, attention's quadratic terms and MoE dispatch all
lower it).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline results.json
"""

from __future__ import annotations

import json
import sys

# NVIDIA H100 SXM5 data sheet, dense rates (no sparsity), at its 700 W limit
PEAK_FLOPS = 989e12       # bf16 FLOP/s per card, tensor cores
HBM_BW = 3.35e12          # bytes/s per card, HBM3
LINK_BW = 450e9           # bytes/s per card and direction over NVLink 4
                          # (the data sheet's 900 GB/s counts both directions)


def active_params(arch: str, total: int) -> int:
    """Active (per-token) parameter count — discounts unrouted experts."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if not cfg.num_experts:
        return total
    e, k, sh = cfg.num_experts, cfg.moe_top_k, cfg.num_shared_experts
    d, f = cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    expert_params_per_layer = 3 * d * f
    routed_total = cfg.num_layers * e * expert_params_per_layer
    routed_active = cfg.num_layers * k * expert_params_per_layer
    return total - routed_total + routed_active


def model_flops(rec: dict) -> float:
    """Analytic useful FLOPs for the whole step (all devices)."""
    from repro_torch.configs.shapes import get_shape

    shape = get_shape(rec["shape"])
    n_active = active_params(rec["arch"], rec["params"])
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


SUGGESTIONS = {
    "compute": ("raise arithmetic efficiency: bf16 GEMMs on the tensor cores "
                "(wgmma), larger microbatches per card, attention on "
                "wgmma/TMA tiles, less remat recompute"),
    "memory": ("cut HBM traffic: fuse elementwise chains, bf16 residuals, "
               "tiles that stay in shared memory between ops (TMA loads)"),
    "collective": ("overlap NCCL all-reduces and all-gathers with the "
                   "backward, reduce-scatter gradients, keep traffic on "
                   "NVLink inside one node"),
}


def analyze(rec: dict) -> dict:
    p = rec.get("probe", {})
    flops = p.get("flops_total", rec.get("flops_scanned", 0.0))
    byts = p.get("bytes_accessed_total", rec.get("bytes_scanned", 0.0))
    coll = p.get("collective_bytes_total", 0)
    t_comp = flops / PEAK_FLOPS
    t_mem = byts / HBM_BW
    t_coll = coll / LINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec)
    hlo_total = flops * rec.get("devices", 256)
    useful = mf / hlo_total if hlo_total else 0.0
    return {
        **{k: rec.get(k) for k in ("arch", "shape", "mesh", "kind",
                                   "devices", "params", "optimizer")},
        "compute_s": t_comp,
        "memory_s": t_mem,
        "collective_s": t_coll,
        "dominant": dominant,
        "bound_s": max(terms.values()),
        "model_flops": mf,
        "hlo_flops_per_dev": flops,
        "useful_ratio": useful,
        "hbm_per_dev_bytes": _hbm_bytes(rec),
        "fix": SUGGESTIONS[dominant],
    }


def _hbm_bytes(rec: dict):
    """Arguments + temporaries + outputs per device; None when one of them
    was not measured (the port's dry run records no temporaries)."""
    parts = [rec.get(k, 0) for k in ("argument_size_in_bytes",
                                     "temp_size_in_bytes",
                                     "output_size_in_bytes")]
    return None if None in parts else sum(parts)


def table(results: list[dict], mesh: str = "16x16") -> str:
    rows = [analyze(r) for r in results
            if r["status"] == "ok" and r["mesh"] == mesh]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = ["| arch | shape | compute s | memory s | collective s | bound | "
           "useful | HBM/dev |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | "
            f"{r['dominant']} | {r['useful_ratio']*100:.0f}% | "
            + ("not measured |" if r["hbm_per_dev_bytes"] is None
               else f"{r['hbm_per_dev_bytes']/1e9:.1f}GB |"))
    return "\n".join(out)


_RAMP_SHAPES = ("train_4k", "train_4k_x2", "train_4k_x4")


def batch_ramp(results: list[dict], mesh: str = "16x16") -> str:
    """Roofline view of the outer global-batch ramp (DESIGN.md §15): with
    the device set fixed, per-device compute and memory terms scale about
    linearly with the batch while the gradient all-reduce stays flat.
    ``pred`` is the base shape's compute term scaled by the batch ratio,
    ``s/ex`` the bound per example."""
    by_arch: dict = {}
    for r in results:
        if (r["status"] == "ok" and r["mesh"] == mesh
                and r["shape"] in _RAMP_SHAPES):
            by_arch.setdefault(r["arch"], {})[r["shape"]] = analyze(r)
    out = ["| arch | shape | B | compute s | pred (linear) | collective s | "
           "bound s/ex |",
           "|---|---|---|---|---|---|---|"]
    from repro_torch.configs.shapes import get_shape

    for arch in sorted(by_arch):
        rows = by_arch[arch]
        if "train_4k" not in rows:
            continue
        base = rows["train_4k"]
        b0 = get_shape("train_4k").global_batch
        for name in _RAMP_SHAPES:
            b = get_shape(name).global_batch
            pred = base["compute_s"] * (b / b0)
            if name in rows:
                r = rows[name]
                out.append(
                    f"| {arch} | {name} | {b} | {r['compute_s']:.3f} | "
                    f"{pred:.3f} | {r['collective_s']:.3f} | "
                    f"{r['bound_s'] / b * 1e3:.3f}ms |")
            else:
                # no record yet: prediction only (collectives assumed flat)
                bound = max(pred, base["memory_s"] * (b / b0),
                            base["collective_s"])
                out.append(
                    f"| {arch} | {name} | {b} | — | {pred:.3f} | "
                    f"~{base['collective_s']:.3f} | "
                    f"{bound / b * 1e3:.3f}ms (pred) |")
    if len(out) == 2:
        return ""
    return "\n".join(out)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "dryrun_results.json"
    with open(path) as f:
        results = json.load(f)
    print("## Roofline (mesh 16x16, per card, H100 SXM constants)\n")
    print(table(results))
    for mesh_name, label in (("16x16", "256 devices"),
                             ("2x16x16", "512 devices")):
        ramp = batch_ramp(results, mesh=mesh_name)
        if ramp:
            print(f"\n## Global-batch ramp ({label}, outer-loop rungs — "
                  f"DESIGN.md §15)\n")
            print(ramp)
    rows = [analyze(r) for r in results
            if r["status"] == "ok" and r["mesh"] == "16x16"]
    print("\nWorst useful-compute ratios:")
    for r in sorted(rows, key=lambda r: r["useful_ratio"])[:3]:
        print(f"  {r['arch']} x {r['shape']}: {r['useful_ratio']*100:.1f}% "
              f"({r['dominant']}-bound) -> {r['fix']}")
    print("\nMost collective-bound:")
    coll = sorted(rows, key=lambda r: -(r["collective_s"]
                                        / max(r["bound_s"], 1e-12)))
    for r in coll[:3]:
        print(f"  {r['arch']} x {r['shape']}: coll {r['collective_s']:.3f}s "
              f"vs bound {r['bound_s']:.3f}s")


if __name__ == "__main__":
    main()
