#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on a GPU.

    python3 chip_smoke.py [--out DIR]

Needs one CUDA card, the CUDA toolkit (nvcc) and this checkout's ``src/``.
Phases, each of which fails the run (nonzero exit) when it goes wrong:

  1. device and build: the card's name and power limit; the flash-attention
     kernels compiled by nvcc for sm_90a from
     ``src/repro_torch/kernels/flash_attention/csrc/``;
  2. every kernel against its plain PyTorch version on the card, at the
     training shapes (B=2, S=T=1024, H=8, Hkv=1, D=256, fp32, causal, with
     num_valid 1 and 2) plus small window/softcap, S<T and non-causal cases;
     padded rows must be exact zeros; kernel and plain version against a
     float64 attention at the training shapes; then kernel, plain and
     library timings (SDPA's memory-efficient forward and backward);
  3. a small-input check that the LM loss and its gradients through the
     kernels equal those of the plain attention path, on the card;
  4. the main path: ``Experiment(...).session().run()`` at gemma-2b's full
     widths (2 layers), seq 1024, three heterogeneous workers, STEPS BSP steps;
     every loss finite, and every kernel's launch count equal to
     layers x microbatches run; the last step runs under torch.profiler
     (device time by kernel, idle share).

The last three lines of standard output are the ``kernels`` JSON line, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.  Longer
reports (nvcc's register and shared-memory use, per-case errors) go to
``--out`` (default ``chiprun_out/``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published dense peaks (NVIDIA data sheets): fp32 outside the tensor cores,
# device-memory bandwidth; the SXM part is the default
PEAKS = {"PCIe": (51e12, 2.0e12), "NVL": (60e12, 3.9e12), "SXM": (67e12, 3.35e12)}
FWD_TOL = 1e-4          # abs and rel: fp32, other summation order over 1024 keys
BWD_TOL = 1e-3          # relative to the tensor's max |value|, same reason
MODEL_TOL = 1e-4        # loss rel and grads rel-to-max, kernel vs plain attention
STEPS = 5               # BSP steps of the main path; the last one is profiled


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "SXM", PEAKS["SXM"]


def time_ms(fn, iters: int) -> float:
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# ------------------------------------------------------------------ phase 2

CASES = [
    # name, B, S, T, H, Hkv, D, causal, window, softcap, num_valid
    ("main-nv1", 2, 1024, 1024, 8, 1, 256, True, None, None, 1),
    ("main-nv2", 2, 1024, 1024, 8, 1, 256, True, None, None, 2),
    ("window-softcap", 2, 256, 256, 4, 2, 64, True, 64, 30.0, 1),
    ("s-lt-t", 1, 128, 256, 4, 1, 128, True, None, None, None),
    ("bidirectional", 1, 192, 192, 4, 4, 32, False, None, None, None),
]


def check_kernels(report: dict) -> dict:
    import torch
    from repro_torch.kernels.flash_attention import kernel as K

    dev = torch.device("cuda")
    errs = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for name, b, s, t, h, hkv, d, causal, window, cap, nv in CASES:
        g = torch.Generator(device=dev).manual_seed(len(name))
        q = torch.randn((b, s, h, d), generator=g, device=dev)
        k = torch.randn((b, t, hkv, d), generator=g, device=dev)
        v = torch.randn((b, t, hkv, d), generator=g, device=dev)
        do = torch.randn((b, s, h, d), generator=g, device=dev)
        nvt = None if nv is None else torch.tensor(nv, dtype=torch.int32,
                                                   device=dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        out, lse = K.flash_fwd(q, k, v, nvt, **kw)
        out_p, lse_p = K.flash_fwd_plain(q, k, v, nvt, **kw)
        delta = (do * out_p).sum(-1).transpose(1, 2).contiguous()
        dq = K.flash_bwd_dq(q, k, v, do, lse_p, delta, nvt, **kw)
        dq_p = K.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, nvt, **kw)
        dk, dv = K.flash_bwd_dkv(q, k, v, do, lse_p, delta, nvt, **kw)
        dk_p, dv_p = K.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, nvt,
                                           **kw)
        torch.cuda.synchronize()
        case = {}
        for label, x, ref in (("out", out, out_p), ("lse", lse, lse_p)):
            err = (x - ref).abs().max().item()
            ok = torch.allclose(x, ref, atol=FWD_TOL, rtol=FWD_TOL)
            case[label] = {"max_abs_err": err, "ok": ok}
            errs["flash_fwd"] = max(errs["flash_fwd"], err)
        for label, x, ref, kname in (("dq", dq, dq_p, "flash_bwd_dq"),
                                     ("dk", dk, dk_p, "flash_bwd_dkv"),
                                     ("dv", dv, dv_p, "flash_bwd_dkv")):
            err = (x - ref).abs().max().item()
            scale = ref.abs().max().item()
            case[label] = {"max_abs_err": err, "ref_max": scale,
                           "ok": err <= BWD_TOL * max(scale, 1e-30)}
            errs[kname] = max(errs[kname], err)
        if nv is not None and nv < b:
            pads = [out[nv:], lse[nv:], dq[nv:], dk[nv:], dv[nv:]]
            case["padded_rows_zero"] = all(bool((x == 0).all()) for x in pads)
        bad = [key for key, val in case.items()
               if (isinstance(val, dict) and not val["ok"])
               or (key == "padded_rows_zero" and not val)]
        log(f"  case {name}: " + ", ".join(
            f"{key} err {val['max_abs_err']:.3g}" for key, val in case.items()
            if isinstance(val, dict))
            + (f", padded rows zero {case['padded_rows_zero']}"
               if "padded_rows_zero" in case else ""))
        report["cases"][name] = case
        if bad:
            raise AssertionError(f"kernel case {name} failed on {bad}: {case}")
    return errs


def attention64(q, k, v):
    """Causal GQA attention in the inputs' dtype (float64 here): the oracle
    of ``check_fp64``, independent of the port's plain versions."""
    import torch
    from repro_torch.kernels.flash_attention.ref import visible_mask

    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d)
    sc = torch.einsum("bsgrd,btgd->bgrst", qg, k) / math.sqrt(d)
    mask = visible_mask(s, t, causal=True, window=None, device=q.device)
    sc = sc.masked_fill(~mask, float("-inf"))
    out = torch.einsum("bgrst,btgd->bsgrd", sc.softmax(-1), v)
    return out.reshape(b, s, h, d)


def check_fp64() -> dict:
    """Kernels and plain versions (fp32) against float64 attention at the
    training shapes, every row valid.  Both backward versions take the plain
    forward's lse and delta, so ``kernel_equals_plain`` compares like with
    like."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as K

    dev = torch.device("cuda")
    b, s, t, h, hkv, d = 2, 1024, 1024, 8, 1, 256
    g = torch.Generator(device=dev).manual_seed(64)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev) for shape in
                   ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, h, d)))
    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    out64 = attention64(*leaves)
    ref = dict(zip(("dq", "dk", "dv"),
                   torch.autograd.grad(out64, leaves, do.double())))
    ref["out"] = out64.detach()
    out_p, lse_p = K.flash_fwd_plain(q, k, v)
    delta = (do * out_p).sum(-1).transpose(1, 2).contiguous()
    got = {}
    for label, fwd, dq_fn, dkv_fn in (
            ("kernel", K.flash_fwd, K.flash_bwd_dq, K.flash_bwd_dkv),
            ("plain", K.flash_fwd_plain, K.flash_bwd_dq_plain,
             K.flash_bwd_dkv_plain)):
        dk, dv = dkv_fn(q, k, v, do, lse_p, delta)
        got[label] = {"out": fwd(q, k, v)[0], "dq": dq_fn(q, k, v, do, lse_p,
                                                         delta),
                      "dk": dk, "dv": dv}
    res = {}
    for name, r in ref.items():
        scale = r.abs().max().item()
        kern, plain = got["kernel"][name], got["plain"][name]
        res[name] = {"kernel_err": (kern.double() - r).abs().max().item(),
                     "plain_err": (plain.double() - r).abs().max().item(),
                     "ref_max": scale,
                     "kernel_equals_plain": bool(torch.equal(kern, plain))}
        tol = FWD_TOL if name == "out" else BWD_TOL
        if res[name]["kernel_err"] > tol * max(scale, 1e-30):
            raise AssertionError(f"{name} off the float64 result: {res}")
    return res


def time_kernels(peak_flops: float, peak_bw: float, report: dict) -> dict:
    """kernel / plain / library times at the main path's shapes (nv = B).

    The library is SDPA's memory-efficient attention in fp32 on (B,H,S,D)
    tensors with the kv head repeated to H.  Its backward is one call that
    computes dq, dk and dv together, so both backward kernels carry its time;
    compare it with the sum of theirs.  Its dk/dv come per query head; summed
    over each kv head's group they are checked against the kernels' here."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import visible_mask

    dev = torch.device("cuda")
    b, s, t, h, hkv, d = 2, 1024, 1024, 8, 1, 256
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b, s, h, d), generator=g, device=dev)
    k = torch.randn((b, t, hkv, d), generator=g, device=dev)
    v = torch.randn((b, t, hkv, d), generator=g, device=dev)
    do = torch.randn((b, s, h, d), generator=g, device=dev)
    nv = torch.tensor(b, dtype=torch.int32, device=dev)
    out, lse = K.flash_fwd(q, k, v, nv)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    pairs = int(visible_mask(s, t, causal=True, window=None).sum())
    f4 = 4  # bytes per fp32 value
    q_bytes, kv_bytes, row_bytes = b * s * h * d * f4, b * t * hkv * d * f4, \
        b * h * s * f4
    work = {  # (flops, bytes): each input read once, each output written once
        "flash_fwd": (4 * d * pairs * h * b,
                      2 * q_bytes + 2 * kv_bytes + row_bytes),
        "flash_bwd_dq": (6 * d * pairs * h * b,
                         3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
        "flash_bwd_dkv": (8 * d * pairs * h * b,
                          2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
    }
    rep = h // hkv
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()
    dot = do.transpose(1, 2).contiguous()
    eff_fwd = torch.ops.aten._scaled_dot_product_efficient_attention
    eff_bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward
    out_l, lse_l, seed, offset = eff_fwd(qt, kt, vt, None, True, 0.0, True)

    def lib_bwd():
        return eff_bwd(dot, qt, kt, vt, None, out_l, lse_l, seed, offset, 0.0,
                       [True, True, True, False], True)

    dq_l, dk_l, dv_l, _ = lib_bwd()
    dq, (dk, dv) = (K.flash_bwd_dq(q, k, v, do, lse, delta, nv),
                    K.flash_bwd_dkv(q, k, v, do, lse, delta, nv))
    report["library_vs_kernel"] = {
        "out": (out_l.transpose(1, 2) - out).abs().max().item(),
        "dq": (dq_l.transpose(1, 2) - dq).abs().max().item(),
        "dk": (dk_l.unflatten(1, (hkv, rep)).sum(2).transpose(1, 2)
               - dk).abs().max().item(),
        "dv": (dv_l.unflatten(1, (hkv, rep)).sum(2).transpose(1, 2)
               - dv).abs().max().item(),
    }
    calls = {
        "flash_fwd": (lambda: K.flash_fwd(q, k, v, nv),
                      lambda: K.flash_fwd_plain(q, k, v, nv),
                      lambda: F.scaled_dot_product_attention(
                          qt, kt, vt, is_causal=True)),
        "flash_bwd_dq": (lambda: K.flash_bwd_dq(q, k, v, do, lse, delta, nv),
                         lambda: K.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                      nv), lib_bwd),
        "flash_bwd_dkv": (lambda: K.flash_bwd_dkv(q, k, v, do, lse, delta, nv),
                          lambda: K.flash_bwd_dkv_plain(q, k, v, do, lse,
                                                        delta, nv), lib_bwd),
    }
    times, lib_ms = {}, {}  # the library backward is timed once, for both
    for name, (kern, plain, lib) in calls.items():
        flops, nbytes = work[name]
        t_ops, t_mem = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        if lib not in lib_ms:
            lib_ms[lib] = time_ms(lib, 20)
        times[name] = {
            "ms": time_ms(kern, 20),
            "plain_ms": time_ms(plain, 5),
            "library_ms": lib_ms[lib],
            "bound_ms": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
            "flops": flops, "bytes": nbytes,
        }
    return times


# ------------------------------------------------------------------ phase 3


def check_model_path() -> dict:
    """LM loss + grads with the kernels vs the plain attention path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm, lm_loss, reduced

    dev = torch.device("cuda")
    cfg = reduced(get_config("gemma-2b"))
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 128), generator=g,
                           device=dev)
    targets = torch.randint(0, cfg.vocab_size, (4, 128), generator=g,
                            device=dev)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev)
    nv = torch.tensor(3, dtype=torch.int32, device=dev)
    res = {}
    for use_kernel in (True, False):
        leaves = {k_: p.detach().requires_grad_() for k_, p in params.items()}
        ls, _, _ = lm_loss(leaves, cfg.with_(use_pallas=use_kernel), tokens,
                           targets, mask, num_valid=nv if use_kernel else None)
        grads = torch.autograd.grad(ls, list(leaves.values()))
        res[use_kernel] = (ls.item(), grads)
    (lk, gk), (lp, gp) = res[True], res[False]
    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = max(((a - b_).abs().max() / b_.abs().max().clamp_min(1e-30))
                   .item() for a, b_ in zip(gk, gp))
    out = {"loss_kernel": lk, "loss_plain": lp, "loss_rel_err": loss_rel,
           "grad_rel_err": grad_rel, "tol": MODEL_TOL}
    if not (math.isfinite(lk) and loss_rel <= MODEL_TOL
            and grad_rel <= MODEL_TOL):
        raise AssertionError(f"kernel path disagrees with plain path: {out}")
    return out


def main_path() -> dict:
    import torch
    from repro_torch.api import (ClusterSpec, Experiment, Hook, TrainConfig,
                                 lm_workload)
    from repro_torch.configs import get_config
    from repro_torch.core import ControllerConfig, plan_microbatches
    from repro_torch.data import DataPipeline
    from repro_torch.kernels.flash_attention import LAUNCHES, reset_launches
    from repro_torch.optim import adam

    class StepClock(Hook):
        """Per-step wall ms (host clock around synchronized steps), and
        torch.profiler over step ``profile_step``: device time by kernel and
        the device's idle share.  The profiler's own start and stop fall
        outside every timed window."""

        def __init__(self, profile_step):
            self.ms, self.t = [], None
            self.profile_step, self.prof, self.profile = profile_step, None, None

        def on_run_start(self, session):
            torch.cuda.synchronize()
            self.t = time.perf_counter()

        def on_step(self, session, rec):
            torch.cuda.synchronize()
            wall = time.perf_counter() - self.t
            self.ms.append(wall * 1e3)
            if rec.step == self.profile_step - 1:
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                self.prof.__enter__()
            elif rec.step == self.profile_step and self.prof is not None:
                self.prof.__exit__(None, None, None)
                self.profile = profile_summary(self.prof, wall * 1e6)
            self.t = time.perf_counter()

    cfg = get_config("gemma-2b", num_layers=2)
    microbatch = 2
    experiment = Experiment(
        workload=lm_workload(cfg, DataPipeline(cfg, seq_len=1024,
                                               num_workers=3),
                             aux_weight=0.01, use_kernel=True),
        cluster=ClusterSpec.hlevel(39, 6.0, 3, workload="transformer",
                                   seed=0),
        optimizer=adam(1e-3),
        config=TrainConfig(b0=4, microbatch=microbatch, batching="dynamic",
                           sync="bsp", max_steps=STEPS,
                           controller=ControllerConfig(kind="p")),
    )
    clock = StepClock(profile_step=STEPS - 1)
    torch.cuda.reset_peak_memory_stats()
    session = experiment.session(hooks=[clock])
    n_params = sum(p.numel() for p in session.params.values())
    initial = list(session.batches)
    reset_launches()
    out = session.run()
    counts = dict(LAUNCHES)
    hist = out["history"]
    pre = [initial] + [r.batches for r in hist[:-1]]
    micro = sum(plan_microbatches(b_, microbatch).n_steps
                for bs in pre for b_ in bs)
    want = cfg.num_layers * micro
    losses = [r.loss for r in hist]
    for r, ms in zip(hist, clock.ms):
        log(f"  step {r.step} wall {ms:.1f} ms  loss {r.loss:.4f}  "
            f"batches {r.batches}  sim_time {r.sim_time:.4f}  "
            f"adjusted {r.adjusted}")
    res = {"params": n_params, "initial_batches": initial,
           "losses": losses, "batches": [r.batches for r in hist],
           "sim_time": [r.sim_time for r in hist],
           "step_wall_ms": clock.ms, "microbatches": micro,
           "launches": counts, "expected_launches": want,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "profile": clock.profile}
    if len(hist) != STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"main path: bad losses {losses}")
    if any(c != want or c <= 0 for c in counts.values()):
        raise AssertionError(f"main path launches {counts}, want {want} each "
                             f"({cfg.num_layers} layers x {micro} microbatches)")
    return res


def profile_summary(prof, wall_us: float, top: int = 8) -> dict:
    """Device time by kernel (self time, us) over one profiled step."""
    kernels = {}
    for ev in prof.events():
        if getattr(ev, "device_type", None) is None or \
                str(ev.device_type) != "DeviceType.CUDA":
            continue
        kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.device_time_total
    busy = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    flash = sum(t for n, t in kernels.items()
                if any(k in n for k in ("fwd_kernel", "dq_kernel",
                                        "dkv_kernel")))
    gemm = sum(t for n, t in kernels.items()
               if "gemm" in n.lower() or "sgemm" in n.lower())
    return {"step_wall_us": wall_us, "device_busy_us": busy,
            "idle_share": (1 - busy / wall_us) if busy else None,
            "flash_kernels_us": flash, "gemm_us": gemm,
            "top": [(n[:90], t) for n, t in ranked[:top]]}


# --------------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    t_start = time.perf_counter()

    # 1. device and build
    smi = gpu_line()
    kind = torch.cuda.get_device_name(0)
    peak_name, (peak_flops, peak_bw) = peaks(kind)
    log(f"[1] gpu: {smi}; torch {torch.__version__}, cuda {torch.version.cuda}"
        f"; peaks ({peak_name}): {peak_flops / 1e12:.0f} TFLOP/s fp32, "
        f"{peak_bw / 1e12:.2f} TB/s")
    t0 = time.perf_counter()
    lib = build.build(K.SOURCE, "flash_attention")
    log(f"    built {os.path.relpath(lib, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    report = {"gpu": smi, "build_log": build.BUILD_LOG.get("flash_attention"),
              "cases": {}}

    # 2. kernels against plain versions, then timings
    log("[2] kernels vs plain versions "
        f"(fwd allclose {FWD_TOL}; bwd max err <= {BWD_TOL} x max|ref|)")
    errs = check_kernels(report)
    report["fp64"] = check_fp64()
    log("  vs float64 (kernel / plain max abs err, kernel == plain): " + ", ".join(
        f"{n} {r['kernel_err']:.3g} / {r['plain_err']:.3g} "
        f"{r['kernel_equals_plain']}" for n, r in report["fp64"].items()))
    times = time_kernels(peak_flops, peak_bw, report)
    log(f"  library vs kernel max abs err: {report['library_vs_kernel']}")
    for name, tm in times.items():
        log(f"  {name}: kernel {tm['ms']:.3f} ms, plain {tm['plain_ms']:.3f} "
            f"ms, library {tm['library_ms']:.3f} ms, bound "
            f"{tm['bound_ms']:.4f} ms ({tm['bound_by']})")
    torch.cuda.empty_cache()

    # 3. small-input model check, then the main path
    log("[3] LM loss + grads, kernels vs plain attention (reduced gemma-2b)")
    report["model_check"] = check_model_path()
    log(f"  {report['model_check']}")
    log(f"[4] main path: gemma-2b widths, 2 layers, seq 1024, "
        f"{STEPS} BSP steps")
    report["main_path"] = main_path()
    mp = report["main_path"]
    pr = mp["profile"]
    if pr and pr["device_busy_us"]:
        log(f"  profiled step: wall {pr['step_wall_us'] / 1e3:.1f} ms, device "
            f"busy {pr['device_busy_us'] / 1e3:.1f} ms (idle share "
            f"{pr['idle_share']:.3f}); gemm {pr['gemm_us'] / 1e3:.1f} ms, "
            f"flash kernels {pr['flash_kernels_us'] / 1e3:.1f} ms")
        for name, us in pr["top"]:
            log(f"    {us / 1e3:8.2f} ms  {name}")
    else:
        log("  profiled step: no device time recorded (not measured)")
    log(f"  params {mp['params']}, microbatches {mp['microbatches']}, "
        f"launches {mp['launches']}, max_memory_allocated "
        f"{mp['max_memory_allocated'] / 2**30:.2f} GiB")

    source = os.path.relpath(K.SOURCE, ROOT)
    replaces = {
        "flash_fwd": "src/repro/kernels/flash_attention/kernel.py:280",
        "flash_bwd_dq": "src/repro/kernels/flash_attention/kernel.py:359",
        "flash_bwd_dkv": "src/repro/kernels/flash_attention/kernel.py:399",
    }
    kernels = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        tm = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces[name],
            "launches": mp["launches"][name],
            "max_abs_err": errs[name],
            "tol": FWD_TOL if name == "flash_fwd" else BWD_TOL,
            "ms": tm["ms"], "kernel_ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"],
            "library_call": "scaled_dot_product_attention" if name ==
            "flash_fwd" else "_scaled_dot_product_efficient_attention_backward"
                             " (dq, dk and dv in one call)",
        })
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    log(f"total {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
