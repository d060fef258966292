#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on a GPU.

    python3 chip_smoke.py [--out DIR]

Needs one CUDA card, the CUDA toolkit (nvcc) and this checkout's ``src/``.
Phases, each of which fails the run (nonzero exit) when it goes wrong:

  1. device and build: the card's name and power limit; the flash-attention,
     SSD and RG-LRU kernels compiled by nvcc for sm_90a from
     ``src/repro_torch/kernels/{flash_attention,ssd_scan,rglru_scan}/csrc/``
     (one nvcc per source, started together);
  2. every kernel against its plain PyTorch version on the card, at the
     training shapes (B=2, S=T=1024, H=8, Hkv=1, D=256, fp32, causal, with
     num_valid 1 and 2) plus small window/softcap, S<T and non-causal cases,
     the recurrentgemma local blocks' shapes on the hybrid path (B=2,
     S=T=2048, H=16, Hkv=1, D=256, window 2048, num_valid 1 and 2) and where
     the window bites (B=1, S=T=4096); padded rows must be exact zeros, and
     a second flash_bwd_dq and flash_bwd_dkv launch must repeat the first
     bit for bit; kernel and plain version against a float64 attention at
     the training shapes; then kernel, plain and library timings (SDPA's
     memory-efficient forward and backward) at the training shapes and at
     the hybrid path's (B=2, S=T=2048, H=16, Hkv=1, D=256, window 2048),
     with the fp32 bound and, for the three flash kernels (tensor cores,
     3xTF32), the 3xTF32 bound; the SSD forward and backward kernels
     against their plain versions at the mamba2-1.3b cell's shapes (B=2,
     nc=32, cl=64, H=64, P=64, N=128), at a smaller one (cl 32) and at a
     ragged one (cl 40, P 20, N 12), a second ssd_bwd launch repeating the
     first bit for bit, the differentiable SSD scan through the kernels and
     the plain fp32 scan against a float64 scan, then kernel and plain
     timings (no single PyTorch call computes the SSD function), with the
     3xTF32 bound for ssd_bwd (tensor cores); the RG-LRU forward and
     backward kernels against their plain versions at the recurrentgemma-9b
     cell's shapes (B 1 and 2, L 2048, W 4096, with and without h0) and at
     W 200, the scan through the kernel pair and the plain fp32 scan against
     a float64 scan, then kernel and plain timings (no single PyTorch call
     computes the RG-LRU scan), with a second rglru_fwd launch repeating the
     first bit for bit and the forward kernel alone against a float64 scan;
  3. small-input checks that the LM loss and its gradients through the
     kernels equal those of the plain path, on the card: reduced gemma-2b
     (attention), reduced mamba2-1.3b (SSD, chunk 8) and reduced
     recurrentgemma-9b (RG-LRU at lru_width 128, flash with window 8);
  4. the main path: ``Experiment(...).session().run()`` at gemma-2b's full
     widths (2 layers), seq 1024, three heterogeneous workers, STEPS BSP steps;
     every loss finite, and every kernel's launch count equal to
     layers x microbatches run; the last step runs under torch.profiler
     (device time by kernel, idle share);
  5. the ssm path: the same loop at mamba2-1.3b's full widths (4 layers),
     seq 2048, with the SSD kernel pair's launch counts equal to layers x
     microbatches and both kernels in the profiled step's device kernels;
  6. the hybrid path: the same loop at recurrentgemma-9b's full widths (3
     layers, one rec-rec-local group), seq 2048, with the RG-LRU pair's
     launch counts equal to 2 rec layers x microbatches, the flash kernels'
     to 1 local layer x microbatches, and all five in the profiled step;
  7. the paper's workloads through ``Experiment(paper_workload(...))`` at
     their full widths: mnist-cnn uniform and dynamic, 60 BSP steps each,
     where dynamic's simulated time must stay under 0.75 x uniform's and
     the final losses within 0.5 (``tests/test_system.py``'s compute-bound
     claim), then resnet dynamic, 20 steps; finite losses, step wall ms and
     peak memory logged, no launch of the port's kernels;
  8. resume: resnet for 6 steps straight, and for 3 steps, ``Session.save``,
     a fresh session resumed from the file, 3 more steps; final params,
     Adam's moments and the resumed steps' records bit-identical (cuDNN
     deterministic for this check);
  9. outer kinds: phase 4's gemma path (2 layers, seq 1024) twice more, 6
     BSP steps each, with an outer global-batch controller on the ladder
     [12, 24]: gns with adam(1e-3), where every step's three |g_k|^2 and
     the combined |g|^2 must be finite and positive and the estimator must
     accept every step, its last step profiled for the side statistics'
     device time (the kernels aten::dot launched) against 4 passes over the
     fp32 parameters at the memory's rate; then geometric with
     adam(batch_coupled(1e-3, "sqrt")), which must resize 12 -> 24 once, at
     its second step (resize log [[2, 24]]), leaving the LR scale at
     sqrt(2); B stays on the ladder, and the flash kernels' launch counts
     equal 2 layers x the microbatches each run ran, the resize included;
     each step's wall ms is logged with the B it ran at, and one
     ``tree_sqnorm`` pass over the path's parameters is timed alone;
 10. churn: a spot-market storm (``storm_market(4, zones=2, seed=11,
     horizon=12)``) lowered by ``compile_churn(min_workers=2)`` into two
     preemptions, two rejoins, a straggler and its restore, each followed
     by a cost-aware Reallocate: (a) phase 4's gemma path (2 layers, seq
     1024, b0 4 on the market's 4-worker fleet) for 13 BSP steps, where
     sum(b_k) must stay 16 at every step, the membership log and the live
     worker count of each step must follow the compiled schedule, every
     loss be finite and the flash kernels' launch counts equal 2 layers x
     the microbatches each step ran; each step's wall ms is logged with its
     worker and microbatch counts; (b) mnist-cnn at phase 7's settings on
     the same storm, saved at step 5 (where a worker rejoins) and resumed
     on the fleet as of the save with the schedule's rest: final params,
     Adam's moments, the tail's records and membership logs bit-identical;
     (c) ``run_chaos`` twice with ``make_fault_plan(11, horizon=30)`` on
     mnist-cnn over 30 steps: equal, non-empty injection logs, equal
     histories, sum(b_k) constant.  (b) and (c) run with cuDNN
     deterministic and launch none of the port's kernels;
 11. the measured backend: (a) phase 4's gemma path on
     ``MeshBackend(dilation="from-spec")``, MESH_STEPS BSP steps: the three
     workers take the card one after another, each gradient call over the
     worker's whole bucket timed by CUDA events; each step's wall ms, split,
     buckets, worker event ms raw and dilated and loss are logged, and each
     warm-up rerun's event ms beside its first call's; sum(b_k) must stay
     12, the split must be ragged with the most
     dilated worker smallest, each worker's buckets and the warm-up reruns
     within the ladder bound ceil(log_1.25(b_max/b_min)) + 1, and each
     flash kernel's launch count equal 2 layers x every gradient call of
     the session (probe and reruns included); (b) one more step under
     torch.profiler; then the flash kernels against their plain versions
     at every (bucket, num_valid) the path's calls ran, and at B 7 with
     num_valid 5 and 6 (padded rows exact zeros); (c) a checkpoint after 2 steps restored into a new
     session and run to step 4: params, Adam's moments, records and
     ``exec_state_dict`` bit-identical to the uninterrupted run (both with
     their times from FakeClock, since measured times differ between
     runs); (d) mnist-cnn under ASP on the mesh, MESH_ASP_UPDATES updates,
     staleness logged and at least 1 somewhere; (e) phase 10's storm on
     mnist-cnn through the mesh trainer's membership methods: membership
     log and live workers as compiled, sum(b_k) kept, the straggler's
     slowdown in the dilation;
 12. serving: (a) gemma-2b at full width and depth (18 layers, random
     weights from seed 0) behind a ``ContinuousBatcher`` of SERVE_SLOTS
     slots x SERVE_CACHE positions, SERVE_REQUESTS requests from
     ``make_traffic("poisson")`` (prompts of 1..SERVE_PROMPT tokens,
     SERVE_NEW new tokens each), submitted at their arrival steps: every
     request finishes; each step's host wall ms (pure decode p50 / p95
     against the step's bytes bound, admitting steps apart), tokens/s and
     peak memory logged; (e) one pure decode step with every slot live
     under torch.profiler, three untraced steps timed before and after it;
     (b) the same requests through a ``KVSlotManager`` over one ``LMShard``
     behind a ``PrefillProgram``, all on the same parameter tensors: each
     stream equal to (a)'s, peak under 11 GiB, prefill ms a token by ladder
     rung; (c) gemma-2b (2 layers), mamba2-1.3b (4) and recurrentgemma-9b
     (3) at full width: 256 tokens decoded one by one through the caches
     against ``apply_lm`` over all of them through the kernels, within
     DECODE_TOL (atol raised to DECODE_ULPS x max|logit| where larger),
     each kernel launched once a layer that runs it and none in decode;
     (d) phase 11(a)'s path with a shared-mode ``ServeSpec`` (the reduced
     gemma-2b decode model), once per engine, COLO_STEPS steps: the decode
     seconds charged to worker 2, sum(b_k) 12, each flash kernel launched
     2 layers x every gradient call.

Each main path runs with every kernel's launch count set to 0 just before
it and read just after (phase 11(a): before its session is built, whose
probe round launches too).

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
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))

# published dense peaks (NVIDIA data sheets): fp32 outside the tensor cores,
# device-memory bandwidth, TF32 on the tensor cores; the SXM part is the
# default
PEAKS = {"PCIe": (51e12, 2.0e12, 378e12), "NVL": (60e12, 3.9e12, 418e12),
         "SXM": (67e12, 3.35e12, 495e12)}
FWD_TOL = 1e-4          # abs and rel: fp32, other summation order over 1024 keys
BWD_TOL = 1e-3          # relative to the tensor's max |value|, same reason
MODEL_TOL = 1e-4        # loss rel and grads rel-to-max, kernel vs plain path
SSD_FWD_TOL = 1e-4      # abs and rel: fp32, other summation order (<= 128 terms)
SSD_BWD_TOL = 1e-4      # relative to the tensor's max |value|, same reason
RGLRU_FWD_TOL = 1e-5    # abs and rel: the reference's RG-LRU tolerance
RGLRU_BWD_TOL = 1e-5    # relative to the tensor's max |value|
STEPS = 5               # BSP steps of each main path; the last one is profiled
MICROBATCH = 2          # rows per microbatch on every main path


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
    # recurrentgemma-9b's local blocks as the hybrid main path runs them
    # (microbatch 2, seq 2048, one row padded when a worker's batch is odd)
    ("hybrid-nv1", 2, 2048, 2048, 16, 1, 256, True, 2048, None, 1),
    ("hybrid-nv2", 2, 2048, 2048, 16, 1, 256, True, 2048, None, 2),
    # and at a length where the window bites
    ("local-window", 1, 4096, 4096, 16, 1, 256, True, 2048, None, None),
]


def check_kernels(report: dict, cases=CASES) -> dict:
    """Each flash kernel against its plain version at ``cases``; returns
    each kernel's largest error."""
    errs = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for case in cases:
        check_flash_case(case, report, errs)
    return errs


def check_flash_case(case: tuple, report: dict, errs: dict) -> None:
    """One case shaped as ``CASES``'s: the three flash kernels against their plain
    versions (padded rows exact zeros, backward launches repeating bit for
    bit); raises on a miss, folds the errors into ``errs``."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as K

    dev = torch.device("cuda")
    name, b, s, t, h, hkv, d, causal, window, cap, nv = case
    g = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))
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
    dk2, dv2 = K.flash_bwd_dkv(q, k, v, do, lse_p, delta, nvt, **kw)
    dq2 = K.flash_bwd_dq(q, k, v, do, lse_p, delta, nvt, **kw)
    torch.cuda.synchronize()
    res = {"dkv_repeats_bit_for_bit": bool(torch.equal(dk, dk2)
                                            and torch.equal(dv, dv2)),
           "dq_repeats_bit_for_bit": bool(torch.equal(dq, dq2))}
    for label, x, ref in (("out", out, out_p), ("lse", lse, lse_p)):
        err = (x - ref).abs().max().item()
        ok = torch.allclose(x, ref, atol=FWD_TOL, rtol=FWD_TOL)
        res[label] = {"max_abs_err": err, "ok": ok}
        errs["flash_fwd"] = max(errs["flash_fwd"], err)
    for label, x, ref, kname in (("dq", dq, dq_p, "flash_bwd_dq"),
                                 ("dk", dk, dk_p, "flash_bwd_dkv"),
                                 ("dv", dv, dv_p, "flash_bwd_dkv")):
        err = (x - ref).abs().max().item()
        scale = ref.abs().max().item()
        res[label] = {"max_abs_err": err, "ref_max": scale,
                      "ok": err <= BWD_TOL * max(scale, 1e-30)}
        errs[kname] = max(errs[kname], err)
    if nv is not None and nv < b:
        pads = [out[nv:], lse[nv:], dq[nv:], dk[nv:], dv[nv:]]
        res["padded_rows_zero"] = all(bool((x == 0).all()) for x in pads)
    bad = [key for key, val in res.items()
           if (isinstance(val, dict) and not val["ok"])
           or (isinstance(val, bool) and not val)]
    log(f"  case {name}: " + ", ".join(
        f"{key} err {val['max_abs_err']:.3g}" for key, val in res.items()
        if isinstance(val, dict))
        + (f", padded rows zero {res['padded_rows_zero']}"
           if "padded_rows_zero" in res else "")
        + f", dk/dv repeat bit for bit {res['dkv_repeats_bit_for_bit']}"
        + f", dq {res['dq_repeats_bit_for_bit']}")
    report["cases"][name] = res
    if bad:
        raise AssertionError(f"kernel case {name} failed on {bad}: {res}")


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


# (label, B, S, T, H, Hkv, D, window): the gemma main path's attention and
# recurrentgemma's local blocks on the hybrid path
FLASH_TIMED = [("gemma", 2, 1024, 1024, 8, 1, 256, None),
               ("hybrid", 2, 2048, 2048, 16, 1, 256, 2048)]


def time_kernels(peak_flops: float, peak_bw: float, peak_tf32: float,
                 report: dict, shape=FLASH_TIMED[0]) -> dict:
    """kernel / plain / library times at one of ``FLASH_TIMED``'s shapes
    (causal, nv = B), with the fp32 bound and, as all three run on the
    tensor cores, the 3xTF32 bound (three TF32 products per fp32 one).

    The library is SDPA's memory-efficient attention in fp32 on (B,H,S,D)
    tensors with the kv head repeated to H (the window, where given, does
    not bite at these S, so causal SDPA computes the same function).  Its
    backward is one call that computes dq, dk and dv together, so both
    backward kernels carry its time; compare it with the sum of theirs.
    Its dk/dv come per query head; summed over each kv head's group they
    are checked against the kernels' here."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import visible_mask

    dev = torch.device("cuda")
    label, b, s, t, h, hkv, d, window = shape
    if window is not None and window < t:
        raise ValueError(f"{label}: a biting window has no SDPA yardstick")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b, s, h, d), generator=g, device=dev)
    k = torch.randn((b, t, hkv, d), generator=g, device=dev)
    v = torch.randn((b, t, hkv, d), generator=g, device=dev)
    do = torch.randn((b, s, h, d), generator=g, device=dev)
    nv = torch.tensor(b, dtype=torch.int32, device=dev)
    kw = dict(causal=True, window=window)
    out, lse = K.flash_fwd(q, k, v, nv, **kw)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    pairs = int(visible_mask(s, t, causal=True, window=window).sum())
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
    dq, (dk, dv) = (K.flash_bwd_dq(q, k, v, do, lse, delta, nv, **kw),
                    K.flash_bwd_dkv(q, k, v, do, lse, delta, nv, **kw))
    report.setdefault("library_vs_kernel", {})[label] = {
        "out": (out_l.transpose(1, 2) - out).abs().max().item(),
        "dq": (dq_l.transpose(1, 2) - dq).abs().max().item(),
        "dk": (dk_l.unflatten(1, (hkv, rep)).sum(2).transpose(1, 2)
               - dk).abs().max().item(),
        "dv": (dv_l.unflatten(1, (hkv, rep)).sum(2).transpose(1, 2)
               - dv).abs().max().item(),
    }
    del dq_l, dk_l, dv_l
    calls = {
        "flash_fwd": (lambda: K.flash_fwd(q, k, v, nv, **kw),
                      lambda: K.flash_fwd_plain(q, k, v, nv, **kw),
                      lambda: F.scaled_dot_product_attention(
                          qt, kt, vt, is_causal=True)),
        "flash_bwd_dq": (lambda: K.flash_bwd_dq(q, k, v, do, lse, delta, nv,
                                                **kw),
                         lambda: K.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                      nv, **kw), lib_bwd),
        "flash_bwd_dkv": (lambda: K.flash_bwd_dkv(q, k, v, do, lse, delta, nv,
                                                  **kw),
                          lambda: K.flash_bwd_dkv_plain(q, k, v, do, lse,
                                                        delta, nv, **kw),
                          lib_bwd),
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
        times[name]["tf32x3_bound_ms"] = max(3 * flops / peak_tf32 * 1e3,
                                             t_mem)
    return times


# ------------------------------------------- phase 2, the scans' shared parts


def check_case(label: str, got: dict, want: dict, fwd: tuple, tols: tuple,
               kernels: tuple, errs: dict, cases: dict) -> None:
    """Hold each kernel output in ``got`` to its plain version in ``want``
    (None where neither computes it): the forward kernel's outputs (names
    in ``fwd``) allclose at tols[0] abs and rel, the backward's within
    tols[1] x max|plain|.  Records the case under ``cases[label]``, the
    largest error of each of ``kernels`` (forward, backward) in ``errs``,
    and raises on a miss."""
    import torch

    torch.cuda.synchronize()
    res = {}
    for name, ref in want.items():
        if ref is None:
            if got[name] is not None:
                raise AssertionError(f"case {label}: {name} should be None")
            continue
        err = (got[name] - ref).abs().max().item()
        scale = ref.abs().max().item()
        kernel = kernels[0] if name in fwd else kernels[1]
        if name in fwd:
            ok = torch.allclose(got[name], ref, atol=tols[0], rtol=tols[0])
        else:
            ok = err <= tols[1] * max(scale, 1e-30)
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        res[name] = {"max_abs_err": err, "ref_max": scale, "ok": ok,
                     "equal": bool(torch.equal(got[name], ref))}
    log(f"  case {label}: " + ", ".join(
        f"{k} err {v['max_abs_err']:.3g}{' (equal)' if v['equal'] else ''}"
        for k, v in res.items()))
    cases[label] = res
    bad = [k for k, v in res.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"case {label} failed on {bad}: {res}")


def time_plain_and_kernel(calls: dict, work: dict, peak_flops: float,
                          peak_bw: float, plain_iters: int) -> dict:
    """Kernel and plain times for kernels no single PyTorch call matches
    (library none), with the bound from ``work[name] = (flops, bytes)``."""
    times = {}
    for name, (kern, plain) in calls.items():
        flops, nbytes = work[name]
        t_ops, t_mem = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        times[name] = {
            "ms": time_ms(kern, 20), "plain_ms": time_ms(plain, plain_iters),
            "library_ms": None,
            "bound_ms": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
            "flops": flops, "bytes": nbytes,
        }
    return times


# ------------------------------------------------------- phase 2, SSD scan

# (name, B, nc, cl, H, G, P, N): the mamba2-1.3b cell (seq 2048 in chunks of
# 64) with B and C for its one group, as the main path runs it, and per head
# (G = H, the reference's layout), tests/test_kernels.py::SSD_CASES[1] (seq
# 128, chunk 32), a ragged shape whose cl, P and N are no multiples of the
# mma tiles, and the same with two groups of three heads
SSD_CASES = [("cell", 2, 32, 64, 64, 1, 64, 128),
             ("cell-per-head", 2, 32, 64, 64, 64, 64, 128),
             ("chunk32", 1, 4, 32, 2, 2, 32, 16),
             ("ragged", 1, 3, 40, 3, 3, 20, 12),
             ("ragged-g2", 1, 3, 40, 6, 2, 20, 12)]


def ssd_inputs(case, dev, seed):
    """x, a, b, c, dy, ds in the kernels' (B,nc,cl,H or G,...) layout; a =
    -|z| / 10, the reference tests' decay scale."""
    import torch

    _, b, nc, cl, h, grp, p, n = case
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, nc, cl, h, p), generator=g, device=dev)
    a = -torch.randn((b, nc, cl, h), generator=g, device=dev).abs() * 0.1
    bm = torch.randn((b, nc, cl, grp, n), generator=g, device=dev)
    cm = torch.randn((b, nc, cl, grp, n), generator=g, device=dev)
    dy = torch.randn((b, nc, cl, h, p), generator=g, device=dev)
    ds = torch.randn((b, nc, h, p, n), generator=g, device=dev)
    return x, a, bm, cm, dy, ds


def check_ssd_kernels(report: dict) -> dict:
    """ssd_fwd / ssd_bwd against their plain versions on the same inputs;
    a second launch of each must repeat the first bit for bit."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as K

    dev = torch.device("cuda")
    errs = {}
    for case in SSD_CASES:
        x, a, bm, cm, dy, ds = ssd_inputs(case, dev, seed=len(case[0]))
        got = dict(zip(("y", "state"), K.ssd_intra_chunk(x, a, bm, cm)))
        want = dict(zip(("y", "state"), K.ssd_intra_chunk_plain(x, a, bm, cm)))
        names = ("dx", "da", "db", "dc")
        got.update(zip(names, K.ssd_intra_chunk_bwd(x, a, bm, cm, dy, ds)))
        want.update(zip(names, K.ssd_intra_chunk_bwd_plain(x, a, bm, cm, dy,
                                                           ds)))
        label = f"ssd {case[0]} {case[1:]}"
        check_case(label, got, want, ("y", "state"),
                   (SSD_FWD_TOL, SSD_BWD_TOL), ("ssd_fwd", "ssd_bwd"), errs,
                   report["ssd_cases"])
        again = dict(zip(("y", "state"), K.ssd_intra_chunk(x, a, bm, cm)))
        again.update(zip(names, K.ssd_intra_chunk_bwd(x, a, bm, cm, dy, ds)))
        for kernel, keys in (("fwd", ("y", "state")), ("bwd", names)):
            repeats = all(bool(torch.equal(again[k], got[k])) for k in keys)
            report["ssd_cases"][label][f"{kernel}_repeats_bit_for_bit"] = \
                repeats
            log(f"    ssd_{kernel} repeats bit for bit: {repeats}")
            if not repeats:
                raise AssertionError(f"case {label}: a second ssd_{kernel} "
                                     "launch differs from the first")
    return errs


def check_ssd_fp64() -> dict:
    """The differentiable scan through the kernel pair (``ops.ssd``, fp32, B
    and C per group) and the plain fp32 ``ssd_chunked`` against a float64
    ``ssd_chunked`` (both on B and C repeated to heads; autograd for the
    gradients), at the cell's shapes."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd, ssd_chunked

    dev = torch.device("cuda")
    _, b, nc, cl, h, grp, p, n = SSD_CASES[0]
    x, a, bm, cm, _, _ = ssd_inputs(SSD_CASES[0], dev, seed=64)
    flat = [t.reshape(b, nc * cl, *t.shape[3:]) for t in (x, a, bm, cm)]
    g = torch.Generator(device=dev).manual_seed(65)
    gy = torch.randn(flat[0].shape, generator=g, device=dev)
    gs = torch.randn((b, h, p, n), generator=g, device=dev)
    names = ("y", "state", "dx", "da", "db", "dc")

    def run(fn, dtype):
        leaves = [t.to(dtype).requires_grad_() for t in flat]
        y, st = fn(*leaves)
        loss = (y * gy.to(dtype)).sum() + (st * gs.to(dtype)).sum()
        grads = torch.autograd.grad(loss, leaves)
        return dict(zip(names, (y.detach(), st.detach(), *grads)))

    def chunked(x_, a_, b_, c_):
        return ssd_chunked(x_, a_, b_.repeat_interleave(h // grp, 2),
                           c_.repeat_interleave(h // grp, 2), cl)

    ref = run(chunked, torch.float64)
    got = {"kernel": run(lambda *v: ssd(*v, chunk=cl), torch.float32),
           "plain": run(chunked, torch.float32)}
    res = {}
    for name, r in ref.items():
        scale = r.abs().max().item()
        res[name] = {
            label: (got[label][name].double() - r).abs().max().item()
            for label in got}
        res[name]["ref_max"] = scale
        tol = SSD_FWD_TOL if name in ("y", "state") else SSD_BWD_TOL
        if res[name]["kernel"] > tol * scale:
            raise AssertionError(f"ssd {name} off the float64 scan: {res}")
    return res


def ssd_work(case) -> dict:
    """kernel -> (flops, bytes) of the SSD function at one of ``SSD_CASES``.

    Operations: the products the function needs, the score products over
    the lower triangle (cl (cl + 1) / 2 pairs) only, and C B^T once per
    (b, chunk, group).  Forward: C B^T and Sc X on the triangle, X^T (B o w)
    in full.  Backward: C B^T, dY X^T, Sc^T dY, dG B and dG^T C on the
    triangle, (B o w) dS^T and X dS in full.  Bytes: each input read once,
    each output written once, B, C, dB and dC per group."""
    _, b, nc, cl, h, grp, p, n = case
    tri, f4 = cl * (cl + 1) // 2, 4
    heads, groups = b * nc * h, b * nc * grp
    xb, ab = b * nc * cl * h * p * f4, b * nc * cl * h * f4
    nb, sb = b * nc * cl * grp * n * f4, b * nc * h * p * n * f4
    cbt = groups * 2 * tri * n
    return {
        "ssd_fwd": (heads * (2 * tri * p + 2 * cl * p * n) + cbt,
                    2 * xb + ab + 2 * nb + sb),
        "ssd_bwd": (heads * (2 * tri * (2 * n + 2 * p) + 4 * cl * p * n) + cbt,
                    2 * (xb + ab + 2 * nb) + xb + sb),
    }


def time_ssd_kernels(peak_flops: float, peak_bw: float,
                     peak_tf32: float) -> dict:
    """Kernel and plain times at the cell's shapes with B and C per group
    (the main path), with the bound and the 3xTF32 bound (both kernels run
    on the tensor cores); then the kernels' times with B and C per head
    (G = H), the layout of the per-head kernels that came before, as
    ``per_head_ms`` beside that layout's bounds.  ``ssd_bwd``'s time
    includes the wrapper's sum of dB and dC over each group's heads;
    ``launch_ms`` is its kernel alone, which writes them per head."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as K

    dev = torch.device("cuda")
    x, a, bm, cm, dy, ds = ssd_inputs(SSD_CASES[0], dev, seed=0)
    calls = {
        "ssd_fwd": (lambda: K.ssd_intra_chunk(x, a, bm, cm),
                    lambda: K.ssd_intra_chunk_plain(x, a, bm, cm)),
        "ssd_bwd": (lambda: K.ssd_intra_chunk_bwd(x, a, bm, cm, dy, ds),
                    lambda: K.ssd_intra_chunk_bwd_plain(x, a, bm, cm, dy,
                                                        ds)),
    }
    work = ssd_work(SSD_CASES[0])
    times = time_plain_and_kernel(calls, work, peak_flops, peak_bw, 5)
    times["ssd_bwd"]["launch_ms"] = time_ms(
        lambda: K.ssd_bwd_per_head(x, a, bm, cm, dy, ds), 20)
    del x, a, bm, cm, dy, ds, calls
    head_work = ssd_work(SSD_CASES[1])
    x, a, bm, cm, dy, ds = ssd_inputs(SSD_CASES[1], dev, seed=0)
    per_head = {"ssd_fwd": lambda: K.ssd_intra_chunk(x, a, bm, cm),
                "ssd_bwd": lambda: K.ssd_intra_chunk_bwd(x, a, bm, cm, dy, ds)}
    for name, tm in times.items():
        (flops, nbytes), (hflops, hbytes) = work[name], head_work[name]
        tm["tf32x3_bound_ms"] = max(3 * flops / peak_tf32,
                                    nbytes / peak_bw) * 1e3
        tm["per_head_ms"] = time_ms(per_head[name], 20)
        tm["per_head_bound_ms"] = max(hflops / peak_flops,
                                      hbytes / peak_bw) * 1e3
        tm["per_head_tf32x3_bound_ms"] = max(3 * hflops / peak_tf32,
                                             hbytes / peak_bw) * 1e3
    return times


# ----------------------------------------------------- phase 2, RG-LRU scan

# (name, B, L, W, h0): the recurrentgemma-9b cell (lru_width 4096, seq 2048;
# the main path runs B 2 without h0), B 1, and a W that is no multiple of 128
RGLRU_CASES = [("cell", 2, 2048, 4096, False),
               ("cell-h0", 2, 2048, 4096, True),
               ("b1-h0", 1, 2048, 4096, True), ("w200", 2, 100, 200, True)]


def rglru_inputs(case, dev, seed):
    """a = sigmoid(z) (the reference tests' gates), bx, h0 (or None), dh,
    dhT standard normal."""
    import torch

    _, b, l, w, with_h0 = case
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.sigmoid(torch.randn((b, l, w), generator=g, device=dev))
    bx, h0, dh, dh_t = (torch.randn(shape, generator=g, device=dev) for shape
                        in ((b, l, w), (b, w), (b, l, w), (b, w)))
    return a, bx, (h0 if with_h0 else None), dh, dh_t


def check_rglru_kernels(report: dict) -> dict:
    """rglru_fwd / rglru_bwd against their plain versions on the same
    inputs (they round alike, so bit-equality is reported too); a second
    rglru_fwd launch must repeat the first bit for bit."""
    import torch
    from repro_torch.kernels.rglru_scan import kernel as K

    dev = torch.device("cuda")
    errs = {}
    for case in RGLRU_CASES:
        a, bx, h0, dh, dh_t = rglru_inputs(case, dev, seed=len(case[0]))
        got = dict(zip(("h", "hT"), K.rglru_linear_scan(a, bx, h0)))
        want = dict(zip(("h", "hT"), K.rglru_linear_scan_plain(a, bx, h0)))
        names = ("da", "dbx", "dh0")
        got.update(zip(names, K.rglru_linear_scan_bwd(a, got["h"], h0, dh,
                                                      dh_t)))
        want.update(zip(names, K.rglru_linear_scan_bwd_plain(
            a, want["h"], h0, dh, dh_t)))
        label = f"rglru {case[0]} {case[1:]}"
        check_case(label, got, want, ("h", "hT"),
                   (RGLRU_FWD_TOL, RGLRU_BWD_TOL), ("rglru_fwd", "rglru_bwd"),
                   errs, report["rglru_cases"])
        again = K.rglru_linear_scan(a, bx, h0)
        torch.cuda.synchronize()
        repeats = all(bool(torch.equal(x, got[k]))
                      for k, x in zip(("h", "hT"), again))
        report["rglru_cases"][label]["fwd_repeats_bit_for_bit"] = repeats
        log(f"    rglru_fwd repeats bit for bit: {repeats}")
        if not repeats:
            raise AssertionError(f"case {label}: a second rglru_fwd launch "
                                 "differs from the first")
    return errs


def check_rglru_fp64() -> dict:
    """The scan through the kernel pair (``ops.rglru``, fp32) and the plain
    fp32 versions against the doubling ``rglru_scan`` in float64 (autograd
    for the gradients), at the cell's shapes with h0; then the forward
    kernel alone as the main path runs it (no h0) against the float64
    scan (``fwd_no_h0``)."""
    import torch
    from repro_torch.kernels.rglru_scan import kernel as K
    from repro_torch.kernels.rglru_scan import rglru, rglru_scan

    dev = torch.device("cuda")
    a, bx, h0, dh, dh_t = rglru_inputs(RGLRU_CASES[1], dev, seed=64)
    names = ("h", "hT", "da", "dbx", "dh0")

    def run(fn, dtype):
        leaves = [t.to(dtype).requires_grad_() for t in (a, bx, h0)]
        h, h_t = fn(*leaves)
        loss = (h * dh.to(dtype)).sum() + (h_t * dh_t.to(dtype)).sum()
        grads = torch.autograd.grad(loss, leaves)
        return dict(zip(names, (h.detach(), h_t.detach(), *grads)))

    def scan(aa, bb, hh):
        h = rglru_scan(aa, bb, initial=hh)
        return h, h[:, -1]

    ref = run(scan, torch.float64)
    h_p, h_t_p = K.rglru_linear_scan_plain(a, bx, h0)
    plain = dict(zip(names, (h_p, h_t_p, *K.rglru_linear_scan_bwd_plain(
        a, h_p, h0, dh, dh_t))))
    got = {"kernel": run(rglru, torch.float32), "plain": plain}
    res = {}
    for name, r in ref.items():
        scale = r.abs().max().item()
        res[name] = {label: (got[label][name].double() - r).abs().max().item()
                     for label in got}
        res[name]["ref_max"] = scale
        tol = RGLRU_FWD_TOL if name in ("h", "hT") else RGLRU_BWD_TOL
        if res[name]["kernel"] > tol * scale:
            raise AssertionError(f"rglru {name} off the float64 scan: {res}")
    a, bx, _, _, _ = rglru_inputs(RGLRU_CASES[0], dev, seed=65)
    h, h_t = K.rglru_linear_scan(a, bx)
    ref = rglru_scan(a.double(), bx.double())
    res["fwd_no_h0"] = {
        "h": (h.double() - ref).abs().max().item(),
        "hT": (h_t.double() - ref[:, -1]).abs().max().item(),
        "ref_max": ref.abs().max().item()}
    if max(res["fwd_no_h0"]["h"], res["fwd_no_h0"]["hT"]) > \
            RGLRU_FWD_TOL * res["fwd_no_h0"]["ref_max"]:
        raise AssertionError(f"rglru_fwd off the float64 scan: {res}")
    return res


def time_rglru_kernels(peak_flops: float, peak_bw: float) -> dict:
    """Kernel and plain times at the main path's shapes (B 2, L 2048, W
    4096, no h0), with the bound.  Bytes: each input read once, each output
    written once (forward: a, bx in, h, hT out; backward: a, h, dh, dhT in,
    da, dbx out).  Operations: a multiply and an add per element forward,
    an add and two multiplies backward."""
    import torch
    from repro_torch.kernels.rglru_scan import kernel as K

    dev = torch.device("cuda")
    a, bx, h0, dh, dh_t = rglru_inputs(RGLRU_CASES[0], dev, seed=0)
    h, _ = K.rglru_linear_scan(a, bx, h0)
    f4, n, row = 4, a.numel(), dh_t.numel()
    work = {"rglru_fwd": (2 * n, (3 * n + row) * f4),
            "rglru_bwd": (3 * n, (5 * n + row) * f4)}
    calls = {
        "rglru_fwd": (lambda: K.rglru_linear_scan(a, bx, h0),
                      lambda: K.rglru_linear_scan_plain(a, bx, h0)),
        "rglru_bwd": (lambda: K.rglru_linear_scan_bwd(a, h, h0, dh, dh_t),
                      lambda: K.rglru_linear_scan_bwd_plain(a, h, h0, dh,
                                                            dh_t)),
    }
    return time_plain_and_kernel(calls, work, peak_flops, peak_bw, 3)


# ------------------------------------------------------------------ phase 3


def check_model_path(arch: str) -> dict:
    """LM loss + grads with the kernels vs the plain path (attention, SSD
    or RG-LRU scan), reduced config, seq 128, one loss-masked row."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm, lm_loss, reduced

    dev = torch.device("cuda")
    cfg = reduced(get_config(arch))
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 128), generator=g,
                           device=dev)
    targets = torch.randint(0, cfg.vocab_size, (4, 128), generator=g,
                            device=dev)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev)
    nv = torch.tensor(3, dtype=torch.int32, device=dev)
    res = {}
    reset_all_launches()
    for use_kernel in (True, False):
        leaves = {k_: p.detach().requires_grad_() for k_, p in params.items()}
        ls, _, _ = lm_loss(leaves, cfg.with_(use_pallas=use_kernel), tokens,
                           targets, mask, num_valid=nv if use_kernel else None)
        grads = torch.autograd.grad(ls, list(leaves.values()))
        res[use_kernel] = (ls.item(), grads)
    launched = {k: v for k, v in all_launches().items() if v}
    (lk, gk), (lp, gp) = res[True], res[False]
    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = max(((a - b_).abs().max() / b_.abs().max().clamp_min(1e-30))
                   .item() for a, b_ in zip(gk, gp))
    out = {"arch": arch, "loss_kernel": lk, "loss_plain": lp,
           "loss_rel_err": loss_rel, "grad_rel_err": grad_rel,
           "tol": MODEL_TOL, "launches": launched}
    if not (math.isfinite(lk) and loss_rel <= MODEL_TOL
            and grad_rel <= MODEL_TOL and launched):
        raise AssertionError(f"kernel path disagrees with plain path: {out}")
    return out


def kernel_modules():
    from repro_torch.kernels import flash_attention, rglru_scan, ssd_scan

    return flash_attention, ssd_scan, rglru_scan


def all_launches() -> dict:
    return {k: v for mod in kernel_modules() for k, v in mod.LAUNCHES.items()}


def reset_all_launches() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


# kernel -> the profiler name fragment of each CUDA kernel its wrapper
# launches (flash_bwd_dkv: the per-head kernel, then the group-sum)
FLASH = {"flash_fwd": ("::fwd_kernel<",), "flash_bwd_dq": ("::dq_kernel<",),
         "flash_bwd_dkv": ("::dkv_kernel<", "::dkv_sum_kernel(")}
# path -> (arch, layers, seq, the path's kernels: name -> (profiler name
# fragments, layers of the path that launch it once per microbatch)); each
# kernel's table entry reads the first path listing it
PATHS = {
    "gemma": ("gemma-2b", 2, 1024,
              {k: (frag, 2) for k, frag in FLASH.items()}),
    "mamba2": ("mamba2-1.3b", 4, 2048,
               {"ssd_fwd": (("ssd_fwd_kernel",), 4),
                "ssd_bwd": (("ssd_bwd_kernel",), 4)}),
    "recurrentgemma": ("recurrentgemma-9b", 3, 2048,
                       {"rglru_fwd": (("rglru_fwd_kernel",), 2),
                        "rglru_bwd": (("rglru_bwd_kernel",), 2),
                        **{k: (frag, 1) for k, frag in FLASH.items()}}),
}


def step_clock(profile_step=None, frags=None):
    """A session hook that records each step's wall ms (host clock around
    synchronized steps) and, given ``profile_step``, runs torch.profiler
    over that step: device time by kernel (``frags``, see
    ``profile_summary``) and the device's idle share.  The profiler's own
    start and stop fall outside every timed window."""
    import torch
    from repro_torch.api import Hook

    class StepClock(Hook):
        def __init__(self):
            self.ms, self.t, self.prof, self.profile = [], None, None, None

        def on_run_start(self, session):
            torch.cuda.synchronize()
            self.t = time.perf_counter()

        def on_step(self, session, rec):
            torch.cuda.synchronize()
            wall = time.perf_counter() - self.t
            self.ms.append(wall * 1e3)
            if profile_step is None:
                pass
            elif rec.step == profile_step - 1:
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                self.prof.__enter__()
            elif rec.step == profile_step and self.prof is not None:
                self.prof.__exit__(None, None, None)
                self.profile = profile_summary(self.prof, wall * 1e6, frags)
            self.t = time.perf_counter()

    return StepClock()


def main_path(path: str, *, steps: int = STEPS, global_batch=None,
              optimizer=None, profile: bool = True, hooks=(), cluster=None,
              workers: int = 3) -> dict:
    """One heterogeneous Experiment at the arch's full widths (depth cut),
    ``steps`` BSP steps, three h-level workers, the fixed outer kind and
    adam(1e-3) unless ``global_batch`` / ``optimizer`` / ``cluster`` (with
    the data pipeline's ``workers``) say otherwise; every launch count is
    set to 0 just before the run and read just after, and held against the
    microbatches of the batches each step ran with (recorded as the step
    starts, after the membership events due at it).  The last step runs
    under torch.profiler when ``profile``; ``hooks`` are extra session
    hooks."""
    import torch
    from repro_torch.api import (ClusterSpec, Experiment, TrainConfig,
                                 lm_workload)
    from repro_torch.configs import get_config
    from repro_torch.core import (ControllerConfig, GlobalBatchConfig,
                                  plan_microbatches)
    from repro_torch.data import DataPipeline
    from repro_torch.optim import adam

    arch, layers, seq, own = PATHS[path]
    frags = {k: frag for k, (frag, _) in own.items()}
    cfg = get_config(arch, num_layers=layers)
    experiment = Experiment(
        workload=lm_workload(cfg, DataPipeline(cfg, seq_len=seq,
                                               num_workers=workers),
                             aux_weight=0.01, use_kernel=True),
        cluster=cluster or ClusterSpec.hlevel(39, 6.0, 3,
                                              workload="transformer", seed=0),
        optimizer=optimizer or adam(1e-3),
        config=TrainConfig(b0=4, microbatch=MICROBATCH, batching="dynamic",
                           sync="bsp", max_steps=steps,
                           controller=ControllerConfig(kind="p"),
                           global_batch=global_batch or GlobalBatchConfig()),
    )
    clock = step_clock(profile_step=steps - 1 if profile else None,
                       frags=frags)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    session = experiment.session(hooks=[clock, *hooks])
    n_params = sum(p.numel() for p in session.params.values())
    trainer, ran = session.trainer, []
    bsp_step = trainer.bsp_step

    def recorded_step():
        ran.append(list(trainer.batches))
        return bsp_step()

    trainer.bsp_step = recorded_step
    reset_all_launches()
    try:
        out = session.run()
    finally:
        del trainer.bsp_step        # no cycle holds the trainer's tensors
    counts = all_launches()
    hist = out["history"]
    per_step = [sum(plan_microbatches(b_, MICROBATCH).n_steps for b_ in bs)
                for bs in ran]
    micro = sum(per_step)
    want = {k: n_layers * micro for k, (_, n_layers) in own.items()}
    losses = [r.loss for r in hist]
    for r, ms in zip(hist, clock.ms):
        log(f"  step {r.step} wall {ms:.1f} ms  loss {r.loss:.4f}  "
            f"batches {r.batches}  sim_time {r.sim_time:.4f}  "
            f"adjusted {r.adjusted}")
    res = {"arch": arch, "layers": layers, "seq": seq, "params": n_params,
           "ran_batches": ran,
           "membership_log": [list(e) for e in
                              out.get("membership_log", [])],
           "losses": losses, "batches": [r.batches for r in hist],
           "sim_time": [r.sim_time for r in hist],
           "step_wall_ms": clock.ms, "microbatches": micro,
           "launches": counts, "expected_launches": want,
           "microbatches_per_step": per_step,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "profile": clock.profile}
    del session, experiment, out, trainer, bsp_step
    torch.cuda.empty_cache()
    if len(hist) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{path} path: bad losses {losses}")
    wrong = {k: c for k, c in counts.items() if c != want.get(k, 0)}
    if wrong or micro <= 0:
        raise AssertionError(
            f"{path} path launches {counts}: want {want} (layers launching "
            f"each x {micro} microbatches), 0 for the others")
    prof = clock.profile
    if prof and prof["device_busy_us"]:
        missing = [f for f, us in prof["fragments_us"].items() if not us > 0]
        if missing:
            raise AssertionError(f"{path} path: {missing} absent from the "
                                 f"profiled step's device kernels: {prof}")
    return res


def profile_summary(prof, wall_us: float, own: dict, top: int = 8) -> dict:
    """Device time by kernel (self time, us) over one profiled step;
    ``fragments_us`` sums it by name fragment, ``kernels_us`` by wrapper
    (the fragments in ``own[name]``)."""
    kernels = {}
    for ev in prof.events():
        if getattr(ev, "device_type", None) is None or \
                str(ev.device_type) != "DeviceType.CUDA":
            continue
        kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.device_time_total
    busy = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    by_frag = {f: sum(t for n, t in kernels.items() if f in n)
               for frags in own.values() for f in frags}
    mine = {k: sum(by_frag[f] for f in frags) for k, frags in own.items()}
    gemm = sum(t for n, t in kernels.items()
               if "gemm" in n.lower() or "sgemm" in n.lower())
    # device time of the kernels that the CPU op aten::dot launched: the
    # GNS side statistics (core/grad.py::tree_sqnorm); nothing else on the
    # main paths calls it
    dots = [ev for ev in prof.events() if ev.name == "aten::dot"
            and str(getattr(ev, "device_type", "")) != "DeviceType.CUDA"]
    return {"step_wall_us": wall_us, "device_busy_us": busy,
            "idle_share": (1 - busy / wall_us) if busy else None,
            "kernels_us": mine, "fragments_us": by_frag, "gemm_us": gemm,
            "sqnorm_us": sum(ev.device_time_total for ev in dots),
            "sqnorm_calls": len(dots),
            "sqnorm_kernels": sorted({k.name[:60] for ev in dots
                                      for k in getattr(ev, "kernels", ())}),
            "top": [(n[:90], t) for n, t in ranked[:top]]}


def log_path(mp: dict) -> None:
    log_profile(mp["profile"])
    log(f"  params {mp['params']}, microbatches {mp['microbatches']} (per "
        f"step {mp['microbatches_per_step']}), launches "
        f"{ {k: v for k, v in mp['launches'].items() if v} }, "
        f"max_memory_allocated {mp['max_memory_allocated'] / 2**30:.2f} GiB")


def log_profile(pr) -> None:
    if pr is None:
        log("  no step profiled")
    elif pr["device_busy_us"]:
        log(f"  profiled step: wall {pr['step_wall_us'] / 1e3:.1f} ms, device "
            f"busy {pr['device_busy_us'] / 1e3:.1f} ms (idle share "
            f"{pr['idle_share']:.3f}); gemm {pr['gemm_us'] / 1e3:.1f} ms, "
            "own kernels " + ", ".join(
                f"{k} {us / 1e3:.1f} ms" for k, us in pr["kernels_us"].items()))
        for name, us in pr["top"]:
            log(f"    {us / 1e3:8.2f} ms  {name}")
    else:
        log("  profiled step: no device time recorded (not measured)")


# ------------------------------------------------------ phase 9, outer kinds

# (name, GlobalBatchConfig knobs, LR coupling rule or None): the gemma path
# with the outer controller walking B along the ladder [12, 24]
OUTER_RUNS = [
    ("gns", dict(kind="gns", warmup=2, cooldown=2, gns_min_samples=2,
                 ladder_growth=2.0, max_factor=2.0), None),
    ("geometric", dict(kind="geometric", warmup=2, cooldown=2, geo_every=2,
                       ladder_growth=2.0, max_factor=2.0), "sqrt"),
]
OUTER_STEPS = 6


def outer_probe():
    """A session hook that records, every step, B and the split, the
    outer controller's rung, resize log and estimator, the coupled LR's
    scale, and the |g_k|^2 / |g|^2 side statistics fed to the controller
    (its ``observe`` is wrapped at the run's start)."""
    from repro_torch.api import Hook

    class OuterProbe(Hook):
        def __init__(self):
            self.steps, self.stats = [], []

        def on_run_start(self, session):
            outer = session.trainer.outer
            observe = outer.observe

            def spy(**kw):
                self.stats.append(kw["stats"])
                return observe(**kw)

            outer.observe = spy

        def on_step(self, session, rec):
            t = session.trainer
            est = getattr(t.outer, "estimator", None)
            sched = getattr(t.optimizer, "schedule", None)
            st = self.stats[-1]
            self.steps.append({
                "step": rec.step, "batches": list(rec.batches),
                "b_global": sum(rec.batches), "rung": t.outer.rung,
                "rungs": list(t.outer.rungs),
                "resize_log": [list(x) for x in t.outer.resize_log],
                "b_noise": est.b_noise if est else None,
                "samples": est.samples if est else None,
                "lr_scale": getattr(sched, "scale", None),
                "sqnorms": None if st is None else list(st.per_worker_sqnorm),
                "combined_sqnorm": None if st is None
                else st.combined_sqnorm})

    return OuterProbe()


def outer_run(name: str, knobs: dict, rule, bytes_per_pass: int,
              peak_bw: float) -> dict:
    """One 6-step run of the gemma path with an outer kind: launch counts
    and the rest of ``main_path``'s checks, then this kind's own."""
    from repro_torch.core import GlobalBatchConfig
    from repro_torch.optim import adam, batch_coupled

    probe = outer_probe()
    lr = 1e-3 if rule is None else batch_coupled(1e-3, rule=rule)
    mp = main_path("gemma", steps=OUTER_STEPS,
                   global_batch=GlobalBatchConfig(**knobs),
                   optimizer=adam(lr), profile=name == "gns", hooks=[probe])
    steps = probe.steps
    for st, ms in zip(steps, mp["step_wall_ms"]):
        log(f"  {name} step {st['step']}: wall {ms:.1f} ms, B "
            f"{st['b_global']} {st['batches']}, rung {st['rung']}, b_noise "
            f"{st['b_noise']}, samples {st['samples']}, lr scale "
            f"{st['lr_scale']}, |g_k|^2 {st['sqnorms']}, |g|^2 "
            f"{st['combined_sqnorm']}")
    res = {**mp, "kind": name, "outer_steps": steps}
    rungs = steps[0]["rungs"]
    bad = [st["step"] for st in steps if st["b_global"] not in rungs]
    if rungs != [12, 24] or bad:
        raise AssertionError(f"{name}: ladder {rungs}, off-ladder B at "
                             f"steps {bad}")
    if name == "gns":
        sq = [x for st in steps
              for x in st["sqnorms"] + [st["combined_sqnorm"]]]
        if not (len(sq) == 4 * OUTER_STEPS
                and all(math.isfinite(x) and x > 0 for x in sq)):
            raise AssertionError(f"gns: side statistics {sq}")
        if steps[-1]["samples"] != OUTER_STEPS:
            raise AssertionError(f"gns: the estimator accepted "
                                 f"{steps[-1]['samples']} of {OUTER_STEPS}")
        prof = mp["profile"] or {}
        res["sqnorm_bound_ms"] = 4 * bytes_per_pass / peak_bw * 1e3
        res["sqnorm_ms"] = (prof["sqnorm_us"] / 1e3
                            if prof.get("device_busy_us") else None)
        log(f"  gns side statistics in the profiled step: "
            + ("not measured (no device time recorded)"
               if res["sqnorm_ms"] is None else
               f"{res['sqnorm_ms']:.3f} ms device over "
               f"{prof['sqnorm_calls']} aten::dot calls "
               f"({prof['sqnorm_kernels']})")
            + f"; bytes bound {res['sqnorm_bound_ms']:.3f} ms (4 passes over "
            f"{bytes_per_pass / 1e9:.2f} GB)")
    else:
        at = [st["step"] for st in steps if st["b_global"] == 24]
        scale = steps[-1]["lr_scale"]
        res["resize_fired_in_step"] = at[0] if at else None
        res["resize_log"] = steps[-1]["resize_log"]
        # each step's wall ms by the B it ran at (step 0, the warm-up, out)
        ran_at = [12] + [st["b_global"] for st in steps[:-1]]
        res["step_wall_ms_at_b"] = {
            b: [w for w, r in zip(mp["step_wall_ms"][1:], ran_at[1:])
                if r == b] for b in (12, 24)}
        log(f"  geometric: B 12 -> 24 fired in step "
            f"{res['resize_fired_in_step']} (resize log "
            f"{res['resize_log']}), lr scale {scale}; step wall ms by the B "
            f"each step ran at (step 0 left out): "
            f"{res['step_wall_ms_at_b']}")
        if res["resize_log"] != [[2, 24]] or scale != math.sqrt(2):
            raise AssertionError(f"geometric: resize log "
                                 f"{res['resize_log']}, lr scale {scale}")
    return res


def check_outer_kinds(peak_bw: float) -> dict:
    """Phase 9: the gemma path at full width with the gns and geometric
    outer kinds (see the module docstring)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import tree_sqnorm
    from repro_torch.models import init_lm

    # the side statistics' bytes: every fp32 parameter of the path, read
    # once a pass; and one pass timed alone at the path's shapes
    cfg = get_config(PATHS["gemma"][0], num_layers=PATHS["gemma"][1])
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)
    n = sum(p.numel() for p in params.values())
    pass_ms = time_ms(lambda: tree_sqnorm(params), 5)
    del params
    torch.cuda.empty_cache()
    log(f"  tree_sqnorm alone over {n} fp32 parameters: {pass_ms:.3f} ms a "
        f"pass (bytes bound {4 * n / peak_bw * 1e3:.3f} ms)")
    res = {"params": n, "sqnorm_pass_ms": pass_ms,
           "sqnorm_pass_bound_ms": 4 * n / peak_bw * 1e3}
    for name, knobs, rule in OUTER_RUNS:
        log(f"  {name}: GlobalBatchConfig({knobs}), adam("
            + ("1e-3" if rule is None else f"batch_coupled(1e-3, {rule!r})")
            + f"), {OUTER_STEPS} BSP steps")
        res[name] = outer_run(name, knobs, rule, 4 * n, peak_bw)
        log_path(res[name])
    return res


# ------------------------------------------------- phases 7-8, paper workloads


def paper_experiment(name: str, batching: str, steps: int, cluster=None):
    """One of the paper's workloads as ``tests/test_system.py`` runs it:
    three CPU-core workers of h-level 8 over 39 cores unless ``cluster``
    says otherwise, b0 32, microbatch 8, BSP, adam(2e-3), the batch
    stream's seed 100; on the card."""
    from repro_torch.api import (ClusterSpec, Experiment, TrainConfig,
                                 paper_workload)
    from repro_torch.optim import adam

    return Experiment(
        workload=paper_workload(name, seed=100),
        cluster=cluster or ClusterSpec.hlevel(39, 8, workload=name, seed=0),
        optimizer=adam(2e-3),
        config=TrainConfig(b0=32, microbatch=8, batching=batching,
                           sync="bsp", max_steps=steps))


def paper_run(name: str, batching: str, steps: int) -> dict:
    """``paper_experiment(...).run()`` with per-step wall ms (host clock
    around synchronized steps), peak memory and the port's kernel launch
    counts, which must stay 0 (the paper workloads' convolutions and
    products are PyTorch calls, as they are XLA's in the reference)."""
    import torch

    clock = step_clock()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    out = paper_experiment(name, batching, steps).run(hooks=[clock])
    launched = {k: v for k, v in all_launches().items() if v}
    losses = [r.loss for r in out["history"]]
    res = {"workload": name, "batching": batching, "steps": out["steps"],
           "sim_time": out["sim_time"], "final_loss": out["final_loss"],
           "batch_adjustments": out["batch_adjustments"],
           "final_batches": out["final_batches"], "losses": losses,
           "step_wall_ms": clock.ms,
           "steady_step_wall_ms": sorted(clock.ms[1:])[(steps - 1) // 2],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launched}
    log(f"  {name} {batching}: {out['steps']} steps, sim_time "
        f"{out['sim_time']:.4f} s, final loss (EWMA) {out['final_loss']:.4f}, "
        f"final batches {out['final_batches']}, adjustments "
        f"{out['batch_adjustments']}; step wall ms median "
        f"{res['steady_step_wall_ms']:.2f} (step 0 {clock.ms[0]:.1f}), peak "
        f"memory {res['max_memory_allocated'] / 2**20:.1f} MiB")
    if out["steps"] != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name} {batching}: bad run {res}")
    if launched:
        raise AssertionError(f"{name} {batching} launched {launched}")
    return res


def check_paper_workloads() -> dict:
    """The paper's compute-bound claim on the card
    (``test_dynamic_beats_uniform_on_compute_bound``): mnist-cnn, 60 steps
    uniform and dynamic; dynamic's simulated time under 0.75 x uniform's,
    the final losses within 0.5.  Then resnet, dynamic, 20 steps."""
    uni = paper_run("mnist-cnn", "uniform", 60)
    dyn = paper_run("mnist-cnn", "dynamic", 60)
    res = {"mnist-cnn-uniform": uni, "mnist-cnn-dynamic": dyn,
           "sim_time_ratio": dyn["sim_time"] / uni["sim_time"],
           "loss_gap": abs(uni["final_loss"] - dyn["final_loss"])}
    log(f"  dynamic / uniform sim_time {res['sim_time_ratio']:.4f} (< 0.75), "
        f"final loss gap {res['loss_gap']:.4f} (< 0.5)")
    if not (res["sim_time_ratio"] < 0.75 and res["loss_gap"] < 0.5):
        raise AssertionError(f"compute-bound claim fails on the card: {res}")
    res["resnet-dynamic"] = paper_run("resnet", "dynamic", 20)
    return res


def check_resume(out_dir: str) -> dict:
    """resnet, 6 BSP steps straight; then 3 steps, ``Session.save``, a fresh
    Experiment's ``session(resume_from=...)``, 3 more: the final params,
    Adam's moments and the last 3 steps' records must be bit-identical.
    cuDNN runs with ``deterministic = True`` and ``benchmark = False`` here
    (its convolution backward may otherwise pick algorithms whose sums vary
    between runs); the settings are restored afterwards."""
    import torch

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    path = os.path.join(out_dir, "resume_resnet.npz")
    try:
        straight = paper_experiment("resnet", "dynamic", 6).session()
        straight.run()
        first = paper_experiment("resnet", "dynamic", 6).session()
        for rec in first:
            if rec.step == 2:
                first.save(path)
                break
        resumed = paper_experiment("resnet", "dynamic", 6).session(
            resume_from=path)
        resumed.run()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
        if os.path.exists(path):
            os.remove(path)
    opt = straight.trainer.opt_state
    opt_r = resumed.trainer.opt_state
    same = {
        "params": all(torch.equal(resumed.params[k], p)
                      for k, p in straight.params.items()),
        "adam_moments": all(torch.equal(opt_r[m][k], x)
                            for m in ("m", "v") for k, x in opt[m].items()),
        "records": [(r.loss, r.batches, r.sim_time) for r in resumed.history]
        == [(r.loss, r.batches, r.sim_time) for r in straight.history[3:]],
    }
    res = {"resumed_at": 3, "steps": resumed.step_idx, "bit_identical": same,
           "cudnn": "deterministic=True, benchmark=False"}
    log(f"  resnet resumed at step 3 of 6 (cuDNN deterministic, benchmark "
        f"off for this check): bit-identical {same}")
    if not all(same.values()):
        raise AssertionError(f"resumed run differs: {res}")
    return res


# ------------------------------------------------------------ phase 10, churn

# the spot market every part of phase 10 replays: 4 workers over 2 zones,
# 12 market steps; compiled with a floor of 2 workers it preempts two
# workers at step 1, rejoins one at 5 and one at 6, slows worker 1 at 9 and
# restores it at 12, with a cost-aware Reallocate after each of those steps
STORM = dict(workers=4, zones=2, seed=11, horizon=12, degrade_rate=0.01,
             straggle_rate=0.02)
STORM_STEPS = 13        # the step-12 restore fires before the last step
RESUME_AT = 5           # an AddWorker sits exactly at this step
CHAOS = dict(seed=11, horizon=30, steps=30)


def storm():
    from repro_torch.api import compile_churn
    from repro_torch.het import storm_market

    kw = dict(STORM)
    market = storm_market(kw.pop("workers"), **kw)
    return market, compile_churn(market.simulate(), min_workers=2)


def expected_membership(churn, workers: int):
    """The trainer's membership log and the live worker count of each step
    that the compiled schedule implies (events fire as their step starts)."""
    from repro_torch.api import AddWorker, Reallocate, RemoveWorker

    log_, live, k = [], [], workers
    for step in range(STORM_STEPS):
        for ev in churn.events:
            if ev.step != step:
                continue
            if isinstance(ev, RemoveWorker):
                log_.append([step, "remove", ev.worker])
                k -= 1
            elif isinstance(ev, AddWorker):
                log_.append([step, "add", k])
                k += 1
            elif isinstance(ev, Reallocate):
                log_.append([step, "reallocate", -1])
        live.append(k)
    return log_, live


def check_churn_storm() -> dict:
    """Phase 10(a): the compiled storm through the gemma path's kernels."""
    from repro_torch.api import ClusterSpec

    market, churn = storm()
    fleet = market.initial_fleet()
    log(f"  storm: {churn.summary()}, dropped {len(churn.dropped)}; events "
        + ", ".join(f"{type(ev).__name__}@{ev.step}" for ev in churn.events))
    cluster = ClusterSpec.explicit(fleet, workload="transformer",
                                   seed=0).with_churn(churn)
    mp = main_path("gemma", steps=STORM_STEPS, cluster=cluster,
                   workers=len(fleet), profile=False)
    want_log, want_live = expected_membership(churn, len(fleet))
    total = 4 * len(fleet)
    live = [len(b) for b in mp["ran_batches"]]
    per_step = mp["microbatches_per_step"]
    for step, (bs, ms, n) in enumerate(zip(mp["ran_batches"],
                                           mp["step_wall_ms"], per_step)):
        log(f"  storm step {step}: wall {ms:.1f} ms, {len(bs)} workers, "
            f"{n} microbatches, ran with {bs}")
    by_k = {}
    for k, ms in zip(live[1:], mp["step_wall_ms"][1:]):   # step 0 warms up
        by_k.setdefault(k, []).append(ms)
    res = {**mp, "storm": STORM, "events": [
        [type(ev).__name__, ev.step] for ev in churn.events],
        "live_workers": live, "expected_live_workers": want_live,
        "expected_membership_log": want_log,
        "step_wall_ms_by_workers": by_k}
    log(f"  step wall ms by live workers (step 0 left out): {by_k}")
    bad = [i for i, bs in enumerate(mp["ran_batches"] + mp["batches"])
           if sum(bs) != total]
    if bad:
        raise AssertionError(f"storm: sum(b_k) != {total} at {bad}: "
                             f"{mp['ran_batches']} / {mp['batches']}")
    if mp["membership_log"] != want_log:
        raise AssertionError(f"storm: membership log {mp['membership_log']}"
                             f", compiled {want_log}")
    if live != want_live:
        raise AssertionError(f"storm: live workers {live}, schedule "
                             f"{want_live}")
    return res


def paper_storm(workers, schedule):
    """mnist-cnn at phase 7's settings on an explicit fleet with a
    membership schedule."""
    from repro_torch.api import ClusterSpec

    cluster = ClusterSpec.explicit(list(workers), workload="mnist-cnn",
                                   seed=0).with_schedule(*schedule)
    return paper_experiment("mnist-cnn", "dynamic", STORM_STEPS,
                            cluster).session()


def check_storm_resume(out_dir: str) -> dict:
    """Phase 10(b): the storm on mnist-cnn, saved at step RESUME_AT and
    resumed on the fleet as of the save with the schedule's suffix; both
    sessions run to the end, which must agree bit for bit."""
    import torch

    market, churn = storm()
    path = os.path.join(out_dir, "storm_resume.ckpt")
    a = paper_storm(market.initial_fleet(), churn.events)
    for _ in a:
        if a.step_idx >= RESUME_AT:
            break
    a.save(path)
    suffix = [ev for ev in churn.events if ev.step >= RESUME_AT]
    b = paper_storm(a.trainer.sim.workers, suffix)
    try:
        b.restore(path)
    finally:
        os.remove(path)
    a.run()
    b.run()
    ta, tb = a.trainer, b.trainer
    same = {
        "params": all(torch.equal(b.params[k], p)
                      for k, p in a.params.items()),
        "adam_moments": all(torch.equal(tb.opt_state[m][k], x)
                            for m in ("m", "v")
                            for k, x in ta.opt_state[m].items()),
        "records": [(r.step, r.loss, r.batches, r.iteration_time)
                    for r in b.history]
        == [(r.step, r.loss, r.batches, r.iteration_time)
            for r in a.history[RESUME_AT:]],
        "membership_log": [e for e in ta.membership_log
                           if e[0] >= RESUME_AT] == tb.membership_log,
    }
    res = {"resumed_at": RESUME_AT, "steps": b.step_idx,
           "events_at_resume": [type(ev).__name__ for ev in suffix
                                if ev.step == RESUME_AT],
           "membership_log": [list(e) for e in tb.membership_log],
           "bit_identical": same}
    log(f"  mnist-cnn storm resumed at step {RESUME_AT} (events there: "
        f"{res['events_at_resume']}), {b.step_idx} steps: bit-identical "
        f"{same}")
    if not all(same.values()) or b.step_idx != STORM_STEPS \
            or not any(e[0] == RESUME_AT and e[1] == "add"
                       for e in tb.membership_log):
        raise AssertionError(f"storm resume differs: {res}")
    return res


def check_chaos(out_dir: str) -> dict:
    """Phase 10(c): ``run_chaos`` twice with one seeded fault plan on
    mnist-cnn; the two injection logs and histories must be equal."""
    from repro_torch.api import ClusterSpec
    from repro_torch.het import make_fault_plan, run_chaos

    def make_session():
        cluster = ClusterSpec.hlevel(24, 3.0, 3, workload="mnist-cnn",
                                     seed=0)
        return paper_experiment("mnist-cnn", "dynamic", CHAOS["steps"],
                                cluster).session()

    plan = make_fault_plan(CHAOS["seed"], horizon=CHAOS["horizon"])
    path = os.path.join(out_dir, "chaos.ckpt")
    runs = []
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            result, _hook = run_chaos(make_session, plan,
                                      checkpoint_path=path)
            runs.append((result, time.perf_counter() - t0))
    finally:
        if os.path.exists(path):
            os.remove(path)
    (r1, s1), (r2, s2) = runs
    hist = [[(r.step, r.loss, tuple(r.batches)) for r in res["history"]]
            for res, _ in runs]
    totals = [sum(r.batches) for r in r1["history"]]
    res = {"plan": plan.summary(), "chaos_log": [list(e) for e in
                                                 r1["chaos_log"]],
           "pending": r1["chaos_pending"], "steps": r1["steps"],
           "seconds": [s1, s2], "sum_b": sorted(set(totals))}
    log(f"  chaos plan {res['plan']}: log {res['chaos_log']}, "
        f"{res['pending']} pending, {r1['steps']} steps, sum(b_k) "
        f"{res['sum_b']}; {s1:.2f} s and {s2:.2f} s a run")
    if not (r1["chaos_log"] and r1["chaos_log"] == r2["chaos_log"]):
        raise AssertionError(f"chaos logs differ or are empty: "
                             f"{r1['chaos_log']} / {r2['chaos_log']}")
    if hist[0] != hist[1]:
        raise AssertionError("chaos replay histories differ")
    if len(set(totals)) != 1 or r1["steps"] != CHAOS["steps"]:
        raise AssertionError(f"chaos: sum(b_k) {totals}, {r1['steps']} "
                             f"steps")
    return res


def check_churn(out_dir: str) -> dict:
    """Phase 10: (a) the storm at gemma width through the kernels, then on
    mnist-cnn with cuDNN deterministic (restored afterwards) and no launch
    of the port's kernels, (b) checkpoint under fire and (c) the chaos
    harness."""
    import torch

    res = {"storm": check_churn_storm()}
    log_path(res["storm"])
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    reset_all_launches()
    try:
        res["resume"] = check_storm_resume(out_dir)
        res["chaos"] = check_chaos(out_dir)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    launched = {k: v for k, v in all_launches().items() if v}
    if launched:
        raise AssertionError(f"mnist-cnn churn launched {launched}")
    return res


# ----------------------------------------------- phase 11, measured backend

MESH_STEPS = 8          # (a)'s BSP steps; one more runs under the profiler
MESH_RESUME = (2, 4)    # (c): saved after 2 steps, resumed and run to 4
MESH_ASP_UPDATES = 18   # (d)
# the flash kernels' shapes on the gemma path at bucket B with num_valid
# rows (the ladder at microbatch 2 is 2, 3, 4, 5, 7, 9, ...); phase 11
# checks every (B, num_valid) its path ran, and B 7 with 5 and 6 valid
# rows, which a split moving off [1, 4, 7] would run
BUCKET_EXTRA = [(7, 5), (7, 6)]


def bucket_case(b: int, nv: int) -> tuple:
    """A ``CASES`` row at the gemma path's attention shapes."""
    return (f"mesh-b{b}-nv{nv}", b, 1024, 1024, 8, 1, 256, True, None,
            None, nv)


class FakeClock:
    """A host clock whose ``perf_counter()`` advances exactly 1.0 a read."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


def mesh_experiment(steps: int):
    """Phase 4's gemma path (2 layers, seq 1024, three h-level workers, b0
    4, microbatch 2, P controller, adam(1e-3)) on the measured backend,
    with the fleet's declared speeds emulated by dilation."""
    from repro_torch.api import (ClusterSpec, Experiment, MeshBackend,
                                 TrainConfig, lm_workload)
    from repro_torch.configs import get_config
    from repro_torch.core import ControllerConfig
    from repro_torch.data import DataPipeline
    from repro_torch.optim import adam

    arch, layers, seq, _ = PATHS["gemma"]
    cfg = get_config(arch, num_layers=layers)
    return Experiment(
        workload=lm_workload(cfg, DataPipeline(cfg, seq_len=seq,
                                               num_workers=3),
                             aux_weight=0.01, use_kernel=True),
        cluster=ClusterSpec.hlevel(39, 6.0, 3, workload="transformer",
                                   seed=0,
                                   backend=MeshBackend(dilation="from-spec")),
        optimizer=adam(1e-3),
        config=TrainConfig(b0=4, microbatch=MICROBATCH, batching="dynamic",
                           sync="bsp", max_steps=steps,
                           controller=ControllerConfig(kind="p")))


def check_mesh_path() -> dict:
    """Phase 11(a)-(b): the gemma path on the measured backend, MESH_STEPS
    sequential BSP steps and one more under torch.profiler.  The launch
    counts are set to 0 before the session is built (its probe round
    launches too) and must equal 2 layers x every gradient call, warm-up
    reruns included.  Every gradient call is logged (step, worker, batch,
    bucket, each event ms, and the caching allocator's new device
    allocations and reserved bytes across it), so a warm-up rerun's time
    stands beside its first call's."""
    import torch
    from repro_torch.train import mesh as M

    steps = MESH_STEPS + 1
    clock = step_clock(profile_step=MESH_STEPS, frags=FLASH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ran, calls_log, timed, measured = [], [], M._timed, \
        M.MeshTrainer._measured_worker_grad

    def logged_timed(fn, device):
        stats = torch.cuda.memory_stats(device)
        allocs, reserved = stats.get("num_device_alloc", 0), \
            torch.cuda.memory_reserved(device)
        out, dt = timed(fn, device)
        calls_log[-1]["ms"].append(dt * 1e3)
        calls_log[-1]["device_allocs"].append(
            torch.cuda.memory_stats(device).get("num_device_alloc", 0)
            - allocs)
        calls_log[-1]["reserved_mib"].append(
            (torch.cuda.memory_reserved(device) - reserved) / 2**20)
        return out, dt

    def logged_grad(trainer, worker, batch_size):
        calls_log.append({"step": len(ran) - 1, "worker": worker,
                          "batch": batch_size,
                          "bucket": trainer.bucket_for(worker, batch_size),
                          "ms": [], "device_allocs": [],
                          "reserved_mib": []})
        return measured(trainer, worker, batch_size)

    reset_all_launches()
    M._timed, M.MeshTrainer._measured_worker_grad = logged_timed, logged_grad
    try:
        session = mesh_experiment(steps).session(hooks=[clock])
    except BaseException:
        M._timed, M.MeshTrainer._measured_worker_grad = timed, measured
        raise
    t = session.trainer
    probe = {"batches": list(t.batches), "calls": t.accum_calls,
             "reruns": t.timing_reruns, "buckets": [sorted(b) for b in
                                                    t.worker_buckets]}
    bsp_step = t.bsp_step

    def recorded_step():
        ran.append(list(t.batches))
        return bsp_step()

    t.bsp_step = recorded_step
    try:
        out = session.run()
    finally:
        del t.bsp_step
        M._timed, M.MeshTrainer._measured_worker_grad = timed, measured
    counts = all_launches()
    hist = out["history"]
    dil = list(t.dilation)
    total = 4 * t.k
    rows = []
    for r, bs, ms in zip(hist, ran, clock.ms):
        row = {"step": r.step, "wall_ms": ms, "ran": bs,
               "buckets": [t.bucket_for(k, b) for k, b in enumerate(bs)],
               "dilated_ms": [x * 1e3 for x in r.worker_times],
               "raw_ms": [x * 1e3 / d for x, d in zip(r.worker_times, dil)],
               "loss": r.loss}
        rows.append(row)
        log(f"  step {r.step}: wall {ms:.1f} ms, ran {bs} in buckets "
            f"{row['buckets']}, worker event ms raw " + ", ".join(
                f"{x:.1f}" for x in row["raw_ms"]) + " (sum "
            f"{sum(row['raw_ms']):.1f}) dilated " + ", ".join(
                f"{x:.1f}" for x in row["dilated_ms"])
            + f", loss {r.loss:.4f}")
    calls = t.accum_calls + t.timing_reruns
    layers = PATHS["gemma"][1]
    res = {"probe": probe, "steps": rows, "dilation": dil,
           "final_batches": list(t.batches),
           "worker_buckets": [sorted(b) for b in t.worker_buckets],
           "accum_calls": t.accum_calls, "timing_reruns": t.timing_reruns,
           "launches": counts,
           "expected_launches": {k: layers * calls for k in FLASH},
           "exec_state": t.exec_state_dict(),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "profile": clock.profile,
           "steady_step_wall_ms": sorted(clock.ms[1:MESH_STEPS])[
               (MESH_STEPS - 1) // 2]}
    bounds = []
    for k, buckets in enumerate(t.worker_buckets):
        seen = [4, probe["batches"][k]] + [bs[k] for bs in ran]
        lo, hi = min(seen), max(seen)
        bounds.append(math.ceil(math.log(hi / lo, 1.25)) + 1 if hi > lo
                      else 1)
    res["bucket_bounds"] = bounds
    res["calls"] = calls_log
    res["visited"] = sorted({(c["bucket"], c["batch"]) for c in calls_log})
    res["reruns"] = log_reruns(calls_log)
    log(f"  probe plan {probe['batches']} ({probe['calls']} calls, "
        f"{probe['reruns']} reruns, buckets {probe['buckets']}); dilation "
        f"{[round(d, 4) for d in dil]}; {t.accum_calls} calls, "
        f"{t.timing_reruns} reruns, buckets {res['worker_buckets']} (bounds "
        f"{bounds}); median step wall (steps 1-{MESH_STEPS - 1}) "
        f"{res['steady_step_wall_ms']:.1f} ms; launches "
        f"{ {k: v for k, v in counts.items() if v} }; peak "
        f"{res['max_memory_allocated'] / 2**30:.2f} GiB")
    del session, out, hist, t, bsp_step
    torch.cuda.empty_cache()
    losses = [row["loss"] for row in rows]
    if len(rows) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"mesh path: bad losses {losses}")
    bad = [row["step"] for row in rows if sum(row["ran"]) != total]
    if bad or sum(res["final_batches"]) != total:
        raise AssertionError(f"mesh path: sum(b_k) != {total} at {bad}")
    last = ran[MESH_STEPS - 1]
    slowest = max(range(len(dil)), key=dil.__getitem__)
    if len(set(last)) < 2 or last[slowest] != min(last):
        raise AssertionError(f"mesh path: split {last} is not ragged with "
                             f"the slowest worker ({slowest}, dilation "
                             f"{dil}) smallest")
    over = [k for k, b in enumerate(res["worker_buckets"])
            if len(b) > bounds[k]]
    if over or res["timing_reruns"] > sum(bounds):
        raise AssertionError(f"mesh path: buckets {res['worker_buckets']} / "
                             f"reruns {res['timing_reruns']} over the "
                             f"ladder bounds {bounds}")
    want = res["expected_launches"]
    if {k: counts.get(k, 0) for k in want} != want or calls <= 0 or any(
            v for k, v in counts.items() if k not in want):
        raise AssertionError(f"mesh path launches {counts}: want {want} "
                             f"(2 layers x {calls} gradient calls)")
    prof = res["profile"]
    if prof and prof["device_busy_us"]:
        missing = [f for f, us in prof["fragments_us"].items() if not us > 0]
        if missing:
            raise AssertionError(f"mesh path: {missing} absent from the "
                                 f"profiled step: {prof}")
    return res


def log_reruns(calls_log: list) -> list:
    """Each warm-up rerun's event ms beside its first call's, and beside
    the warm calls of the same worker at the same bucket and step kind
    (the probe's calls are the same work for every worker, so the probe
    compares across workers)."""
    rows = []
    for c in calls_log:
        if len(c["ms"]) != 2:
            continue
        same = [w["ms"][0] for w in calls_log if len(w["ms"]) == 1
                and w["bucket"] == c["bucket"] and w["batch"] == c["batch"]
                and (w["worker"] == c["worker"]
                     or (c["step"] < 0 and w["step"] < 0))]
        row = {"step": c["step"], "worker": c["worker"],
               "bucket": c["bucket"], "batch": c["batch"],
               "first_ms": c["ms"][0], "rerun_ms": c["ms"][1],
               "first_over_rerun": c["ms"][0] / c["ms"][1],
               "device_allocs": c["device_allocs"],
               "reserved_mib": c["reserved_mib"],
               "warm_ms": [min(same), max(same)] if same else None}
        rows.append(row)
        log(f"  rerun at step {'probe' if c['step'] < 0 else c['step']}, "
            f"worker {c['worker']}, b {c['batch']} in bucket {c['bucket']}: "
            f"first call {row['first_ms']:.2f} ms, rerun "
            f"{row['rerun_ms']:.2f} ms (x{row['first_over_rerun']:.4f}); "
            f"new device allocations {c['device_allocs']}, reserved "
            f"+{c['reserved_mib'][0]:.0f} / +{c['reserved_mib'][1]:.0f} MiB"
            + ("; warm calls at this bucket "
               f"{row['warm_ms'][0]:.2f}-{row['warm_ms'][1]:.2f} ms"
               if same else "; no warm call at this bucket"))
    return rows


def check_mesh_resume(out_dir: str) -> dict:
    """Phase 11(c): the gemma mesh path saved after MESH_RESUME[0] steps,
    restored into a new session and run to MESH_RESUME[1], against the
    uninterrupted run: params, Adam's moments, the records and
    ``exec_state_dict`` bit-identical.  Measured times differ from run to
    run, so both runs take their times from ``FakeClock`` (the trainer's
    timer swapped for the host clock, as tests/test_torch_mesh.py does): the
    check is of the checkpoint, not of the clock."""
    import torch
    from repro_torch.train import mesh as M

    at, steps = MESH_RESUME
    path = os.path.join(out_dir, "mesh_resume.ckpt")
    timer = M._timed, M._time
    M._timed, M._time = M._host_timed, FakeClock()
    try:
        first = mesh_experiment(steps).session()
        for rec in first:
            if rec.step == at - 1:
                first.save(path)
                break
        first.run()
        t = first.trainer
        want = {"params": {k: p.cpu() for k, p in t.params.items()},
                "adam": {m: {k: x.cpu() for k, x in t.opt_state[m].items()}
                         for m in ("m", "v")},
                "records": [(r.step, r.loss, r.batches, r.worker_times,
                             r.sim_time) for r in first.history[at:]],
                "exec": t.exec_state_dict()}
        del first, t
        torch.cuda.empty_cache()
        resumed = mesh_experiment(steps).session(resume_from=path)
        resumed.run()
    finally:
        M._timed, M._time = timer
        if os.path.exists(path):
            os.remove(path)
    t = resumed.trainer
    same = {
        "params": all(torch.equal(t.params[k].cpu(), p)
                      for k, p in want["params"].items()),
        "adam_moments": all(torch.equal(t.opt_state[m][k].cpu(), x)
                            for m, xs in want["adam"].items()
                            for k, x in xs.items()),
        "records": [(r.step, r.loss, r.batches, r.worker_times, r.sim_time)
                    for r in resumed.history] == want["records"],
        "exec_state": t.exec_state_dict() == want["exec"],
    }
    res = {"saved_after": at, "steps": t.step_idx, "bit_identical": same,
           "exec_state": want["exec"],
           "records": [list(r) for r in want["records"]]}
    log(f"  gemma mesh checkpoint after {at} steps, resumed to step "
        f"{t.step_idx} (FakeClock times): bit-identical {same}; exec state "
        f"{want['exec']}")
    del resumed, t
    torch.cuda.empty_cache()
    if not all(same.values()) or res["steps"] != steps:
        raise AssertionError(f"mesh resume differs: {res}")
    return res


def mesh_paper_session(steps: int, sync: str, cluster=None):
    """mnist-cnn at phase 7's settings on the measured backend (dilation
    from the fleet's declared speeds)."""
    from repro_torch.api import (ClusterSpec, Experiment, MeshBackend,
                                 TrainConfig, paper_workload)
    from repro_torch.optim import adam

    cluster = cluster or ClusterSpec.hlevel(39, 8, workload="mnist-cnn",
                                            seed=0)
    cluster.backend = MeshBackend(dilation="from-spec")
    return Experiment(
        workload=paper_workload("mnist-cnn", seed=100), cluster=cluster,
        optimizer=adam(2e-3),
        config=TrainConfig(b0=32, microbatch=8, batching="dynamic",
                           sync=sync, max_steps=steps)).session()


def check_mesh_asp() -> dict:
    """Phase 11(d): mnist-cnn under ASP, MESH_ASP_UPDATES updates through
    the event engine fed by the measured rates."""
    t0 = time.perf_counter()
    session = mesh_paper_session(MESH_ASP_UPDATES, "asp")
    out = session.run()
    hist = out["history"]
    stale = [int(r.straggler_waste) for r in hist]
    res = {"updates": out["steps"], "staleness": stale,
           "batches": [r.batches for r in hist],
           "final_batches": out["final_batches"],
           "dilation": session.trainer.dilation,
           "losses": [r.loss for r in hist],
           "seconds": time.perf_counter() - t0}
    log(f"  mnist-cnn ASP: {out['steps']} updates, staleness {stale}, final "
        f"batches {out['final_batches']} (dilation "
        f"{[round(d, 3) for d in res['dilation']]}), "
        f"{res['seconds']:.2f} s")
    total = sum(hist[0].batches)
    if out["steps"] != MESH_ASP_UPDATES or not all(
            math.isfinite(x) for x in res["losses"]) or max(stale) < 1 \
            or any(sum(r.batches) != total for r in hist):
        raise AssertionError(f"mesh ASP: {res}")
    return res


def check_mesh_storm() -> dict:
    """Phase 11(e): phase 10's seed-11 storm, compiled by compile_churn,
    replayed through the mesh trainer's membership methods on mnist-cnn:
    the membership log and live workers as compiled, sum(b_k) kept, and
    the straggler's SlowWorker seen in the dilation its steps ran with."""
    from repro_torch.api import ClusterSpec

    market, churn = storm()
    cluster = ClusterSpec.explicit(market.initial_fleet(),
                                   workload="mnist-cnn",
                                   seed=0).with_churn(churn)
    session = mesh_paper_session(STORM_STEPS, "bsp", cluster)
    t, live, dilation = session.trainer, [], []
    bsp_step = t.bsp_step

    def recorded_step():
        live.append(t.k)
        dilation.append([round(d, 4) for d in t.dilation])
        return bsp_step()

    t.bsp_step = recorded_step
    try:
        out = session.run()
    finally:
        del t.bsp_step
    want_log, want_live = expected_membership(churn, len(
        market.initial_fleet()))
    got_log = [list(e) for e in out["membership_log"]]
    totals = sorted({sum(r.batches) for r in out["history"]})
    res = {"membership_log": got_log, "live_workers": live,
           "sum_b": totals, "dilation_per_step": dilation,
           "batches": [r.batches for r in out["history"]],
           "timing_reruns": t.timing_reruns}
    log(f"  mnist-cnn storm on the mesh: {out['steps']} steps, live workers "
        f"{live}, sum(b_k) {totals}, membership log {got_log}; dilation "
        f"each step ran with {dilation}; batches {res['batches']}")
    slowed = max(max(d) for d in dilation) > max(dilation[0])
    if got_log != want_log or live != want_live or len(totals) != 1 \
            or not slowed:
        raise AssertionError(f"mesh storm: {res}; compiled log {want_log}, "
                             f"live {want_live}, a SlowWorker reached the "
                             f"dilation: {slowed}")
    return res


def check_mesh_kernels(report: dict, errs: dict, visited: list) -> list:
    """The flash kernels against their plain versions at every (bucket,
    num_valid) the mesh path ran and at BUCKET_EXTRA; each case draws its
    own inputs (seeded by its name)."""
    shapes = sorted(set(map(tuple, visited)) | set(BUCKET_EXTRA))
    log("  flash kernels at the mesh path's (bucket, num_valid) "
        f"{[list(x) for x in visited]} and {BUCKET_EXTRA}")
    errs.update({k: max(v, errs[k]) for k, v in check_kernels(
        report, [bucket_case(b, nv) for b, nv in shapes]).items()})
    return [list(x) for x in shapes]


def check_mesh(report: dict, errs: dict, out_dir: str) -> dict:
    """Phase 11: (a)-(b) the gemma path, the flash kernels at the shapes it
    ran, (c) resume, (d) ASP and (e) the storm."""
    res, seconds = {}, {}
    for part, check in (("path", check_mesh_path),
                        ("kernels", lambda: check_mesh_kernels(
                            report, errs, res["path"]["visited"])),
                        ("resume", lambda: check_mesh_resume(out_dir)),
                        ("asp", check_mesh_asp), ("storm", check_mesh_storm)):
        t0 = time.perf_counter()
        res[part] = check()
        seconds[part] = time.perf_counter() - t0
        if part == "path":
            log_profile(res["path"]["profile"])
    res["seconds"] = seconds
    log("  phase 11 seconds: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in seconds.items()))
    return res


# ------------------------------------------------------ phase 12, serving

SERVE_SLOTS, SERVE_CACHE = 8, 1024       # (a)-(b): 8 KV slots of 1024
SERVE_REQUESTS = 16
SERVE_PROMPT, SERVE_NEW = 64, 32         # prompts of 1..64 tokens (ragged)
SERVE_RATE, SERVE_SEED = 1.0, 12         # poisson arrivals per step
# tests/test_models.py's atol and rtol for decode against the full pass; at
# full width the logits reach 1000-4200, where fp32 resolves ~1e-4-5e-4, so
# the atol becomes 4 x 2^-23 x max|logit| (2-4 ulps of the largest logit)
# where that is larger (the two full passes, kernel and plain, differ by
# more than 2e-4 at mamba2's width: PERF.md, PR 24)
DECODE_TOL = (2e-4, 2e-3)
DECODE_ULPS = 4 * 2.0 ** -23
DECODE_SEQ = 256
# (c): arch, layers, the kernels its full pass launches and their layers
DECODE_PATHS = {"gemma-2b": (2, {"flash_fwd": 2}),
                "mamba2-1.3b": (4, {"ssd_fwd": 4}),
                "recurrentgemma-9b": (3, {"rglru_fwd": 2, "flash_fwd": 1})}
COLO_STEPS = 3                           # (d): BSP steps an engine
COLO_SERVE = dict(mode="shared", arch="gemma-2b", slots=4, cache_len=64,
                  requests_per_round=2.0, prompt_len=16, max_new_tokens=24,
                  decode_steps_per_round=16, seed=3)


def serve_arrivals(vocab: int) -> list:
    """SERVE_REQUESTS requests from ``make_traffic("poisson")``, each with
    the batcher step it arrives at."""
    from repro_torch.serve import make_traffic

    traffic = make_traffic("poisson", rate=SERVE_RATE,
                           prompt_len=SERVE_PROMPT,
                           max_new_tokens=SERVE_NEW, vocab_size=vocab,
                           seed=SERVE_SEED)
    out, step = [], 0
    while len(out) < SERVE_REQUESTS:
        out += [(step, r) for r in traffic.next_round()]
        step += 1
    return out[:SERVE_REQUESTS]


def serve_drive(engine, arrivals) -> tuple:
    """Submit each request at its step and step ``engine`` until idle; each
    step's host wall ms (the step reads its tokens back, which waits for
    the card), and whether it admitted or prefilled a request."""
    from repro_torch.serve import Request

    reqs = [Request(uid=r.uid, prompt=r.prompt.copy(),
                    max_new_tokens=r.max_new_tokens) for _, r in arrivals]
    prefill = getattr(engine, "prefill", None)
    rows, i = [], 0
    while i < len(reqs) or not engine.idle:
        while i < len(reqs) and arrivals[i][0] <= engine.step_count:
            engine.submit(reqs[i])
            i += 1
        work = (sum(r.started_step is not None for r in reqs),
                getattr(prefill, "calls", 0))
        t0 = time.perf_counter()
        engine.step()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append((ms, (sum(r.started_step is not None for r in reqs),
                          getattr(prefill, "calls", 0)) != work))
    return reqs, rows


def step_stats(rows) -> dict:
    import numpy as np

    dec = [ms for ms, admitted in rows if not admitted]
    adm = [ms for ms, admitted in rows if admitted]
    pct = (lambda xs, q: float(np.percentile(xs, q)) if xs else None)
    return {"steps": len(rows), "decode_steps": len(dec),
            "decode_ms_p50": pct(dec, 50), "decode_ms_p95": pct(dec, 95),
            "admission_steps": len(adm), "admission_ms_p50": pct(adm, 50),
            "admission_ms_max": max(adm) if adm else None,
            "seconds": sum(ms for ms, _ in rows) / 1e3}


def check_serve_engines(peak_bw: float) -> dict:
    """Phase 12(a), (e), (b): gemma-2b at full width and depth behind a
    ContinuousBatcher, one pure decode step of it profiled, then the same
    requests through the disaggregated KVSlotManager sharing the same
    parameter tensors; the streams must match."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.serve import (ContinuousBatcher, KVSlotManager,
                                   LMShard, PrefillProgram, Request)

    dev = torch.device("cuda")
    cfg = get_config("gemma-2b")
    torch.cuda.empty_cache()
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    n_params = sum(p.numel() for p in params.values())
    param_bytes = sum(p.numel() * p.element_size() for p in params.values())
    arrivals = serve_arrivals(cfg.vocab_size)
    res = {"layers": cfg.num_layers, "params": n_params,
           "prompt_lens": [len(r.prompt) for _, r in arrivals],
           "arrival_steps": [s for s, _ in arrivals]}
    # (a) the batcher
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    batcher = ContinuousBatcher(params, cfg, slots=SERVE_SLOTS,
                                cache_len=SERVE_CACHE, device=dev)
    batcher.warmup()
    cache_bytes = sum(x.numel() * x.element_size()
                      for x in batcher.caches.values())
    reqs, rows = serve_drive(batcher, arrivals)
    a = step_stats(rows)
    a["tokens"] = sum(len(r.tokens) for r in reqs)
    a["tokens_per_s"] = a["tokens"] / a["seconds"]
    a["finished"] = len(batcher.finished)
    a["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    a["launches"] = {k: v for k, v in all_launches().items() if v}
    a["cache_mib"] = cache_bytes / 2**20
    # the least bytes a pure decode step moves: every parameter and the
    # whole KV cache read once (the plain scores read all 1024 slots)
    a["bound_ms"] = (param_bytes + cache_bytes) / peak_bw * 1e3
    streams = {r.uid: list(r.tokens) for r in reqs}
    log(f"  (a) batcher: {a['finished']}/{SERVE_REQUESTS} requests, prompts "
        f"{res['prompt_lens']}; {a['steps']} steps: {a['decode_steps']} "
        f"pure decode p50 {a['decode_ms_p50']:.3f} / p95 "
        f"{a['decode_ms_p95']:.3f} ms (bound {a['bound_ms']:.3f} ms: "
        f"{param_bytes / 1e9:.3f} GB of parameters + "
        f"{a['cache_mib']:.0f} MiB of KV cache), {a['admission_steps']} "
        f"admitting p50 {a['admission_ms_p50']:.1f} / max "
        f"{a['admission_ms_max']:.1f} ms; {a['tokens']} tokens in "
        f"{a['seconds']:.2f} s ({a['tokens_per_s']:.1f} tokens/s); peak "
        f"{a['peak_gib']:.2f} GiB; launches {a['launches']}")
    # (e) one pure decode step under torch.profiler: all slots live
    for uid in range(SERVE_SLOTS):
        batcher.submit(Request(uid=100 + uid, prompt=arrivals[uid][1]
                               .prompt[:4].copy(), max_new_tokens=8))
    batcher.step()

    def pure_steps(n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            batcher.step()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    before = pure_steps(3)
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        batcher.step()
        wall_us = (time.perf_counter() - t0) * 1e6
    e = profile_summary(prof, wall_us, {})
    e["bound_ms"] = a["bound_ms"]
    log_profile(e)
    after = pure_steps(3)
    e["decode_ms_around_profiler"] = (before, after)
    log("  pure decode steps before the profiler: " + ", ".join(
        f"{x:.2f}" for x in before) + " ms; after: " + ", ".join(
        f"{x:.2f}" for x in after) + " ms")
    del batcher, prof
    torch.cuda.empty_cache()
    # (b) the disaggregated engine on the same parameter tensors
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    prefill = PrefillProgram(params, cfg, cache_len=SERVE_CACHE, device=dev)
    shard = LMShard(params, cfg, slots=SERVE_SLOTS, cache_len=SERVE_CACHE,
                    device=dev)
    shared = all(prefill.params[k] is params[k] and shard.params[k] is
                 params[k] for k in params)
    mgr = KVSlotManager([shard], prefill, cache_len=SERVE_CACHE, extent=1)
    rung_ms: dict = {}
    run = prefill.run

    def timed_run(fed):
        t0 = time.perf_counter()
        out = run(fed)
        torch.cuda.synchronize()
        rung_ms.setdefault(prefill.bucket_for(len(fed)), []).append(
            (len(fed), (time.perf_counter() - t0) * 1e3))
        return out

    prefill.run = timed_run
    mgr.warmup()
    rung_ms.clear()
    try:
        reqs_b, rows_b = serve_drive(mgr, arrivals)
    finally:
        del prefill.run          # no cycle holds the parameters after this

    b = step_stats(rows_b)
    b["finished"] = len(mgr.finished)
    b["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    b["launches"] = {k: v for k, v in all_launches().items() if v}
    b["prefill_traces"] = mgr.stats()["prefill_traces"]
    b["prefill_ms_by_rung"] = {
        rung: {"runs": len(xs), "tokens": [n for n, _ in xs],
               "ms": [ms for _, ms in xs],
               "ms_per_token": sum(ms for _, ms in xs)
               / sum(n for n, _ in xs)}
        for rung, xs in sorted(rung_ms.items())}
    b["one_param_copy"] = shared
    b["streams_equal_a"] = {r.uid: list(r.tokens) for r in reqs_b} == streams
    log(f"  (b) KVSlotManager + PrefillProgram: {b['finished']}/"
        f"{SERVE_REQUESTS} requests; {b['decode_steps']} pure decode steps "
        f"p50 {b['decode_ms_p50']:.3f} / p95 {b['decode_ms_p95']:.3f} ms; "
        f"prefill traces {b['prefill_traces']}, ms per token by rung "
        + ", ".join(f"{k}: {v['ms_per_token']:.3f} ({v['runs']} runs)"
                    for k, v in b["prefill_ms_by_rung"].items())
        + f"; peak {b['peak_gib']:.2f} GiB; one parameter copy {shared}; "
        f"streams equal (a)'s {b['streams_equal_a']}; launches "
        f"{b['launches']}")
    del mgr, shard, prefill, params
    torch.cuda.empty_cache()
    res.update(batcher=a, profile=e, disaggregated=b, streams=streams)
    bad = []
    if a["finished"] != SERVE_REQUESTS or b["finished"] != SERVE_REQUESTS:
        bad.append("unfinished requests")
    if any(len(s) != SERVE_NEW for s in streams.values()):
        bad.append("short streams")
    if not b["streams_equal_a"]:
        bad.append("disaggregated streams differ from the batcher's")
    if a["launches"] or b["launches"]:
        bad.append("decode launched a kernel of the port")
    if not shared or b["peak_gib"] >= 11.0:
        bad.append("more than one parameter copy")
    if bad:
        raise AssertionError(f"serving: {bad}: {res}")
    return res


def check_decode_vs_kernels() -> dict:
    """Phase 12(c): per model at full width, a prompt decoded token by
    token through the caches against ``apply_lm`` over the whole prompt,
    which runs the port's kernels: logits within DECODE_TOL (with the atol
    raised to DECODE_ULPS x max|logit| where larger), each kernel launched
    once a layer that runs it in the full pass, none in decode.
    The plain full pass (no kernel) is logged beside it.  Every model runs
    before the phase fails on any."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import apply_lm, init_caches, init_lm

    dev = torch.device("cuda")

    def excess(got, ref):
        """max(|got - ref| - (atol + rtol |ref|)): <= 0 passes; with the
        |ref| and |got - ref| where it is largest, and the same at the
        reference's atol alone."""
        atol, rtol = DECODE_TOL
        plain = ((got - ref).abs() - atol - rtol * ref.abs()).max().item()
        atol = max(atol, DECODE_ULPS * ref.abs().max().item())
        e = (got - ref).abs() - atol - rtol * ref.abs()
        k = int(e.argmax())
        return {"excess": e.max().item(), "atol": atol,
                "excess_at_atol_2e-4": plain,
                "at_abs_ref": ref.flatten()[k].abs().item(),
                "at_abs_err": (got - ref).flatten()[k].abs().item(),
                "max_abs_err": (got - ref).abs().max().item()}

    res, failed = {}, []
    for arch, (layers, want) in DECODE_PATHS.items():
        cfg = get_config(arch, num_layers=layers).with_(use_pallas=True)
        params = init_lm(torch.Generator(device=dev).manual_seed(1), cfg)
        toks = torch.randint(0, cfg.vocab_size, (1, DECODE_SEQ),
                             generator=torch.Generator(device=dev)
                             .manual_seed(2), device=dev)
        reset_all_launches()
        with torch.no_grad():
            full, _ = apply_lm(params, cfg, toks)
        full_launches = {k: v for k, v in all_launches().items() if v}
        reset_all_launches()
        caches, dec = init_caches(cfg, 1, DECODE_SEQ, device=dev), []
        t0 = time.perf_counter()
        with torch.no_grad():
            for i in range(DECODE_SEQ):
                lg, caches, _ = apply_lm(
                    params, cfg, toks[:, i:i + 1], caches=caches,
                    positions=torch.full((1, 1), i, device=dev))
                dec.append(lg)
        seconds = time.perf_counter() - t0
        dec_launches = {k: v for k, v in all_launches().items() if v}
        dec = torch.cat(dec, dim=1)
        with torch.no_grad():
            plain, _ = apply_lm(params, cfg.with_(use_pallas=False), toks)
        res[arch] = {"layers": layers, "full_pass_launches": full_launches,
                     "decode_launches": dec_launches,
                     "decode_vs_kernel_path": excess(dec, full),
                     "decode_vs_plain_path": excess(dec, plain),
                     "kernel_vs_plain_path": excess(full, plain),
                     "max_abs_logit": full.abs().max().item(),
                     "decode_seconds": seconds}
        r = res[arch]
        log(f"  (c) {arch}, {layers} layers, {DECODE_SEQ} tokens: full pass "
            f"launches {full_launches} (want {want}), decode launches "
            f"{dec_launches}; max |logit| {r['max_abs_logit']:.1f}; "
            f"max(|a - b| - (atol + rtol|b|)) (<= 0 passes): " + ", ".join(
                f"{k} {v['excess']:.3g} at atol {v['atol']:.3g} "
                f"({v['excess_at_atol_2e-4']:.3g} at atol 2e-4; there |b| "
                f"{v['at_abs_ref']:.3g}, |a - b| {v['at_abs_err']:.3g}; max "
                f"|a - b| {v['max_abs_err']:.3g})"
                for k, v in r.items() if k.endswith("_path"))
            + f"; decode {seconds:.2f} s")
        del params, full, plain, caches, dec, lg
        torch.cuda.empty_cache()
        if full_launches != want or dec_launches or \
                r["decode_vs_kernel_path"]["excess"] > 0:
            failed.append(arch)
    if failed:
        raise AssertionError(f"decode vs kernel path ({failed}): {res}")
    return res


def check_serve_colocated() -> dict:
    """Phase 12(d): phase 11(a)'s gemma path on
    ``MeshBackend(dilation="from-spec")`` with a shared-mode ServeSpec, once
    per engine, COLO_STEPS BSP steps; the decode seconds are charged to
    worker 2 (the last), Σb_k stays 12, and each flash kernel launches 2
    layers x every gradient call."""
    import torch
    from repro_torch.serve import ServeSpec

    res = {}
    for engine in ("batcher", "disaggregated"):
        exp = mesh_experiment(COLO_STEPS)
        exp.cluster.serve = ServeSpec(engine=engine, **COLO_SERVE)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        clock = step_clock()
        session = exp.session(hooks=[clock])
        out = session.run()
        t = session.trainer
        counts = all_launches()
        calls = t.accum_calls + t.timing_reruns
        want = {k: 2 * calls for k in FLASH}
        rows = []
        for r, ms, charge in zip(out["history"], clock.ms, t.round_charges):
            rows.append({"step": r.step, "wall_ms": ms,
                         "worker_ms": [x * 1e3 for x in r.worker_times],
                         "charge_ms": charge * 1e3,
                         "batches_after": r.batches})
            log(f"  (d) {engine} step {r.step}: wall {ms:.1f} ms, worker ms "
                "(dilated, charge included) " + ", ".join(
                    f"{x * 1e3:.1f}" for x in r.worker_times)
                + f", decode charge {charge * 1e3:.1f} ms to worker "
                f"{t.serve_slice.shared_with}; split after {r.batches}")
        serve = out["serve"]
        res[engine] = {"steps": rows, "serve": serve,
                       "ran_first": out["history"][0].batches,
                       "launches": counts, "expected_launches": want,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"  (d) {engine}: charged {serve['charged_seconds'] * 1e3:.1f} "
            f"ms over {serve['decode_steps']} decode steps (p50 "
            f"{serve['decode_step_ms']['p50']:.2f} ms), "
            f"{serve['requests_finished']} of "
            f"{serve['requests_submitted']} requests finished; launches "
            f"{ {k: v for k, v in counts.items() if v} }; peak "
            f"{res[engine]['peak_gib']:.2f} GiB")
        bad = [row["step"] for row in rows
               if sum(row["batches_after"]) != 12
               or row["worker_ms"][2] < row["charge_ms"]]
        del session, out, t, exp
        torch.cuda.empty_cache()
        if bad or not serve["charged_seconds"] > 0 or serve[
                "shared_with"] != 2 or {k: counts.get(k, 0) for k in want} \
                != want or any(v for k, v in counts.items()
                               if k not in want):
            raise AssertionError(f"co-located {engine}: {res[engine]}")
    return res


def check_serving(peak_bw: float) -> dict:
    """Phase 12: (a), (e), (b) the engines on gemma-2b, (c) decode against
    the kernel path, (d) co-located serving in shared mode."""
    res, seconds = {}, {}
    for part, check in (("engines", lambda: check_serve_engines(peak_bw)),
                        ("decode", check_decode_vs_kernels),
                        ("colocated", check_serve_colocated)):
        t0 = time.perf_counter()
        res[part] = check()
        seconds[part] = time.perf_counter() - t0
    res["seconds"] = seconds
    log("  phase 12 seconds: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in seconds.items()))
    return res


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
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.rglru_scan import kernel as KR
    from repro_torch.kernels.ssd_scan import kernel as KS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    t_start = time.perf_counter()

    # 1. device and build
    smi = gpu_line()
    kind = torch.cuda.get_device_name(0)
    peak_name, (peak_flops, peak_bw, peak_tf32) = peaks(kind)
    log(f"[1] gpu: {smi}; torch {torch.__version__}, cuda {torch.version.cuda}"
        f"; peaks ({peak_name}): {peak_flops / 1e12:.0f} TFLOP/s fp32, "
        f"{peak_bw / 1e12:.2f} TB/s")
    t0 = time.perf_counter()
    sources = {"flash_attention": K.SOURCE, "ssd_scan": KS.SOURCE,
               "rglru_scan": KR.SOURCE}
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(lambda kv: build.build(kv[1], kv[0]),
                                          sources.items())))
    log("    built " + ", ".join(os.path.relpath(lib, ROOT)
                                 for lib in libs.values())
        + f" in {time.perf_counter() - t0:.1f} s (in parallel)")
    report = {"gpu": smi, "build_log": dict(build.BUILD_LOG), "cases": {},
              "ssd_cases": {}, "rglru_cases": {}}

    # 2. kernels against plain versions, then timings
    log("[2] kernels vs plain versions "
        f"(fwd allclose {FWD_TOL}; bwd max err <= {BWD_TOL} x max|ref|)")
    errs = check_kernels(report)
    report["fp64"] = check_fp64()
    log("  vs float64 (kernel / plain max abs err, kernel == plain): " + ", ".join(
        f"{n} {r['kernel_err']:.3g} / {r['plain_err']:.3g} "
        f"{r['kernel_equals_plain']}" for n, r in report["fp64"].items()))
    times = time_kernels(peak_flops, peak_bw, peak_tf32, report)
    report["hybrid_times"] = time_kernels(peak_flops, peak_bw, peak_tf32,
                                          report, FLASH_TIMED[1])
    torch.cuda.empty_cache()
    log(f"  library vs kernel max abs err: {report['library_vs_kernel']}")
    for name, tm in report["hybrid_times"].items():
        log(f"  {name} at the hybrid shapes {FLASH_TIMED[1][1:]}: kernel "
            f"{tm['ms']:.3f} ms, plain {tm['plain_ms']:.3f} ms, library "
            f"{tm['library_ms']:.3f} ms, bound {tm['bound_ms']:.4f} ms"
            + (f", 3xTF32 bound {tm['tf32x3_bound_ms']:.4f} ms"
               if "tf32x3_bound_ms" in tm else ""))
    log(f"  SSD kernels vs plain versions (fwd allclose {SSD_FWD_TOL}; bwd max"
        f" err <= {SSD_BWD_TOL} x max|ref|)")
    errs.update(check_ssd_kernels(report))
    report["ssd_fp64"] = check_ssd_fp64()
    log(f"  SSD scan vs float64 (kernel / plain max abs err; tol "
        f"{SSD_FWD_TOL} / {SSD_BWD_TOL} x max|ref|): " + ", ".join(
            f"{n} {r['kernel']:.3g} / {r['plain']:.3g} (max {r['ref_max']:.3g})"
            for n, r in report["ssd_fp64"].items()))
    times.update(time_ssd_kernels(peak_flops, peak_bw, peak_tf32))
    log(f"  RG-LRU kernels vs plain versions (fwd allclose {RGLRU_FWD_TOL}; "
        f"bwd max err <= {RGLRU_BWD_TOL} x max|ref|)")
    errs.update(check_rglru_kernels(report))
    report["rglru_fp64"] = check_rglru_fp64()
    log(f"  RG-LRU scan vs float64 (kernel / plain max abs err; tol "
        f"{RGLRU_FWD_TOL} / {RGLRU_BWD_TOL} x max|ref|): " + ", ".join(
            f"{n} {r['kernel']:.3g} / {r['plain']:.3g} (max {r['ref_max']:.3g})"
            for n, r in report["rglru_fp64"].items() if n != "fwd_no_h0")
        + "; rglru_fwd alone, no h0: h {h:.3g}, hT {hT:.3g} (max "
        "{ref_max:.3g})".format(**report["rglru_fp64"]["fwd_no_h0"]))
    times.update(time_rglru_kernels(peak_flops, peak_bw))
    for name, tm in times.items():
        lib_ms = ("none" if tm["library_ms"] is None
                  else f"{tm['library_ms']:.3f} ms")
        log(f"  {name}: kernel {tm['ms']:.3f} ms, plain {tm['plain_ms']:.3f} "
            f"ms, library {lib_ms}, bound {tm['bound_ms']:.4f} ms "
            f"({tm['bound_by']})"
            + (f", 3xTF32 bound {tm['tf32x3_bound_ms']:.4f} ms"
               if "tf32x3_bound_ms" in tm else "")
            + (f"; launch alone {tm['launch_ms']:.3f} ms"
               if "launch_ms" in tm else "")
            + (f"; B and C per head: kernel {tm['per_head_ms']:.3f} ms, "
               f"bound {tm['per_head_bound_ms']:.4f} ms, 3xTF32 bound "
               f"{tm['per_head_tf32x3_bound_ms']:.4f} ms"
               if "per_head_ms" in tm else ""))
    torch.cuda.empty_cache()

    # 3. small-input model checks, then the main paths
    report["model_check"] = {}
    for arch in ("gemma-2b", "mamba2-1.3b", "recurrentgemma-9b"):
        log(f"[3] LM loss + grads, kernels vs plain path (reduced {arch})")
        report["model_check"][arch] = check_model_path(arch)
        log(f"  {report['model_check'][arch]}")
    report["paths"] = {}
    for step_no, path in enumerate(PATHS, start=4):
        arch, layers, seq, _ = PATHS[path]
        log(f"[{step_no}] main path: {arch} widths, {layers} layers, seq "
            f"{seq}, microbatch {MICROBATCH}, {STEPS} BSP steps")
        report["paths"][path] = main_path(path)
        log_path(report["paths"][path])

    # 7-8. the paper's workloads, then resume
    log("[7] paper workloads on the card (hlevel 39 cores, h 8, b0 32, "
        "microbatch 8, adam 2e-3, BSP)")
    report["paper"] = check_paper_workloads()
    log("[8] checkpoint and resume on the card")
    report["resume"] = check_resume(args.out)
    log(f"[9] outer kinds: gemma-2b widths, 2 layers, seq 1024, microbatch "
        f"{MICROBATCH}, the gns and geometric outer controllers")
    report["outer"] = check_outer_kinds(peak_bw)
    log(f"[10] churn: the seed-{STORM['seed']} storm compiled from "
        f"storm_market, at gemma-2b widths (2 layers, seq 1024, b0 4, "
        f"microbatch {MICROBATCH}), then checkpoint under fire and the chaos "
        f"harness on mnist-cnn")
    report["churn"] = check_churn(args.out)
    log(f"[11] measured backend: gemma-2b widths (2 layers, seq 1024, b0 4, "
        f"microbatch {MICROBATCH}) on MeshBackend(dilation='from-spec'), "
        f"workers timed by CUDA events one after another; then mnist-cnn "
        f"ASP and the phase-10 storm on the mesh")
    report["mesh"] = check_mesh(report, errs, args.out)
    log(f"[12] serving: gemma-2b at full width and depth behind the "
        f"ContinuousBatcher ({SERVE_SLOTS} slots of {SERVE_CACHE}) and the "
        f"disaggregated KVSlotManager, {SERVE_REQUESTS} poisson requests; "
        f"decode against the kernel path on three models; co-located "
        f"serving in shared mode on phase 11's mesh path")
    report["serving"] = check_serving(peak_bw)

    replaces = {
        "flash_fwd": "src/repro/kernels/flash_attention/kernel.py:280",
        "flash_bwd_dq": "src/repro/kernels/flash_attention/kernel.py:359",
        "flash_bwd_dkv": "src/repro/kernels/flash_attention/kernel.py:399",
        "ssd_fwd": "src/repro/kernels/ssd_scan/kernel.py:29",
        "ssd_bwd": "src/repro/kernels/ssd_scan/kernel.py:29",
        "rglru_fwd": "src/repro/kernels/rglru_scan/kernel.py:22",
        "rglru_bwd": "src/repro/kernels/rglru_scan/kernel.py:22",
    }
    library_call = {
        "flash_fwd": "scaled_dot_product_attention",
        "flash_bwd_dq": "_scaled_dot_product_efficient_attention_backward"
                        " (dq, dk and dv in one call)",
        "flash_bwd_dkv": "_scaled_dot_product_efficient_attention_backward"
                         " (dq, dk and dv in one call)",
        "ssd_fwd": None, "ssd_bwd": None, "rglru_fwd": None, "rglru_bwd": None,
    }
    tols = {"flash_fwd": FWD_TOL, "flash_bwd_dq": BWD_TOL,
            "flash_bwd_dkv": BWD_TOL, "ssd_fwd": SSD_FWD_TOL,
            "ssd_bwd": SSD_BWD_TOL, "rglru_fwd": RGLRU_FWD_TOL,
            "rglru_bwd": RGLRU_BWD_TOL}
    sources = {"flash": K.SOURCE, "ssd": KS.SOURCE, "rglru": KR.SOURCE}
    kernels = []
    for name in replaces:
        path = next(p for p in PATHS if name in PATHS[p][3])
        tm = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(sources[name.split("_")[0]], ROOT),
            "replaces": replaces[name],
            "launches": report["paths"][path]["launches"][name],
            "max_abs_err": errs[name], "tol": tols[name],
            "ms": tm["ms"], "kernel_ms": tm["ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"],
            "library_call": library_call[name],
            **({"tf32x3_bound_ms": tm["tf32x3_bound_ms"]}
               if "tf32x3_bound_ms" in tm else {}),
            **({"hybrid_ms": report["hybrid_times"][name]["ms"]}
               if name in report["hybrid_times"] else {}),
            **{key: tm[key] for key in ("launch_ms", "per_head_ms",
                                        "per_head_bound_ms") if key in tm},
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
