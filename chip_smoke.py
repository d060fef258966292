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
     the window bites (B=1, S=T=4096), phi-3-vision's (B=2, S=T=1024,
     H=Hkv=32, D=96, num_valid 1 and 2), grok-1's (H=48, Hkv=8, D=128,
     softcap 30) and a head_dim the wrapper zero-pads (80); padded rows must be exact zeros, and
     a second flash_bwd_dq and flash_bwd_dkv launch must repeat the first
     bit for bit; kernel and plain version against a float64 attention at
     the training shapes; then kernel, plain and library timings (SDPA's
     memory-efficient forward and backward) at the training shapes and at
     the hybrid path's (B=2, S=T=2048, H=16, Hkv=1, D=256, window 2048),
     phi-3-vision's and grok-1's (SDPA without the softcap there, a
     yardstick of another function),
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
     then the 16-bit flash entries (csrc/flash_attention_16.cu: a wgmma +
     TMA forward, m16n8k16 backward kernels and the backward's delta) on
     bf16 and fp16 inputs at the gemma (num_valid 1 and 2), llama3-8b and
     phi-3-vision (D 96) shapes against the plain versions on the same
     inputs (outputs in the inputs' dtype, within HALF_TOL of each tensor's
     largest value, delta within DELTA_TOL, padded rows exact zeros, a
     second dq and dk/dv launch bit-equal, each call launching its 16-bit
     entry alone and allocating no fp32 copy of an input), and their bf16
     times at the gemma and llama3-8b shapes, no cast in the timed call,
     beside SDPA's flash backend (the memory-efficient call beside it),
     with their device time by torch.profiler and their bound at the bf16
     tensor-core rate (the fp32 and 3xTF32 bounds beside it);
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
     2 layers x every gradient call;
 13. slice 7, phase 4's settings: (a) the vlm main path, phi-3-vision-4.2b
     at full width (2 layers), seq 1024 = 576 patch positions + 448 text,
     through the flash kernels at head_dim 96: losses finite, each flash
     kernel launched 2 layers x microbatches, the weight sum = examples x
     448 (patch positions carry none), the last step profiled; (b)
     deepseek-v2-236b at full width, 1 layer, 32 of its 160 routed experts
     (MLA, top-6, 2 shared, capacity 1.25, aux weight 0.01), seq 1024:
     each step's aux, dropped-choice share and split logged, sum(b_k) 12,
     no port kernel launched; (c) llama3-8b (2 layers), yi-9b (2),
     command-r-plus-104b (1), grok-1-314b (1, its 8 experts), deepseek
     (1, all 160 experts) and phi-3-vision (2, with its prefix) at full
     width, random weights: 256 tokens (phi-3: 576 patches + 64) decoded
     one by one through the caches against ``apply_lm`` over all of them
     through the kernels, within 12(c)'s tolerance, MoE configs at
     capacity num_experts / top_k with no choice dropped, each flash
     kernel launched once a GQA layer in the full pass and none in
     decode; (d) whisper-medium at full width and depth (24 + 24 layers),
     1500 encoder frames, decoder seq 448, SLICE7_STEPS BSP steps (no port
     kernel), then ENCDEC_DECODE decoder tokens through the caches against
     the full decode pass on the trained parameters;
 14. slice 8: (a) the port's CLI (``repro_torch.launch.train.main``) in
     process: mamba2-1.3b at full config (48 layers, fp32, Adam, the plain
     SSD scan as the reference's CLI runs it), 3 workers, 4 BSP steps, seq
     256, b0 12, microbatch 4, then reduced gemma-2b on the measured
     backend for 3 steps: losses finite, sum(b_k) = workers x b0 every
     step, sim_time increasing, wall ms a step and peak memory logged; and
     ``--serve --serve-mode dedicated`` on the one card raising the
     reference's reserve error ("reserving 1 of 1 data-axis devices"); (b) the
     step programs (``launch/steps.py``) at the dry run's overrides (bf16
     parameters and activations, remat) through the kernels:
     gemma-2b at full depth (18 layers), B 4 x S 1024, Adam, 3 steps each
     with remat off, "full" and "dots", then 3 with accum_steps 4: step 0's
     loss equal across the three settings (bit-equality reported), flash
     launches 2 x 18 x microbatches forward under remat (18 x without),
     18 x microbatches each backward, each through its 16-bit entry (and
     the delta kernel once a backward), peak memory and step ms by CUDA
     events; llama3-8b at full depth (32 layers), B 2 x S 2048, remat
     "full", adafactor over the reference's stacked leaves, 3 steps and a
     fourth profiled: losses finite, step 2's below step 0's, the flash
     kernels' and the dtype casts' shares of busy time, no cast inside
     the flash attention function's forward or backward, useful TFLOP/s
     (6 x active parameters x tokens) beside the bf16 peak of
     ``launch/roofline.py``; then its serve
     step over SERVE_TOKENS tokens from empty caches against its prefill
     step on the same tokens (the kernels), within SERVE_TOL x max|logit|;
     (c) phase 6's hybrid path for one step with remat: the loss of phase
     6's step 0, each forward kernel launched twice a layer and
     microbatch, the backward ones once, peak memory beside phase 6's;
 15. slice 5b, the measured backend's concurrent round over
     ``MeshBackend(device=["cuda:0", "cpu"])``, the card and the host CPU
     computing at once (no two workers on a card): (a) mnist-cnn at phase
     7's settings, 2 workers, CONC_MNIST_STEPS BSP steps: every round has
     max(dispatch) < min(completion) in ``last_round_stamps`` and
     ``iteration_time == max(worker_times)``, Σb_k stays 64, losses are
     finite, over the last CONC_TAIL rounds the worker slower per example
     holds the smaller mean batch, and the CPU replica ends bit-equal to
     the card's master; each round's wall ms is logged beside the max and
     the sum of the worker ms, with the split, buckets and the torch thread
     count; (b) gemma-2b at full width, 2 layers, seq 512 (cut from 1024 for
     the CPU worker's calls), b0 2, microbatch 1, 3 BSP steps: each flash
     kernel launched 2 layers x the card worker's gradient calls (probe and
     reruns included), none for the CPU worker's, Σb_k kept, losses
     finite; per-worker ms, split, buckets and peak GiB logged; (c) phase
     11(a)'s path with ``ServeSpec(mode="dedicated", devices=1)`` (phase
     12(d)'s decode model): the CPU is the serve slice and the 3 workers
     take the card one after another, CONC_SERVE_STEPS steps, then the
     queue drained: every request finishes, nothing is charged, Σb_k is
     12, the decode engine's tensors are on the CPU and the trainer's on
     the card; (d) under FakeClock (cuDNN deterministic) ``device=
     ["cuda:0"]`` and ``device=None`` run mnist-cnn as ``"cuda:0"`` does
     over CONC_MATCH_STEPS steps.

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
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))

# published dense peaks (NVIDIA data sheets): fp32 outside the tensor cores,
# device-memory bandwidth, TF32 and bf16 (= fp16) on the tensor cores; the
# SXM part is the default
PEAKS = {"PCIe": (51e12, 2.0e12, 378e12, 756e12),
         "NVL": (60e12, 3.9e12, 418e12, 835e12),
         "SXM": (67e12, 3.35e12, 495e12, 989e12)}
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
    # slice 7: phi-3-vision's attention (head_dim 96, MHA) as phase 13(a)
    # runs it, grok-1's (GQA 6:1, softcap 30), and a head_dim the wrapper
    # zero-pads (80 -> 96)
    ("phi3-nv1", 2, 1024, 1024, 32, 32, 96, True, None, None, 1),
    ("phi3-nv2", 2, 1024, 1024, 32, 32, 96, True, None, None, 2),
    ("grok-nv2", 2, 1024, 1024, 48, 8, 128, True, None, 30.0, 2),
    ("pad-d80", 2, 256, 256, 4, 2, 80, True, 64, 30.0, 1),
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


# (label, B, S, T, H, Hkv, D, window, softcap): the gemma main path's
# attention, recurrentgemma's local blocks on the hybrid path, and slice 7's
# phi-3-vision (phase 13(a)) and grok-1 (13(c)) shapes; on 16-bit inputs
# gemma's and llama3-8b's (phase 14(b))
FLASH_TIMED = [("gemma", 2, 1024, 1024, 8, 1, 256, None, None),
               ("hybrid", 2, 2048, 2048, 16, 1, 256, 2048, None),
               ("phi3", 2, 1024, 1024, 32, 32, 96, None, None),
               ("grok", 2, 1024, 1024, 48, 8, 128, None, 30.0)]
FLASH_TIMED_16 = [FLASH_TIMED[0],
                  ("llama3", 2, 2048, 2048, 32, 8, 128, None, None)]


YARDSTICK_ROUNDS = 5  # the 16-bit forward alternated with SDPA's default,
                      # the 16-bit backward pair with SDPA's flash backward


def time_kernels(peak: tuple, report: dict, shape=FLASH_TIMED[0],
                 dtype: str = "float32") -> dict:
    """kernel / plain / library times at one of ``FLASH_TIMED``'s shapes
    (causal, nv = B) on inputs of ``dtype``, with the bound.  ``peak`` is a
    ``PEAKS`` entry.  Each input is counted read once and each output
    written once; the FLOPs are those of the visible pairs.

    On fp32 inputs the fp32 entry runs, and the bound takes the fp32 rate,
    with the 3xTF32 bound beside it (three TF32 products per fp32 one, as
    the fp32 kernels compute).  The library is SDPA's memory-efficient
    attention in fp32 on (B,H,S,D) tensors with the kv head repeated to H
    (the window, where given, does not bite at these S, so causal SDPA
    computes the same function; SDPA has no softcap, so with one it times
    the uncapped function, a yardstick only: ``library_same_function``
    False and no error against it).  Its backward is one call that
    computes dq, dk and dv together, so both backward kernels carry its
    time; compare it with the sum of theirs.  Its dk/dv come per query
    head; summed over each kv head's group they are checked against the
    kernels' here.

    On 16-bit inputs the 16-bit entries run (keys ``flash_fwd_16`` ...,
    and ``flash_delta_16``, the backward's delta), reading the inputs as
    they are: no cast in the timed call.  Bytes are 16-bit ones (lse,
    delta and the GQA partials' fp32 scratch aside), and the bound takes
    the 16-bit tensor-core rate (products of 16-bit inputs accumulated in
    fp32 compute Q.K^T exactly); the fp32 and 3xTF32 bounds stand beside
    it.  The library is SDPA's flash backend alone
    (``aten._scaled_dot_product_flash_attention`` and its backward), the
    memory-efficient call's times beside it as ``efficient_ms`` (and, for
    the forward, ``F.scaled_dot_product_attention``'s own choice of
    backend as ``sdpa_default_ms``, the yardstick of the 16-bit path's
    earlier timings).
    ``device_ms`` is the kernels' device time a call by torch.profiler,
    where ``ms`` (CUDA events around back-to-back calls) also holds the
    wrapper's host time when that is the longer."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import visible_mask

    dev = torch.device("cuda")
    label, b, s, t, h, hkv, d, window, cap = shape
    if window is not None and window < t:
        raise ValueError(f"{label}: a biting window has no SDPA yardstick")
    peak_fp32, peak_bw, peak_tf32, peak_16 = peak
    dt = getattr(torch, dtype)
    half = dt != torch.float32
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(x, generator=g, device=dev).to(dt)
                   for x in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d),
                             (b, s, h, d)))
    nv = torch.tensor(b, dtype=torch.int32, device=dev)
    kw = dict(causal=True, window=window, softcap=cap)
    out, lse = K.flash_fwd(q, k, v, nv, **kw)
    delta = K.flash_delta_plain(do, out)
    pairs = int(visible_mask(s, t, causal=True, window=window).sum())
    size = q.element_size()  # bytes per input value; lse and delta fp32
    q_bytes, kv_bytes, row_bytes = b * s * h * d * size, \
        b * t * hkv * d * size, b * h * s * 4
    work = {  # (flops, bytes): each input read once, each output written once
        "flash_fwd": (4 * d * pairs * h * b,
                      2 * q_bytes + 2 * kv_bytes + row_bytes),
        "flash_bwd_dq": (6 * d * pairs * h * b,
                         3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
        "flash_bwd_dkv": (8 * d * pairs * h * b,
                          2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
        "flash_delta": (2 * b * s * h * d, 2 * q_bytes + row_bytes),
    }
    rep = h // hkv
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()
    dot = do.transpose(1, 2).contiguous()
    eff_fwd = torch.ops.aten._scaled_dot_product_efficient_attention
    eff_bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward
    out_e, lse_e, seed, offset = eff_fwd(qt, kt, vt, None, True, 0.0, True)

    def eff_backward():
        return eff_bwd(dot, qt, kt, vt, None, out_e, lse_e, seed, offset, 0.0,
                       [True, True, True, False], True)

    if half:
        fa_fwd = torch.ops.aten._scaled_dot_product_flash_attention
        fa_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
        fa = fa_fwd(qt, kt, vt, 0.0, True, False)

        def lib_fwd():
            return fa_fwd(qt, kt, vt, 0.0, True, False)

        def lib_bwd():
            return fa_bwd(dot, qt, kt, vt, fa[0], fa[1], fa[2], fa[3], fa[4],
                          fa[5], 0.0, True, fa[6], fa[7])

        out_l, (dq_l, dk_l, dv_l) = fa[0], lib_bwd()
    else:
        def lib_fwd():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        lib_bwd = eff_backward
        out_l, (dq_l, dk_l, dv_l, _) = out_e, lib_bwd()
    dq, (dk, dv) = (K.flash_bwd_dq(q, k, v, do, lse, delta, nv, **kw),
                    K.flash_bwd_dkv(q, k, v, do, lse, delta, nv, **kw))
    key = label if not half else f"{label}-{dtype}"
    report.setdefault("library_vs_kernel", {})[key] = None if cap else {
        "out": (out_l.transpose(1, 2).float() - out.float()).abs().max()
        .item(),
        "dq": (dq_l.transpose(1, 2).float() - dq.float()).abs().max().item(),
        "dk": (dk_l.float().unflatten(1, (hkv, rep)).sum(2).transpose(1, 2)
               - dk.float()).abs().max().item(),
        "dv": (dv_l.float().unflatten(1, (hkv, rep)).sum(2).transpose(1, 2)
               - dv.float()).abs().max().item(),
    }
    del dq_l, dk_l, dv_l
    calls = {
        "flash_fwd": (lambda: K.flash_fwd(q, k, v, nv, **kw),
                      lambda: K.flash_fwd_plain(q, k, v, nv, **kw), lib_fwd),
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
    if half:
        calls["flash_delta"] = (lambda: K.flash_delta(do, out),
                                lambda: K.flash_delta_plain(do, out), None)
    times, lib_ms = {}, {None: None}  # a library call is timed once
    efficient = {"flash_fwd": lambda: eff_fwd(qt, kt, vt, None, True, 0.0,
                                              True)}
    for name, (kern, plain, lib) in calls.items():
        flops, nbytes = work[name]
        t_mem = nbytes / peak_bw * 1e3
        t_fp32 = flops / peak_fp32 * 1e3
        t_ops = t_fp32 if not half else flops / peak_16 * 1e3
        if lib not in lib_ms:
            lib_ms[lib] = time_ms(lib, 20)
        tm = {
            "ms": time_ms(kern, 20),
            "plain_ms": time_ms(plain, 5),
            "library_ms": lib_ms[lib],
            "bound_ms": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
            "flops": flops, "bytes": nbytes,
            "library_same_function": lib is not None and not cap,
        }
        if name != "flash_delta":
            tm["tf32x3_bound_ms"] = max(3 * flops / peak_tf32 * 1e3, t_mem)
        if half:
            tm["fp32_bound_ms"] = max(t_fp32, t_mem)
            tm["device_ms"] = device_ms(kern, FLASH16[f"{name}_16"])
            if tm["device_ms"] is None:
                raise AssertionError(
                    f"{name}_16 at the {label} shapes: the profiler recorded "
                    f"none of its kernels in 3 profiles: {PROFILE_MISSES}")
            if name in efficient:
                tm["efficient_ms"] = time_ms(efficient[name], 20)

                def sdpa():  # the backend SDPA picks by itself: the yardstick
                    return F.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True)

                # its readings spread from call to call: alternate it with
                # the kernel, YARDSTICK_ROUNDS times, and keep every reading
                rounds = [(time_ms(kern, 20), time_ms(sdpa, 20))
                          for _ in range(YARDSTICK_ROUNDS)]
                tm["kernel_ms_alternated"] = [a for a, _ in rounds]
                tm["sdpa_default_ms_alternated"] = [b for _, b in rounds]
                tm["sdpa_default_ms"] = statistics.median(
                    tm["sdpa_default_ms_alternated"])
                prof = device_profile(sdpa)
                tm["sdpa_default_device_ms"] = sum(prof.values()) or None
                tm["sdpa_default_kernels"] = [n[:100] for n in prof]
            elif name != "flash_delta":
                if "bwd" not in lib_ms:
                    lib_ms["bwd"] = time_ms(eff_backward, 20)
                tm["efficient_ms"] = lib_ms["bwd"]
        times[f"{name}_16" if half else name] = tm
    if half:
        # dq + dk/dv against SDPA's flash backward (dq, dk and dv in one
        # call), in turn YARDSTICK_ROUNDS times, by the profiler's device
        # time: every reading kept, on the dk/dv entry
        def pair():
            calls["flash_bwd_dq"][0]()
            calls["flash_bwd_dkv"][0]()

        frags = FLASH16["flash_bwd_dq_16"] + FLASH16["flash_bwd_dkv_16"]
        rounds = [(device_ms(pair, frags),
                   sum(device_profile(lib_bwd).values()) or None)
                  for _ in range(YARDSTICK_ROUNDS)]
        tm = times["flash_bwd_dkv_16"]
        tm["pair_device_ms_alternated"] = [a for a, _ in rounds]
        tm["library_device_ms_alternated"] = [b for _, b in rounds]
    return times


# ------------------------------------------ phase 2, 16-bit flash inputs

HALF_TOL = 1e-2   # of each tensor's max |value|: 16-bit outputs, and the 16-bit
                  # kernels round P and dS to 16 bits (ROADMAP queue 3); each
                  # (b, s, h) row is also held to ``K.row_error``'s limit and
                  # lse to ``K.LSE_TOL`` of its max
DELTA_TOL = 1e-5  # of max |delta|: fp32 sums of exact products, another order
# (label, B, S, H, Hkv, D, num_valid, window, softcap), causal, S = T:
# gemma's main path (one and two valid rows), llama3-8b's (phase 14(b)),
# phi-3-vision's (D 96, phase 13(a)), grok-1's heads with its softcap 30,
# and the hybrid's local blocks (D 256, H 16, Hkv 1) with a window that
# bites (half of S)
HALF_CASES = [("gemma-nv1", 2, 1024, 8, 1, 256, 1, None, None),
              ("gemma-nv2", 2, 1024, 8, 1, 256, 2, None, None),
              ("llama3", 2, 2048, 32, 8, 128, None, None, None),
              ("phi3-nv1", 2, 1024, 32, 32, 96, 1, None, None),
              ("grok-softcap", 2, 1024, 48, 8, 128, 1, None, 30.0),
              ("hybrid-window", 2, 2048, 16, 1, 256, 1, 1024, None)]


def check_flash_half(report: dict) -> dict:
    """The 16-bit flash entries on bf16 and fp16 inputs at ``HALF_CASES``
    against the plain versions on the same inputs: out, dq, dk and dv in the
    inputs' dtype and lse f32 within HALF_TOL of each tensor's largest
    value, each row of out, dq, dk and dv within ``K.row_error``'s limit (a
    few units in the last place of the row's own largest value) and lse
    within ``K.LSE_TOL`` of its largest (fp32), padded rows exact zeros, a
    second forward, dq and dk/dv launch bit-equal,
    ``flash_delta`` within DELTA_TOL of its plain version.  Each call must
    launch its 16-bit entry alone (``LAUNCHES_16`` moves with ``LAUNCHES``:
    the fp32 entry does not run) and allocate no more than its outputs and
    scratch (1 MiB of slack; an fp32 copy of an input would not fit): for
    dk/dv that is the fp32 partials of ``K.dkv16_splits`` splits, none where
    a kv head's whole group of query heads runs in one block.
    Returns each 16-bit kernel's largest error and, under ``"rows"``, each
    one's largest ``row_error`` (lse's: its error over LSE_TOL x max)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as K

    dev = torch.device("cuda")
    errs = {k: 0.0 for k in FLASH16}
    row_errs = {k: 0.0 for k in ("out", "lse", "dq", "dk", "dv")}
    slack = 1 << 20

    def run(fn, allowed: int):
        """fn()'s result, its launches, and the bytes it allocated at peak
        (and whether that stayed within ``allowed``)"""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        new = torch.cuda.max_memory_allocated() - before
        counts = {k: v for k, v in {**K.LAUNCHES, **K.LAUNCHES_16}.items()
                  if v}
        return out, counts, new, new <= allowed + slack

    for dtype in (torch.bfloat16, torch.float16):
        for label, b, s, h, hkv, d, nv, window, cap in HALF_CASES:
            name = f"{label}-{str(dtype)[6:]}"
            kw = dict(causal=True, window=window, softcap=cap)
            g = torch.Generator(device=dev).manual_seed(zlib.crc32(
                name.encode()))
            q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                           .to(dtype) for shape in ((b, s, h, d),
                                                    (b, s, hkv, d),
                                                    (b, s, hkv, d),
                                                    (b, s, h, d)))
            nvt = None if nv is None else torch.tensor(nv, dtype=torch.int32,
                                                       device=dev)
            qb, kb, rows = q.numel() * 2, k.numel() * 2, b * h * s * 4
            # the dk/dv kernel's fp32 partials: (B, T, Hkv * splits, D) for
            # dk and for dv where it splits the groups, else none
            splits = K.dkv16_splits(b, s, h, hkv, d)
            scratch = 2 * b * s * hkv * splits * d * 4 if splits > 1 else 0
            out_p, lse_p = K.flash_fwd_plain(q, k, v, nvt, **kw)
            delta_p = K.flash_delta_plain(do, out_p)
            calls = {
                "fwd": (lambda: K.flash_fwd(q, k, v, nvt, **kw), qb + rows,
                        {"flash_fwd": 1, "flash_fwd_16": 1}),
                "dq": (lambda: K.flash_bwd_dq(q, k, v, do, lse_p, delta_p,
                                              nvt, **kw), qb,
                       {"flash_bwd_dq": 1, "flash_bwd_dq_16": 1}),
                "dkv": (lambda: K.flash_bwd_dkv(q, k, v, do, lse_p, delta_p,
                                                nvt, **kw), 2 * kb + scratch,
                        {"flash_bwd_dkv": 1, "flash_bwd_dkv_16": 1}),
            }
            got, res = {}, {"dkv_splits": splits,
                            "dkv_scratch_bytes": scratch}
            for key, (fn, allowed, want_counts) in calls.items():
                got[key], counts, new, fits = run(fn, allowed)
                res[f"{key}_launches"] = counts
                res[f"{key}_new_bytes"] = new
                res[f"{key}_entry_16_alone"] = counts == want_counts
                res[f"{key}_no_fp32_copy"] = fits
            (out, lse), dq, (dk, dv) = got["fwd"], got["dq"], got["dkv"]
            delta, counts, new, fits = run(lambda: K.flash_delta(do, out),
                                           rows)
            res["delta_entry_16_alone"] = counts == {"flash_delta_16": 1}
            res["delta_no_fp32_copy"] = fits
            out2, lse2 = K.flash_fwd(q, k, v, nvt, **kw)
            dq2 = K.flash_bwd_dq(q, k, v, do, lse_p, delta_p, nvt, **kw)
            dk2, dv2 = K.flash_bwd_dkv(q, k, v, do, lse_p, delta_p, nvt,
                                       **kw)
            torch.cuda.synchronize()
            res["fwd_repeats_bit_for_bit"] = bool(torch.equal(out, out2)
                                                  and torch.equal(lse, lse2))
            res["dq_repeats_bit_for_bit"] = bool(torch.equal(dq, dq2))
            res["dkv_repeats_bit_for_bit"] = bool(torch.equal(dk, dk2)
                                                  and torch.equal(dv, dv2))
            want = {"out": out_p, "lse": lse_p,
                    "dq": K.flash_bwd_dq_plain(q, k, v, do, lse_p, delta_p,
                                               nvt, **kw)}
            want["dk"], want["dv"] = K.flash_bwd_dkv_plain(
                q, k, v, do, lse_p, delta_p, nvt, **kw)
            kernel_of = {"out": "flash_fwd_16", "lse": "flash_fwd_16",
                         "dq": "flash_bwd_dq_16", "dk": "flash_bwd_dkv_16",
                         "dv": "flash_bwd_dkv_16"}
            for key, x in {"out": out, "lse": lse, "dq": dq, "dk": dk,
                           "dv": dv}.items():
                ref = want[key]
                err = (x.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                row = (err / (K.LSE_TOL * scale) if key == "lse"
                       else K.row_error(x, ref))
                row_errs[key] = max(row_errs[key], row)
                res[key] = {"max_abs_err": err, "ref_max": scale,
                            "dtype": str(x.dtype), "row_error": row,
                            "ok": (err <= HALF_TOL * scale and row <= 1
                                   and x.dtype == ref.dtype
                                   and x.dtype == (torch.float32
                                                   if key == "lse" else dtype)
                                   and (nv is None
                                        or bool((x[nv:] == 0).all())))}
                errs[kernel_of[key]] = max(errs[kernel_of[key]], err)
            ref = K.flash_delta_plain(do, out)
            err = (delta - ref).abs().max().item()
            scale = ref.abs().max().item()
            res["delta"] = {"max_abs_err": err, "ref_max": scale,
                            "ok": err <= DELTA_TOL * max(scale, 1e-30)}
            errs["flash_delta_16"] = max(errs["flash_delta_16"], err)
            log(f"  case {name}: " + ", ".join(
                f"{key} err {res[key]['max_abs_err']:.3g} (max "
                f"{res[key]['ref_max']:.3g}"
                + (f", row {res[key]['row_error']:.3g})" if key != "delta"
                   else ")")
                for key in ("out", "lse", "dq", "dk", "dv", "delta"))
                + f"; 16-bit entries alone "
                + str(all(res[f"{c}_entry_16_alone"]
                          for c in ("fwd", "dq", "dkv", "delta")))
                + ", no fp32 copy " + str(all(
                    res[f"{c}_no_fp32_copy"]
                    for c in ("fwd", "dq", "dkv", "delta")))
                + f" (new bytes fwd {res['fwd_new_bytes']}, dq "
                f"{res['dq_new_bytes']}, dkv {res['dkv_new_bytes']}; dk/dv "
                f"splits {splits}, partials {scratch} bytes)"
                + f", fwd / dq / dk,dv repeat bit for bit "
                f"{res['fwd_repeats_bit_for_bit']} / "
                f"{res['dq_repeats_bit_for_bit']} / "
                f"{res['dkv_repeats_bit_for_bit']}")
            report.setdefault("half_cases", {})[name] = res
            bad = [key for key, r in res.items()
                   if (isinstance(r, dict) and not r.get("ok", True))
                   or (isinstance(r, bool) and not r)]
            if bad:
                raise AssertionError(f"16-bit flash case {name} failed on "
                                     f"{bad}: {res}")
    errs["rows"] = row_errs
    return errs


def device_profile(fn, iters: int = 10) -> dict:
    """Each CUDA kernel's name -> its device ms a call of ``fn`` by
    torch.profiler (CUPTI), over ``iters`` calls; empty where the profiler
    records no device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms: dict = {}
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")) == "DeviceType.CUDA":
            ms[ev.name] = (ms.get(ev.name, 0.0)
                           + ev.device_time_total / iters / 1e3)
    return ms


# each profile in which ``device_ms`` found none of its kernels: the name
# fragments it looked for and the kernels the profiler did record
PROFILE_MISSES: list = []


def device_ms(fn, frags: tuple, iters: int = 10, attempts: int = 3) -> float:
    """Device time a call of ``fn``: the kernels whose names hold one of
    ``frags``, from the first of up to ``attempts`` profiles that records
    any of them (each miss is kept in ``PROFILE_MISSES``); None where none
    does."""
    for _ in range(attempts):
        prof = device_profile(fn, iters)
        ms = sum(t for name, t in prof.items()
                 if any(f in name for f in frags))
        if ms:
            return ms
        PROFILE_MISSES.append({"frags": list(frags),
                               "recorded": [n[:100] for n in prof]})
    return None


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


def launches_16() -> dict:
    """The 16-bit flash entries' launches (each also counted under its fp32
    name in ``all_launches``)."""
    from repro_torch.kernels.flash_attention import LAUNCHES_16

    return dict(LAUNCHES_16)


def reset_all_launches() -> None:
    for mod in kernel_modules():
        mod.reset_launches()


# kernel -> the profiler name fragment of each CUDA kernel its wrapper
# launches (flash_bwd_dkv: the per-head kernel, then the group-sum)
FLASH = {"flash_fwd": ("::fwd_kernel<",), "flash_bwd_dq": ("::dq_kernel<",),
         "flash_bwd_dkv": ("::dkv_kernel<", "::dkv_sum_kernel(")}
# the 16-bit entries' kernels (csrc/flash_attention_16.cu; flash_bwd_dkv_16:
# the group-summing kernel, then the sum of the splits' partials where the
# launcher splits the groups)
FLASH16 = {"flash_fwd_16": ("::fwd16_kernel<",),
           "flash_bwd_dq_16": ("::dq16_kernel<",),
           "flash_bwd_dkv_16": ("::dkv16_kernel<", "::dkv_sum16_kernel<"),
           "flash_delta_16": ("::delta16_kernel<",)}
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

    arch, layers, seq, own, overrides = (
        (*PATHS[path], {}) if path in PATHS
        else {**SLICE7_PATHS, **SLICE8_PATHS}[path])
    frags = {k: frag for k, (frag, _) in own.items()}
    cfg = get_config(arch, num_layers=layers, **overrides)
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
    trainer, ran, weight_sums = session.trainer, [], []
    bsp_step, loss_and_grad = trainer.bsp_step, trainer._loss_and_grad

    def recorded_step():
        ran.append(list(trainer.batches))
        return bsp_step()

    def recorded_loss_and_grad(params, batch, mask):
        metas, grads = loss_and_grad(params, batch, mask)
        weight_sums.append(metas[1])
        return metas, grads

    trainer.bsp_step = recorded_step
    trainer._loss_and_grad = recorded_loss_and_grad
    reset_all_launches()
    try:
        out = session.run()
    finally:
        del trainer.bsp_step        # no cycle holds the trainer's tensors
        trainer._loss_and_grad = loss_and_grad
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
           "weight_sum": float(torch.stack(weight_sums).sum()),
           "examples": sum(sum(bs) for bs in ran),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "profile": clock.profile}
    del session, experiment, out, trainer, bsp_step, loss_and_grad
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
    # cuBLAS's Hopper bf16 kernels are named nvjet_*
    gemm = sum(t for n, t in kernels.items()
               if "gemm" in n.lower() or n.startswith("nvjet"))
    # dtype casts and copies (the bf16 paths' upcasts to fp32 among them)
    copies = sum(t for n, t in kernels.items() if "copy" in n.lower())
    # device time of the kernels that the CPU op aten::dot launched: the
    # GNS side statistics (core/grad.py::tree_sqnorm); nothing else on the
    # main paths calls it
    dots = [ev for ev in prof.events() if ev.name == "aten::dot"
            and str(getattr(ev, "device_type", "")) != "DeviceType.CUDA"]
    return {"step_wall_us": wall_us, "device_busy_us": busy,
            "idle_share": (1 - busy / wall_us) if busy else None,
            "kernels_us": mine, "fragments_us": by_frag, "gemm_us": gemm,
            "copy_us": copies,
            "sqnorm_us": sum(ev.device_time_total for ev in dots),
            "sqnorm_calls": len(dots),
            "sqnorm_kernels": sorted({k.name[:60] for ev in dots
                                      for k in getattr(ev, "kernels", ())}),
            "top": [(n[:90], t) for n, t in ranked[:top]]}


def cast_summary(prof) -> dict:
    """The dtype casts (``aten::_to_copy``) of a profiled step: how many,
    their device time, and how many ran inside the flash attention
    function's forward or backward (a ``_FlashAttention`` range: the
    autograd function's own range, the backward node's)."""
    events = prof.events()
    casts = [ev for ev in events if ev.name == "aten::_to_copy"]

    def in_flash(ev) -> bool:
        while ev.cpu_parent is not None:
            ev = ev.cpu_parent
            if "_FlashAttention" in ev.name:
                return True
        return False

    return {"casts": len(casts),
            "casts_us": sum(ev.device_time_total for ev in casts),
            "flash_ranges": sum("_FlashAttention" in ev.name
                                for ev in events),
            "flash_casts": sum(in_flash(ev) for ev in casts)}


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
            f"copies and casts {pr['copy_us'] / 1e3:.1f} ms, own kernels "
            + ", ".join(
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


def excess(got, ref) -> dict:
    """max(|got - ref| - (atol + rtol |ref|)) at DECODE_TOL with the atol
    raised to DECODE_ULPS x max|ref| where larger: <= 0 passes; with the
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


def log_excess(r: dict) -> str:
    return ", ".join(
        f"{k} {v['excess']:.3g} at atol {v['atol']:.3g} "
        f"({v['excess_at_atol_2e-4']:.3g} at atol 2e-4; there |b| "
        f"{v['at_abs_ref']:.3g}, |a - b| {v['at_abs_err']:.3g}; max "
        f"|a - b| {v['max_abs_err']:.3g})"
        for k, v in r.items() if k.endswith("_path"))


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
            f"max(|a - b| - (atol + rtol|b|)) (<= 0 passes): "
            + log_excess(r) + f"; decode {seconds:.2f} s")
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


# ------------------------------------------------------- phase 13, slice 7

# path -> (arch, layers, seq, the path's kernels as in PATHS, config
# overrides): (a) the vlm main path, (b) MLA + MoE with 32 of deepseek's 160
# routed experts (the one cut beyond depth: PERF.md section 4), (d) whisper
# at full depth with Whisper's 448-token text context
SLICE7_PATHS = {
    # MHA: dk/dv come per kv head straight away, no group-sum kernel
    "phi3v": ("phi-3-vision-4.2b", 2, 1024,
              {k: (frag[:1], 2) for k, frag in FLASH.items()}, {}),
    "deepseek": ("deepseek-v2-236b", 1, 1024, {}, {"num_experts": 32}),
    "whisper": ("whisper-medium", 24, 448, {}, {}),
}
SLICE7_STEPS = {"phi3v": 4, "deepseek": 3, "whisper": 3}
# (c): arch -> (layers, the kernels its full pass launches and their
# layers, tokens); phi-3-vision's 640 positions are its 576 patches and 64
# text tokens
SLICE7_DECODE = {
    "llama3-8b": (2, {"flash_fwd": 2}, DECODE_SEQ),
    "yi-9b": (2, {"flash_fwd": 2}, DECODE_SEQ),
    "command-r-plus-104b": (1, {"flash_fwd": 1}, DECODE_SEQ),
    "grok-1-314b": (1, {"flash_fwd": 1}, DECODE_SEQ),
    "deepseek-v2-236b": (1, {}, DECODE_SEQ),
    "phi-3-vision-4.2b": (2, {"flash_fwd": 2}, 640),
}
ENCDEC_DECODE = 64      # (d): decoder tokens through the caches


class MoeProbe:
    """While entered, every ``apply_moe`` call's aux loss and the count of
    its routed choices that found no capacity (and of all its choices) are
    kept, as device tensors; ``take()`` returns their sums as floats and
    starts over."""

    def __enter__(self):
        from repro_torch.models import layers as L

        self.L, self.route, self.apply = L, L.moe_route, L.apply_moe
        self.calls, self.pending = [], None

        def route(p, xt, cfg):
            out = self.route(p, xt, cfg)
            cap = L.moe_capacity(xt.shape[1], cfg.moe_top_k, cfg.num_experts,
                                 cfg.moe_capacity_factor)
            self.pending = ((out[4] >= cap).sum(), out[4].numel())
            return out

        def apply(p, x, cfg):
            out, aux = self.apply(p, x, cfg)
            self.calls.append((aux.detach(), *self.pending))
            return out, aux

        L.moe_route, L.apply_moe = route, apply
        return self

    def __exit__(self, *exc):
        self.L.moe_route, self.L.apply_moe = self.route, self.apply

    def take(self) -> dict:
        calls, self.calls = self.calls, []
        if not calls:
            return {"calls": 0, "aux_mean": None, "dropped": 0, "choices": 0}
        import torch

        aux = torch.stack([a for a, _, _ in calls]).mean().item()
        dropped = int(torch.stack([d for _, d, _ in calls]).sum())
        return {"calls": len(calls), "aux_mean": aux, "dropped": dropped,
                "choices": sum(n for _, _, n in calls)}


def check_vlm_path() -> dict:
    """13(a): phi-3-vision at full width (2 layers), seq 1024 = 576 patch
    positions + 448 text, through the flash kernels at head_dim 96."""
    mp = main_path("phi3v", steps=SLICE7_STEPS["phi3v"])
    log_path(mp)
    arch, _, seq, _, _ = SLICE7_PATHS["phi3v"]
    from repro_torch.configs import get_config

    text = seq - get_config(arch).num_patches
    mp["text_positions"] = text
    log(f"  weight sum {mp['weight_sum']} over {mp['examples']} examples "
        f"(want {mp['examples']} x {text} text positions)")
    if mp["weight_sum"] != mp["examples"] * text:
        raise AssertionError(f"vlm weight sum {mp['weight_sum']} counts "
                             f"patch positions: {mp['examples']} x {text}")
    return mp


def check_moe_path() -> dict:
    """13(b): deepseek-v2 (MLA + MoE, 32 routed experts, top-6, 2 shared,
    capacity 1.25, aux weight 0.01) at full width, 1 layer, seq 1024; each
    step's aux, dropped-choice share and split logged."""
    from repro_torch.api import Hook

    steps = []

    class PerStep(Hook):
        def on_step(self, session, rec):
            st = probe.take()
            st["batches"] = list(rec.batches)
            st["dropped_share"] = st["dropped"] / max(st["choices"], 1)
            steps.append(st)
            log(f"  step {rec.step}: aux {st['aux_mean']:.5f} (mean of "
                f"{st['calls']} MoE calls), dropped {st['dropped']} of "
                f"{st['choices']} choices ({st['dropped_share']:.4f}), split "
                f"{rec.batches}")

    with MoeProbe() as probe:
        mp = main_path("deepseek", steps=SLICE7_STEPS["deepseek"],
                       hooks=[PerStep()])
    log_path(mp)
    mp["moe_steps"] = steps
    bad = [b for b in mp["batches"] if sum(b) != 12]
    if bad or not all(st["calls"] and math.isfinite(st["aux_mean"])
                      for st in steps):
        raise AssertionError(f"MoE path: splits {mp['batches']}, "
                             f"steps {steps}")
    return mp


def check_slice7_decode() -> dict:
    """13(c): each config at full width (depth cut), random weights, one
    row of tokens (phi-3-vision's first 576 positions its patch prefix)
    decoded one by one through the caches against ``apply_lm`` over all of
    them through the kernels, within DECODE_TOL as 12(c); MoE configs at
    capacity factor num_experts / top_k, where no choice may drop; each
    flash kernel launched once a layer in the full pass, none in decode.
    Each model is freed before the next; every model runs before the phase
    fails on any."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import apply_lm, init_caches, init_lm, lm_loss

    dev = torch.device("cuda")
    res, failed = {}, []
    for arch, (layers, want, seq) in SLICE7_DECODE.items():
        cfg = get_config(arch, num_layers=layers).with_(use_pallas=True)
        if cfg.num_experts:
            cfg = cfg.with_(moe_capacity_factor=cfg.num_experts
                            / cfg.moe_top_k)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_lm(torch.Generator(device=dev).manual_seed(1), cfg)
        n_params = sum(p.numel() for p in params.values())
        g = torch.Generator(device=dev).manual_seed(2)
        toks = torch.randint(0, cfg.vocab_size, (1, seq), generator=g,
                             device=dev)
        prefix = (0.02 * torch.randn((1, cfg.num_patches, cfg.d_model),
                                     generator=g, device=dev)
                  if cfg.num_patches else None)
        with MoeProbe() as probe, torch.no_grad():
            reset_all_launches()
            full, _ = apply_lm(params, cfg, toks, prefix_embeds=prefix)
            torch.cuda.synchronize()
            full_ms = (time.perf_counter() - t0) * 1e3
            full_launches = {k: v for k, v in all_launches().items() if v}
            moe_full = probe.take()
            reset_all_launches()
            caches, dec = init_caches(cfg, 1, seq, device=dev), []
            t1 = time.perf_counter()
            for i in range(seq):
                pe = (prefix[:, i:i + 1] if prefix is not None
                      and i < prefix.shape[1] else None)
                lg, caches, _ = apply_lm(
                    params, cfg, toks[:, i:i + 1], caches=caches,
                    positions=torch.full((1, 1), i, device=dev),
                    prefix_embeds=pe)
                dec.append(lg)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t1
            dec_launches = {k: v for k, v in all_launches().items() if v}
            moe_dec = probe.take()
            dec = torch.cat(dec, dim=1)
            plain, _ = apply_lm(params, cfg.with_(use_pallas=False), toks,
                                prefix_embeds=prefix)
            weight_sum = None
            if prefix is not None:
                weight_sum = lm_loss(params, cfg, toks, toks,
                                     torch.ones(1, device=dev),
                                     prefix_embeds=prefix)[1].item()
        r = res[arch] = {
            "layers": layers, "params": n_params, "seq": seq,
            "full_pass_launches": full_launches,
            "decode_launches": dec_launches,
            "decode_vs_kernel_path": excess(dec, full),
            "decode_vs_plain_path": excess(dec, plain),
            "kernel_vs_plain_path": excess(full, plain),
            "max_abs_logit": full.abs().max().item(),
            "moe_full_pass": moe_full, "moe_decode": moe_dec,
            "init_and_full_pass_ms": full_ms, "decode_seconds": seconds,
            "weight_sum": weight_sum,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
        log(f"  (c) {arch}, {layers} layers, {n_params / 1e9:.2f}B params, "
            f"{seq} tokens: full pass launches {full_launches} (want "
            f"{want}), decode launches {dec_launches}; MoE dropped "
            f"{moe_full['dropped']} + {moe_dec['dropped']} of "
            f"{moe_full['choices']} + {moe_dec['choices']} choices; max "
            f"|logit| {r['max_abs_logit']:.1f}; max(|a - b| - (atol + "
            f"rtol|b|)) (<= 0 passes): " + log_excess(r)
            + f"; decode {seconds:.2f} s; peak "
            f"{r['max_memory_allocated'] / 2**30:.2f} GiB")
        del params, full, plain, caches, dec, lg
        torch.cuda.empty_cache()
        if full_launches != want or dec_launches or \
                r["decode_vs_kernel_path"]["excess"] > 0 or \
                moe_full["dropped"] or moe_dec["dropped"] or \
                (weight_sum is not None
                 and weight_sum != seq - cfg.num_patches) or \
                bool(cfg.num_experts) != bool(moe_full["calls"]):
            failed.append(arch)
    if failed:
        raise AssertionError(f"slice 7 decode ({failed}): {res}")
    return res


def check_encdec_path() -> dict:
    """13(d): whisper-medium at full width and depth (24 + 24 layers), 1500
    encoder frames, decoder seq 448, trained on the sim backend (no port
    kernel: the encdec route never takes them); then ENCDEC_DECODE decoder
    tokens through ``init_dec_caches`` against the full decode pass on the
    trained parameters, within DECODE_TOL as 12(c)."""
    import torch
    from repro_torch.api import Hook
    from repro_torch.configs import get_config
    from repro_torch.models import (encdec_decode, encdec_encode,
                                    init_dec_caches)

    kept = {}

    class KeepParams(Hook):
        def on_run_end(self, session, result):
            kept["params"] = session.params

    mp = main_path("whisper", steps=SLICE7_STEPS["whisper"],
                   hooks=[KeepParams()])
    log_path(mp)
    arch, layers, _, _, _ = SLICE7_PATHS["whisper"]
    cfg = get_config(arch, num_layers=layers)
    params, dev = kept.pop("params"), torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    frames = 0.02 * torch.randn((1, cfg.encoder_seq, cfg.d_model),
                                generator=g, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (1, ENCDEC_DECODE), generator=g,
                         device=dev)
    reset_all_launches()
    with torch.no_grad():
        enc = encdec_encode(params, cfg, frames)
        full, _ = encdec_decode(params, cfg, toks, enc)
        caches, dec = init_dec_caches(cfg, 1, ENCDEC_DECODE, device=dev), []
        t0 = time.perf_counter()
        for i in range(ENCDEC_DECODE):
            lg, caches = encdec_decode(
                params, cfg, toks[:, i:i + 1], enc, caches=caches,
                positions=torch.full((1, 1), i, device=dev))
            dec.append(lg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launched = {k: v for k, v in all_launches().items() if v}
    mp["decode"] = r = {"decode_vs_full_pass": excess(torch.cat(dec, 1),
                                                      full),
                        "max_abs_logit": full.abs().max().item(),
                        "decode_seconds": seconds, "launches": launched}
    log(f"  decode {ENCDEC_DECODE} tokens against the full decode pass: "
        f"max |logit| {r['max_abs_logit']:.1f}, excess "
        f"{r['decode_vs_full_pass']['excess']:.3g} at atol "
        f"{r['decode_vs_full_pass']['atol']:.3g} (max |a - b| "
        f"{r['decode_vs_full_pass']['max_abs_err']:.3g}); {seconds:.2f} s")
    del params, enc, full, caches, dec, lg
    torch.cuda.empty_cache()
    if launched or r["decode_vs_full_pass"]["excess"] > 0:
        raise AssertionError(f"encdec decode: {r}")
    return mp


def check_slice7() -> dict:
    """Phase 13: (a) the vlm main path, (b) MLA + MoE training, (c) the six
    configs' decode against the kernel path, (d) encdec."""
    res, seconds = {}, {}
    for part, label, check in (
            ("vlm", "(a) phi-3-vision-4.2b widths, 2 layers, seq 1024 (576 "
             "patches + 448 text), flash kernels at head_dim 96",
             check_vlm_path),
            ("moe", "(b) deepseek-v2-236b widths, 1 layer (MLA, 32 of 160 "
             "routed experts, top-6, 2 shared), seq 1024", check_moe_path),
            ("decode", "(c) six configs at full width: decode against the "
             "kernel path", check_slice7_decode),
            ("encdec", "(d) whisper-medium, 24 + 24 layers, 1500 frames, "
             "decoder seq 448", check_encdec_path)):
        log(f"  {label}")
        t0 = time.perf_counter()
        res[part] = check()
        seconds[part] = time.perf_counter() - t0
    res["seconds"] = seconds
    log("  phase 13 seconds: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in seconds.items()))
    return res


# ------------------------------------------------------- phase 14, slice 8

# (a) the CLI on the card: mamba2-1.3b at full config (48 layers, fp32,
# Adam, the plain SSD scan as the reference's CLI runs it), then reduced
# gemma on the measured backend
CLI_FULL = ["--arch", "mamba2-1.3b", "--full-config", "--workers", "3",
            "--steps", "4", "--seq-len", "256", "--b0", "12",
            "--microbatch", "4", "--quiet"]
CLI_MESH = ["--arch", "gemma-2b", "--backend", "mesh", "--steps", "3",
            "--quiet"]
# (b) the step programs at the dry run's overrides, run for real
DRYRUN = dict(param_dtype="bfloat16", dtype="bfloat16", remat=True,
              use_pallas=True)
GEMMA_STEPS = ("gemma-2b", 4, 1024, 3)     # arch, B, S, steps a setting
LLAMA_STEPS = ("llama3-8b", 2, 2048, 3)
LLAMA_LR = 1e-4        # adafactor's step is lr x an update of RMS <= 1
SERVE_TOKENS = 128
SERVE_TOL = 5e-2       # of max |logit|: two bf16 computations, 32 layers
# (c) phase 6's hybrid path with remat: each forward kernel launches twice
# a layer (forward and recompute), the backward ones once
SLICE8_PATHS = {
    "hybrid_remat": ("recurrentgemma-9b", 3, 2048,
                     {"rglru_fwd": (("rglru_fwd_kernel",), 4),
                      "rglru_bwd": (("rglru_bwd_kernel",), 2),
                      "flash_fwd": (FLASH["flash_fwd"], 2),
                      "flash_bwd_dq": (FLASH["flash_bwd_dq"], 1),
                      "flash_bwd_dkv": (FLASH["flash_bwd_dkv"], 1)},
                     {"remat": True}),
}


def check_cli() -> dict:
    """14(a): the port's CLI in process on the card."""
    import torch
    from repro_torch.launch import train

    res = {}
    for label, argv, b0 in (("mamba2_full", CLI_FULL, 12),
                            ("gemma_mesh", CLI_MESH, 16)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train.main(argv)
        seconds = time.perf_counter() - t0
        hist = out["history"]
        r = res[label] = {
            "argv": argv, "losses": [h.loss for h in hist],
            "batches": [h.batches for h in hist],
            "sim_time": [h.sim_time for h in hist],
            "wall_ms_a_step": out["wall_time"] / len(hist) * 1e3,
            "seconds": seconds,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
        log(f"  (a) {' '.join(argv)}: losses "
            f"{[round(x, 4) for x in r['losses']]}, batches {r['batches']}, "
            f"sim_time {[round(x, 4) for x in r['sim_time']]}; "
            f"{r['wall_ms_a_step']:.1f} ms a step, {seconds:.1f} s in all, "
            f"peak {r['max_memory_allocated'] / 2**30:.2f} GiB")
        del out, hist
        torch.cuda.empty_cache()
        workers = 3
        if not (len(r["losses"]) == int(argv[argv.index("--steps") + 1])
                and all(math.isfinite(x) for x in r["losses"])
                and all(sum(b) == workers * b0 for b in r["batches"])
                and all(b > a for a, b in zip(r["sim_time"],
                                              r["sim_time"][1:]))):
            raise AssertionError(f"CLI run {label}: {r}")
    try:
        train.main(CLI_MESH + ["--serve", "--serve-mode", "dedicated"])
    except ValueError as exc:
        res["dedicated_raises"] = str(exc)
        if not str(exc).startswith("reserving 1 of 1 data-axis devices"):
            raise
    else:
        raise AssertionError("--serve-mode dedicated ran on one card")
    log(f"  (a) --serve --serve-mode dedicated raises: "
        f"{res['dedicated_raises']}")
    return res


def step_batch(cfg, b: int, s: int, seed: int) -> dict:
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                    device=dev),
            "targets": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                     device=dev),
            "weights": torch.ones(b, device=dev)}


def run_steps(cfg, params, opt, batch, n: int, accum: int = 1,
              profile_step=None) -> dict:
    """``n`` train steps of ``make_train_step`` on the same batch, each
    timed by CUDA events, launch counts set to 0 just before and read just
    after; step ``profile_step`` runs under torch.profiler too.  Returns
    the last params beside the record."""
    import torch
    from repro_torch.launch.steps import make_train_step

    step_fn = make_train_step(cfg, opt, accum)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    losses, ms, prof = [], [], None
    for i in range(n):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        if i == profile_step:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            t0 = time.perf_counter()
        a.record()
        params, state, m = step_fn(params, state, i, batch)
        e.record()
        torch.cuda.synchronize()
        if i == profile_step:
            wall = (time.perf_counter() - t0) * 1e6
            prof.__exit__(None, None, None)
            casts = cast_summary(prof)
            prof = profile_summary(prof, wall, {**FLASH, **FLASH16})
            prof["casts"] = casts
        ms.append(a.elapsed_time(e))
        losses.append(m["loss"].item())
    res = {"losses": losses, "step_ms": ms, "launches": all_launches(),
           "launches_16": launches_16(),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "profile": prof}
    del state
    return params, res


def check_step_programs(report: dict) -> dict:
    """14(b): the step programs at the dry run's overrides (bf16 parameters
    and activations, remat, the kernels), run for real on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    from repro_torch.launch.steps import (make_prefill_step,
                                          make_serve_step, pick_optimizer)
    from repro_torch.models import init_caches, init_lm, param_count
    from repro_torch.models.convert import reference_leaves
    from repro_torch.optim import get_optimizer
    from repro_torch.serve.engine import cache_length

    dev = torch.device("cuda")
    res = {}
    # gemma-2b at full depth: remat off, full, dots, then accumulation
    arch, b, s, n = GEMMA_STEPS
    cfg = get_config(arch).with_(**DRYRUN)

    def fresh():
        """The same parameters for every setting; the call to run_steps
        holds the only reference, so the first step frees them."""
        return init_lm(torch.Generator(device=dev).manual_seed(0), cfg)

    n_params = param_count(cfg)
    batch = step_batch(cfg, b, s, 1)
    runs = {}
    for label, over, accum in (("no_remat", dict(remat=False), 1),
                               ("full", dict(remat_policy="full"), 1),
                               ("dots", dict(remat_policy="dots"), 1),
                               ("full_accum4", dict(remat_policy="full"), 4)):
        torch.cuda.empty_cache()
        c = cfg.with_(**over)
        r = run_steps(c, fresh(), pick_optimizer(c, n_params), batch, n,
                      accum)[1]
        micro = n * accum
        layers = cfg.num_layers
        r["expected_launches"] = {
            "flash_fwd": (2 if c.remat else 1) * layers * micro,
            "flash_bwd_dq": layers * micro, "flash_bwd_dkv": layers * micro}
        r["expected_launches_16"] = {
            **{f"{k}_16": v for k, v in r["expected_launches"].items()},
            "flash_delta_16": layers * micro}
        runs[label] = r
        log(f"  (b) {arch} {layers} layers bf16, B {b} x S {s}, {label}: "
            f"losses {[round(x, 5) for x in r['losses']]}, step ms "
            f"{[round(x, 1) for x in r['step_ms']]}, launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }, peak "
            f"{r['max_memory_allocated'] / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    step0 = [runs[k]["losses"][0] for k in ("no_remat", "full", "dots")]
    res["gemma"] = {"params": n_params, "optimizer": "adam", "runs": runs,
                    "step0_losses": step0,
                    "step0_bit_equal": len(set(step0)) == 1}
    log(f"  (b) step 0's loss off / full / dots: {step0} (bit-equal "
        f"{res['gemma']['step0_bit_equal']})")
    bad = [k for k, r in runs.items()
           if {k2: v for k2, v in r["launches"].items() if v}
           != r["expected_launches"]
           or {k2: v for k2, v in r["launches_16"].items() if v}
           != r["expected_launches_16"]
           or not all(math.isfinite(x) for x in r["losses"])]
    if bad or max(step0) - min(step0) > 1e-6 * abs(step0[0]):
        raise AssertionError(f"gemma step programs ({bad}): {res['gemma']}")

    # llama3-8b at full depth, remat full, adafactor
    arch, b, s, n = LLAMA_STEPS
    cfg = get_config(arch).with_(**DRYRUN, remat_policy="full")
    t0 = time.perf_counter()
    init = [init_lm(torch.Generator(device=dev).manual_seed(0), cfg)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in init[0].values())
    opt = get_optimizer("adafactor", LLAMA_LR,
                        leaves=reference_leaves(init[0], cfg))
    batch = step_batch(cfg, b, s, 2)
    torch.cuda.empty_cache()
    # run_steps holds the only reference to the initial parameters
    params, r = run_steps(cfg, init.pop(), opt, batch, n + 1,
                          profile_step=n)
    tokens = b * s
    active = roofline.active_params(arch, n_params)
    steady = r["step_ms"][1:n]
    step_s = sorted(steady)[len(steady) // 2] / 1e3
    r.update(params=n_params, active_params=active, init_s=init_s,
             useful_tflops=6 * active * tokens / step_s / 1e12,
             bf16_peak_tflops=roofline.PEAK_FLOPS / 1e12,
             expected_launches={"flash_fwd": 2 * cfg.num_layers * (n + 1),
                                "flash_bwd_dq": cfg.num_layers * (n + 1),
                                "flash_bwd_dkv": cfg.num_layers * (n + 1)})
    r["expected_launches_16"] = {
        **{f"{k}_16": v for k, v in r["expected_launches"].items()},
        "flash_delta_16": cfg.num_layers * (n + 1)}
    pr = r["profile"]
    if pr and pr["device_busy_us"]:
        r["flash_share"] = sum(pr["kernels_us"].values()) \
            / pr["device_busy_us"]
        r["cast_share"] = pr["casts"]["casts_us"] / pr["device_busy_us"]
        # the 16-bit forward's device ms in the profiled step (2 launches a
        # layer under remat)
        r["flash_fwd_16_ms"] = pr["kernels_us"]["flash_fwd_16"] / 1e3
    res["llama"] = r
    log(f"  (b) {arch} {cfg.num_layers} layers bf16 ({n_params / 1e9:.2f}B),"
        f" B {b} x S {s}, remat full, adafactor: losses "
        f"{[round(x, 5) for x in r['losses']]}, step ms "
        f"{[round(x, 1) for x in r['step_ms']]} (the last profiled), "
        f"useful {r['useful_tflops']:.1f} TFLOP/s of "
        f"{r['bf16_peak_tflops']:.0f} bf16, launches "
        f"{ {k: v for k, v in r['launches'].items() if v} }, peak "
        f"{r['max_memory_allocated'] / 2**30:.2f} GiB, flash share of busy "
        f"time {r.get('flash_share', float('nan')):.3f} (the forward "
        f"{r.get('flash_fwd_16_ms', float('nan')):.2f} ms a step), casts "
        f"{r.get('cast_share', float('nan')):.3f}")
    if pr:
        log(f"  (b) 16-bit launches {r['launches_16']}; casts in the profiled "
            f"step: {pr['casts']['casts']} ({pr['casts']['casts_us'] / 1e3:.1f}"
            f" ms), {pr['casts']['flash_casts']} of them inside the "
            f"{pr['casts']['flash_ranges']} flash attention ranges")
    log_profile(pr)
    if not (all(math.isfinite(x) for x in r["losses"])
            and r["losses"][2] < r["losses"][0]
            and {k: v for k, v in r["launches"].items() if v}
            == r["expected_launches"]
            and {k: v for k, v in r["launches_16"].items() if v}
            == r["expected_launches_16"]
            and pr is not None and pr["casts"]["flash_ranges"]
            and not pr["casts"]["flash_casts"]):
        raise AssertionError(f"llama3-8b steps: {r}")

    # llama3-8b serving on the trained parameters: 128 tokens through the
    # caches against the prefill step over all of them (the kernels)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    toks = batch["tokens"][:, :SERVE_TOKENS]
    reset_all_launches()
    prefill = make_prefill_step(cfg)(params, {"tokens": toks})
    prefill_launches = {k: v for k, v in all_launches().items() if v}
    serve = make_serve_step(cfg)
    caches = init_caches(cfg, b, cache_length(cfg, SERVE_TOKENS),
                         device=dev)
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SERVE_TOKENS):
        logits, caches = serve(params, {
            "token": toks[:, i:i + 1], "caches": caches,
            "position": torch.tensor(i, dtype=torch.int32, device=dev)})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    err = (logits.float() - prefill.float()).abs().max().item()
    scale = prefill.float().abs().max().item()
    res["llama_serve"] = sv = {
        "tokens": SERVE_TOKENS, "max_abs_err": err, "max_abs_logit": scale,
        "tol": SERVE_TOL, "argmax_equal": bool(torch.equal(
            logits.argmax(-1), prefill.argmax(-1))),
        "ms_a_token": seconds / SERVE_TOKENS * 1e3,
        "prefill_launches": prefill_launches,
        "serve_launches": {k: v for k, v in all_launches().items() if v},
        "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"  (b) {arch} serve step x {SERVE_TOKENS} against the prefill step:"
        f" max |a - b| {err:.4g} of max |logit| {scale:.4g} (tol "
        f"{SERVE_TOL} x max), argmax equal {sv['argmax_equal']}; "
        f"{sv['ms_a_token']:.1f} ms a token; prefill launches "
        f"{prefill_launches}, serve launches {sv['serve_launches']}; peak "
        f"{sv['max_memory_allocated'] / 2**30:.2f} GiB")
    del params, caches, logits, prefill, batch, toks, opt
    torch.cuda.empty_cache()
    if err > SERVE_TOL * scale or sv["serve_launches"] or \
            prefill_launches != {"flash_fwd": cfg.num_layers}:
        raise AssertionError(f"llama3-8b serving: {sv}")
    return res


def check_hybrid_remat(report: dict) -> dict:
    """14(c): phase 6's hybrid path for one step with remat: the loss of
    phase 6's step 0, each forward kernel launched twice a layer."""
    mp = main_path("hybrid_remat", steps=1, profile=False)
    log_path(mp)
    ref = report["paths"]["recurrentgemma"]
    mp["phase6_step0_loss"] = ref["losses"][0]
    mp["loss_bit_equal"] = mp["losses"][0] == ref["losses"][0]
    mp["phase6_max_memory_allocated"] = ref["max_memory_allocated"]
    log(f"  (c) loss {mp['losses'][0]!r} against phase 6's step 0 "
        f"{ref['losses'][0]!r} (bit-equal {mp['loss_bit_equal']}); peak "
        f"{mp['max_memory_allocated'] / 2**30:.2f} GiB against phase 6's "
        f"{ref['max_memory_allocated'] / 2**30:.2f}")
    if abs(mp["losses"][0] - ref["losses"][0]) > 1e-6 * abs(ref["losses"][0]):
        raise AssertionError(f"hybrid remat loss {mp['losses'][0]} != "
                             f"phase 6's {ref['losses'][0]}")
    return mp


def check_slice8(report: dict) -> dict:
    """Phase 14: (a) the CLI, (b) the step programs in bf16 with remat,
    (c) the hybrid path with remat."""
    res, seconds = {}, {}
    for part, label, check in (
            ("cli", "(a) the CLI: mamba2-1.3b full config, reduced gemma on "
             "the measured backend", lambda: check_cli()),
            ("steps", "(b) step programs, bf16 + remat + kernels: gemma-2b "
             "and llama3-8b at full depth", lambda: check_step_programs(
                 report)),
            ("hybrid", "(c) recurrentgemma-9b-3L with remat",
             lambda: check_hybrid_remat(report))):
        log(f"  {label}")
        t0 = time.perf_counter()
        res[part] = check()
        seconds[part] = time.perf_counter() - t0
    res["seconds"] = seconds
    log("  phase 14 seconds: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in seconds.items()))
    return res


# ------------------------------------------------------ phase 15, slice 5b

# the concurrent round's data axis on a one-card machine: the card and the
# host CPU, two disjoint devices computing at once
CONC_AXIS = ["cuda:0", "cpu"]
CONC_MNIST_STEPS = 20                    # (a)
CONC_TAIL = 5                            # (a): rounds "ends with" reads
# (b): seq cut from phase 4's 1024 so the CPU worker's calls fit the
# phase's time; microbatch 1 so its one-row bucket carries no padded row
CONC_GEMMA = dict(layers=2, seq=512, b0=2, microbatch=1, steps=3)
CONC_SERVE_STEPS = 4                     # (c)
CONC_MATCH_STEPS = 4                     # (d)


def round_log(trainer, stamps: list):
    """A session hook keeping, after each BSP step, the batches that step
    ran (read as it starts) and ``last_round_stamps``."""
    from repro_torch.api import Hook

    ran = []
    bsp_step = trainer.bsp_step

    def recorded_step():
        ran.append(list(trainer.batches))
        return bsp_step()

    trainer.bsp_step = recorded_step

    class Stamps(Hook):
        def on_step(self, session, rec):
            stamps.append(session.trainer.last_round_stamps)

    return ran, Stamps()


def conc_rows(out, trainer, ran, stamps, wall_ms) -> list:
    """One row a concurrent round: wall ms beside the max and the sum of
    the worker ms, the split it ran and its buckets, and whether every
    call was in flight at once (max dispatch < min completion)."""
    rows = []
    for r, b, st, ms in zip(out["history"], ran, stamps, wall_ms):
        wk = [x * 1e3 for x in r.worker_times]
        rows.append({
            "step": r.step, "wall_ms": ms, "worker_ms": wk,
            "max_ms": max(wk), "sum_ms": sum(wk), "ran": b,
            "buckets": [trainer.bucket_for(k, x) for k, x in enumerate(b)],
            "per_example_ms": [w / x for w, x in zip(wk, b)],
            "all_in_flight": st is not None and max(d for d, _ in st)
            < min(c for _, c in st),
            "iteration_is_max": r.iteration_time == max(r.worker_times),
            "loss": r.loss, "batches_after": r.batches})
    return rows


def log_conc_rows(part: str, rows: list) -> None:
    for row in rows:
        log(f"  ({part}) step {row['step']}: wall {row['wall_ms']:.1f} ms, "
            f"worker ms " + ", ".join(f"{x:.1f}" for x in row["worker_ms"])
            + f" (max {row['max_ms']:.1f}, sum {row['sum_ms']:.1f}); ran "
            f"{row['ran']} in buckets {row['buckets']}, all in flight "
            f"{row['all_in_flight']}, loss {row['loss']:.4f}")


def check_conc_mnist() -> dict:
    """15(a): mnist-cnn at phase 7's settings on two workers over the card
    and the CPU, concurrent, no dilation."""
    import torch
    from repro_torch.api import ClusterSpec, MeshBackend

    exp = paper_experiment("mnist-cnn", "dynamic", CONC_MNIST_STEPS,
                           cluster=ClusterSpec.hlevel(
                               39, 8, 2, workload="mnist-cnn", seed=0,
                               backend=MeshBackend(device=CONC_AXIS)))
    reset_all_launches()
    clock, stamps = step_clock(), []
    session = exp.session()
    t = session.trainer
    probe = list(t.batches)
    ran, stamp_hook = round_log(t, stamps)
    session.hooks.extend([clock, stamp_hook])
    out = session.run()
    del t.bsp_step
    rows = conc_rows(out, t, ran, stamps, clock.ms)
    log_conc_rows("a", rows)
    # "ends with" over the last rounds: single rounds of these
    # overhead-bound calls jitter by a factor of 2-10 (PERF.md §6)
    last = rows[-CONC_TAIL:]
    per_example = [sum(r["per_example_ms"][k] for r in last) / len(last)
                   for k in range(2)]
    tail_batches = [sum(r["ran"][k] for r in last) / len(last)
                    for k in range(2)]
    final = out["final_batches"]
    replica_equal = all(torch.equal(t._replicas[1][k], v.cpu())
                        for k, v in t.params.items())
    launched = {k: v for k, v in all_launches().items() if v}
    res = {"rows": rows, "probe_plan": probe, "final_batches": final,
           "per_example_ms_tail": per_example,
           "batches_tail": tail_batches,
           "slices": [list(x) for x in t.slice_plan.slices],
           "replica_equal": replica_equal, "launches": launched,
           "torch_threads": torch.get_num_threads(),
           "timing_reruns": t.timing_reruns}
    log(f"  (a) probe plan {probe}, final {final}; over the last "
        f"{CONC_TAIL} rounds per-example ms card {per_example[0]:.4f}, CPU "
        f"{per_example[1]:.4f}, mean batch card {tail_batches[0]:.1f}, CPU "
        f"{tail_batches[1]:.1f}; CPU replica bit-equal {replica_equal}; "
        f"torch threads "
        f"{res['torch_threads']}; reruns {t.timing_reruns}")
    slower = max(range(2), key=lambda k: per_example[k])
    if not (len(rows) == CONC_MNIST_STEPS
            and all(sum(r["batches_after"]) == 64 for r in rows)
            and all(r["all_in_flight"] and r["iteration_is_max"]
                    for r in rows)
            and all(math.isfinite(r["loss"]) for r in rows)
            and tail_batches[slower] < tail_batches[1 - slower]
            and replica_equal and not launched):
        raise AssertionError(f"15(a) concurrent mnist-cnn: {res}")
    return res


def conc_gemma_experiment():
    """Phase 4's gemma path at seq CONC_GEMMA["seq"], two undilated
    workers over the card and the CPU."""
    from repro_torch.api import (ClusterSpec, Experiment, MeshBackend,
                                 TrainConfig, lm_workload)
    from repro_torch.configs import get_config
    from repro_torch.core import ControllerConfig
    from repro_torch.data import DataPipeline
    from repro_torch.optim import adam

    g = CONC_GEMMA
    cfg = get_config("gemma-2b", num_layers=g["layers"])
    return Experiment(
        workload=lm_workload(cfg, DataPipeline(cfg, seq_len=g["seq"],
                                               num_workers=2,
                                               device=CONC_AXIS[0]),
                             aux_weight=0.01, use_kernel=True),
        cluster=ClusterSpec.hlevel(39, 6.0, 2, workload="transformer",
                                   seed=0,
                                   backend=MeshBackend(device=CONC_AXIS)),
        optimizer=adam(1e-3),
        config=TrainConfig(b0=g["b0"], microbatch=g["microbatch"],
                           batching="dynamic", sync="bsp",
                           max_steps=g["steps"],
                           controller=ControllerConfig(kind="p")))


def check_conc_gemma() -> dict:
    """15(b): gemma-2b at full width (2 layers, seq 512) on two workers
    over the card and the CPU; the flash kernels launch for the card
    worker's calls only (the CPU worker takes their plain versions)."""
    import torch

    from repro_torch.train import mesh as mesh_mod

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # every gradient call, probe and reruns included, counted by the
    # device its slice starts on
    calls = {"cuda": 0, "cpu": 0}
    inner = mesh_mod.MeshTrainer._slice_call

    def counted(self, rec, params, shards):
        calls[self.devices[rec.rows[0]].type] += 1
        return inner(self, rec, params, shards)

    clock, stamps = step_clock(), []
    mesh_mod.MeshTrainer._slice_call = counted
    reset_all_launches()          # the probe round launches too
    try:
        session = conc_gemma_experiment().session()
        t = session.trainer
        probe = list(t.batches)
        ran, stamp_hook = round_log(t, stamps)
        session.hooks.extend([clock, stamp_hook])
        out = session.run()
    finally:
        mesh_mod.MeshTrainer._slice_call = inner
    del t.bsp_step
    counts = all_launches()
    layers = CONC_GEMMA["layers"]
    card_calls = t.accum_calls + t.timing_reruns - calls["cpu"]
    want = {k: layers * calls["cuda"] for k in FLASH}
    rows = conc_rows(out, t, ran, stamps, clock.ms)
    log_conc_rows("b", rows)
    res = {"rows": rows, "probe_plan": probe, "calls": calls,
           "card_calls": card_calls, "launches": counts,
           "expected_launches": want,
           "final_batches": out["final_batches"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "cut": "seq 1024 -> 512 (the CPU worker's calls)"}
    log(f"  (b) probe plan {probe}; gradient calls (reruns included) card "
        f"{calls['cuda']}, CPU {calls['cpu']}; launches "
        f"{ {k: v for k, v in counts.items() if v} } (want {want}); peak "
        f"{res['peak_gib']:.2f} GiB; seq cut 1024 -> 512")
    del session, out, t
    torch.cuda.empty_cache()
    if not (len(rows) == CONC_GEMMA["steps"]
            and all(sum(r["batches_after"]) == 2 * CONC_GEMMA["b0"]
                    for r in rows)
            and all(math.isfinite(r["loss"]) and r["iteration_is_max"]
                    and r["all_in_flight"] for r in rows)
            and calls["cuda"] == card_calls > 0 and calls["cpu"] > 0
            and {k: counts.get(k, 0) for k in want} == want
            and not any(v for k, v in counts.items() if k not in want)):
        raise AssertionError(f"15(b) concurrent gemma: {res}")
    return res


def check_conc_dedicated() -> dict:
    """15(c): phase 11(a)'s gemma path with a dedicated serve slice over
    the card and the CPU: the CPU is the serve slice, the three workers
    take the card one after another (fewer training devices than
    workers), and the decode loop's seconds are charged to no one."""
    import torch
    from repro_torch.api import MeshBackend
    from repro_torch.serve import ServeSpec

    exp = mesh_experiment(CONC_SERVE_STEPS)
    exp.cluster.backend = MeshBackend(dilation="from-spec",
                                      device=CONC_AXIS)
    exp.cluster.serve = ServeSpec(**dict(COLO_SERVE, mode="dedicated",
                                         devices=1))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    clock = step_clock()
    session = exp.session(hooks=[clock])
    t = session.trainer
    out = session.run()
    t.traffic.rate = 0.0
    t.batcher.run_until_idle()
    counts = all_launches()
    want = {k: 2 * (t.accum_calls + t.timing_reruns) for k in FLASH}
    serve = t.serve_stats()
    engine_devices = {str(x.device) for x in t.batcher.params.values()} | {
        str(x.device) for x in t.batcher.caches.values()}
    trainer_devices = {str(x.device) for x in t.params.values()}
    rows = [{"step": r.step, "wall_ms": ms, "batches": r.batches,
             "worker_ms": [x * 1e3 for x in r.worker_times],
             "decode_ms": c * 1e3}
            for r, ms, c in zip(out["history"], clock.ms, t.round_charges)]
    for row in rows:
        log(f"  (c) step {row['step']}: wall {row['wall_ms']:.1f} ms, "
            f"worker ms " + ", ".join(f"{x:.1f}" for x in row["worker_ms"])
            + f", decode on the CPU {row['decode_ms']:.1f} ms (uncharged);"
            f" split after {row['batches']}")
    res = {"rows": rows, "concurrent": t.concurrent, "reserve": t.reserve,
           "serve": serve, "engine_devices": sorted(engine_devices),
           "trainer_devices": sorted(trainer_devices), "launches": counts,
           "expected_launches": want,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"  (c) serve slice {serve['serve_slice']}, reserve {t.reserve}, "
        f"concurrent {t.concurrent}; {serve['requests_finished']} of "
        f"{serve['requests_submitted']} requests finished, charged "
        f"{serve['charged_seconds']} s; decode engine on "
        f"{sorted(engine_devices)}, trainer on {sorted(trainer_devices)}; "
        f"peak {res['peak_gib']:.2f} GiB")
    del session, out, t, exp
    torch.cuda.empty_cache()
    if not (len(rows) == CONC_SERVE_STEPS
            and all(sum(r["batches"]) == 12 for r in rows)
            and serve["requests_finished"] == serve["requests_submitted"] > 0
            and serve["charged_seconds"] == 0.0
            and engine_devices == {"cpu"}
            and trainer_devices == {"cuda:0"}
            and {k: counts.get(k, 0) for k in want} == want
            and not any(v for k, v in counts.items() if k not in want)):
        raise AssertionError(f"15(c) dedicated serving: {res}")
    return res


def check_conc_one_card() -> dict:
    """15(d): under FakeClock the one-card list and ``device=None`` run
    mnist-cnn exactly as ``device="cuda:0"`` (cuDNN deterministic)."""
    import torch
    from repro_torch.api import ClusterSpec, MeshBackend
    from repro_torch.train import mesh as mesh_mod

    runs = {}
    saved = (mesh_mod._timed, mesh_mod._time,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        mesh_mod._timed = mesh_mod._host_timed
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        for label, device in (("cuda:0", "cuda:0"), ("[cuda:0]", ["cuda:0"]),
                              ("None", None)):
            mesh_mod._time = FakeClock()
            exp = paper_experiment(
                "mnist-cnn", "dynamic", CONC_MATCH_STEPS,
                cluster=ClusterSpec.hlevel(
                    39, 8, workload="mnist-cnn", seed=0,
                    backend=MeshBackend(dilation="from-spec",
                                        device=device)))
            session = exp.session()
            out = session.run()
            t = session.trainer
            runs[label] = {
                "records": [(r.batches, r.worker_times, r.sim_time, r.loss)
                            for r in out["history"]],
                "exec": t.exec_state_dict(), "reruns": t.timing_reruns,
                "devices": [str(d) for d in t.devices]}
    finally:
        (mesh_mod._timed, mesh_mod._time, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
    want = runs["cuda:0"]
    same = {label: {k: v for k, v in r.items() if k != "devices"}
            == {k: v for k, v in want.items() if k != "devices"}
            for label, r in runs.items()}
    log(f"  (d) trajectories == device='cuda:0': {same}; devices "
        f"{ {k: r['devices'] for k, r in runs.items()} }")
    if not all(same.values()):
        raise AssertionError(f"15(d) one-card lists: {runs}")
    return {"runs": runs, "same": same}


def check_slice5b() -> dict:
    """Phase 15: (a) mnist-cnn and (b) gemma-2b concurrent over the card
    and the CPU, (c) dedicated serving on the CPU, (d) one-card lists."""
    res, seconds = {}, {}
    for part, label, check in (
            ("mnist", "(a) mnist-cnn, concurrent on the card and the CPU",
             check_conc_mnist),
            ("gemma", "(b) gemma-2b (2 layers, seq 512), concurrent on the "
             "card and the CPU", check_conc_gemma),
            ("dedicated", "(c) dedicated serving: decode on the CPU, three "
             "workers on the card", check_conc_dedicated),
            ("one_card", "(d) one-card lists under FakeClock",
             check_conc_one_card)):
        log(f"  {label}")
        t0 = time.perf_counter()
        res[part] = check()
        seconds[part] = time.perf_counter() - t0
    res["seconds"] = seconds
    log("  phase 15 seconds: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in seconds.items()))
    return res


# ------------------------------------------------------ phase 16, slice 11

# (a) the dry run: (arch, shape, --mesh, --optimized, the most FLOPs its
# devices may count together over the same program traced on one rank),
# each in a fresh interpreter on the machine's CPU, started once (b) and (c)
# have left the card and the host; the probe programs (1 and 2 block
# groups) carry the counts.  Every matmul and contraction of these programs
# is split over the mesh but for a few that DTensor keeps whole on 'model'
# (1.00-1.13 counted on torch 2.13 and 2.11); a count of global FLOPs, or
# an op rerun replicated, is many times more
DRYRUN_CASES = (("llama3-8b", "train_4k", "pod", False, 1.2),
                ("llama3-8b", "decode_32k", "pod", True, 1.2),
                ("deepseek-v2-236b", "train_4k", "pod", False, 1.2),
                ("grok-1-314b", "train_4k", "multipod", False, 1.2))
DRYRUN_TIMEOUT = 600
# the same program on one fake rank, for the split check
ONE_RANK = """
import json, sys
from repro_torch.launch import dryrun
arch, shape, mode, opt, out = sys.argv[1:6]
over = {"attn_chunk": 512} if opt == "1" and mode == "train" else None
rec = dryrun.run_one(arch, shape, mesh="1x1", sharding_mode=mode,
                     config_overrides=over, verbose=False)
with open(out, "w") as f:
    json.dump([rec], f)
"""
# (b) sharded decode: (arch, config overrides), B rows, tokens
SHARDED_DECODE = (("gemma-2b", {}),
                  ("deepseek-v2-236b", dict(num_layers=1, num_experts=32)))
SHARDED_DECODE_B, SHARDED_DECODE_T = 4, 64


def start_dryruns(out_dir: str) -> list:
    """Phase 16(a), started: ``python -m repro_torch.launch.dryrun`` per
    case, and the same program on one fake rank, with no card visible."""
    from repro_torch.configs.shapes import get_shape

    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    runs = []
    for arch, shape, mesh, optimized, ceiling in DRYRUN_CASES:
        out = os.path.join(out_dir, f"dryrun_{arch}_{shape}_{mesh}.json")
        one = out.replace(".json", "_one_rank.json")
        mode = "decode2d" if optimized and get_shape(shape).kind == "decode" \
            else "train"
        cmds = ([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", mesh, "--out", out]
                + (["--optimized"] if optimized else []),
                [sys.executable, "-c", ONE_RANK, arch, shape, mode,
                 str(int(optimized)), one])
        runs.append(((arch, shape, mesh, optimized, ceiling), (out, one),
                     time.perf_counter(),
                     [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
                      for cmd in cmds]))
    return runs


def finish_dryruns(runs: list) -> dict:
    """Phase 16(a), read: each record's argument bytes ``==`` the count
    from the partition specs; no op rerun replicated; the FLOPs of all
    devices together at least those of the same program on one rank (a
    count of global FLOPs would be the devices' number times more) and at
    most the case's ceiling times them; per-device argument GiB, FLOPs and
    collective GB logged with the roofline's reading."""
    from repro_torch.configs.shapes import get_shape
    from repro_torch.launch import dryrun, roofline

    res = {}
    for (arch, shape, mesh, optimized, ceiling), outs, t0, procs in runs:
        recs = []
        for proc, out in zip(procs, outs):
            text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
            if proc.returncode:
                raise AssertionError(f"dry run {arch} {shape} {mesh} exited "
                                     f"{proc.returncode}: {text[-3000:]}")
            with open(out) as f:
                rec, = json.load(f)
            if rec["status"] != "ok":
                raise AssertionError(f"dry run {arch} {shape}: {rec}")
            recs.append(rec)
        rec, one = recs
        kind = get_shape(shape).kind
        mode = "decode2d" if optimized and kind == "decode" else "train"
        over = {"attn_chunk": 512} if optimized and kind != "decode" \
            else None
        want = dryrun.rules_argument_bytes(
            dryrun.run_config(arch, get_shape(shape), over),
            get_shape(shape), dryrun.MeshShape(rec["mesh"]), True, mode)
        r, p = roofline.analyze(rec), rec["probe"]
        split = p["flops_total"] * rec["devices"] / one["probe"]["flops_total"]
        res[f"{arch}/{shape}/{rec['mesh']}"] = {
            "process_s": time.perf_counter() - t0, "record": rec,
            "roofline": r, "one_rank_flops": one["probe"]["flops_total"],
            "split_ratio": split, "split_ceiling": ceiling}
        coll = ", ".join(f"{k} {v / 1e9:.3f}"
                         for k, v in p["collective_bytes"].items() if v)
        log(f"  (a) {arch} x {shape} x {rec['mesh']} ({mode}): args "
            f"{rec['argument_size_in_bytes'] / 2**30:.3f} GiB/device "
            f"(specs' count {want / 2**30:.3f}), {p['flops_total']:.4g} "
            f"FLOPs/device, x {rec['devices']} devices = {split:.4f} x the "
            f"program on one rank (ceiling {ceiling}), collectives "
            f"{p['collective_bytes_total'] / 1e9:.3f} GB/device ({coll}), "
            f"useful {r['useful_ratio']:.3f} of the counted FLOPs, bound "
            f"{r['dominant']} {r['bound_s']:.4g} s; {p['replicated_ops']} "
            f"ops rerun replicated {p['replicated']}; {rec['wall_s']} s in "
            f"the dry run, {one['wall_s']} s on one rank")
        if rec["argument_size_in_bytes"] != want or p["replicated_ops"] \
                or not 1 - 1e-9 <= split <= ceiling:
            raise AssertionError(
                f"dry run {arch} {shape}: argument bytes "
                f"{rec['argument_size_in_bytes']} (specs {want}), "
                f"replicated {p['replicated']} {p['replicated_why']}, split "
                f"ratio {split} (ceiling {ceiling})")
    return res


def one_rank_mesh():
    """One NCCL rank and a (1, 1) ("data", "model") mesh on the card."""
    from repro_torch import compat
    from repro_torch.launch.mesh import make_mesh

    compat.init_group("nccl", 1, 0)
    return make_mesh((1, 1), ("data", "model"))


def placed(tensors: dict, specs: dict, mesh) -> dict:
    """Whole tensors -> DTensors placed by ``specs`` (on one rank, views
    of the same storage)."""
    from repro_torch import compat

    return {k: compat.place(v, mesh, compat.to_placements(specs[k], mesh))
            for k, v in tensors.items()}


def sharded_decode_case(arch: str, overrides: dict, mesh) -> dict:
    """16(b), one model: the same parameters and tokens decoded one step at
    a time on the plain path and with the caches as DTensors and the
    ``decode_attn`` rule set; the sharded attention counted as reached."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.dryrun import sharded_program
    from repro_torch.models import (apply_lm, init_caches, init_model,
                                    shard_hooks, sharded_attn)

    cfg = get_config(arch, **overrides)
    if cfg.num_experts:     # no token dropped: both paths route alike
        cfg = cfg.with_(moe_capacity_factor=cfg.num_experts / cfg.moe_top_k)
    b, t = SHARDED_DECODE_B, SHARDED_DECODE_T
    g = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(g, cfg)
    toks = torch.randint(0, cfg.vocab_size, (b, t), generator=g,
                         device="cuda")
    name = "mla_decode_attention" if cfg.attention == "mla" \
        else "decode_attention"
    calls = [0]
    inner = getattr(sharded_attn, name)

    def reached(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    def decode(sharded: bool, counted: bool = False):
        caches = init_caches(cfg, b, t, device="cuda")
        counter = sharded_program() if counted \
            else contextlib.nullcontext()
        if sharded:
            caches = placed(caches, SH.cache_shardings(caches, mesh), mesh)
            shard_hooks.set_rules({"decode_attn": (mesh, ("data",),
                                                   "model")})
            setattr(sharded_attn, name, reached)
        out = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        try:
            with torch.no_grad(), counter as counts:
                start.record()
                for i in range(t):
                    lg, caches, _ = apply_lm(
                        params, cfg, toks[:, i:i + 1], caches=caches,
                        positions=torch.full((b, 1), i, device="cuda"))
                    out.append(lg)
                end.record()
            torch.cuda.synchronize()
        finally:
            shard_hooks.set_rules(None)
            setattr(sharded_attn, name, inner)
        return torch.cat(out, 1), start.elapsed_time(end) / t, counts

    torch.cuda.reset_peak_memory_stats()
    want, plain_ms, _ = decode(False)
    # counted once (every op through DeviceCounter), timed without it
    got, counted_ms, counter = decode(True, counted=True)
    again, ms, _ = decode(True)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    res = {"arch": arch, "layers": cfg.num_layers, "tokens": t, "batch": b,
           "calls": calls[0], "all_reduce": counter.collectives[
               "all-reduce_count"], "replicated_ops": counter.replicated_ops,
           "max_abs_err": err, "max_abs_logit": scale,
           "bit_equal": bool(torch.equal(got, want)),
           "repeat_bit_equal": bool(torch.equal(again, got)),
           "plain_ms_per_token": plain_ms, "ms_per_token": ms,
           "counted_ms_per_token": counted_ms,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"  (b) {arch} {cfg.num_layers} layers ({cfg.attention}), B {b}, "
        f"{t} tokens: sharded {name} reached {calls[0]} times, "
        f"{res['all_reduce']} logits all-reduces, max abs err {err:.3g} of "
        f"max |logit| {scale:.3g} (bit-equal {res['bit_equal']}); ms a token"
        f" sharded {ms:.2f} ({counted_ms:.2f} counting every op), plain "
        f"{plain_ms:.2f}; peak "
        f"{res['max_memory_allocated'] / 2**30:.2f} GiB")
    n = cfg.num_layers * t
    if not (calls[0] == 2 * n and res["all_reduce"] == n
            and res["repeat_bit_equal"]
            and res["replicated_ops"] == 0
            and err <= 1e-5 * scale and torch.isfinite(got).all()):
        raise AssertionError(f"sharded decode {arch}: {res}")
    del params, got, want, again
    torch.cuda.empty_cache()
    return res


def sharded_step(cfg, batch, mesh=None, steps: int = 2) -> dict:
    """16(c): ``steps`` train steps of ``make_train_step`` from the seed-0
    parameters, on the plain path or (``mesh``) with parameters, state and
    batch as DTensors placed by the partition rules and the hooks' rules
    set; each step timed by CUDA events (the first sharded one pays
    DTensor's sharding propagation on the host).  Returns the losses, the
    parameters after step 0 (plain tensors) and the timings."""
    import torch
    from repro_torch import compat
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.dryrun import sharded_program
    from repro_torch.launch.steps import make_train_step, pick_optimizer
    from repro_torch.models import init_model, shard_hooks

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    opt = pick_optimizer(cfg)
    program = contextlib.nullcontext()
    if mesh is not None:
        program = sharded_program()
        params = placed(params, SH.params_shardings(params, mesh, cfg=cfg),
                        mesh)
        batch = placed(batch, SH.batch_shardings(batch, mesh), mesh)
        shard_hooks.set_rules({
            "logits": (mesh, compat.to_placements(("data", None, "model"),
                                                  mesh)),
            "activations": (mesh, compat.to_placements(
                ("data", None, None), mesh)),
            "attention": (mesh, ("data",), "model")})

    def whole(v):
        return v.full_tensor() if isinstance(v, compat.DTensor) else v

    state = opt.init(params)    # placed as the parameters
    step = make_train_step(cfg, opt)
    losses, ms = [], []
    try:
        with program as counter:
            for i in range(steps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                params, state, m = step(params, state, i, batch)
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
                losses.append(whole(m["loss"]).item())
                if i == 0:
                    after0 = {k: whole(v).clone() for k, v in params.items()}
    finally:
        shard_hooks.set_rules(None)
    del state, params
    return {"losses": losses, "params": after0, "step_ms": ms,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "replicated_ops": getattr(counter, "replicated_ops", None),
            "replicated": getattr(counter, "replicated", None),
            "replicated_why": getattr(counter, "replicated_why", None),
            "collectives": getattr(counter, "collectives", None)}


def check_sharded_step(mesh, report: dict) -> dict:
    """16(c): gemma-2b, 18 layers, bf16, remat "full", B 4 x S 1024, the
    plain attention: the sharded step against the same step unsharded; the
    flash kernels refuse a DTensor."""
    import torch
    from repro_torch import compat
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import attention

    arch, b, s, _ = GEMMA_STEPS
    cfg = get_config(arch).with_(**{**DRYRUN, "use_pallas": False},
                                 remat_policy="full")
    batch = step_batch(cfg, b, s, 1)
    plain = sharded_step(cfg, batch)
    want = plain.pop("params")
    got = sharded_step(cfg, batch, mesh)
    have = got.pop("params")
    worst, equal, n = 0.0, 0, len(want)
    for k, w in want.items():
        d = (have[k].float() - w.float()).abs()
        worst = max(worst, (d / w.float().abs().clamp_min(1e-30)).max()
                    .item() if d.max() > 0 else 0.0)
        equal += int(torch.equal(have[k], w))
    del want, have
    torch.cuda.empty_cache()
    q = compat.DTensor.from_local(
        torch.zeros(1, 128, 2, 64, device="cuda"), mesh,
        [compat.Replicate()] * 2, run_check=False)
    try:
        attention(q, q, q)
        refused = False
    except TypeError:
        refused = True
    phase14 = report.get("slice8", {}).get("steps", {}).get(
        "gemma", {}).get("runs", {}).get("full", {})
    res = {"losses": got["losses"], "plain_losses": plain["losses"],
           "loss_bit_equal": got["losses"][0] == plain["losses"][0],
           "tensors": n, "tensors_bit_equal": equal, "max_rel_err": worst,
           "step_ms": got["step_ms"], "plain_step_ms": plain["step_ms"],
           "max_memory_allocated": got["max_memory_allocated"],
           "plain_max_memory_allocated": plain["max_memory_allocated"],
           "replicated_ops": got["replicated_ops"],
           "replicated": got["replicated"],
           "replicated_why": got["replicated_why"],
           "collectives": got["collectives"],
           "flash_refuses_dtensor": refused,
           "phase14_full_step_ms": phase14.get("step_ms"),
           "phase14_full_peak": phase14.get("max_memory_allocated")}
    log(f"  (c) {arch} {cfg.num_layers} layers bf16, remat full, B {b} x S "
        f"{s}, plain attention: losses sharded {got['losses']!r}, "
        f"unsharded {plain['losses']!r} (step 0 bit-equal "
        f"{res['loss_bit_equal']}); parameters after step 0 bit-equal "
        f"{equal} of {n}, max rel err {worst:.3g}; step ms sharded "
        f"{[round(x, 1) for x in got['step_ms']]}, unsharded "
        f"{[round(x, 1) for x in plain['step_ms']]} (phase 14(b), flash "
        f"kernels: "
        f"{res['phase14_full_step_ms']}); peak sharded "
        f"{got['max_memory_allocated'] / 2**30:.2f} GiB, unsharded "
        f"{plain['max_memory_allocated'] / 2**30:.2f} GiB (14(b) "
        f"{res['phase14_full_peak']} B); "
        f"{got['replicated_ops']} ops rerun replicated "
        f"{got['replicated']}; the flash kernels refuse "
        f"a DTensor: {refused}")
    l0, p0 = got["losses"][0], plain["losses"][0]
    if not (refused and got["replicated_ops"] == 0
            and all(math.isfinite(x) for x in got["losses"])
            and abs(l0 - p0) <= 1e-5 * abs(p0) and worst <= 1e-5):
        raise AssertionError(f"sharded step: {res}")
    return res


def check_slice11(report: dict, out_dir: str) -> dict:
    """Phase 16: over one NCCL rank, (b) the sharded decode and (c) the
    sharded train step, timed with the host to themselves (they are
    host-bound); the group is destroyed after each.  Then (a) the dry run
    on the CPU."""
    from repro_torch import compat

    res, seconds = {}, {}
    t0 = time.perf_counter()
    t = time.perf_counter()
    mesh = one_rank_mesh()
    try:
        res["decode"] = {arch: sharded_decode_case(arch, over, mesh)
                         for arch, over in SHARDED_DECODE}
    finally:
        compat.destroy_group()
    seconds["decode"] = time.perf_counter() - t
    t = time.perf_counter()
    mesh = one_rank_mesh()
    try:
        res["step"] = check_sharded_step(mesh, report)
    finally:
        compat.destroy_group()
    seconds["step"] = time.perf_counter() - t
    t = time.perf_counter()
    runs = start_dryruns(out_dir)
    try:
        res["dryrun"] = finish_dryruns(runs)
    finally:
        for *_, procs in runs:      # stopped, whatever failed
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    seconds["dryrun"] = time.perf_counter() - t
    seconds["total"] = time.perf_counter() - t0
    res["seconds"] = seconds
    log("  phase 16 seconds: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in seconds.items()))
    return res


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
    peak_name, peak = peaks(kind)
    peak_flops, peak_bw, peak_tf32, _ = peak
    log(f"[1] gpu: {smi}; torch {torch.__version__}, cuda {torch.version.cuda}"
        f"; peaks ({peak_name}): {peak_flops / 1e12:.0f} TFLOP/s fp32, "
        f"{peak_bw / 1e12:.2f} TB/s")
    t0 = time.perf_counter()
    sources = build.sources()
    build_s = {}

    def timed_build(item):
        name, source = item
        t = time.perf_counter()
        lib = build.build(source, name)
        build_s[name] = time.perf_counter() - t
        return lib

    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(timed_build, sources.items())))
    log("    built " + ", ".join(
        f"{os.path.relpath(lib, ROOT)} ({build_s[name]:.1f} s)"
        for name, lib in libs.items())
        + f" in {time.perf_counter() - t0:.1f} s (in parallel)")
    report = {"gpu": smi, "build_log": dict(build.BUILD_LOG),
              "build_s": build_s, "cases": {}, "ssd_cases": {},
              "rglru_cases": {}}

    # 2. kernels against plain versions, then timings
    log("[2] kernels vs plain versions "
        f"(fwd allclose {FWD_TOL}; bwd max err <= {BWD_TOL} x max|ref|)")
    errs = check_kernels(report)
    report["fp64"] = check_fp64()
    log("  vs float64 (kernel / plain max abs err, kernel == plain): " + ", ".join(
        f"{n} {r['kernel_err']:.3g} / {r['plain_err']:.3g} "
        f"{r['kernel_equals_plain']}" for n, r in report["fp64"].items()))
    times = time_kernels(peak, report)
    report["hybrid_times"] = time_kernels(peak, report, FLASH_TIMED[1])
    report["slice7_times"] = {shape[0]: time_kernels(peak, report, shape)
                              for shape in FLASH_TIMED[2:]}
    torch.cuda.empty_cache()
    log(f"  library vs kernel max abs err: {report['library_vs_kernel']}")
    log(f"  16-bit flash kernels on bf16 and fp16 inputs vs plain versions "
        f"(max err <= {HALF_TOL} x max|ref|, delta {DELTA_TOL}; a row's "
        f"err <= {K.ROW_ULPS} ulps of its max + {K.ROW_ATOL} x max|ref| "
        f"(row <= 1), lse {K.LSE_TOL} x max; outputs in the inputs' dtype)")
    half_errs = check_flash_half(report)
    report["bf16_times"] = {shape[0]: time_kernels(peak, report, shape,
                                                   dtype="bfloat16")
                            for shape in FLASH_TIMED_16}
    torch.cuda.empty_cache()
    if PROFILE_MISSES:
        log(f"  profiles that recorded none of the kernels asked for (a "
            f"later attempt did): {PROFILE_MISSES}")
    for label, tms in report["bf16_times"].items():
        for name, tm in tms.items():
            lib = ("" if tm["library_ms"] is None else
                   f", SDPA flash backend {tm['library_ms']:.4f} ms "
                   f"(memory-efficient {tm['efficient_ms']:.4f} ms"
                   + (f", SDPA's default {tm['sdpa_default_ms']:.4f} ms"
                      if "sdpa_default_ms" in tm else "") + ")")
            log(f"  {name} on bf16 at the {label} shapes: kernel "
                f"{tm['ms']:.4f} ms (device {tm['device_ms']:.4f} ms), plain "
                f"{tm['plain_ms']:.3f} ms{lib}, bound at the bf16 "
                f"tensor-core rate {tm['bound_ms']:.4f} ms ({tm['bound_by']});"
                f" fp32 bound {tm['fp32_bound_ms']:.4f} ms"
                + (f", 3xTF32 bound {tm['tf32x3_bound_ms']:.4f} ms"
                   if "tf32x3_bound_ms" in tm else ""))
        tm = tms["flash_bwd_dkv_16"]
        log(f"  dq16 + dkv16 on bf16 at the {label} shapes, alternated "
            f"with SDPA's flash backward (device ms): "
            f"{tm['pair_device_ms_alternated']} against "
            f"{tm['library_device_ms_alternated']}")
    shaped = [("hybrid", FLASH_TIMED[1], report["hybrid_times"])] + [
        (shape[0], shape, report["slice7_times"][shape[0]])
        for shape in FLASH_TIMED[2:]]
    for label, shape, tms in shaped:
        for name, tm in tms.items():
            log(f"  {name} at the {label} shapes {shape[1:]}: kernel "
                f"{tm['ms']:.3f} ms, plain {tm['plain_ms']:.3f} ms, library "
                f"{tm['library_ms']:.3f} ms"
                + ("" if tm["library_same_function"] else " (no softcap)")
                + f", bound {tm['bound_ms']:.4f} ms"
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
    log("[13] slice 7: the vlm main path (phi-3-vision, flash kernels at "
        "head_dim 96), MLA + MoE training, decode of six configs at full "
        "width, encdec at full depth")
    report["slice7"] = check_slice7()
    log("[14] slice 8: the CLI on the card, the step programs in bf16 with "
        "remat through the kernels (gemma-2b and llama3-8b at full depth, "
        "llama3-8b serving), the hybrid path with remat")
    report["slice8"] = check_slice8(report)
    log("[15] slice 5b: the measured backend's concurrent round over the "
        "card and the host CPU (mnist-cnn, gemma-2b), dedicated serving on "
        "the CPU, one-card device lists")
    report["slice5b"] = check_slice5b()
    log("[16] slice 11: the dry run of four production programs on the CPU "
        "(fake groups of 256 and 512 ranks); over one NCCL rank, the "
        "sharded decode of gemma-2b (18 layers) and deepseek-v2 (MLA) and "
        "the sharded gemma-2b train step, each against its plain path")
    report["slice11"] = check_slice11(report, args.out)

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
            **({"launches_vlm_path":
                report["slice7"]["vlm"]["launches"][name],
                "shapes": {label: {key: tms[name][key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_same_function")}
                    for label, tms in report["slice7_times"].items()}}
               if name in FLASH else {}),
            **{key: tm[key] for key in ("launch_ms", "per_head_ms",
                                        "per_head_bound_ms") if key in tm},
        })
    # the 16-bit entries: bf16 at the gemma shapes (llama3-8b's beside),
    # launches from phase 14(b)'s llama3-8b steps, errors from phase 2's
    # bf16 and fp16 cases
    replaces_16 = {
        "flash_fwd_16": replaces["flash_fwd"],
        "flash_bwd_dq_16": replaces["flash_bwd_dq"],
        "flash_bwd_dkv_16": replaces["flash_bwd_dkv"],
        # flash_attention_bwd's delta = rowsum(dO . O)
        "flash_delta_16": "src/repro/kernels/flash_attention/kernel.py:610",
    }
    fa_bwd = ("_scaled_dot_product_flash_attention_backward (dq, dk and dv "
              "in one call)")
    library_16 = {"flash_fwd_16": "_scaled_dot_product_flash_attention",
                  "flash_bwd_dq_16": fa_bwd, "flash_bwd_dkv_16": fa_bwd,
                  "flash_delta_16": None}
    rows_of = {"flash_fwd_16": ("out", "lse"), "flash_bwd_dq_16": ("dq",),
               "flash_bwd_dkv_16": ("dk", "dv"), "flash_delta_16": ()}
    llama = report["slice8"]["steps"]["llama"]
    for name in replaces_16:
        tm = report["bf16_times"]["gemma"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(K.SOURCE_16, ROOT),
            "replaces": replaces_16[name],
            "launches": llama["launches_16"][name],
            "max_abs_err": half_errs[name],
            "tol": DELTA_TOL if name == "flash_delta_16" else HALF_TOL,
            # each output's largest row_error (lse: error / LSE_TOL x max),
            # at most 1
            "row_error": {key: half_errs["rows"][key]
                          for key in rows_of[name]},
            "ms": tm["ms"], "kernel_ms": tm["ms"],
            "device_ms": tm["device_ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"], "library_call": library_16[name],
            "efficient_ms": tm.get("efficient_ms"),
            "sdpa_default_ms": tm.get("sdpa_default_ms"), "dtype": "bfloat16",
            "shapes": {label: {key: tms[name].get(key) for key in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "efficient_ms", "sdpa_default_ms")}
                for label, tms in report["bf16_times"].items()},
        })
    report["kernels"] = kernels
    report["profile_misses"] = PROFILE_MISSES
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
