"""Training launcher CLI.

Runs heterogeneous data-parallel training of any assigned architecture
under a simulated heterogeneous cluster, with the paper's batching
policies selectable:

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --batching dynamic --hlevel 6 --steps 50 --b0 16 --seq-len 64

Real SGD on the reduced config; wall-clock from the calibrated simulator
(or measured, with ``--backend mesh``); prints per-step records and a
summary.  ``--full-config`` trains the full-size config.  It runs on the
CUDA card (the mesh backend on every visible card) unless ``--device``
names others: ``--device cpu`` asks for the CPU, and the mesh backend takes
a list, ``--device cuda:0,cpu``.

All run construction goes through ``repro_torch.api`` (DESIGN.md §10): the
CLI parses flags into a declarative Experiment and drives a Session.  The
flags and their checks are the reference's, plus ``--device``.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.api import (
    ClusterSpec,
    Experiment,
    MeshBackend,
    ServeSpec,
    SimBackend,
    TrainConfig,
    lm_workload,
)
from repro_torch.configs import get_config, list_architectures
from repro_torch.core import (ControllerConfig, GLOBAL_BATCH_KINDS,
                              GlobalBatchConfig)
from repro_torch.data import DataPipeline
from repro_torch.het import traces
from repro_torch.models import reduced
from repro_torch.optim import adam, batch_coupled


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b",
                    choices=list_architectures())
    ap.add_argument("--batching", default="dynamic",
                    choices=["uniform", "static", "dynamic"])
    ap.add_argument("--sync", default="bsp", choices=["bsp", "asp"])
    ap.add_argument("--backend", default="sim", choices=["sim", "mesh"],
                    help="execution backend (DESIGN.md §11-§12): 'sim' = "
                         "simulated clock; 'mesh' = measured: the workers "
                         "run on disjoint slices of the devices at once "
                         "(or take them in turn when there are fewer "
                         "devices than workers) over bucket-padded "
                         "batches, the controller fed their measured step "
                         "times (worker heterogeneity emulated from the "
                         "cluster spec); supports --sync asp and --ckpt")
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--total-cores", type=int, default=39)
    ap.add_argument("--hlevel", type=float, default=6.0)
    ap.add_argument("--interference", action="store_true",
                    help="inject a mid-run slowdown on the largest worker")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--b0", type=int, default=16)
    ap.add_argument("--microbatch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--dead-band", type=float, default=0.05)
    ap.add_argument("--controller", default="p",
                    choices=["p", "pi", "pid", "gain"],
                    help="control law: paper P, PI, full PID, or "
                         "gain-scheduled PID (DESIGN.md §3)")
    ap.add_argument("--beyond-paper", action="store_true",
                    help="zero-cost resize controller variant (DESIGN.md §2)")
    ap.add_argument("--global-batch-kind", default="fixed",
                    choices=list(GLOBAL_BATCH_KINDS),
                    help="outer global-batch loop (DESIGN.md §15): 'fixed' = "
                         "paper behaviour (B constant); 'geometric' = "
                         "GeoDamp-style doubling schedule; 'gns' = "
                         "gradient-noise-scale critical-batch tracking "
                         "(bsp only); 'bandit' = epsilon-greedy over the "
                         "rung ladder on loss-per-second reward; 'dynamix' "
                         "= learned contextual Q-policy over GNS + system "
                         "state picking down/hold/up on the same ladder "
                         "(bsp only; DESIGN.md §18)")
    ap.add_argument("--global-batch", type=float, default=8.0,
                    metavar="MAX_FACTOR",
                    help="cap for the outer loop: B may grow to at most "
                         "MAX_FACTOR x the initial global batch")
    ap.add_argument("--lr-couple", default="none",
                    choices=["none", "linear", "sqrt"],
                    help="couple the learning rate to outer global-batch "
                         "resizes: eta <- eta0 * (B/B0) (linear) or "
                         "* sqrt(B/B0) (sqrt); DESIGN.md §15")
    ap.add_argument("--serve", action="store_true",
                    help="co-locate a continuous-batching decode loop on "
                         "the training mesh (DESIGN.md §13): a serve slice "
                         "is carved from the data axis, decode latency "
                         "percentiles land in the summary, and the batch "
                         "controller re-equalizes around the interference; "
                         "requires --backend mesh and --sync bsp")
    ap.add_argument("--serve-mode", default="shared",
                    choices=["shared", "dedicated"],
                    help="shared = time-multiplex the last worker's devices "
                         "(decode seconds charged to its step time); "
                         "dedicated = withhold --serve-devices devices, SLO "
                         "policy grows/shrinks the slice")
    ap.add_argument("--serve-devices", type=int, default=1,
                    help="dedicated serve-slice width (data-axis devices)")
    ap.add_argument("--serve-rate", type=float, default=1.0,
                    help="decode requests arriving per training round")
    ap.add_argument("--serve-slots", type=int, default=2,
                    help="concurrent decode sequences (scheduler slots; "
                         "per shard with --serve-engine disaggregated)")
    ap.add_argument("--serve-engine", default="batcher",
                    choices=["batcher", "disaggregated"],
                    help="batcher = single-device continuous batcher; "
                         "disaggregated = sharded KV slots, one decode "
                         "shard per serve-region device behind a dedicated "
                         "prefill program (DESIGN.md §17)")
    ap.add_argument("--serve-traffic", default="steady",
                    choices=["steady", "poisson", "diurnal"],
                    help="arrival model: steady accumulator, seeded "
                         "Poisson, or the raised-cosine diurnal envelope "
                         "(peaks at 4x --serve-rate) that makes the SLO "
                         "policy oscillate training's device count (§17)")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where to train: the CUDA card (every visible card "
                         "on the mesh backend) unless 'cpu' (or another "
                         "torch device) is given; the mesh backend takes a "
                         "comma-separated list, e.g. 'cuda:0,cpu'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = reduced(cfg)

    devices = args.device.split(",") if args.device else None
    if devices is not None and len(devices) > 1 and args.backend != "mesh":
        ap.error("--device with several devices requires --backend mesh: "
                 "the sim backend trains on one device")
    backend = (MeshBackend(dilation="from-spec", device=devices)
               if args.backend == "mesh" else SimBackend(device=args.device))
    if args.backend == "mesh" and args.interference:
        ap.error("--interference requires the sim backend: availability "
                 "traces are a simulator concept, and MeshTrainer does not "
                 "emulate them (its dilation factors are static)")
    serve = None
    if args.serve:
        if args.backend != "mesh":
            ap.error("--serve requires --backend mesh: co-located serving "
                     "shares the training mesh's devices (DESIGN.md §13)")
        if args.sync != "bsp":
            ap.error("--serve requires --sync bsp: the decode loop is "
                     "multiplexed against BSP round boundaries")
        serve = ServeSpec(mode=args.serve_mode, devices=args.serve_devices,
                          slots=args.serve_slots, arch=args.arch,
                          requests_per_round=args.serve_rate,
                          engine=args.serve_engine,
                          traffic=args.serve_traffic,
                          seed=args.seed)
    cluster = ClusterSpec.hlevel(args.total_cores, args.hlevel, args.workers,
                                 workload="transformer", seed=args.seed,
                                 backend=backend, serve=serve)
    if args.interference:
        cluster.with_trace(-1, traces.step_interference(5.0, 1e9, 0.3))

    if args.global_batch_kind in ("gns", "dynamix") and args.sync != "bsp":
        ap.error(f"--global-batch-kind {args.global_batch_kind} requires "
                 "--sync bsp: the GNS estimator needs per-round per-worker "
                 "gradient moments (DESIGN.md §15, §18)")

    pipe = DataPipeline(cfg, seq_len=args.seq_len, num_workers=args.workers,
                        seed=args.seed,
                        device=devices[0] if devices else None)
    lr = (batch_coupled(1e-3, rule=args.lr_couple)
          if args.lr_couple != "none" else 1e-3)
    experiment = Experiment(
        workload=lm_workload(cfg, pipe, aux_weight=0.01),
        cluster=cluster,
        optimizer=adam(lr),
        config=TrainConfig(
            b0=args.b0, microbatch=args.microbatch, batching=args.batching,
            sync=args.sync, max_steps=args.steps, seed=args.seed,
            controller=ControllerConfig(dead_band=args.dead_band,
                                        kind=args.controller,
                                        beyond_paper=args.beyond_paper),
            global_batch=GlobalBatchConfig(kind=args.global_batch_kind,
                                           max_factor=args.global_batch)),
    )

    session = experiment.session()
    out = session.run()
    if not args.quiet:
        for rec in out["history"][:: max(1, args.steps // 10)]:
            print(f"  step {rec.step:4d} t={rec.sim_time:8.2f}s "
                  f"loss={rec.loss:7.4f} batches={rec.batches} "
                  f"{'<- adjusted' if rec.adjusted else ''}")
        print(json.dumps({k: v for k, v in out.items() if k != "history"},
                         default=str, indent=1))
    if args.ckpt:
        session.save(args.ckpt, extra_meta={"arch": args.arch})
        if not args.quiet:
            print(f"checkpoint -> {args.ckpt}")
    return out


if __name__ == "__main__":
    main()
