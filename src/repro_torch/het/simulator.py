"""Heterogeneous-cluster performance simulator.

The container is CPU-only, so cluster heterogeneity (different CPU/GPU/TPU
worker sizes, interference, preemption) is *modelled*, calibrated to the
paper's observations:

  * iteration time:  t_k(b) = t_sync + w * s(c_k) * b / avail_k(time)
    - w: per-sample compute cost of the workload (seconds at 1 core);
    - s(c) = (1-p) + p/c: Amdahl per-sample speedup with c cores
      (paper §III-C: "throughput on large workers may be lower than what is
      indicated by their core counts");
    - t_sync: fixed per-iteration communication/synchronization overhead
      (paper: LinReg is communication-bound -> large t_sync/w ratio);
    - avail_k(time): dynamic availability trace in (0, 1] (interference,
      overcommitment, preemption).
  * memory cliff (paper Fig. 5): past b_mem the per-sample cost inflates —
    sharply for GPU workers (strict memory limit), gradually for CPU.
  * GPU workers: per-sample cost scaled by 1/flops_ratio vs the CPU baseline
    (paper Fig. 7: P100 vs 48-core Xeon = 0.813 : 0.187 FLOPs split).

BSP and ASP synchronisation are both modelled; the simulator advances a
virtual clock while the caller performs *real* SGD updates — convergence is
real, wall-time is simulated (DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np

Trace = Callable[[float], float]  # sim-time -> availability multiplier (0,1]


@dataclasses.dataclass
class WorkerSpec:
    """Static resources of one worker."""

    cores: float = 1.0                 # CPU cores (or chip count for TPU slices)
    flops_ratio: float = 1.0           # relative peak vs 1 reference core
    kind: str = "cpu"                  # 'cpu' | 'gpu' | 'tpu'
    b_mem: Optional[int] = None        # batch where the memory cliff starts
    trace: Optional[Trace] = None      # dynamic availability (None = 1.0)
    price: float = 1.0                 # relative $/hr (spot-market cost model
    #                                    consumed by core/allocation.py's
    #                                    cost_aware_allocation)

    def availability(self, t: float) -> float:
        return self.trace(t) if self.trace is not None else 1.0


@dataclasses.dataclass
class WorkloadModel:
    """Per-workload cost constants (calibrated per paper §IV scale ratios)."""

    name: str
    w: float = 1e-3          # seconds/sample on one reference core
    t_sync: float = 0.05     # seconds/iteration fixed sync+comm overhead
    amdahl_p: float = 0.95   # parallel fraction inside a worker
    cliff_cpu: float = 0.3   # gradual post-cliff slope for CPU workers
    cliff_gpu: float = 4.0   # sharp post-cliff penalty for GPU workers


# Paper workloads, calibrated to §IV scales: ResNet-50/CIFAR is seconds per
# iteration on CPU workers (strongly compute-bound), the MNIST CNN is
# moderately compute-bound, LinReg is communication/sync-bound (paper: only
# ~15% benefit from load balancing).
WORKLOADS = {
    "resnet": WorkloadModel("resnet", w=0.3, t_sync=0.2, amdahl_p=0.97),
    "mnist-cnn": WorkloadModel("mnist-cnn", w=0.02, t_sync=0.05,
                               amdahl_p=0.95),
    "linreg": WorkloadModel("linreg", w=4e-4, t_sync=0.05, amdahl_p=0.80),
    "transformer": WorkloadModel("transformer", w=0.1, t_sync=0.1,
                                 amdahl_p=0.98),
}


def amdahl_speedup(cores: float, p: float) -> float:
    return 1.0 / ((1.0 - p) + p / max(cores, 1e-9))


class ClusterSim:
    """Virtual clock + iteration-time model over K heterogeneous workers."""

    def __init__(self, workers: Sequence[WorkerSpec], workload: WorkloadModel,
                 noise: float = 0.02, seed: int = 0):
        self.workers = list(workers)
        self.wl = workload
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self.time = 0.0
        self.iteration = 0

    # ------------------------------------------------------------- model

    def per_sample_time(self, k: int, batch: int, at_time: float) -> float:
        w_spec = self.workers[k]
        base = self.wl.w / (amdahl_speedup(w_spec.cores, self.wl.amdahl_p)
                            * w_spec.flops_ratio)
        # memory cliff (paper Fig. 5)
        if w_spec.b_mem is not None and batch > w_spec.b_mem:
            over = (batch - w_spec.b_mem) / max(w_spec.b_mem, 1)
            pen = (self.wl.cliff_gpu if w_spec.kind == "gpu"
                   else self.wl.cliff_cpu)
            base *= 1.0 + pen * over
        return base / max(w_spec.availability(at_time), 1e-6)

    def iteration_time(self, k: int, batch: int,
                       at_time: Optional[float] = None) -> float:
        t = self.time if at_time is None else at_time
        compute = self.per_sample_time(k, batch, t) * batch
        jitter = 1.0 + self.noise * float(self.rng.standard_normal())
        return (self.wl.t_sync + compute) * max(jitter, 0.1)

    def peek_iteration_time(self, k: int, batch: int,
                            at_time: Optional[float] = None) -> float:
        """Expected iteration time WITHOUT drawing jitter.

        ``iteration_time`` consumes the noise RNG stream — calling it just to
        *observe* (controller inputs, open-loop allocation estimates, replans)
        perturbs every subsequent simulated timing.  Observation goes through
        this side-effect-free path; only actual simulated work should draw
        from the jitter stream.
        """
        t = self.time if at_time is None else at_time
        compute = self.per_sample_time(k, batch, t) * batch
        return self.wl.t_sync + compute

    def throughput(self, k: int, batch: int) -> float:
        return batch / self.iteration_time(k, batch)

    def peek_throughput(self, k: int, batch: int) -> float:
        """Expected samples/sec — RNG-free (see ``peek_iteration_time``)."""
        return batch / self.peek_iteration_time(k, batch)

    # -------------------------------------------------------- membership

    def add_worker(self, spec: WorkerSpec) -> int:
        """Admit a worker in place (appended last): the clock and the noise
        stream continue — no reseed, no state rebuild."""
        self.workers.append(spec)
        return len(self.workers) - 1

    def remove_worker(self, k: int) -> WorkerSpec:
        """Fail-stop removal of worker k; remaining indices shift down."""
        if not (0 <= k < len(self.workers)):
            raise ValueError(f"no worker {k} in a {len(self.workers)}-cluster")
        if len(self.workers) <= 1:
            raise ValueError("cannot remove the last worker")
        return self.workers.pop(k)

    # --------------------------------------------------------------- BSP

    def bsp_step(self, batches: Sequence[int]) -> dict:
        """One BSP iteration: all workers compute, barrier at the max."""
        times = [self.iteration_time(k, b) for k, b in enumerate(batches)]
        t_iter = max(times)
        self.time += t_iter
        self.iteration += 1
        return {
            "worker_times": times,
            "iteration_time": t_iter,
            "straggler_waste": sum(t_iter - t for t in times) / max(
                len(times) * t_iter, 1e-9),
        }

    # --------------------------------------------------------------- ASP

    def asp_run(self, batches: Sequence[int], num_updates: int) -> dict:
        """Event-driven ASP: workers push updates independently.

        Returns the update log [(sim_time, worker, staleness)]: staleness of
        an update = number of global updates applied between this worker's
        parameter read and its write (drives statistical-inefficiency
        modelling in the benchmarks).

        The event loop itself lives in ``repro_torch.train.engine.EventEngine``
        (the single owner of (worker, next_done, version) queues); this is
        a timing-only convenience wrapper kept for the benchmarks/tests.
        """
        from repro_torch.train.engine import EventEngine  # lazy: avoids an import cycle

        return EventEngine(self).run_asp(batches, num_updates)


# ------------------------------------------------------- cluster generators


def hlevel_cluster(total_cores: int, h_level: float, k: int = 3,
                   **spec_kw) -> list[WorkerSpec]:
    """K-worker CPU cluster with max/min core ratio = h_level and the same
    total capacity (paper §IV-A: e.g. total 39, H=2 -> (9, 12, 18);
    H=10 -> (2, 17, 20))."""
    if k < 2:
        raise ValueError("need k >= 2")
    if h_level < 1:
        raise ValueError("h_level must be >= 1")
    # pick min m from the continuous solution, pin max to round(m*h),
    # give the remainder to the middle workers (matches the paper's
    # (2, 17, 20) at H=10 / (9, 12, 18)-style splits at H=2)
    m_cont = total_cores / (1 + h_level + (k - 2) * (1 + h_level) / 2)
    m = max(1, round(m_cont))
    big = max(m, round(m * h_level))
    rest = total_cores - m - big
    if k > 2:
        if rest < k - 2:
            raise ValueError("infeasible h-level for this total")
        mid = [rest // (k - 2)] * (k - 2)
        mid[-1] += rest - sum(mid)
        cores = [m] + mid + [big]
    else:
        cores = [m, big + rest]
    if min(cores) < 1:
        raise ValueError("infeasible h-level for this total")
    return [WorkerSpec(cores=float(c), **spec_kw) for c in cores]


def mixed_gpu_cpu_cluster(flops_split=(0.813, 0.187), cpu_cores: int = 48,
                          amdahl_p: float = 0.97) -> list[WorkerSpec]:
    """Paper §IV-B: one P100 GPU + one 48-core Xeon; FLOPs ratio 0.813:0.187.

    flops_ratio is expressed vs ONE reference CPU core, so the GPU's ratio is
    (g/c) x the whole Xeon's effective cores (the paper: GPU 'only' 4.3x the
    48-core Xeon)."""
    g, c = flops_split
    xeon_effective = amdahl_speedup(cpu_cores, amdahl_p)
    return [
        WorkerSpec(cores=1, flops_ratio=(g / c) * xeon_effective, kind="gpu",
                   b_mem=512),
        WorkerSpec(cores=cpu_cores, flops_ratio=1.0, kind="cpu", b_mem=2048),
    ]


def homogeneous_cluster(total_cores: int, k: int = 3) -> list[WorkerSpec]:
    per = total_cores / k
    return [WorkerSpec(cores=per) for _ in range(k)]
