"""The measured backend: the dynamic-batching loop fed by measured step times.

`HeterogeneousTrainer` closes the loop against the cluster *simulator*: real
SGD, modelled clock.  This module closes it against the device itself: K
logical workers compute real gradients with *ragged* per-worker batches, and
the controller observes their **measured** times (EWMA-filtered) instead of
simulated ones.  It is the reference's ``train/mesh.py`` for one card.

Execution model on one card:

  * all K workers time-multiplex the card, one after the other: the
    reference's sequential round, which it takes by itself whenever its mesh
    data axis has fewer devices than workers (one card is one device);
  * worker k's mini-batch b_k is padded up to a *bucketed* shape
    ``bucket_up(b_k)`` (geometric ladder, ``core.batching``); rows past b_k
    carry zero weight through the validity mask, which is a prefix of ones
    (the suffix-padding contract the flash kernels' ``num_valid`` relies on);
  * each worker makes ONE gradient call over its whole bucket, and
    :func:`repro_torch.core.grad.weighted_psum` divides its masked gradient
    sum by its mask-weight sum once, so padding rows contribute exactly
    zero; the per-worker gradients are then combined with the paper's lambda
    weights (``combine_weighted``), as on the sim path;
  * each call is timed: on the card by a pair of CUDA events recorded on the
    current stream around it (``elapsed_time`` once the end event has
    completed); on the CPU by the module's ``_time.perf_counter``, read
    where the reference reads it.  A worker's first call at a bucket of its
    execution record stands in for the reference's fresh XLA trace and is
    run again, alone, for the time (``timing_reruns``), so warm-up never
    pollutes the control signal; an EWMA (``time_alpha``) smooths the times
    the controller sees.

The measured completions feed a :class:`_MeasuredTimeModel` that duck-types
the ``ClusterSim`` surface :class:`repro_torch.train.engine.EventEngine`
drives, so BSP, ASP and elastic schedules all run through the same event
queue as the sim backend.

Not here: the reference's concurrent round (disjoint data-axis slices in
flight at once, awaiter threads; slice 5b of the port, which needs more than
one card) and its co-located serving surface (``reserve``, ``set_reserve``,
``_charge_interference``, ``slice_devices``; slice 6).  Execution records
and the slice plan are still kept as the reference keeps them, with its
default switch, for a one-device data axis (a lone worker owns the
one-device slice), because they decide when a worker's buckets count as
fresh and what :meth:`MeshTrainer.exec_state_dict` holds.

Optional ``worker_dilation`` multiplies worker k's *measured* time by a
constant factor, emulating a heterogeneous fleet on one card; the
computation itself is always real.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import (
    SlicePlan,
    bucket_up,
    combine_weighted,
    combine_weighted_with_sqnorm,
    cost_aware_allocation,
    largest_remainder_round,
    make_controller,
    plan_slices,
    static_allocation,
    weighted_psum,
    weighted_psum_with_sqnorm,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.het.simulator import WorkerSpec, amdahl_speedup
from repro_torch.optim.optimizers import Optimizer
from repro_torch.train.engine import EventEngine
from repro_torch.train.loop import OuterBatchMixin, StepRecord, TrainConfig

# the data axis of one device: the quantum of every bucket and the width a
# slice plan divides (the reference's ``data_extent``, with no serve reserve)
EXTENT = 1


class _MeasuredTimeModel:
    """Measured-time stand-in for ``ClusterSim``: the event engine's clock.

    Duck-types the surface :class:`EventEngine` needs (``workers``,
    ``iteration_time``, ``bsp_step``, mutable ``time``) but is backed by
    EWMA per-example rates learned from real, device-synced completion
    measurements instead of a calibrated model — this is what lets the
    backend-agnostic engine drive ASP/elastic schedules on the mesh
    (DESIGN.md §12).
    """

    DEFAULT_RATE = 1e-3   # sec/example before any worker has been measured

    def __init__(self, num_workers: int, alpha: float) -> None:
        self.time = 0.0
        self.iteration = 0
        self.alpha = alpha
        self.rate: list[Optional[float]] = [None] * num_workers
        self._pending_round: Optional[list[float]] = None

    @property
    def workers(self) -> list:                 # engine reads len(sim.workers)
        return self.rate

    # -------------------------------------------------------- observations

    def observe(self, k: int, batch: int, seconds: float) -> None:
        """Fold one measured (dilated) completion into worker k's rate."""
        r = seconds / max(batch, 1)
        prev = self.rate[k]
        self.rate[k] = r if prev is None else (
            self.alpha * r + (1 - self.alpha) * prev)

    def iteration_time(self, k: int, batch: int,
                       at_time: Optional[float] = None) -> float:
        """Predicted step time from the EWMA rate (engine schedule source).

        Unmeasured workers (fresh joiners, cold start) borrow the mean
        measured rate so the event queue stays well-ordered until their
        first real completion lands.
        """
        r = self.rate[k]
        if r is None:
            known = [x for x in self.rate if x is not None]
            r = sum(known) / len(known) if known else self.DEFAULT_RATE
        return r * batch

    # ----------------------------------------------------------- BSP round

    def push_round(self, worker_times: Sequence[float]) -> None:
        """Stage one round's measured per-worker times for ``bsp_step``."""
        self._pending_round = list(worker_times)

    def bsp_step(self, batches: Sequence[int]) -> dict:
        """Engine-facing barrier: consumes the staged MEASURED times (the
        sim backend models these; here they were clocked on device)."""
        times = self._pending_round
        if times is None or len(times) != len(batches):
            raise RuntimeError(
                "bsp_step needs a staged measured round (push_round first)")
        self._pending_round = None
        t_iter = max(times)
        self.time += t_iter
        self.iteration += 1
        return {
            "worker_times": times,
            "iteration_time": t_iter,
            "straggler_waste": sum(t_iter - t for t in times) / max(
                len(times) * t_iter, 1e-9),
        }

    # ---------------------------------------------------------- membership

    def remove_worker(self, k: int) -> None:
        del self.rate[k]

    def add_worker(self) -> None:
        self.rate.append(None)


@dataclasses.dataclass(eq=False)
class _WorkerExec:
    """One worker's execution record: its bucket ladder and the buckets it
    has run (the reference's per-record jit cache: a bucket's first call on
    a record is warm-up, timed again alone)."""

    quantum: int                   # bucket quantum = slice data extent
    bucket_base: int               # ladder anchor (microbatch, quantized)
    slice: Optional[tuple[int, int]]   # (start, length); None = shared record
    warm: set = dataclasses.field(default_factory=set)


def _host_timed(fn: Callable, device: torch.device):
    """``fn()`` and its seconds on the host clock (the CPU path: the call
    has finished when it returns)."""
    t0 = _time.perf_counter()
    out = fn()
    return out, _time.perf_counter() - t0


def _event_timed(fn: Callable, device: torch.device):
    """``fn()`` and its seconds between two CUDA events recorded on the
    device's current stream around it, read once the end event completed."""
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    out = fn()
    end.record(stream)
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def _timed(fn: Callable, device: torch.device):
    """Time one gradient call: CUDA events on the card, the host clock on
    the CPU."""
    if device.type == "cuda":
        return _event_timed(fn, device)
    return _host_timed(fn, device)


class MeshTrainer(OuterBatchMixin):
    """Drives the dynamic-batching loop on one device with measured times.

    Presents the same surface as :class:`HeterogeneousTrainer` to
    :class:`repro_torch.api.session.Session` (``bsp_step`` / ``asp_step`` /
    ``history`` / ``batches`` / ``controller`` / ``engine`` / membership
    events / checkpoint state) and feeds the controller measured times.
    Construct via :class:`repro_torch.api.backend.MeshBackend`.

    loss_and_grad(params, batch, mask) -> ((loss_sum, w_sum, aux), grads)
        called once per worker with the worker's whole padded bucket; grads
        of the weighted SUM loss.
    next_batch(worker, n) -> dict of tensors with leading dim n, on ``device``.
    init_params(generator) -> flat parameter dict; the generator is seeded
        with ``cfg.seed``.
    """

    backend_kind = "mesh"

    def __init__(
        self,
        *,
        num_workers: int,
        init_params: Callable,
        loss_and_grad: Callable,
        next_batch: Callable,
        optimizer: Optimizer,
        cfg: TrainConfig,
        growth: float = 1.25,
        time_alpha: float = 0.5,
        worker_dilation: Optional[Sequence[float]] = None,
        dilation_for_spec: Optional[Callable[[WorkerSpec], float]] = None,
        device: DeviceLike = None,
    ):
        if num_workers < 1:
            raise ValueError("need at least one worker")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bucket_base = EXTENT * -(-cfg.microbatch // EXTENT)
        self.growth = growth
        self.time_alpha = time_alpha
        self.k = num_workers
        if worker_dilation is not None and len(worker_dilation) != num_workers:
            raise ValueError(
                f"{len(worker_dilation)} dilation factors for "
                f"{num_workers} workers")
        self.dilation = ([1.0] * num_workers if worker_dilation is None
                         else [float(d) for d in worker_dilation])
        self._dilation_for_spec = dilation_for_spec
        self.next_batch = next_batch
        self.optimizer = optimizer
        self._loss_and_grad = loss_and_grad
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.params = init_params(gen)
        self.opt_state = optimizer.init(self.params)
        self.step_idx = 0
        self.history: list[StepRecord] = []
        self.membership_log: list[tuple[int, str, int]] = []
        self.accum_calls = 0       # gradient calls (timing reruns excluded)
        self.timing_reruns = 0     # warm-up re-executions (timing only)
        self.worker_buckets: list[set[int]] = [set() for _ in range(self.k)]
        self._need_grad_stats = cfg.global_batch.needs_grad_stats
        self._last_sqnorm: Optional[float] = None
        self.concurrent = False
        self.slice_plan: Optional[SlicePlan] = None
        self._exec: list[_WorkerExec] = []
        self._reconfigure_execution()
        self._ewma: list[Optional[float]] = [None] * self.k
        self.time_model = _MeasuredTimeModel(self.k, time_alpha)
        self.sim = self.time_model   # Session/metrics read trainer.sim.time
        self.batches = self._initial_batches()
        self.engine = EventEngine(self.time_model)
        self.controller = None
        if cfg.batching == "dynamic":
            self.controller = make_controller(self.batches, cfg.controller)
        self._init_outer()
        self._outer_last_time = self.time_model.time

    # ----------------------------------------------------- execution setup

    def _make_exec(self, slice_: Optional[tuple[int, int]]) -> _WorkerExec:
        quantum = EXTENT if slice_ is None else slice_[1]
        return _WorkerExec(
            quantum=quantum,
            bucket_base=quantum * -(-self.cfg.microbatch // quantum),
            slice=slice_)

    def _reconfigure_execution(
            self, plan: Optional[SlicePlan] = None) -> None:
        """(Re)build per-worker execution records for the current k, as the
        reference does with its default switch: a lone worker owns the
        one-device slice, several workers share one full-axis record.
        Workers whose record changed get a cleared bucket set, and a new
        record starts with no warm buckets.  (With one device a slice record
        only arises for k = 1, whose round is the sequential one all the
        same.)"""
        old = list(self._exec)
        was_concurrent = self.concurrent
        concurrent = self.k <= EXTENT
        if concurrent and plan is None:
            plan = plan_slices(EXTENT, self.k)
        self.concurrent = concurrent
        self.slice_plan = plan if concurrent else None
        if not concurrent:
            if old and not was_concurrent and old[0].quantum == EXTENT:
                shared = old[0]
            else:
                shared = self._make_exec(None)
            new = [shared] * self.k
        else:
            by_slice = {rec.slice: rec for rec in old} if was_concurrent \
                else {}
            new = [by_slice.get((start, length))
                   or self._make_exec((start, length))
                   for start, length in self.slice_plan.slices]
        for j in range(min(len(old), self.k)):
            if new[j] is not old[j]:
                self.worker_buckets[j] = set()
        self._exec = new

    # ------------------------------------------------------------- planning

    def bucket_for(self, worker: int, batch: int) -> int:
        """Worker's ladder rung for ``batch`` (anchored at its record)."""
        rec = self._exec[worker]
        return bucket_up(batch, base=rec.bucket_base, growth=self.growth,
                         quantum=rec.quantum)

    def bucket(self, batch: int) -> int:
        """Full-axis ladder rung (the shared record's shape for ``batch``)."""
        return bucket_up(batch, base=self.bucket_base, growth=self.growth,
                         quantum=EXTENT)

    def _initial_batches(self) -> list[int]:
        cfg = self.cfg
        outer_active = (cfg.batching == "dynamic"
                        and cfg.global_batch.kind != "fixed")
        if cfg.batching == "uniform" or (
            cfg.batching == "dynamic" and cfg.init_allocation == "uniform"
            and not outer_active
        ):
            return [cfg.b0] * self.k
        # open-loop init on the device: a PROBE round (one measured call per
        # worker at b0, gradients discarded) replaces the simulator's
        # throughput peek; the measurements also seed the event engine's
        # rate model, so an ASP run's first schedule is measurement-ordered
        times = []
        for k in range(self.k):
            t = self._measured_worker_grad(k, cfg.b0)[3]
            self.time_model.observe(k, cfg.b0, t)
            times.append(t)
        if outer_active:
            # the device exposes no memory-cliff capacities or spot prices,
            # so the outer kinds' cost-aware start reduces to the
            # measured-throughput split of K*b0
            return cost_aware_allocation(
                [cfg.b0 / t for t in times], self.k * cfg.b0)
        return static_allocation([cfg.b0 / t for t in times], cfg.b0)

    # ------------------------------------------------------------ gradients

    def _grad_call(self, data: dict, mask: torch.Tensor) -> tuple:
        """Masked gradient SUM over the bucket, divided once by the mask's
        weight sum; ``(g_mean, loss_sum, w_sum[, |g_mean|^2])`` on the
        device."""
        (loss_sum, w_sum, _aux), grads = self._loss_and_grad(
            self.params, data, mask)
        if self._need_grad_stats:
            g, sqn = weighted_psum_with_sqnorm(grads, w_sum)
            return g, loss_sum, w_sum, sqn
        return weighted_psum(grads, w_sum), loss_sum, w_sum

    def _measured_worker_grad(self, worker: int, batch_size: int):
        """One timed gradient call for ``worker`` over its bucket.

        Fetches bucket-many examples and masks the tail (the first b_k
        stream examples are those of an unpadded fetch).  SUFFIX-PADDING
        CONTRACT: the mask ``arange(bucket) < batch_size`` is the single
        source of truth for which rows are real; valid rows always form a
        prefix, and ``lm_workload(use_kernel=True)`` recovers the flash
        kernels' ``num_valid`` by counting them.

        Returns ``(g_mean, loss_sum, weight_sum, seconds)``, seconds being
        the warm, dilated time of the call.  The probe round, the BSP round
        and ASP all come through here.
        """
        rec = self._exec[worker]
        bucket = self.bucket_for(worker, batch_size)
        self.worker_buckets[worker].add(bucket)
        data = self.next_batch(worker, bucket)
        mask = (torch.arange(bucket, device=self.device)
                < batch_size).to(torch.float32)
        warm = bucket in rec.warm
        rec.warm.add(bucket)
        out, dt = _timed(lambda: self._grad_call(data, mask), self.device)
        self.accum_calls += 1
        if not warm:
            # the first call at a bucket paid for warm-up: run it again,
            # alone, from the same data (result identical and discarded)
            self.timing_reruns += 1
            _, dt = _timed(lambda: self._grad_call(data, mask), self.device)
        # the loss and weight sums (and |g_k|^2) reach the host together
        host = torch.stack(list(out[1:])).tolist()
        self._last_sqnorm = float(host[2]) if self._need_grad_stats else None
        return out[0], float(host[0]), float(host[1]), \
            dt * self.dilation[worker]

    def _observe_time(self, worker: int, seconds: float) -> float:
        """EWMA filter over measured step times (measurement pipeline; the
        controller applies its own ``ewma_alpha`` smoothing on top)."""
        prev = self._ewma[worker]
        cur = seconds if prev is None else (
            self.time_alpha * seconds + (1 - self.time_alpha) * prev)
        self._ewma[worker] = cur
        return cur

    # ------------------------------------------------------------------ BSP

    def _round_sequential(self):
        """Time-multiplex the device: worker after worker (sum-of-workers)."""
        grads, losses, weights, raw_times, sqnorms = [], 0.0, 0.0, [], []
        for k in range(self.k):
            g, ls, ws, dt = self._measured_worker_grad(k, self.batches[k])
            grads.append(g)
            losses += ls
            weights += ws
            raw_times.append(dt)
            if self._last_sqnorm is not None:
                sqnorms.append(self._last_sqnorm)
        return grads, losses, weights, raw_times, sqnorms

    def bsp_step(self) -> StepRecord:
        pre_batches = list(self.batches)
        grads, losses, weights, raw_times, sqnorms = self._round_sequential()
        smoothed = [self._observe_time(k, t) for k, t in enumerate(raw_times)]
        for k, t in enumerate(raw_times):
            self.time_model.observe(k, self.batches[k], t)
        # Eq. 2-3: lambda-weighted combine (identical to the sim path)
        if self._need_grad_stats:
            g, g_sqnorm = combine_weighted_with_sqnorm(grads, self.batches)
        else:
            g = combine_weighted(grads, self.batches)
            g_sqnorm = None
        del grads
        self.params, self.opt_state = self.optimizer.update(
            self.params, g, self.opt_state, self.step_idx)
        if g_sqnorm is not None:
            g_sqnorm = float(g_sqnorm)
        # the engine's barrier consumes the round's MEASURED times and keeps
        # the version counter BSP and ASP staleness both read; only the
        # controller sees the EWMA-filtered view
        self.time_model.push_round(raw_times)
        info = self.engine.bsp_round(self.batches)
        adjusted = False
        if self.controller is not None:
            upd = self.controller.observe(smoothed)
            adjusted = upd.updated
            self.batches = upd.batches
        if self._observe_outer(
                loss=losses / max(weights, 1e-9),
                seconds=info["iteration_time"],
                sqnorms=sqnorms or None, pre_batches=pre_batches,
                combined_sqnorm=g_sqnorm,
                worker_times=raw_times):
            # a B_global resize walks each worker's own bucket ladder
            adjusted = True
        rec = StepRecord(
            step=self.step_idx,
            sim_time=self.time_model.time,
            iteration_time=info["iteration_time"],
            loss=losses / max(weights, 1e-9),
            batches=list(self.batches),
            adjusted=adjusted,
            straggler_waste=info["straggler_waste"],
            worker_times=list(raw_times),
        )
        self.history.append(rec)
        self.step_idx += 1
        return rec

    # ------------------------------------------------------------------ ASP

    def asp_step(self) -> StepRecord:
        """One global ASP update.

        The event engine pops the predicted-earliest completion (per-worker
        EWMA rates learned from real measurements); that worker's gradient
        is computed, for real, against the params it last read, applied with
        the paper's staleness-weighted lambda scaling, and the measured
        duration updates the rate model so the emulated timeline tracks the
        device.  Staleness and versioning are those of
        ``HeterogeneousTrainer.asp_step`` (the queue is the same engine).
        """
        eng = self.engine
        if not eng.scheduled:
            eng.asp_schedule(self.batches, payload=self.params)
        ev = eng.asp_next(self.batches)
        i = ev.worker
        saved = self.params
        self.params = eng.get_payload(i)
        g, ls, ws, dt = self._measured_worker_grad(i, self.batches[i])
        self.params = saved
        self._observe_time(i, dt)
        self.time_model.observe(i, self.batches[i], dt)
        lam = self.batches[i] / sum(self.batches)
        g = {name: lam * self.k * x for name, x in g.items()}
        self.params, self.opt_state = self.optimizer.update(
            self.params, g, self.opt_state, self.step_idx)
        eng.set_payload(i, self.params)
        adjusted = False
        if self.controller is not None and eng.version % self.k == 0:
            # each worker's expected iteration time from the rate model: a
            # prediction, not a fresh measurement
            times = [self.time_model.iteration_time(j, self.batches[j])
                     for j in range(self.k)]
            upd = self.controller.observe(times)
            adjusted = upd.updated
            self.batches = upd.batches
        if self.outer is not None and eng.version % self.k == 0:
            elapsed = self.time_model.time - self._outer_last_time
            self._outer_last_time = self.time_model.time
            if self._observe_outer(loss=ls / max(ws, 1e-9),
                                   seconds=max(elapsed, 0.0)):
                adjusted = True
        rec = StepRecord(
            step=self.step_idx, sim_time=self.time_model.time,
            iteration_time=float(ev.time), loss=ls / max(ws, 1e-9),
            batches=list(self.batches), adjusted=adjusted,
            straggler_waste=float(ev.staleness),
        )
        self.history.append(rec)
        self.step_idx += 1
        return rec

    # ------------------------------------------------------------ membership

    def _measured_xput(self) -> list[float]:
        """Per-worker throughput from the MEASURED (EWMA) times; workers
        without a measurement yet (fresh joiners) get the mean."""
        xput = [self.batches[i] / self._ewma[i]
                if i < len(self.batches) and self._ewma[i] else None
                for i in range(self.k)]
        known = [x for x in xput if x is not None] or [1.0]
        mean = sum(known) / len(known)
        return [mean if x is None else x for x in xput]

    def _measured_replan(self, total: int) -> list[int]:
        """Throughput-proportional split of the invariant global batch from
        measured times (no controller attached)."""
        xput = self._measured_xput()
        s = sum(xput)
        return largest_remainder_round([total * x / s for x in xput],
                                       total, lo=1)

    def remove_worker(self, k: int) -> None:
        """Preemption of worker k; its batch share is reabsorbed (Σb_k
        invariant) and survivors keep controller and measurement state."""
        if self.k <= 1:
            raise ValueError("cannot remove the last worker")
        if not (0 <= k < self.k):
            raise ValueError(f"no worker {k} in a {self.k}-cluster")
        self.membership_log.append((self.step_idx, "remove", k))
        total = sum(self.batches)
        del self._ewma[k], self.dilation[k], self.worker_buckets[k]
        del self._exec[k]
        self.time_model.remove_worker(k)
        self.engine.remove_worker(k)
        # keep survivor indices aligned with the measurement state before
        # any replan reads batches[i]/ewma[i] pairs
        self.batches = [b for j, b in enumerate(self.batches) if j != k]
        self.k -= 1
        if self.controller is not None:
            self.batches = self.controller.remove_worker(k)
        else:
            self.batches = self._measured_replan(total)
        self._reconfigure_execution(
            self.slice_plan.remove(k) if self.slice_plan is not None
            else None)

    def add_worker(self, spec: WorkerSpec) -> None:
        """A replacement joins (model state is already on the device).
        ``spec`` changes no hardware; it seeds the newcomer's dilation when
        heterogeneity is emulated (``MeshBackend(dilation="from-spec")``)."""
        self.membership_log.append((self.step_idx, "add", self.k))
        total = (self.controller.global_batch if self.controller is not None
                 else sum(self.batches))
        self.k += 1
        self._ewma.append(None)
        self.worker_buckets.append(set())
        self.dilation.append(self._dilation_for_spec(spec)
                             if self._dilation_for_spec is not None else 1.0)
        self.time_model.add_worker()
        if self.controller is not None:
            self.batches = self.controller.add_worker(total / self.k)
        else:
            self.batches = self._measured_replan(total)
        self._reconfigure_execution(
            self.slice_plan.add() if (self.slice_plan is not None
                                      and self.k <= EXTENT)
            else None)
        # the newcomer reads the CURRENT params; only a live ASP schedule
        # reads payloads, so on BSP none is held (it would keep a full copy
        # of the params alive for as long as the newcomer stays)
        self.engine.add_worker(
            self.batches[-1],
            payload=self.params if self.engine.scheduled else None)

    def slow_worker(self, k: int, factor: float) -> None:
        """Mesh half of :class:`repro_torch.api.cluster.SlowWorker`: scales
        worker ``k``'s emulation dilation, so the measured control signal
        slows down as a degrading spot instance's would.  Factors compose;
        the reciprocal restores; the dilation is part of
        ``exec_state_dict``."""
        if not (0 <= k < self.k):
            raise ValueError(f"no worker {k} in a {self.k}-cluster")
        if not (factor > 0):
            raise ValueError(f"slowdown factor must be positive, got {factor}")
        self.dilation[k] = self.dilation[k] * float(factor)

    def reallocate_cost_aware(self) -> list[int]:
        """Churn replan from MEASURED throughput: the device exposes no
        simulator capacities or spot prices, so the cost-aware allocator
        reduces to the measured-throughput split, with controller state
        kept through ``apply_allocation``."""
        total = (self.controller.global_batch if self.controller is not None
                 else sum(self.batches))
        b_min = (self.controller.config.b_min
                 if self.controller is not None else 1)
        plan = cost_aware_allocation(self._measured_xput(), total,
                                     b_min=b_min)
        self.membership_log.append((self.step_idx, "reallocate", -1))
        if self.controller is not None:
            self.batches = self.controller.apply_allocation(plan)
        else:
            self.batches = plan
        return self.batches

    # ------------------------------------------------------------ checkpoint

    def exec_state_dict(self) -> dict:
        """Execution state for ``Session.save``: measurement EWMAs, the
        engine's rate model and clock, the buckets visited, the slice
        assignment and the dilation factors, in the reference's layout (JSON
        for the checkpoint's metadata)."""
        return {
            "extent": EXTENT,
            "reserve": 0,
            "concurrent": self.concurrent,
            "slices": ([list(s) for s in self.slice_plan.slices]
                       if self.slice_plan is not None else None),
            "ewma": list(self._ewma),
            "rates": list(self.time_model.rate),
            "clock": {"time": self.time_model.time,
                      "iteration": self.time_model.iteration},
            "buckets": [sorted(b) for b in self.worker_buckets],
            "dilation": list(self.dilation),
        }

    def check_exec_state_dict(self, st: dict) -> Optional[SlicePlan]:
        """Every check of :meth:`load_exec_state_dict`, changing nothing;
        returns the checkpoint's slice plan (None when it has none)."""
        if int(st["extent"]) != EXTENT:
            raise ValueError(
                f"checkpoint was taken on a mesh with data extent "
                f"{st['extent']}, this mesh has {EXTENT} — "
                f"rebuild the Experiment on a matching mesh")
        slices = st["slices"]
        if bool(st["concurrent"]) != (slices is not None) or \
                (slices is None) != (self.slice_plan is None):
            raise ValueError(
                "checkpoint and session disagree on concurrent slicing "
                "(worker count vs data-axis width changed, or inconsistent "
                "checkpoint payload?)")
        if slices is None:
            return None
        return SlicePlan(extent=EXTENT, quantum=1,
                         slices=tuple((int(a), int(b)) for a, b in slices))

    def load_exec_state_dict(self, st: dict) -> None:
        """Inverse of :meth:`exec_state_dict` (bit-identical controller-
        facing state; warm buckets are relearnt on the first call at each
        bucket after the restore)."""
        plan = self.check_exec_state_dict(st)
        if plan is not None and plan.slices != self.slice_plan.slices:
            self._reconfigure_execution(plan)
        self._ewma = [None if v is None else float(v) for v in st["ewma"]]
        self.time_model.rate = [None if v is None else float(v)
                                for v in st["rates"]]
        self.time_model.time = float(st["clock"]["time"])
        self.time_model.iteration = int(st["clock"]["iteration"])
        self.worker_buckets = [set(int(x) for x in b)
                               for b in st["buckets"]]
        self.dilation = [float(d) for d in st["dilation"]]


def dilation_from_specs(specs: Sequence[WorkerSpec],
                        amdahl_p: float = 0.95):
    """Time-dilation factors emulating a ``ClusterSpec``'s declared
    heterogeneity on homogeneous hardware: the fastest declared worker runs
    undilated, a worker with half its effective speed takes 2x the measured
    time.  Effective speed = Amdahl(cores) x flops_ratio, the same model the
    simulator uses (DESIGN.md §2).

    Returns ``(dilations, dilation_for_spec)`` — the per-worker factors plus
    a function dilating any LATER-joining :class:`WorkerSpec` against the
    same reference (the initial fleet's fastest worker), so elastic joins
    stay on a consistent scale.
    """

    def eff(s: WorkerSpec) -> float:
        return amdahl_speedup(s.cores, amdahl_p) * s.flops_ratio

    top = max(eff(s) for s in specs)
    return [top / eff(s) for s in specs], lambda s: top / eff(s)
