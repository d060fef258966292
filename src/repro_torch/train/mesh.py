"""The measured backend: the dynamic-batching loop fed by measured step times.

`HeterogeneousTrainer` closes the loop against the cluster *simulator*: real
SGD, modelled clock.  This module closes it against the devices themselves:
K logical workers compute real gradients with *ragged* per-worker batches,
and the controller observes their **measured** times (EWMA-filtered)
instead of simulated ones.  It is the reference's ``train/mesh.py`` over a
list of torch devices, the counterpart of the reference's mesh data axis
(one device a row).

Execution model:

  * each worker owns a **disjoint, contiguous slice** of the data axis
    (`core.placement.SlicePlan`), so the K gradient calls run
    **concurrently**, one thread a worker: a dispatch stamp is taken on the
    main thread, then an awaiter thread stamps the call's completion (on a
    card, once the call's end event has completed), and a BSP round costs
    the slowest worker's time, not the sum.  With fewer training devices
    than workers (one card) the workers take the whole training region one
    after another on the main thread: the reference's sequential round;
  * worker k's mini-batch b_k is padded up to a *bucketed* shape
    ``bucket_up(b_k)`` (geometric ladder, ``core.batching``, anchored at the
    worker's slice length, so every padded bucket splits evenly); rows past
    b_k carry zero weight through the validity mask, which is a prefix of
    ones (the suffix-padding contract the flash kernels' ``num_valid``
    relies on);
  * the bucket is split into equal row shards, one a device of the slice;
    each device computes the masked gradient SUM of its rows on its own
    copy of the parameters, and :func:`repro_torch.core.grad.weighted_psum`
    adds the slice's partial sums on its first device, in slice order, and
    divides by the weight sum once, so padding rows contribute exactly
    zero; each worker's mean then moves to the home device (the list's
    first) and the workers' means are combined there with the paper's
    lambda weights in worker order, as on the sim path;
  * the master parameters and the optimizer state live on the home device;
    every other device of the training region holds a replica, copied from
    the master after each update (bit-equal);
  * each call is timed as the device its slice starts on allows: on a card
    by a pair of CUDA events recorded on the device's current stream around
    the call and the slice's reduction; on the CPU by the module's
    ``_time.perf_counter`` (the round's host stamps in a concurrent round,
    around the call otherwise).  A worker's first call at a bucket of its
    execution record stands in for the reference's fresh XLA trace and is
    run again, alone, for the time (``timing_reruns``), so warm-up never
    pollutes the control signal; an EWMA (``time_alpha``) smooths the times
    the controller sees.

No two workers share a card: a CUDA device may appear once in the list, and
a worker launches on its devices' current streams only.  ``"cpu"`` may
repeat; it stands in for the reference's fake host devices in the tests,
and times on a repeated device measure shared hardware.  Each shard takes
the kernel path of the device its tensors are on (the kernels on a card,
their plain versions on the CPU); the kernel libraries are loaded on the
main thread before the first threaded call.

The measured completions feed a :class:`_MeasuredTimeModel` that duck-types
the ``ClusterSim`` surface :class:`repro_torch.train.engine.EventEngine`
drives, so BSP, ASP and elastic schedules all run through the same event
queue as the sim backend.

Co-located serving (``repro_torch.train.colocate``): ``reserve`` withholds
the top devices of the data axis from training so a decode loop can own
them; :meth:`MeshTrainer.set_reserve` resizes that region through the same
replan path membership events use, and ``_charge_interference`` folds
measured decode seconds into a sharing worker's step time.

Optional ``worker_dilation`` multiplies worker k's *measured* time by a
constant factor, emulating a heterogeneous fleet on homogeneous hardware;
the computation itself is always real.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time as _time
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import (
    SlicePlan,
    bucket_up,
    carve_serve,
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
from repro_torch.device import DevicesLike, resolve_devices
from repro_torch.het.simulator import WorkerSpec, amdahl_speedup
from repro_torch.kernels import build as kernel_build
from repro_torch.optim.optimizers import Optimizer
from repro_torch.train.engine import EventEngine
from repro_torch.train.loop import OuterBatchMixin, StepRecord, TrainConfig


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
    """One worker's execution record: its rows of the data axis, its bucket
    ladder and the buckets it has run (the reference's per-record jit cache:
    a bucket's first call on a record is warm-up, timed again alone)."""

    rows: range                    # data-axis rows the bucket is split over
    quantum: int                   # bucket quantum = slice data extent
    bucket_base: int               # ladder anchor (microbatch, quantized)
    slice: Optional[tuple[int, int]]   # (start, length); None = shared record
    warm: set = dataclasses.field(default_factory=set)


@dataclasses.dataclass(eq=False)
class _Dispatch:
    """A worker's gradient call, in flight on its thread."""

    worker: int
    call: Future                   # -> (out, CUDA (start, end) events | None)
    t0: float                      # host dispatch stamp (perf_counter)
    fresh: bool                    # first call at this bucket of its record
    shards: list                   # (data, mask) a row, on the row's device


def _device_scope(device: torch.device):
    """Make ``device`` the calling thread's current card (a kernel launches
    on the current device); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _recorded(fn: Callable, device: torch.device):
    """``fn()`` between two CUDA events recorded on the device's current
    stream: ``(out, (start, end))``, the events not yet waited for."""
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    out = fn()
    end.record(stream)
    return out, (start, end)


def _host_timed(fn: Callable, device: torch.device):
    """``fn()`` and its seconds on the host clock (the CPU path: the call
    has finished when it returns)."""
    t0 = _time.perf_counter()
    out = fn()
    return out, _time.perf_counter() - t0


def _event_timed(fn: Callable, device: torch.device):
    """``fn()`` and its seconds between two CUDA events recorded on the
    device's current stream around it, read once the end event completed."""
    out, (start, end) = _recorded(fn, device)
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def _timed(fn: Callable, device: torch.device):
    """Time one gradient call: CUDA events on the card, the host clock on
    the CPU."""
    if device.type == "cuda":
        return _event_timed(fn, device)
    return _host_timed(fn, device)


def _ready_timestamp(d: _Dispatch) -> float:
    """Wait for ``d``'s call (re-raising its exception) and, on a card, for
    its end event; return the completion time.  Runs on an awaiter thread
    per in-flight worker, so each completion is stamped when *that* call
    finishes, whatever order the main thread collects them in."""
    _out, events = d.call.result()
    if events is not None:
        events[1].synchronize()
    return _time.perf_counter()


def _call_seconds(events, t0: float, done: float) -> float:
    """A concurrent call's seconds: its CUDA events on a card, its host
    stamps (dispatch to completion) on the CPU."""
    if events is not None:
        return events[0].elapsed_time(events[1]) / 1e3
    return done - t0


class MeshTrainer(OuterBatchMixin):
    """Drives the dynamic-batching loop on a list of devices (BSP + ASP).

    Presents the same surface as :class:`HeterogeneousTrainer` to
    :class:`repro_torch.api.session.Session` (``bsp_step`` / ``asp_step`` /
    ``history`` / ``batches`` / ``controller`` / ``engine`` / membership
    events / checkpoint state), executes concurrently over disjoint slices
    of ``device`` when there is one device a worker, and feeds the
    controller measured times.  Construct via
    :class:`repro_torch.api.backend.MeshBackend`.

    loss_and_grad(params, batch, mask) -> ((loss_sum, w_sum, aux), grads)
        called once per device of a worker's slice with that device's rows
        of the padded bucket, on tensors on that device; grads of the
        weighted SUM loss.
    next_batch(worker, n) -> dict of tensors with leading dim n, on the
        home device (``device``'s first).
    init_params(generator) -> flat parameter dict; the generator is seeded
        with ``cfg.seed`` on the home device.
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
        device: DevicesLike = None,
        concurrent: bool = True,
        reserve: int = 0,
    ):
        if num_workers < 1:
            raise ValueError("need at least one worker")
        self.cfg = cfg
        self.devices = resolve_devices(device)
        self.device = self.devices[0]    # home: master params, data, combine
        # train-region ladder anchors (the shared record's quanta); slices
        # get their own per-worker quanta from the placement plan.  The top
        # ``reserve`` devices belong to a co-located serve slice and never
        # hold training shards.
        self.data_extent = len(self.devices)
        if reserve < 0 or self.data_extent - reserve < 1:
            raise ValueError(
                f"reserving {reserve} of {self.data_extent} data-axis "
                f"devices for serving would leave no training devices — "
                f"training fully preempted; shrink the serve slice or "
                f"time-multiplex it (serve mode 'shared')")
        self.reserve = reserve
        self.train_extent = self.data_extent - reserve
        self.quantum = self.train_extent
        self.bucket_base = self.quantum * -(-cfg.microbatch // self.quantum)
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
        self._replicas: dict[int, dict] = {}   # row -> copy of the master
        self.step_idx = 0
        self.history: list[StepRecord] = []
        self.membership_log: list[tuple[int, str, int]] = []
        self.accum_calls = 0       # gradient calls (timing reruns excluded)
        self.timing_reruns = 0     # warm-up re-executions (timing only)
        # (dispatch, completion) host stamps per worker of the last
        # concurrent BSP round (None until one ran)
        self.last_round_stamps: Optional[list[tuple[float, float]]] = None
        self.worker_buckets: list[set[int]] = [set() for _ in range(self.k)]
        self._need_grad_stats = cfg.global_batch.needs_grad_stats
        self._last_sqnorm: Optional[float] = None
        self._want_concurrent = bool(concurrent)
        self.concurrent = False
        self.slice_plan: Optional[SlicePlan] = None
        self._exec: list[_WorkerExec] = []
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_size = 0
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
        start, length = (0, self.train_extent) if slice_ is None else slice_
        return _WorkerExec(
            rows=range(start, start + length), quantum=length,
            bucket_base=length * -(-self.cfg.microbatch // length),
            slice=slice_)

    def _reconfigure_execution(
            self, plan: Optional[SlicePlan] = None) -> None:
        """(Re)build per-worker execution records for the current k.

        Concurrent mode when the training region has at least one device
        per worker; otherwise all workers take turns on one record spanning
        the training region.  Unchanged slices keep their record (and its
        warm buckets); workers whose placement changed get a fresh record
        and a cleared bucket set.
        """
        old = list(self._exec)
        was_concurrent = self.concurrent
        concurrent = self._want_concurrent and self.k <= self.train_extent
        if concurrent and plan is None:
            # equal device shares: the heterogeneity lives in the batch
            # sizes, not the slice widths; a live serve reserve goes through
            # the placement layer's carve, its one source of truth
            if self.reserve:
                plan, _ = carve_serve(self.data_extent, self.k, self.reserve)
            else:
                plan = plan_slices(self.train_extent, self.k)
        self.concurrent = concurrent
        self.slice_plan = plan if concurrent else None
        if not concurrent:
            # the shared record is reusable only while the training region
            # is unchanged (a serve-slice resize changes its quantum)
            if old and not was_concurrent \
                    and old[0].quantum == self.train_extent:
                shared = old[0]
            else:
                shared = self._make_exec(None)
            new = [shared] * self.k
        else:
            by_slice = {rec.slice: rec for rec in old} if was_concurrent \
                else {}
            new = [by_slice.get(s) or self._make_exec(s)
                   for s in self.slice_plan.slices]
        for j in range(min(len(old), self.k)):
            if new[j] is not old[j]:
                self.worker_buckets[j] = set()
        self._exec = new
        self._sync_replicas()

    def _sync_replicas(self) -> None:
        """Copy the master parameters into the replica of every row of the
        training region but the home row (bit-equal copies); rows that left
        the region drop theirs."""
        rows = range(1, self.train_extent)
        self._replica_source = self.params
        for row in [r for r in self._replicas if r not in rows]:
            del self._replicas[row]
        for row in rows:
            rep = self._replicas.get(row)
            if rep is None:
                self._replicas[row] = {
                    k: v.to(self.devices[row], copy=True)
                    for k, v in self.params.items()}
            else:
                for k, v in self.params.items():
                    rep[k].copy_(v)

    def _params_at(self, row: int, params: dict) -> dict:
        """``params`` on row ``row``'s device: the replica there when they
        are the master the replicas were copied from, else (a stale ASP
        read) a copy made for this call."""
        if row == 0:
            return params
        if params is self._replica_source:
            return self._replicas[row]
        return {k: v.to(self.devices[row]) for k, v in params.items()}

    def _await_pool(self) -> ThreadPoolExecutor:
        """Threads for the workers' calls and their awaiters (one each per
        in-flight worker, so no call or await ever queues); grown on
        membership.  Its creation loads the kernel libraries, on the main
        thread, when the axis has a card."""
        if self._pool is None or self._pool_size < 2 * self.k:
            if any(d.type == "cuda" for d in self.devices):
                kernel_build.load_all()
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            self._pool_size = max(2 * self.k, 4)
            self._pool = ThreadPoolExecutor(
                max_workers=self._pool_size, thread_name_prefix="mesh-worker")
        return self._pool

    # ------------------------------------------------------------- planning

    def bucket_for(self, worker: int, batch: int) -> int:
        """Worker's ladder rung for ``batch`` (anchored at its slice)."""
        rec = self._exec[worker]
        return bucket_up(batch, base=rec.bucket_base, growth=self.growth,
                         quantum=rec.quantum)

    def bucket(self, batch: int) -> int:
        """Full-axis ladder rung (the shared record's shape for ``batch``)."""
        return bucket_up(batch, base=self.bucket_base, growth=self.growth,
                         quantum=self.quantum)

    def _initial_batches(self) -> list[int]:
        cfg = self.cfg
        outer_active = (cfg.batching == "dynamic"
                        and cfg.global_batch.kind != "fixed")
        if cfg.batching == "uniform" or (
            cfg.batching == "dynamic" and cfg.init_allocation == "uniform"
            and not outer_active
        ):
            return [cfg.b0] * self.k
        # open-loop init on the devices: a PROBE round (one measured call
        # per worker at b0, gradients discarded) replaces the simulator's
        # throughput peek; the measurements also seed the event engine's
        # rate model, so an ASP run's first schedule is measurement-ordered
        times = []
        for k in range(self.k):
            t = self._measured_worker_grad(k, cfg.b0)[3]
            self.time_model.observe(k, cfg.b0, t)
            times.append(t)
        if outer_active:
            # the devices expose no memory-cliff capacities or spot prices,
            # so the outer kinds' cost-aware start reduces to the
            # measured-throughput split of K*b0
            return cost_aware_allocation(
                [cfg.b0 / t for t in times], self.k * cfg.b0)
        return static_allocation([cfg.b0 / t for t in times], cfg.b0)

    # ------------------------------------------------------------ gradients

    def _prepare(self, worker: int, batch_size: int):
        """Fetch and place one worker's bucket: ``(record, shards, fresh)``.

        Fetches bucket-many examples and masks the tail (the first b_k
        stream examples are those of an unpadded fetch), then splits the
        bucket into equal contiguous row shards, one on each device of the
        worker's record.  SUFFIX-PADDING CONTRACT: the mask ``arange(bucket)
        < batch_size`` is the single source of truth for which rows are
        real; valid rows always form a prefix, padding a suffix, and a
        prefix restricted to a contiguous shard is still a prefix, so
        ``lm_workload(use_kernel=True)`` recovers each shard's ``num_valid``
        by counting its mask.
        """
        rec = self._exec[worker]
        bucket = self.bucket_for(worker, batch_size)
        self.worker_buckets[worker].add(bucket)
        data = self.next_batch(worker, bucket)
        mask = (torch.arange(bucket, device=self.device)
                < batch_size).to(torch.float32)
        n = bucket // len(rec.rows)
        shards = []
        for j, row in enumerate(rec.rows):
            dev = self.devices[row]
            shards.append(({key: x[j * n:(j + 1) * n].to(dev)
                            for key, x in data.items()},
                           mask[j * n:(j + 1) * n].to(dev)))
        fresh = bucket not in rec.warm
        rec.warm.add(bucket)
        return rec, shards, fresh

    def _slice_call(self, rec: _WorkerExec, params: dict,
                    shards: list) -> tuple:
        """One worker's gradient call over its slice: each device's masked
        gradient SUM over its rows, then ``weighted_psum`` on the slice's
        first device; ``(g_mean, loss_sum, w_sum[, |g_mean|^2])`` there."""
        parts = []
        for row, (data, mask) in zip(rec.rows, shards):
            with _device_scope(self.devices[row]):
                (loss_sum, w_sum, _aux), grads = self._loss_and_grad(
                    self._params_at(row, params), data, mask)
            parts.append((grads, loss_sum, w_sum))
        (g0, loss_sum, w0), rest = parts[0], parts[1:]
        others = [(g, w) for g, _, w in rest]
        w_sum = w0
        with _device_scope(self.devices[rec.rows[0]]):
            for _, ls, w in rest:
                loss_sum = loss_sum + ls.to(loss_sum.device)
                w_sum = w_sum + w.to(w_sum.device)
            if self._need_grad_stats:
                g, sqn = weighted_psum_with_sqnorm(g0, w0, others)
                return g, loss_sum, w_sum, sqn
            return weighted_psum(g0, w0, others), loss_sum, w_sum

    def _finish(self, worker: int, out: tuple, seconds: float):
        """A finished call's ``(g_mean on the home device, loss_sum,
        weight_sum, dilated seconds)``; keeps its |g_k|^2 for the caller."""
        # the loss and weight sums (and |g_k|^2) reach the host together
        host = torch.stack(list(out[1:])).tolist()
        self._last_sqnorm = float(host[2]) if self._need_grad_stats else None
        g = {name: x.to(self.device) for name, x in out[0].items()}
        return g, float(host[0]), float(host[1]), \
            seconds * self.dilation[worker]

    def _measured_worker_grad(self, worker: int, batch_size: int):
        """One timed gradient call for ``worker`` over its bucket, alone, on
        the main thread.

        Returns ``(g_mean, loss_sum, weight_sum, seconds)``, seconds being
        the warm, dilated time of the call.  The probe round, the
        sequential round and ASP come through here; concurrent BSP rounds
        use :meth:`_dispatch`.
        """
        params = self.params
        rec, shards, fresh = self._prepare(worker, batch_size)
        first = self.devices[rec.rows[0]]

        def call():
            return self._slice_call(rec, params, shards)

        with _device_scope(first):
            out, dt = _timed(call, first)
            self.accum_calls += 1
            if fresh:
                # the first call at a bucket paid for warm-up: run it
                # again, alone, from the same data (result identical and
                # discarded)
                self.timing_reruns += 1
                _, dt = _timed(call, first)
        return self._finish(worker, out, dt)

    def _launch(self, rec: _WorkerExec, params: dict, shards: list):
        """A dispatched call, as its worker thread runs it: ``(out,
        events)``, events the CUDA start and end events around it on the
        slice's first device when that is a card (None on the CPU)."""
        first = self.devices[rec.rows[0]]

        def call():
            return self._slice_call(rec, params, shards)

        if first.type != "cuda":
            return call(), None
        with _device_scope(first):
            return _recorded(call, first)

    def _dispatch(self, worker: int, batch_size: int) -> _Dispatch:
        """Draw and place one worker's batch here, on the main thread, then
        start its call on the worker's thread without waiting."""
        return self._start(worker, *self._prepare(worker, batch_size))

    def _start(self, worker: int, rec: _WorkerExec, shards: list,
               fresh: bool) -> _Dispatch:
        """Stamp the dispatch and start a prepared call on its thread."""
        pool = self._await_pool()
        t0 = _time.perf_counter()
        call = pool.submit(self._launch, rec, self.params, shards)
        self.accum_calls += 1
        return _Dispatch(worker=worker, call=call, t0=t0, fresh=fresh,
                         shards=shards)

    def _solo_rerun(self, d: _Dispatch) -> float:
        """Warm-up-free timing: the call was the first at its bucket, so run
        it again, alone, on the main thread, from the same shards (result
        identical and discarded)."""
        self.timing_reruns += 1
        rec = self._exec[d.worker]
        first = self.devices[rec.rows[0]]
        with _device_scope(first):
            _, dt = _timed(
                lambda: self._slice_call(rec, self.params, d.shards), first)
        return dt

    def _observe_time(self, worker: int, seconds: float) -> float:
        """EWMA filter over measured step times (measurement pipeline; the
        controller applies its own ``ewma_alpha`` smoothing on top)."""
        prev = self._ewma[worker]
        cur = seconds if prev is None else (
            self.time_alpha * seconds + (1 - self.time_alpha) * prev)
        self._ewma[worker] = cur
        return cur

    # ------------------------------------------------------------------ BSP

    def _round_concurrent(self):
        """All workers in flight at once; max-of-workers wall time.

        Split into :meth:`_dispatch_round` / :meth:`_collect_round` so the
        co-located trainer can run decode work on its dedicated serve slice
        while the training calls are in flight.
        """
        return self._collect_round(self._dispatch_round())

    def _dispatch_round(self) -> list[_Dispatch]:
        """Draw and place every worker's batch, in worker order, then start
        every call: placing a batch on the CPU waits for the card's queue,
        which must not hold a call of this round yet."""
        prepared = [self._prepare(k, self.batches[k]) for k in range(self.k)]
        return [self._start(k, *p) for k, p in enumerate(prepared)]

    def _submit_awaiters(self, dispatches: list[_Dispatch]) -> list:
        """Start one awaiter per in-flight worker NOW, so completions are
        stamped the moment they land even if the main thread goes on to do
        other work (the co-located trainer runs its decode loop here)."""
        pool = self._await_pool()
        return [pool.submit(_ready_timestamp, d) for d in dispatches]

    def _collect_round(self, dispatches: list[_Dispatch], futures=None):
        """Wait for every worker's completion stamp (a worker's exception
        re-raises here, after all calls have ended); gather grads on the
        home device, losses and raw times."""
        if futures is None:
            futures = self._submit_awaiters(dispatches)
        wait(futures)
        stamps = [f.result() for f in futures]
        # (dispatch, completion) per worker: max(dispatch) < min(completion)
        # means all K calls were in flight at once
        self.last_round_stamps = [(d.t0, done)
                                  for d, done in zip(dispatches, stamps)]
        grads, losses, weights, raw_times, sqnorms = [], 0.0, 0.0, [], []
        for d, done in zip(dispatches, stamps):
            out, events = d.call.result()
            dt = _call_seconds(events, d.t0, done)
            if d.fresh:
                dt = self._solo_rerun(d)
            g, ls, ws, dt = self._finish(d.worker, out, dt)
            grads.append(g)
            losses += ls
            weights += ws
            raw_times.append(dt)
            if self._last_sqnorm is not None:
                sqnorms.append(self._last_sqnorm)
        return grads, losses, weights, raw_times, sqnorms

    def _round_sequential(self):
        """Time-multiplex the training region: worker after worker
        (sum-of-workers)."""
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

    def _charge_interference(self, raw_times: list[float]) -> list[float]:
        """Hook: the co-located trainer adds measured decode seconds to the
        worker whose devices the serve loop time-multiplexes, so the
        controller, the engine clock and the step records all see the
        interference.  Base trainer: no-op."""
        return raw_times

    def bsp_step(self) -> StepRecord:
        pre_batches = list(self.batches)
        if self.concurrent and self.k > 1:
            grads, losses, weights, raw_times, sqnorms = \
                self._round_concurrent()
        else:
            grads, losses, weights, raw_times, sqnorms = \
                self._round_sequential()
        raw_times = self._charge_interference(raw_times)
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
        self._sync_replicas()
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
            # a B_global resize needs no slice replan: each worker's grown
            # batch walks its own bucket ladder
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
        is computed, for real, on its slice against the params it last
        read, applied with the paper's staleness-weighted lambda scaling,
        and the measured duration updates the rate model so the emulated
        timeline tracks the devices.  Staleness and versioning are those of
        ``HeterogeneousTrainer.asp_step`` (the queue is the same engine).
        """
        eng = self.engine
        if not eng.scheduled:
            eng.asp_schedule(self.batches, payload=self.params)
        ev = eng.asp_next(self.batches)
        i = ev.worker
        # gradient on stale params (the params this worker last read)
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
        self._sync_replicas()
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
        invariant), survivors keep controller and measurement state, and
        the departed worker's devices rejoin the survivors' slices."""
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
        """A replacement joins and gets a carved-out slice (model state is
        already replicated).  ``spec`` changes no hardware; it seeds the
        newcomer's dilation when heterogeneity is emulated
        (``MeshBackend(dilation="from-spec")``)."""
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
                                      and self.k <= self.train_extent)
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
        """Churn replan from MEASURED throughput: the devices expose no
        simulator capacities or spot prices, so the cost-aware allocator
        reduces to the measured-throughput split, with controller state
        kept through ``apply_allocation``; slices are not replanned (batch
        shares move, devices stay)."""
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

    def slice_devices(self, start: int, length: int) -> list:
        """The device of each data-axis row in ``[start, start+length)``:
        the serve region's placement handles (the disaggregated decode
        engine pins one shard a row)."""
        if start < 0 or length < 1 or start + length > self.data_extent:
            raise ValueError(
                f"rows [{start}, {start + length}) outside the "
                f"{self.data_extent}-row data axis")
        return self.devices[start:start + length]

    def set_reserve(self, n: int) -> None:
        """Resize the reserved serve region at the top of the data axis.

        The preemption policy's replan path: growing the reserve makes
        training *yield* devices to the serve slice, shrinking it returns
        them; either way the worker slices replan through
        :meth:`_reconfigure_execution` exactly like a membership event, so
        controller and measurement state survive untouched.
        """
        if n == self.reserve:
            return
        self._check_reserve(n)
        self.reserve = n
        self.train_extent = self.data_extent - n
        self.quantum = self.train_extent
        self.bucket_base = self.quantum * -(-self.cfg.microbatch
                                            // self.quantum)
        self._reconfigure_execution()

    def _check_reserve(self, n: int) -> None:
        if n < 0 or self.data_extent - n < 1:
            raise ValueError(
                f"reserving {n} of {self.data_extent} data-axis devices "
                f"would leave no training devices — training fully "
                f"preempted; the serve slice may not take the whole axis")

    # ------------------------------------------------------------ checkpoint

    def exec_state_dict(self) -> dict:
        """Execution state for ``Session.save``: the data extent, the serve
        reserve, the slice assignment, measurement EWMAs, the engine's rate
        model and clock, the buckets visited and the dilation factors, in
        the reference's layout (JSON for the checkpoint's metadata)."""
        return {
            "extent": self.data_extent,
            "reserve": self.reserve,
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
        if int(st["extent"]) != self.data_extent:
            raise ValueError(
                f"checkpoint was taken on a mesh with data extent "
                f"{st['extent']}, this mesh has {self.data_extent} — "
                f"rebuild the Experiment on a matching mesh")
        # the serve reserve may have been resized by the preemption policy
        # since construction; the slices are checked against the training
        # region the restored reserve leaves
        reserve = int(st.get("reserve", 0))
        if reserve != self.reserve:
            self._check_reserve(reserve)
        train_extent = self.data_extent - reserve
        concurrent = self._want_concurrent and self.k <= train_extent
        slices = st["slices"]
        if bool(st["concurrent"]) != (slices is not None) or \
                (slices is None) == concurrent:
            raise ValueError(
                "checkpoint and session disagree on concurrent slicing "
                "(worker count vs data-axis width changed, or inconsistent "
                "checkpoint payload?)")
        if slices is None:
            return None
        return SlicePlan(extent=train_extent, quantum=1,
                         slices=tuple((int(a), int(b)) for a, b in slices))

    def load_exec_state_dict(self, st: dict) -> None:
        """Inverse of :meth:`exec_state_dict` (bit-identical controller-
        facing state; warm buckets are relearnt on the first call at each
        bucket after the restore).  The replicas are copied from the master
        parameters the session has just restored."""
        plan = self.check_exec_state_dict(st)
        self.set_reserve(int(st.get("reserve", 0)))
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
        self._sync_replicas()


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
