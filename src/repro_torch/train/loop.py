"""Heterogeneous data-parallel training loop (multislice mode), in PyTorch.

K workers (heterogeneous simulated slices) each process a variable mini-batch
b_k as fixed-shape microbatches (core.batching); gradients are combined with
lambda_k weights (core.grad); iteration times come from the cluster simulator
(real SGD on the device, simulated clock); a pluggable dynamic-batching
controller (core.control) replans {b_k} online.

Execution: per worker step, one Python loop over the stacked microbatches
(`core.grad.accumulate_microbatch_grads`) keeps gradient, loss and weight
sums on the device; the loss and weight sums (and, for the outer kinds that
need it, the mean gradient's |g_k|^2) come back to the host once per worker
step.  The reference's trace counters and per-LR-scale jit cache have no
counterpart in eager PyTorch; ``accum_calls`` stays.

Two-level batch control (DESIGN.md §15): a non-fixed
``TrainConfig.global_batch`` kind adds the outer controller, which walks
the global batch along its ladder while the inner law splits it.

Batching policies (paper §III): 'uniform', 'static', 'dynamic'.
Synchronisation: 'bsp' or 'asp', both through train.engine.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Optional

import torch

from repro_torch.core import (
    ControllerConfig,
    GlobalBatchConfig,
    GradStats,
    accumulate_microbatch_grads,
    combine_weighted,
    combine_weighted_with_sqnorm,
    cost_aware_allocation,
    largest_remainder_round,
    make_controller,
    make_global_controller,
    plan_microbatches,
    static_allocation,
    tree_sqnorm,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.het.simulator import ClusterSim
from repro_torch.optim.optimizers import Optimizer
from repro_torch.optim.schedules import BatchCoupledSchedule
from repro_torch.train.engine import EventEngine


@dataclasses.dataclass
class TrainConfig:
    b0: int = 32                     # per-worker nominal batch (global = K*b0)
    microbatch: int = 8              # fixed compiled shape
    batching: str = "dynamic"        # 'uniform' | 'static' | 'dynamic'
    init_allocation: str = "static"  # 'uniform' | 'static' (dynamic's start)
    sync: str = "bsp"                # 'bsp' | 'asp'
    controller: ControllerConfig = dataclasses.field(
        default_factory=ControllerConfig)
    global_batch: GlobalBatchConfig = dataclasses.field(
        default_factory=GlobalBatchConfig)
    max_steps: int = 1000
    target_loss: Optional[float] = None
    loss_ewma: float = 0.1           # smoothing for the stop criterion
    seed: int = 0
    log_every: int = 50

    _BATCHING = ("uniform", "static", "dynamic")
    _SYNC = ("bsp", "asp")
    _INIT_ALLOCATION = ("uniform", "static")

    def __post_init__(self) -> None:
        """Fail fast on typos: ``sync='asynch'`` used to silently run ASP's
        else-branch; now every enum-like field is validated."""
        if self.batching not in self._BATCHING:
            raise ValueError(
                f"batching must be one of {self._BATCHING}, got {self.batching!r}")
        if self.sync not in self._SYNC:
            raise ValueError(
                f"sync must be one of {self._SYNC}, got {self.sync!r}")
        if self.init_allocation not in self._INIT_ALLOCATION:
            raise ValueError(f"init_allocation must be one of "
                             f"{self._INIT_ALLOCATION}, got {self.init_allocation!r}")
        if self.b0 < 1:
            raise ValueError(f"b0 must be >= 1, got {self.b0}")
        if self.microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {self.microbatch}")
        if self.microbatch > self.b0:
            raise ValueError(
                f"microbatch ({self.microbatch}) must be <= b0 ({self.b0})")
        if self.max_steps < 1:
            raise ValueError(f"max_steps must be >= 1, got {self.max_steps}")
        if not (0.0 < self.loss_ewma <= 1.0):
            raise ValueError(
                f"loss_ewma must be in (0, 1], got {self.loss_ewma}")
        if not isinstance(self.global_batch, GlobalBatchConfig):
            raise TypeError(
                f"global_batch must be a GlobalBatchConfig, "
                f"got {type(self.global_batch).__name__}")
        if (self.global_batch.kind in ("gns", "dynamix")
                and self.sync != "bsp"):
            raise ValueError(
                f"global_batch kind={self.global_batch.kind!r} consumes "
                "per-worker gradient moments of one BSP round; use "
                "sync='bsp' ('geometric'/'bandit' also run on ASP)")


@dataclasses.dataclass
class StepRecord:
    step: int
    sim_time: float
    iteration_time: float
    loss: float
    batches: list
    adjusted: bool
    straggler_waste: float
    worker_times: Optional[list] = None   # per-worker times (BSP rounds)


class OuterBatchMixin:
    """Two-level batch control glue (the outer B_global controller).

    Owns the outer controller (DESIGN.md §15): construction (only for
    non-'fixed' kinds, so the fixed path stays bit-for-bit the pre-existing
    code), applying resizes through the inner controller's
    `set_global_batch`, coupling the LR schedule to the batch ratio, and
    checkpoint serde.  Host-side only; expects the host class to provide
    ``cfg``, ``batches``, ``controller``, ``optimizer`` and ``k``.
    """

    outer = None

    def _init_outer(self) -> None:
        """Construct the outer controller (call once batches/controller exist).

        The ladder quantum is 1 so rung 0 equals the exact initial global
        batch — the first resize, not construction, is the first deviation
        from the fixed-batch trajectory.
        """
        cfg = self.cfg
        self.outer = None
        self._need_grad_stats = cfg.global_batch.needs_grad_stats
        if cfg.global_batch.kind == "fixed":
            return
        self.outer = make_global_controller(
            cfg.global_batch, b0=sum(self.batches), quantum=1)
        sched = getattr(self.optimizer, "schedule", None)
        if isinstance(sched, BatchCoupledSchedule):
            # reset a (possibly reused) coupled schedule to ratio 1
            sched.set_batch_ratio(1.0)

    def _apply_global_batch(self, total: int) -> list[int]:
        """Commit an outer resize: rescale the split, re-couple the LR."""
        if self.controller is not None:
            self.batches = list(self.controller.set_global_batch(total))
        else:
            cur = sum(self.batches)
            self.batches = largest_remainder_round(
                [b * total / max(cur, 1) for b in self.batches],
                int(total), lo=1)
        self._couple_lr(total)
        return self.batches

    def _couple_lr(self, total: int) -> None:
        """Re-evaluate a batch-coupled LR schedule at the new B_global.

        The optimizers read ``schedule(step)`` at every update, so the new
        scale takes effect at the next one; no per-scale copy of the update
        is kept (the reference needs one per jit trace).
        """
        if self.outer is None:
            return
        sched = getattr(self.optimizer, "schedule", None)
        if isinstance(sched, BatchCoupledSchedule):
            sched.set_batch_ratio(total / self.outer.b0)

    def _worker_prices(self) -> Optional[list]:
        """Hook: per-worker spot prices for the outer context (or None)."""
        return None

    def _queue_signal(self) -> Optional[float]:
        """Hook: serve-queue depth for the outer context (or None)."""
        return None

    def _outer_context(self, worker_times=None) -> dict:
        """System context for context-aware outer kinds (DESIGN.md §18)."""
        ctx = {}
        if worker_times:
            ctx["worker_times"] = [float(t) for t in worker_times]
        prices = self._worker_prices()
        if prices:
            ctx["prices"] = [float(p) for p in prices]
        q = self._queue_signal()
        if q is not None:
            ctx["queue"] = float(q)
        return ctx

    def _observe_outer(self, *, loss: float, seconds: float,
                       sqnorms=None, pre_batches=None,
                       combined_sqnorm=None, worker_times=None) -> bool:
        """Feed the outer controller one step; apply a resize if it fires."""
        if self.outer is None:
            return False
        stats = None
        if self._need_grad_stats and sqnorms is not None:
            stats = GradStats(per_worker_sqnorm=list(sqnorms),
                              batches=list(pre_batches),
                              combined_sqnorm=float(combined_sqnorm))
        new_total = self.outer.observe(
            loss=loss, seconds=seconds, stats=stats,
            context=self._outer_context(worker_times))
        if new_total is None:
            return False
        self._apply_global_batch(new_total)
        return True

    def set_outer(self, outer) -> None:
        """Install an outer controller rebuilt from a checkpoint payload
        (``global_batch_from_state_dict``) and re-couple the LR to its
        B_global."""
        self.outer = outer
        self._need_grad_stats = outer.config.needs_grad_stats
        self._couple_lr(outer.b_global)


class HeterogeneousTrainer(OuterBatchMixin):
    """Drives (loss_and_grad, next_batch, optimizer) under simulated heterogeneity.

    loss_and_grad(params, batch, mask) -> ((loss_sum, w_sum, aux), grads)
        called with fixed microbatch shapes only.  CONTRACT: grads must be
        the gradient of the *weighted SUM* loss (loss_sum), NOT the mean —
        the trainer accumulates grad sums across microbatches and divides by
        the total weight once (exact Eq. 2-3 weighting).
    next_batch(worker, n) -> dict of tensors with leading dim n, on ``device``.
    init_params(generator) -> flat parameter dict on the generator's device;
        the generator is seeded with ``cfg.seed``.
    """

    backend_kind = "sim"

    def __init__(
        self,
        *,
        init_params: Callable,
        loss_and_grad: Callable,
        next_batch: Callable,
        optimizer: Optimizer,
        sim: ClusterSim,
        cfg: TrainConfig,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.sim = sim
        self.device = resolve_device(device)
        self.k = len(sim.workers)
        self.next_batch = next_batch
        self.optimizer = optimizer
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.params = init_params(gen)
        self.opt_state = optimizer.init(self.params)
        self.step_idx = 0
        self._loss_and_grad = loss_and_grad
        self.history: list[StepRecord] = []
        self.accum_calls = 0      # accumulation calls (one per worker step)
        self.engine = EventEngine(sim)
        self.batches = self._initial_batches()
        self.controller = None
        if cfg.batching == "dynamic":
            self.controller = make_controller(self.batches, cfg.controller)
        self._init_outer()
        self._outer_last_time = self.sim.time

    # ------------------------------------------------------------- planning

    def _worker_prices(self) -> Optional[list]:
        # spot prices live on the worker specs; the outer policy reads them
        # as context
        return [w.price for w in self.sim.workers]

    def _initial_batches(self) -> list[int]:
        cfg = self.cfg
        if cfg.batching == "dynamic" and cfg.global_batch.kind != "fixed":
            # the outer controller's initial B_global goes through the
            # price/capacity-aware allocator (DESIGN.md §15): the same
            # RNG-free peek throughputs, plus each worker's memory-cliff
            # capacity and spot price from its spec
            xput = [self.sim.peek_throughput(i, cfg.b0) for i in range(self.k)]
            return cost_aware_allocation(
                xput, self.k * cfg.b0,
                capacities=[w.b_mem for w in self.sim.workers],
                prices=[w.price for w in self.sim.workers])
        if cfg.batching == "uniform" or (
            cfg.batching == "dynamic" and cfg.init_allocation == "uniform"
        ):
            return [cfg.b0] * self.k
        # open-loop: proportional to modelled worker throughput at b0, from
        # the RNG-free peek path so planning never perturbs the jitter stream
        xput = [self.sim.peek_throughput(i, cfg.b0) for i in range(self.k)]
        return static_allocation(xput, cfg.b0)

    # --------------------------------------------------------- degradation

    def slow_worker(self, k: int, factor: float) -> None:
        """Multiplicative slowdown of worker ``k`` (``factor`` > 1 = slower);
        the spec is replaced, never mutated."""
        if not (0 <= k < self.k):
            raise ValueError(f"no worker {k} in a {self.k}-cluster")
        if not (factor > 0):
            raise ValueError(f"slowdown factor must be positive, got {factor}")
        spec = self.sim.workers[k]
        self.sim.workers[k] = dataclasses.replace(
            spec, flops_ratio=spec.flops_ratio / factor)

    # ------------------------------------------------------------ gradients

    def _worker_grad(self, worker: int, batch_size: int):
        """Mean gradient over worker's b_k examples, plus its loss and
        weight sums as host floats (one device->host transfer, which also
        carries |g_k|^2 into ``_last_sqnorm`` when the outer kind needs
        it)."""
        cfg = self.cfg
        plan = plan_microbatches(batch_size, cfg.microbatch)
        data = self.next_batch(worker, plan.padded_examples)
        stacked = {k: x.reshape((plan.n_steps, cfg.microbatch) + x.shape[1:])
                   for k, x in data.items()}
        masks = torch.as_tensor(plan.masks(), device=self.device)
        g_sum, loss_sum, w_sum, _aux = accumulate_microbatch_grads(
            self._loss_and_grad, self.params, stacked, masks)
        # mean gradient over the worker's examples (divide ONCE), in place
        denom = torch.clamp(w_sum, min=1e-9)
        for g in g_sum.values():
            g.div_(denom)
        self.accum_calls += 1
        if self._need_grad_stats:
            ls, ws, sq = torch.stack(
                [loss_sum, w_sum, tree_sqnorm(g_sum)]).tolist()
            self._last_sqnorm = float(sq)
        else:
            ls, ws = torch.stack([loss_sum, w_sum]).tolist()
            self._last_sqnorm = None
        return g_sum, float(ls), float(ws)

    # ------------------------------------------------------------------ BSP

    def bsp_step(self) -> StepRecord:
        grads, losses, weights = [], 0.0, 0.0
        pre_batches = list(self.batches)
        sqnorms = []
        for k in range(self.k):
            g, ls, ws = self._worker_grad(k, self.batches[k])
            grads.append(g)
            losses += ls
            weights += ws
            if self._need_grad_stats:
                sqnorms.append(self._last_sqnorm)
        # Eq. 2-3: lambda-weighted combine
        if self._need_grad_stats:
            g, g_sqnorm = combine_weighted_with_sqnorm(grads, self.batches)
        else:
            g = combine_weighted(grads, self.batches)
            g_sqnorm = None
        del grads
        self.params, self.opt_state = self.optimizer.update(
            self.params, g, self.opt_state, self.step_idx)
        if g_sqnorm is not None:
            # read back after the update is queued: one sync per step
            g_sqnorm = float(g_sqnorm)
        info = self.engine.bsp_round(self.batches)
        adjusted = False
        if self.controller is not None:
            upd = self.controller.observe(info["worker_times"])
            adjusted = upd.updated
            self.batches = upd.batches
        if self._observe_outer(
                loss=losses / max(weights, 1e-9),
                seconds=info["iteration_time"],
                sqnorms=sqnorms or None, pre_batches=pre_batches,
                combined_sqnorm=g_sqnorm,
                worker_times=info["worker_times"]):
            adjusted = True
        rec = StepRecord(
            step=self.step_idx,
            sim_time=self.sim.time,
            iteration_time=info["iteration_time"],
            loss=losses / max(weights, 1e-9),
            batches=list(self.batches),
            adjusted=adjusted,
            straggler_waste=info["straggler_waste"],
            worker_times=list(info["worker_times"]),
        )
        self.history.append(rec)
        self.step_idx += 1
        return rec

    # ------------------------------------------------------------------ ASP

    def asp_step(self) -> StepRecord:
        """One global ASP update (next worker to finish pushes its gradient),
        computed on the params that worker last read."""
        eng = self.engine
        if not eng.scheduled:
            eng.asp_schedule(self.batches, payload=self.params)
        ev = eng.asp_next(self.batches)
        i = ev.worker
        saved = self.params
        self.params = eng.get_payload(i)
        g, ls, ws = self._worker_grad(i, self.batches[i])
        self.params = saved
        lam = self.batches[i] / sum(self.batches)
        g = {name: lam * self.k * x for name, x in g.items()}
        self.params, self.opt_state = self.optimizer.update(
            self.params, g, self.opt_state, self.step_idx)
        eng.set_payload(i, self.params)
        adjusted = False
        if self.controller is not None and eng.version % self.k == 0:
            # RNG-free peek: observation must not consume the jitter stream
            times = [self.sim.peek_iteration_time(j, self.batches[j])
                     for j in range(self.k)]
            upd = self.controller.observe(times)
            adjusted = upd.updated
            self.batches = upd.batches
        if self.outer is not None and eng.version % self.k == 0:
            # outer cadence matches the inner one: every K pushed versions
            # (~one whole-cluster sweep); gns is BSP-only (config-validated),
            # so no stats here — seconds are the simulated span of the sweep
            elapsed = self.sim.time - self._outer_last_time
            self._outer_last_time = self.sim.time
            if self._observe_outer(loss=ls / max(ws, 1e-9),
                                   seconds=max(elapsed, 0.0)):
                adjusted = True
        rec = StepRecord(
            step=self.step_idx, sim_time=self.sim.time,
            iteration_time=float(ev.time), loss=ls / max(ws, 1e-9),
            batches=list(self.batches), adjusted=adjusted,
            straggler_waste=float(ev.staleness),
        )
        self.history.append(rec)
        self.step_idx += 1
        return rec

    # ------------------------------------------------------------------ run

    def run(self) -> dict:
        """The closed loop: up to ``cfg.max_steps`` steps, stopping once the
        EWMA-smoothed loss reaches ``cfg.target_loss``."""
        cfg = self.cfg
        smoothed = None
        wall0 = _time.perf_counter()
        for _ in range(cfg.max_steps):
            rec = self.bsp_step() if cfg.sync == "bsp" else self.asp_step()
            smoothed = rec.loss if smoothed is None else (
                cfg.loss_ewma * rec.loss + (1 - cfg.loss_ewma) * smoothed)
            if cfg.target_loss is not None and smoothed <= cfg.target_loss:
                break
        return {
            "steps": self.step_idx,
            "sim_time": self.sim.time,
            "final_loss": smoothed,
            "reached_target": (cfg.target_loss is not None
                               and smoothed is not None
                               and smoothed <= cfg.target_loss),
            "wall_time": _time.perf_counter() - wall0,
            "batch_adjustments": (self.controller.num_updates
                                  if self.controller else 0),
            "outer_resizes": (self.outer.num_resizes
                              if self.outer is not None else 0),
            "history": self.history,
            "final_batches": list(self.batches),
        }
