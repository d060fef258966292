"""Heterogeneous data-parallel training loop (multislice mode), in PyTorch.

K workers (heterogeneous simulated slices) each process a variable mini-batch
b_k as fixed-shape microbatches (core.batching); gradients are combined with
lambda_k weights (core.grad); iteration times come from the cluster simulator
(real SGD on the device, simulated clock); a pluggable dynamic-batching
controller (core.control) replans {b_k} online.

Execution: per worker step, one Python loop over the stacked microbatches
(`core.grad.accumulate_microbatch_grads`) keeps gradient, loss and weight
sums on the device; the loss and weight sums come back to the host once per
worker step.  The reference's trace counters and per-LR-scale jit cache
have no counterpart in eager PyTorch; ``accum_calls`` stays.

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
    accumulate_microbatch_grads,
    combine_weighted,
    make_controller,
    plan_microbatches,
    static_allocation,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.het.simulator import ClusterSim
from repro_torch.optim.optimizers import Optimizer
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
        if self.global_batch.kind != "fixed":
            raise NotImplementedError(
                f"global_batch kind={self.global_batch.kind!r} is not ported "
                "yet: this slice runs kind='fixed' only (ROADMAP queue 1, "
                "non-fixed outer kinds with policy.py's TD step in torch)")


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

    This slice runs ``GlobalBatchConfig(kind="fixed")`` only (``TrainConfig``
    rejects the others), for which the outer controller does not exist and
    the paper's per-worker split is the whole story.  The hooks stay at the
    reference's call sites so the non-fixed slice fills them in.
    """

    outer = None

    def _observe_outer(self, **_) -> bool:
        return False


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

    # ------------------------------------------------------------- planning

    def _initial_batches(self) -> list[int]:
        cfg = self.cfg
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
        weight sums as host floats (one device->host transfer)."""
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
        ls, ws = torch.stack([loss_sum, w_sum]).tolist()
        return g_sum, float(ls), float(ws)

    # ------------------------------------------------------------------ BSP

    def bsp_step(self) -> StepRecord:
        grads, losses, weights = [], 0.0, 0.0
        for k in range(self.k):
            g, ls, ws = self._worker_grad(k, self.batches[k])
            grads.append(g)
            losses += ls
            weights += ws
        # Eq. 2-3: lambda-weighted combine
        g = combine_weighted(grads, self.batches)
        del grads
        self.params, self.opt_state = self.optimizer.update(
            self.params, g, self.opt_state, self.step_idx)
        info = self.engine.bsp_round(self.batches)
        adjusted = False
        if self.controller is not None:
            upd = self.controller.observe(info["worker_times"])
            adjusted = upd.updated
            self.batches = upd.batches
        if self._observe_outer(loss=losses / max(weights, 1e-9),
                               seconds=info["iteration_time"]):
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
