"""Co-located serving + training on one data axis (DESIGN.md §13).

The "heavy traffic + training" scenario: a continuous-batching decode loop
(``repro_torch.serve``) runs on a slice of the SAME devices the
dynamic-batching trainer owns, and the batch controller absorbs the
interference the way the paper's controller absorbs a background CPU
tenant — decode traffic is one more reason a worker's measured iteration
time went up.

:class:`ColocatedMeshTrainer` extends
:class:`repro_torch.train.mesh.MeshTrainer` with a serve slice carved from
the data axis (`core.placement.carve_serve`):

  * **shared** mode time-multiplexes the LAST training worker's devices:
    each round the decode loop runs first on them (serve-latency priority),
    its measured wall seconds are *charged* onto that worker's step time
    (:meth:`MeshTrainer._charge_interference`), and the controller shrinks
    that worker's batch until all workers, decode included, finish
    together again.  In a concurrent round the other workers' calls are
    already in flight while the decode loop runs; the contended worker
    starts once it has ended.  The charge is host wall time, as in the
    reference: every decode step reads its tokens back to the host, which
    waits for the device;
  * **dedicated** mode withholds ``ServeSpec.devices`` rows at the top of
    the data axis from training (``MeshTrainer(reserve=...)``); the decode
    loop runs while the training round is in flight, so on disjoint
    devices the two overlap, and nothing is charged.  The
    :class:`~repro_torch.serve.colocate.SLOPolicy` grows the slice when
    queue pressure breaches the serve SLO (training *yields* a device
    through :meth:`MeshTrainer.set_reserve`'s replan path) and returns it
    when traffic drains.  One device has none to withhold: training would
    be fully preempted, which ``MeshTrainer(reserve=...)`` raises.

Engines (``ServeSpec.engine``): ``"batcher"`` runs one
:class:`~repro_torch.serve.scheduler.ContinuousBatcher` on the serve
slice's first device; ``"disaggregated"`` one
:class:`~repro_torch.serve.slots.LMShard` per serve-region row behind a
:class:`~repro_torch.serve.engine.PrefillProgram` on the region's first
row, managed by a :class:`~repro_torch.serve.slots.KVSlotManager`.  When a
replan moves the region, the engine follows it by row: the batcher moves
its parameters and live caches, the disaggregated engine keeps the shards
of rows still in the region and gives new rows fresh shards
(``KVSlotManager.set_shards`` migrates or resumes the rest); either
re-warms.  Rows stand for the reference's devices, which a repeated
``"cpu"`` could not tell apart.  The decode model is the reduced config
``ServeSpec.arch`` with parameters drawn from
``torch.Generator(home device).manual_seed(serve.seed)``.

BSP only: the serve loop is driven once per barrier round, so the backend
rejects ``sync="asp"``.

Construct via :class:`repro_torch.api.backend.MeshBackend` with
``ClusterSpec(serve=ServeSpec(...))``, not directly.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.placement import ServeSlice
from repro_torch.models import init_lm, reduced
from repro_torch.serve.colocate import ServeSpec, SLOPolicy
from repro_torch.serve.engine import PrefillProgram
from repro_torch.serve.scheduler import ContinuousBatcher, on_device
from repro_torch.serve.slots import KVSlotManager, LMShard
from repro_torch.serve.traffic import make_traffic
from repro_torch.train.loop import StepRecord
from repro_torch.train.mesh import MeshTrainer


class ColocatedMeshTrainer(MeshTrainer):
    """MeshTrainer + a co-located continuous-batching decode loop.

    Presents the same Session-facing surface as :class:`MeshTrainer` plus
    :meth:`serve_stats` (decode latency percentiles, queue pressure, the
    interference charged, the preemption policy's actions), which
    ``Session.run`` reports under ``"serve"``.
    """

    def __init__(self, *, serve: ServeSpec, **kw):
        cfg = kw["cfg"]
        if cfg.sync != "bsp":
            raise ValueError(
                "co-located serving multiplexes the decode loop against BSP "
                "round boundaries; sync='asp' is not supported — drop the "
                "ServeSpec or use sync='bsp' (DESIGN.md §13)")
        reserve = serve.devices if serve.mode == "dedicated" else 0
        super().__init__(reserve=reserve, **kw)
        self.serve_spec = serve
        model_cfg = reduced(get_config(serve.arch))
        self.serve_model_cfg = model_cfg
        self.serve_slice: ServeSlice = self._serve_slice_now()
        gen = torch.Generator(device=self.device).manual_seed(serve.seed)
        serve_params = init_lm(gen, model_cfg)
        self._serve_params = serve_params
        sl = self.serve_slice
        if serve.engine == "disaggregated":
            # one decode shard per serve-region row + a prefill program on
            # the region's first row (DESIGN.md §17)
            self.prefill = PrefillProgram(serve_params, model_cfg,
                                          cache_len=serve.cache_len,
                                          device=self.devices[sl.start])
            self._prefill_row = sl.start
            self._shard_rows = {row: self._new_shard(row)
                                for row in self._serve_rows()}
            self.batcher = KVSlotManager(
                self._shard_rows.values(), self.prefill, eos_id=None,
                cache_len=serve.cache_len, extent=self.data_extent)
        else:
            self.prefill = None
            self._serve_row = sl.start
            self.batcher = ContinuousBatcher(
                serve_params, model_cfg,
                slots=serve.slots, cache_len=serve.cache_len,
                device=self.devices[sl.start])
        # the reference compiles the decode step here, so that no charged
        # step is the compiling one; the port runs the same throwaway step
        self.batcher.warmup()
        self.traffic = make_traffic(
            serve.traffic, rate=serve.requests_per_round,
            prompt_len=serve.prompt_len,
            max_new_tokens=serve.max_new_tokens,
            vocab_size=model_cfg.vocab_size, seed=serve.seed,
            peak_rate=serve.peak_rate, period=serve.period)
        self.policy = SLOPolicy(slo_queue_delay=serve.slo_queue_delay,
                                idle_patience=serve.idle_patience)
        self.policy_log: list[tuple[int, str, int]] = []
        self._decode_walls: list[float] = []
        self._charged_seconds = 0.0
        self._round_serve_seconds = 0.0
        # (start, end) perf_counter stamps of the last round's decode burst,
        # to set beside last_round_stamps: the decode loop overlapped the
        # in-flight training calls when the two intersect
        self.last_serve_window: tuple[float, float] | None = None
        # decode seconds charged (shared) or overlapped (dedicated) each
        # round, aligned with the step history
        self.round_charges: list[float] = []

    # ------------------------------------------------------ serve placement

    def _serve_slice_now(self) -> ServeSlice:
        """The decode loop's rows under the current placement: dedicated
        mode always owns the reserved rows at the top of the data axis;
        shared mode tracks the trainer's last slice, which membership
        replans may have resized, and the shared record shares the whole
        training region."""
        if self.serve_spec.mode == "dedicated":
            return ServeSlice(self.train_extent, self.reserve)
        if self.slice_plan is not None:
            start, length = self.slice_plan.slices[-1]
            return ServeSlice(start, length, shared_with=self.k - 1)
        return ServeSlice(0, self.train_extent, shared_with=self.k - 1)

    def _serve_rows(self) -> range:
        sl = self.serve_slice
        return range(sl.start, sl.start + sl.length)

    def _new_shard(self, row: int) -> LMShard:
        sp = self.serve_spec
        return LMShard(self._serve_params, self.serve_model_cfg,
                       slots=sp.slots, cache_len=sp.cache_len,
                       device=self.slice_devices(row, 1)[0])

    def _replace_serve(self) -> None:
        """Re-derive the serve slice after a replan; move the decode engine
        if its rows moved.

        Batcher engine: one device — its parameters and live KV caches move
        to the slice's first row, and it re-warms.  Disaggregated engine:
        shards whose row is still in the region stay live (their KV lanes
        untouched), the removed shards' occupied slots migrate or resume
        through :meth:`KVSlotManager.set_shards`, new rows get fresh shards,
        the prefill program follows the region's first row, and the engine
        re-warms, which also resets its decode-latency window.
        """
        self.serve_slice = self._serve_slice_now()
        start = self.serve_slice.start
        dev = self.slice_devices(start, 1)[0]
        if self.serve_spec.engine == "disaggregated":
            rows = self._serve_rows()
            if set(self._shard_rows) == set(rows):
                return
            self._shard_rows = {row: self._shard_rows.get(row)
                                or self._new_shard(row) for row in rows}
            self.batcher.set_shards(self._shard_rows.values())
            if self._prefill_row != start:
                self._prefill_row = start
                self.prefill.device = dev
                self.prefill.params = on_device(self.prefill.params, dev)
            self.batcher.warmup()
            return
        if self._serve_row != start:
            self._serve_row = start
            self.batcher.device = dev
            self.batcher.params = on_device(self.batcher.params, dev)
            self.batcher.caches = on_device(self.batcher.caches, dev)
            # live requests survive: the warm-up restores the state
            self.batcher.warmup()

    def set_reserve(self, n: int) -> None:
        super().set_reserve(n)
        if hasattr(self, "batcher"):
            self._replace_serve()

    def load_exec_state_dict(self, st: dict) -> None:
        super().load_exec_state_dict(st)
        # the restore may rebuild slices from the checkpoint's plan directly
        self._replace_serve()

    def remove_worker(self, k: int) -> None:
        super().remove_worker(k)
        self._replace_serve()

    def add_worker(self, spec) -> None:
        super().add_worker(spec)
        self._replace_serve()

    # -------------------------------------------------------- decode rounds

    def _serve_round(self) -> float:
        """Admit this round's arrivals, run the decode budget; return the
        measured decode wall seconds (0.0 when the engine is idle).

        The budget is ``decode_steps_per_round`` scheduler steps, per
        reserved row in dedicated mode on the batcher engine: a wider slice
        owns proportionally more device time, so a policy ``grow`` adds
        serving throughput.  The disaggregated engine's step already decodes
        every shard of the region, so its budget stays constant."""
        for req in self.traffic.next_round():
            self.batcher.submit(req)
        b = self.batcher
        if b.idle:
            return 0.0
        budget = self.serve_spec.decode_steps_per_round
        if self.serve_slice.dedicated \
                and self.serve_spec.engine != "disaggregated":
            budget *= self.serve_slice.length
        t0 = _time.perf_counter()
        for _ in range(budget):
            if b.idle:
                break
            t1 = _time.perf_counter()
            b.step()
            self._decode_walls.append(_time.perf_counter() - t1)
        t_end = _time.perf_counter()
        self.last_serve_window = (t0, t_end)
        return t_end - t0

    def _round_concurrent(self):
        if self.serve_slice.dedicated:
            # training in flight on its slices first, decode on the
            # disjoint serve slice meanwhile; the awaiters start BEFORE the
            # decode loop so each training completion is stamped when it
            # lands and the decode wall never inflates the (uncharged)
            # training times
            dispatches = self._dispatch_round()
            futures = self._submit_awaiters(dispatches)
            self._round_serve_seconds = self._serve_round()
            return self._collect_round(dispatches, futures)
        # shared devices: serve-latency priority holds on the CONTENDED
        # worker's slice only — the other workers' calls start first and
        # overlap the decode loop, the contended one once decode has
        # released its devices.  Every batch is drawn and placed first
        # (placing one on the CPU waits for a card's queue).  A worker's
        # time is its own completion minus its own dispatch, so the
        # ordering changes neither the measurement nor the charge.
        c = self.serve_slice.shared_with
        prepared = [self._prepare(k, self.batches[k]) for k in range(self.k)]
        others = [k for k in range(self.k) if k != c]
        dispatches = {k: self._start(k, *prepared[k]) for k in others}
        futures = dict(zip(others, self._submit_awaiters(
            [dispatches[k] for k in others])))
        self._round_serve_seconds = self._serve_round()
        dispatches[c] = self._start(c, *prepared[c])
        futures[c] = self._submit_awaiters([dispatches[c]])[0]
        return self._collect_round(
            [dispatches[k] for k in range(self.k)],
            [futures[k] for k in range(self.k)])

    def _round_sequential(self):
        self._round_serve_seconds = self._serve_round()
        return super()._round_sequential()

    def _charge_interference(self, raw_times: list[float]) -> list[float]:
        """Shared mode: the contended worker's step time absorbs the
        measured decode seconds (real wall time, undilated — the decode
        work is real)."""
        sl = self.serve_slice
        if sl.shared_with is not None and self._round_serve_seconds > 0.0:
            raw_times = list(raw_times)
            raw_times[sl.shared_with] += self._round_serve_seconds
            self._charged_seconds += self._round_serve_seconds
        return raw_times

    # ----------------------------------------------------- policy + records

    def bsp_step(self) -> StepRecord:
        self._round_serve_seconds = 0.0
        rec = super().bsp_step()
        self.round_charges.append(self._round_serve_seconds)
        self._maybe_apply_policy()
        return rec

    def _queue_signal(self):
        # serve-queue pressure feeds the outer dynamix policy's state vector
        return float(self.batcher.stats()["queued"])

    def _maybe_apply_policy(self) -> None:
        """Dedicated mode, every ``check_every`` rounds: apply the SLO
        policy through the replan path (grow = training yields a device,
        shrink = the freed device returns; floor = the spec's slice,
        ceiling = all but one data-axis device)."""
        sp = self.serve_spec
        if sp.mode != "dedicated" or self.step_idx % sp.check_every:
            return
        action = self.policy.decide(self.batcher.stats())
        if action == "grow":
            target = min(self.reserve + 1, self.data_extent - 1)
        elif action == "shrink":
            target = max(self.reserve - 1, sp.devices)
        else:
            return
        if target != self.reserve:
            self.set_reserve(target)
            self.policy_log.append((self.step_idx, action, target))

    def serve_stats(self) -> dict:
        """Decode-side run summary (``Session.run`` result key ``"serve"``):
        latency percentiles over measured scheduler steps, queue pressure,
        interference charged to training, and the policy's actions.  Its
        queue-delay percentiles cover every finished request of the run;
        the engine's windowed ``stats()`` is the policy's signal."""
        walls_ms = [1e3 * w for w in self._decode_walls]

        def pct(q):
            return float(np.percentile(walls_ms, q)) if walls_ms else 0.0

        delays = [r.started_step - r.arrived_step
                  for r in self.batcher.finished
                  if r.started_step is not None]
        stats = self.batcher.stats()
        out = {
            "mode": self.serve_spec.mode,
            "engine": self.serve_spec.engine,
            "traffic": self.serve_spec.traffic,
            "serve_slice": (self.serve_slice.start, self.serve_slice.length),
            "shared_with": self.serve_slice.shared_with,
            "reserve": self.reserve,
            "requests_submitted": self.traffic.submitted,
            "requests_finished": stats["finished"],
            "requests_queued": stats["queued"],
            "decode_steps": len(walls_ms),
            "decode_step_ms": {"p50": pct(50), "p95": pct(95),
                               "p99": pct(99)},
            # the engine's own window (reset by a re-warm), distinct from
            # the whole-run walls above
            "decode_step_ms_windowed": {
                "p50": stats.get("p50_decode_step_ms", 0.0),
                "p95": stats.get("p95_decode_step_ms", 0.0),
            },
            "queue_delay_steps": {
                "mean": float(np.mean(delays)) if delays else 0.0,
                "p95": (float(np.percentile(delays, 95))
                        if delays else 0.0),
            },
            "charged_seconds": self._charged_seconds,
            "policy_actions": list(self.policy_log),
        }
        if self.serve_spec.engine == "disaggregated":
            out["shards"] = stats["shards"]
            out["slots_total"] = stats["slots_total"]
            out["slot_migrations"] = stats["slot_migrations"]
            out["pool_migrations"] = stats["pool_migrations"]
            out["resumes"] = stats["resumes"]
            out["prefill"] = {"calls": stats["prefill_calls"],
                              "traces": stats["prefill_traces"]}
        return out
