"""Co-located serving + training on one device (DESIGN.md §13).

The "heavy traffic + training" scenario: a continuous-batching decode loop
(``repro_torch.serve``) shares the device the dynamic-batching trainer
owns, and the batch controller absorbs the interference the way the
paper's controller absorbs a background CPU tenant — decode traffic is one
more reason a worker's measured iteration time went up.

:class:`ColocatedMeshTrainer` extends
:class:`repro_torch.train.mesh.MeshTrainer` in **shared** mode, the one
mode one card has (the reference's too: a dedicated slice withholds data
axis devices, and withholding the only one leaves training fully
preempted, which ``MeshTrainer(reserve=...)`` raises).  Each round the
decode loop runs first (serve-latency priority), then the workers take the
card one after another; the decode loop's measured wall seconds are
*charged* onto the last worker's step time
(:meth:`MeshTrainer._charge_interference`), and the controller shrinks
that worker's batch until all workers, decode included, finish together
again.  The charge is host wall time, as in the reference: every decode
step reads its tokens back to the host, which waits for the card.

Engines (``ServeSpec.engine``): ``"batcher"`` runs one
:class:`~repro_torch.serve.scheduler.ContinuousBatcher`;
``"disaggregated"`` one :class:`~repro_torch.serve.slots.LMShard` per
serve-region row (one on one card) behind a
:class:`~repro_torch.serve.engine.PrefillProgram`, managed by a
:class:`~repro_torch.serve.slots.KVSlotManager`.  The decode model is the
reduced config ``ServeSpec.arch`` with parameters drawn from
``torch.Generator(device).manual_seed(serve.seed)``.

BSP only: the serve loop is driven once per barrier round, so the backend
rejects ``sync="asp"``.  Not here (slice 5b, more than one card): the
dedicated slice's concurrent round, ``set_reserve`` and the SLO policy's
actions; :class:`~repro_torch.serve.colocate.SLOPolicy` itself is ported.

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
from repro_torch.serve.scheduler import ContinuousBatcher
from repro_torch.serve.slots import KVSlotManager, LMShard
from repro_torch.serve.traffic import make_traffic
from repro_torch.train.loop import StepRecord
from repro_torch.train.mesh import EXTENT, MeshTrainer


class ColocatedMeshTrainer(MeshTrainer):
    """MeshTrainer + a co-located continuous-batching decode loop.

    Presents the same Session-facing surface as :class:`MeshTrainer` plus
    :meth:`serve_stats` (decode latency percentiles, queue pressure, the
    interference charged), which ``Session.run`` reports under ``"serve"``.
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
        if serve.engine == "disaggregated":
            # one decode shard per serve-region row + a prefill program on
            # the region's first device (DESIGN.md §17)
            region = self._serve_region_devices()
            self.prefill = PrefillProgram(serve_params, model_cfg,
                                          cache_len=serve.cache_len,
                                          device=region[0])
            shards = [LMShard(serve_params, model_cfg, slots=serve.slots,
                              cache_len=serve.cache_len, device=d)
                      for d in region]
            self.batcher = KVSlotManager(
                shards, self.prefill, eos_id=None,
                cache_len=serve.cache_len, extent=EXTENT)
        else:
            self.prefill = None
            self.batcher = ContinuousBatcher(
                serve_params, model_cfg,
                slots=serve.slots, cache_len=serve.cache_len,
                device=self.device)
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
        # (start, end) perf_counter stamps of the last round's decode burst
        self.last_serve_window: tuple[float, float] | None = None
        # decode seconds charged each round, aligned with the step history
        self.round_charges: list[float] = []

    # ------------------------------------------------------ serve placement

    def _serve_slice_now(self) -> ServeSlice:
        """The decode loop's rows under the current placement: shared mode
        tracks the trainer's last slice (a lone worker's), and the
        full-axis record shares everything."""
        if self.slice_plan is not None:
            start, length = self.slice_plan.slices[-1]
            return ServeSlice(start, length, shared_with=self.k - 1)
        return ServeSlice(0, EXTENT, shared_with=self.k - 1)

    def _serve_region_devices(self) -> list:
        """One device per serve-slice row — the disaggregated engine's
        shard placement."""
        sl = self.serve_slice
        return self.slice_devices(sl.start, sl.length)

    def _replace_serve(self) -> None:
        """Re-derive the serve slice after a membership change or a restore
        (its ``shared_with`` follows the last worker).  On one card the
        decode engine's device never moves, so nothing migrates and
        nothing re-warms."""
        self.serve_slice = self._serve_slice_now()

    def load_exec_state_dict(self, st: dict) -> None:
        super().load_exec_state_dict(st)
        self._replace_serve()

    def remove_worker(self, k: int) -> None:
        super().remove_worker(k)
        self._replace_serve()

    def add_worker(self, spec) -> None:
        super().add_worker(spec)
        self._replace_serve()

    # -------------------------------------------------------- decode rounds

    def _serve_round(self) -> float:
        """Admit this round's arrivals, run the decode budget
        (``decode_steps_per_round`` scheduler steps); return the measured
        decode wall seconds (0.0 when the engine is idle)."""
        for req in self.traffic.next_round():
            self.batcher.submit(req)
        b = self.batcher
        if b.idle:
            return 0.0
        t0 = _time.perf_counter()
        for _ in range(self.serve_spec.decode_steps_per_round):
            if b.idle:
                break
            t1 = _time.perf_counter()
            b.step()
            self._decode_walls.append(_time.perf_counter() - t1)
        t_end = _time.perf_counter()
        self.last_serve_window = (t0, t_end)
        return t_end - t0

    def _round_sequential(self):
        self._round_serve_seconds = self._serve_round()
        return super()._round_sequential()

    def _charge_interference(self, raw_times: list[float]) -> list[float]:
        """The contended worker's step time absorbs the measured decode
        seconds (real wall time, undilated — the decode work is real)."""
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
        return rec

    def _queue_signal(self):
        # serve-queue pressure feeds the outer dynamix policy's state vector
        return float(self.batcher.stats()["queued"])

    def serve_stats(self) -> dict:
        """Decode-side run summary (``Session.run`` result key ``"serve"``):
        latency percentiles over measured scheduler steps, queue pressure,
        interference charged to training, and the policy's actions (none
        in shared mode)."""
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
