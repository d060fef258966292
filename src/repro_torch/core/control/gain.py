"""Gain-scheduled controller: re-tune on availability-trace shifts.

Transient-VM fleets (paper §II-A) change regime abruptly — a colocated job
arrives, a VM is throttled, interference ends.  A fixed-gain controller
smooths straight through the shift: its EWMA window still averages the old
regime, so the first few corrections chase stale state.

This controller watches each *raw* sample against the worker's current
EWMA.  A relative jump beyond ``shift_threshold`` is treated as a regime
change for that worker: its filter window and PID window state (integral,
derivative memory) are restarted so the next smoothed value is the fresh
post-shift sample, and the next correction is computed against the new
regime only.  Between shifts it behaves exactly like :class:`PIDController`
with the configured gains.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.control.pid import PIDController


class GainScheduledController(PIDController):
    """PID + per-worker regime-shift detection and window re-tune."""

    kind = "gain"

    def _pre_smooth(self, iteration_times: Sequence[float]) -> None:
        thr = self.config.shift_threshold
        self._in_transient = set()
        for i, (w, t) in enumerate(zip(self.workers, iteration_times)):
            if w.ewma_time is None:
                continue
            if abs(t - w.ewma_time) / w.ewma_time > thr:
                # regime shift: restart this worker's windows so the next
                # EWMA value is the fresh post-shift sample; mark it
                # in-transient so the integral sits this round out
                w.ewma_time = None
                w.integral = 0.0
                w.prev_smoothed = None
                self._in_transient.add(i)
                self.num_retunes += 1
