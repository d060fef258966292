"""Run-summary metrics shared by benchmarks and examples."""

from __future__ import annotations

import numpy as np


def time_to_target(history, target_loss: float, ewma: float = 0.1):
    """(sim_time, step) at which the smoothed loss first crosses target."""
    smoothed = None
    for rec in history:
        smoothed = rec.loss if smoothed is None else (
            ewma * rec.loss + (1 - ewma) * smoothed)
        if smoothed <= target_loss:
            return rec.sim_time, rec.step
    return None, None


def iteration_time_stats(history, per_worker: bool = False):
    """Aggregate iteration-time stats over a run's StepRecord history.

    With ``per_worker=True`` the result additionally carries a
    ``"per_worker"`` dict of per-worker mean/p50/p95/max lists, computed
    from BSP rounds that recorded ``worker_times``.  Elastic runs change
    the worker count mid-history, so per-worker stats cover the trailing
    span of records whose worker count matches the final one (``None``
    when no record carries per-worker times, e.g. pure-ASP histories).
    """
    times = np.asarray([r.iteration_time for r in history])
    out = {
        "mean": float(times.mean()),
        "p50": float(np.percentile(times, 50)),
        "p95": float(np.percentile(times, 95)),
        "max": float(times.max()),
    }
    if per_worker:
        rows = []
        for rec in reversed(history):
            wt = getattr(rec, "worker_times", None)
            if wt is None or (rows and len(wt) != len(rows[-1])):
                break
            rows.append(wt)
        if rows:
            per = np.asarray(rows[::-1])  # (steps, k)
            out["per_worker"] = {
                "mean": [float(x) for x in per.mean(axis=0)],
                "p50": [float(x) for x in np.percentile(per, 50, axis=0)],
                "p95": [float(x) for x in np.percentile(per, 95, axis=0)],
                "max": [float(x) for x in per.max(axis=0)],
            }
        else:
            out["per_worker"] = None
    return out


def straggler_waste(history):
    return float(np.mean([r.straggler_waste for r in history]))


def batch_trajectory(history):
    return np.asarray([r.batches for r in history])
