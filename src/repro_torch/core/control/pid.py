"""PI / PID batch controllers (beyond the paper's P law).

The paper's P law is multiplicative-deadbeat: on *exact* iteration times
``t_k = b_k / x_k`` the update ``b' = b * t_bar / t`` equalizes times in a
single readjustment.  Its weakness is that it acts on the EWMA-smoothed
times, which lag regime changes: after a step disturbance the first
smoothed sample carries only ``alpha`` of the shift, so P's first
correction is partial and it needs an extra readjustment (with a fresh
window) to finish.

PID closes that gap by running the same multiplicative law on
*lead-compensated* time estimates:

    D_k      = mu_k - mu_k(prev)              # first difference (derivative)
    t_hat_k  = mu_k + kd * D_k                # lead filter
    I_k     += (t_hat_k - t_bar_hat) / t_bar_hat   # window-scoped integral
    t_ctrl_k = t_hat_k * (1 + ki * I_k)
    b'       = b * (kp * t_bar_ctrl / t_ctrl + (1 - kp))

With ``kd = (1-alpha)/alpha`` the lead term exactly cancels the EWMA lag
after a step (the EWMA moves by ``alpha * delta`` and its first difference
is also ``alpha * delta``), so the very first post-shift readjustment sees
the true post-shift times — deadbeat in ONE adjustment where P needs two
or more.  The integral term accumulates persistent relative error that is
individually too small to clear the dead-band, eliminating steady-state
imbalance; it resets with the EWMA window on every readjustment (the
paper's window-scoped framing).  ``kp = 1`` recovers the full correction;
``kp < 1`` damps it.
"""

from __future__ import annotations

from repro_torch.core.control.base import BatchController


class PIDController(BatchController):
    """Multiplicative PID on lead-compensated smoothed iteration times."""

    kind = "pid"

    def _raw_targets(self, mu, t_bar, errors):
        kp, ki, kd = self.config.resolved_gains(self.kind)
        i_max = self.config.i_max
        # derivative lead: reconstruct the unlagged time estimate
        t_hat = []
        for w, m in zip(self.workers, mu):
            d = 0.0 if w.prev_smoothed is None else m - w.prev_smoothed
            w.prev_smoothed = m
            t_hat.append(max(m + kd * d, 1e-9))
        t_bar_hat = sum(t_hat) / len(t_hat)
        # window-scoped integral of the relative error.  Two guards keep it
        # honest: a deadzone so it never chases error that integer batch
        # rounding cannot express (one batch unit ~ 1/b_k relative time) or
        # sub-half-dead-band noise, and a transient gate so it only
        # integrates *persistent* error — while the lead term is active
        # (regime change in flight) the P+D terms own the correction
        t_ctrl = []
        transient = getattr(self, "_in_transient", frozenset())
        for i, (w, m, th) in enumerate(zip(self.workers, mu, t_hat)):
            e_rel = (th - t_bar_hat) / t_bar_hat
            deadzone = max(self.config.dead_band / 2.0,
                           1.0 / max(w.batch, 1))
            steady = (i not in transient
                      and abs(th - m) / max(m, 1e-9) <= self.config.dead_band)
            if steady and abs(e_rel) > deadzone:
                w.integral = max(-i_max, min(i_max, w.integral + e_rel))
            t_ctrl.append(max(th * (1.0 + ki * w.integral), 1e-9))
        t_bar_ctrl = sum(t_ctrl) / len(t_ctrl)
        # multiplicative-deadbeat law on the compensated times, damped by kp
        return [
            max(w.batch * (kp * t_bar_ctrl / tc + (1.0 - kp)), 1e-6)
            for w, tc in zip(self.workers, t_ctrl)
        ]


class PIController(PIDController):
    """PID with the derivative gain defaulted to zero (lag-tolerant,
    steady-state-error-free)."""

    kind = "pi"
