"""Paper §III-C proportional controller (the seed behaviour, bit-for-bit).

Control law (Eq. 4-5 of the paper):

    tau_k      = t_k - t_bar                  # error: deviation from mean
    X_k        = b_k / t_k                    # empirical throughput
    delta(b_k) = -X_k * tau_k
    b_k       <- b_k + delta(b_k)  ==  b_k * (t_bar / t_k)

The multiplicative form ``b_k * t_bar / mu_k`` is kept verbatim (not the
algebraically-equal additive form) so default-config trajectories are
float-identical to the seed implementation.
"""

from __future__ import annotations

from repro_torch.core.control.base import BatchController


class DynamicBatchController(BatchController):
    """Paper §III-C proportional controller with EWMA/dead-band/bounds."""

    kind = "p"

    def _raw_targets(self, mu, t_bar, errors):
        # b' = b + delta = b - (b/mu)*(mu - t_bar) = b * t_bar / mu
        return [w.batch * t_bar / m for w, m in zip(self.workers, mu)]


# Explicit alias: the paper-faithful P controller.
ProportionalController = DynamicBatchController
