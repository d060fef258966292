"""DYNAMIX-style learned outer batch-size policy (DESIGN.md §18), in PyTorch.

`DynamixGlobalBatch` replaces the bandit's per-rung value table with a
small contextual Q-head trained online: every ``bandit_window`` outer
steps it summarizes the system+statistical state into a normalized
feature vector, scores the finished decision window by smoothed loss
drop per time unit, pushes the resulting transition into a seeded replay
ring, runs one TD(0) update (SGD + momentum on the Q-head), and
epsilon-greedily picks one of three actions — DOWN one rung, HOLD, UP
one rung — on the frozen §15 ladder.  Because actions are rung-relative
and the base class still applies the clamp + slew-rate limit, every §11
recompile bound and §15 hysteresis argument carries over untouched.

State vector (all features clipped to [-1, 1] and rounded to 1e-3):

  0. log2(b_noise / B) / 3      — gradient-noise-scale pull (gns.py)
  1. rung position in [-1, 1]   — where on the ladder we stand
  2. loss-slope EWMA (scaled)   — is training still moving
  3. worker step-time spread    — inner-split imbalance (context)
  4. log2(throughput / EWMA)    — instantaneous speed deviation
  5. mean spot price - 1        — churn/market pressure (context)
  6. serve queue depth / 8      — co-located serving pressure (context)
  7. bias (1.0)

Feature 0 doubles as a potential function: the shaped reward adds
``policy_shaping * (gamma * phi(s') - phi(s))`` with ``phi = -|f0|``,
which is potential-based (optimal policy unchanged) yet pulls the early
policy toward the GNS critical batch before much reward has been seen.

Under ``time_signal='steps'`` the reward denominator is the step count
and features 3-4 are zeroed, so the decision sequence is a pure function
of the discrete trajectory; the 1e-3 quantization absorbs the last-bit
loss differences between reduction orders (two backends, two devices, or
this package and the JAX one), which is what lets decisions be compared
for equality.

The Q-head (8 x 16 x 3 fp32 weights) lives on the CPU by design: it is
controller state, like the numpy controllers beside it, updated once per
decision window and checkpointed as JSON.  The trainer's model, gradients
and kernels stay on their device; nothing here moves them.

Everything is deterministic given the config seed: weight init draws from
``torch.Generator("cpu").manual_seed(seed)``, exploration and replay
sampling share one ``np.random.default_rng(seed)`` whose bit-generator
state — along with the weights, momentum buffers, and the replay ring —
joins the checkpointed outer state (restores are bit-identical).  The
reference draws its first layer from ``jax.random``, which torch cannot
reproduce; `policy_params_from_jax` carries such a Q-head over.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.control.global_batch.gns import GNSEstimator, GradStats
from repro_torch.core.control.global_batch.outer import (
    GlobalBatchConfig,
    GlobalBatchController,
)

N_FEATURES = 8
N_ACTIONS = 3       # 0 = down one rung, 1 = hold, 2 = up one rung
_QUANT = 3          # decimal places for feature/reward rounding


def _clip(x: float) -> float:
    return max(-1.0, min(1.0, float(x)))


def _f32_tensor(x) -> torch.Tensor:
    """fp32 CPU tensor from nested lists or arrays (numpy's rounding of
    Python floats, as ``jnp.asarray(..., jnp.float32)``)."""
    return torch.from_numpy(np.array(x, np.float32))


def _q_values(params: dict, s: torch.Tensor) -> torch.Tensor:
    """Q(s, ·) for a linear ({w, b}) or tanh-MLP ({w1, b1, w2, b2}) head."""
    if "w1" in params:
        h = torch.tanh(s @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]
    return s @ params["w"] + params["b"]


def _td_step(params: dict, velocity: dict, batch: dict):
    """One TD(0) step over a replay minibatch: SGD + momentum on the
    Q-head toward ``r + gamma * max_a' Q(s', a')`` (target stop-gradded).

    Returns new (params, velocity) dicts; the inputs are not modified.
    """
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    with torch.enable_grad():
        qa = torch.gather(_q_values(leaves, batch["s"]), 1,
                          batch["a"][:, None])[:, 0]
        q2 = torch.max(_q_values(leaves, batch["s2"]), dim=1).values
        tgt = (batch["r"] + batch["gamma"] * q2).detach()
        loss = torch.mean((qa - tgt) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    velocity = {k: batch["momentum"] * velocity[k] + g
                for k, g in zip(leaves, grads)}
    params = {k: params[k] - batch["lr"] * velocity[k] for k in leaves}
    return params, velocity


def _init_params(seed: int, hidden: int) -> dict:
    """Q-head weights: zero output layer (Q starts identically 0, so the
    first greedy pick is HOLD), seeded normal hidden layer to break the
    MLP's symmetry."""
    if hidden == 0:
        return {"w": torch.zeros((N_FEATURES, N_ACTIONS), dtype=torch.float32),
                "b": torch.zeros((N_ACTIONS,), dtype=torch.float32)}
    gen = torch.Generator("cpu").manual_seed(seed)
    w1 = 0.3 * torch.randn((N_FEATURES, hidden), generator=gen,
                           dtype=torch.float32)
    return {"w1": w1,
            "b1": torch.zeros((hidden,), dtype=torch.float32),
            "w2": torch.zeros((hidden, N_ACTIONS), dtype=torch.float32),
            "b2": torch.zeros((N_ACTIONS,), dtype=torch.float32)}


def _tree_to_lists(tree: dict) -> dict:
    return {k: v.tolist() for k, v in tree.items()}


def _tree_from_lists(tree: dict) -> dict:
    # float32 -> python float (double) -> float32 roundtrips exactly, so
    # the JSON checkpoint payload restores the weights bit-identically
    return {k: _f32_tensor(v) for k, v in tree.items()}


def policy_params_from_jax(tree: dict) -> dict:
    """The reference's Q-head (a dict of arrays, e.g. its ``params`` or
    ``velocity`` as numpy) as this module's fp32 CPU tensors, bit for bit."""
    return _tree_from_lists(tree)


class DynamixGlobalBatch(GlobalBatchController):
    """Learned {down, hold, up} rung policy on the frozen §15 ladder."""

    kind = "dynamix"

    def __init__(self, config: GlobalBatchConfig, b0: int,
                 quantum: int = 1) -> None:
        super().__init__(config, b0, quantum)
        self.estimator = GNSEstimator(alpha=config.gns_alpha,
                                      min_samples=config.gns_min_samples)
        self._rng = np.random.default_rng(config.seed)
        self.params = _init_params(config.seed, config.policy_hidden)
        self.velocity = {k: torch.zeros_like(v)
                         for k, v in self.params.items()}
        self.replay: list[list] = []       # rows: [s, a, r, s'] (JSON-ready)
        self._replay_pos = 0
        self.decisions = 0
        self.action_log: list[int] = []
        # episode accumulators (mirror the bandit's)
        self._loss_ewma: Optional[float] = None
        self._slope_ewma = 0.0
        self._xput_ewma: Optional[float] = None
        self._last_xput: Optional[float] = None
        self._reward_scale: Optional[float] = None
        self._ep_steps = 0
        self._ep_seconds = 0.0
        self._ep_loss0: Optional[float] = None
        self._pending: Optional[tuple] = None   # (state, action, phi)
        self._seed_replay()
        for _ in range(32):   # burn the prior into the Q-head up front
            self._train()

    def _seed_replay(self) -> None:
        """Seed the replay ring with synthetic shaped transitions.

        Before any reward has been observed the Q-head is all zeros and
        greedy always HOLDs — a cold-start that would waste the whole §15
        warmup.  These rows encode only the potential-based shaping term
        over hypothetical (GNS-pull, rung-position) states: moving the
        rung toward the b_noise side shrinks |f0| by one ladder step,
        moving away grows it, and the shaped reward is the resulting
        potential difference.  That gives the policy a follow-the-GNS
        prior out of the box; observed rewards then overwrite it through
        the same TD updates.  Fully deterministic (no RNG draw here).
        """
        cfg = self.config
        n = len(self.rungs)
        dpos = 2.0 / (n - 1) if n > 1 else 0.0
        dpull = math.log2(cfg.ladder_growth) / 3.0   # one rung, f0 units
        for pull in (-1.0, -0.6, -0.2, 0.2, 0.6, 1.0):
            for pos in (-1.0, 0.0, 1.0):
                for action in range(N_ACTIONS):
                    move = action - 1
                    toward = (move != 0 and (move > 0) == (pull > 0))
                    if move == 0:
                        pull2 = pull
                    elif toward:
                        pull2 = pull - math.copysign(dpull, pull)
                    else:
                        pull2 = _clip(pull + math.copysign(dpull, pull))
                    s = [round(pull, _QUANT), round(pos, _QUANT),
                         0.0, 0.0, 0.0, 0.0, 0.0, 1.0]
                    s2 = [round(pull2, _QUANT),
                          round(_clip(pos + move * dpos), _QUANT),
                          0.0, 0.0, 0.0, 0.0, 0.0, 1.0]
                    r = cfg.policy_shaping * (
                        cfg.policy_gamma * -abs(pull2) - -abs(pull))
                    self._push(s, action, round(r, _QUANT), s2)

    # ------------------------------------------------------------- signals

    def _ingest(self, loss: float, seconds: float,
                stats: Optional[GradStats]) -> None:
        if stats is not None:
            self.estimator.observe(stats)
        prev = self._loss_ewma
        self._loss_ewma = loss if prev is None else 0.2 * loss + 0.8 * prev
        if prev is not None:
            slope = (prev - self._loss_ewma) / max(abs(prev), 1e-9)
            self._slope_ewma = 0.2 * slope + 0.8 * self._slope_ewma
        xput = (self.b_global / seconds
                if self.config.time_signal == "measured" and seconds > 0
                else None)
        # a subnormal step time overflows the throughput to inf, which
        # would poison the EWMA (the reference then fails on log2(0) in
        # _features); such a step leaves the throughput signal as it was
        if xput is not None and math.isfinite(xput):
            self._last_xput = xput
            self._xput_ewma = xput if self._xput_ewma is None else (
                0.2 * xput + 0.8 * self._xput_ewma)
        if self._ep_loss0 is None:
            self._ep_loss0 = self._loss_ewma
        self._ep_steps += 1
        self._ep_seconds += max(seconds, 0.0)

    def _features(self) -> np.ndarray:
        cfg = self.config
        n = len(self.rungs)
        f = [0.0] * N_FEATURES
        bn = self.estimator.b_noise if self.estimator.ready else None
        if bn is not None and math.isfinite(bn) and bn > 0:
            f[0] = _clip(math.log2(bn / self.b_global) / 3.0)
        f[1] = (2.0 * self.rung / (n - 1) - 1.0) if n > 1 else 0.0
        f[2] = _clip(self._slope_ewma * 50.0)
        ctx = self._last_context
        times = ctx.get("worker_times")
        if cfg.time_signal == "measured" and times:
            mean = sum(times) / len(times)
            if mean > 0:
                f[3] = _clip(max(times) / mean - 1.0)
        if (cfg.time_signal == "measured" and self._xput_ewma
                and self._last_xput):
            f[4] = _clip(math.log2(self._last_xput / self._xput_ewma))
        prices = ctx.get("prices")
        if prices:
            f[5] = _clip(sum(prices) / len(prices) - 1.0)
        queue = ctx.get("queue")
        if queue is not None:
            f[6] = _clip(float(queue) / 8.0)
        f[7] = 1.0
        return np.asarray([round(v, _QUANT) for v in f], np.float32)

    # ------------------------------------------------------------- learning

    def _push(self, s, a: int, r: float, s2) -> None:
        row = [np.asarray(s, np.float32).tolist(), int(a), float(r),
               np.asarray(s2, np.float32).tolist()]
        if len(self.replay) < self.config.replay_capacity:
            self.replay.append(row)
        else:
            self.replay[self._replay_pos] = row
            self._replay_pos = (
                self._replay_pos + 1) % self.config.replay_capacity

    def _train(self) -> None:
        cfg = self.config
        if not self.replay:
            return
        idx = self._rng.integers(0, len(self.replay), size=cfg.replay_batch)
        rows = [self.replay[int(i)] for i in idx]
        batch = {
            "s": _f32_tensor([r[0] for r in rows]),
            "a": torch.from_numpy(np.asarray([r[1] for r in rows], np.int64)),
            "r": _f32_tensor([r[2] for r in rows]),
            "s2": _f32_tensor([r[3] for r in rows]),
            # Python floats holding the fp32 values, as the reference's
            # jnp.float32 scalars: torch multiplies fp32 tensors by them in
            # fp32
            "gamma": float(np.float32(cfg.policy_gamma)),
            "lr": float(np.float32(cfg.policy_lr)),
            "momentum": float(np.float32(cfg.policy_momentum)),
        }
        self.params, self.velocity = _td_step(
            self.params, self.velocity, batch)

    def _select(self, state: np.ndarray) -> int:
        cfg = self.config
        eps = max(cfg.epsilon_min,
                  cfg.epsilon * cfg.epsilon_decay ** self.decisions)
        valid = [a for a in range(N_ACTIONS)
                 if 0 <= self.rung + (a - 1) < len(self.rungs)]
        # the uniform draw happens on BOTH branches so explore/exploit use
        # the same RNG stream positions — determinism is draw-for-draw
        if float(self._rng.random()) < eps:
            return int(self._rng.choice(valid))
        q = _q_values(self.params, torch.from_numpy(state)).numpy()
        best, best_q = valid[0], -math.inf
        for a in valid:
            if float(q[a]) > best_q:
                best, best_q = a, float(q[a])
        return best

    # ------------------------------------------------------------- decision

    def _target_rung(self) -> Optional[int]:
        cfg = self.config
        if self._ep_steps < cfg.bandit_window:
            return None
        denom = (self._ep_seconds if cfg.time_signal == "measured"
                 else float(self._ep_steps))
        reward = (self._ep_loss0 - self._loss_ewma) / max(denom, 1e-9)
        # normalize by a running magnitude so the quantized reward keeps
        # resolution whatever the workload's loss/time scales are
        mag = abs(reward)
        self._reward_scale = mag if self._reward_scale is None else (
            0.2 * mag + 0.8 * self._reward_scale)
        reward = reward / max(self._reward_scale, 1e-12)
        state = self._features()
        phi = -abs(float(state[0]))
        if self._pending is not None:
            s_prev, a_prev, phi_prev = self._pending
            r = reward + cfg.policy_shaping * (cfg.policy_gamma * phi
                                               - phi_prev)
            self._push(s_prev, a_prev, round(float(r), _QUANT), state)
            self._train()
        action = self._select(state)
        self._pending = (state, action, phi)
        self.decisions += 1
        self.action_log.append(int(action))
        self._ep_steps = 0
        self._ep_seconds = 0.0
        self._ep_loss0 = self._loss_ewma
        if action == 1:
            return None
        return self.rung + (action - 1)

    # ---------------------------------------------------------------- serde

    def _extra_state(self) -> dict:
        return {
            "estimator": self.estimator.state_dict(),
            "params": _tree_to_lists(self.params),
            "velocity": _tree_to_lists(self.velocity),
            "replay": [list(r) for r in self.replay],
            "replay_pos": self._replay_pos,
            "rng_state": self._rng.bit_generator.state,
            "decisions": self.decisions,
            "action_log": list(self.action_log),
            "loss_ewma": self._loss_ewma,
            "slope_ewma": self._slope_ewma,
            "xput_ewma": self._xput_ewma,
            "last_xput": self._last_xput,
            "reward_scale": self._reward_scale,
            "ep_steps": self._ep_steps,
            "ep_seconds": self._ep_seconds,
            "ep_loss0": self._ep_loss0,
            "pending": (None if self._pending is None else
                        [self._pending[0].tolist(), int(self._pending[1]),
                         float(self._pending[2])]),
        }

    def _load_extra_state(self, state: dict) -> None:
        self.estimator = GNSEstimator.from_state_dict(state["estimator"])
        self.params = _tree_from_lists(state["params"])
        self.velocity = _tree_from_lists(state["velocity"])
        self.replay = [list(r) for r in state["replay"]]
        self._replay_pos = int(state["replay_pos"])
        self._rng = np.random.default_rng(self.config.seed)
        self._rng.bit_generator.state = state["rng_state"]
        self.decisions = int(state["decisions"])
        self.action_log = [int(a) for a in state["action_log"]]
        self._loss_ewma = state["loss_ewma"]
        self._slope_ewma = float(state["slope_ewma"])
        self._xput_ewma = state["xput_ewma"]
        self._last_xput = state["last_xput"]
        self._reward_scale = state["reward_scale"]
        self._ep_steps = int(state["ep_steps"])
        self._ep_seconds = float(state["ep_seconds"])
        self._ep_loss0 = state["ep_loss0"]
        p = state["pending"]
        self._pending = (None if p is None else
                         (np.asarray(p[0], np.float32), int(p[1]),
                          float(p[2])))
