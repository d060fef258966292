"""The port's learned outer policy (``dynamix``, ``policy.py``): its torch
Q-head against the reference's jitted one, then mirrors of
``tests/test_policy.py`` on the port.

The reference draws its first Q-head layer from ``jax.random``, which torch
cannot reproduce, so the parity tests start the port from the reference's
Q-head through ``policy_params_from_jax`` (the port's ``_init_params`` is
patched, so the injected head is in place before the replay ring is
seeded and the 32 burn-in updates run).  Everything else of the controller
is numpy or pure Python and must be ``==``: the replay ring, the RNG state,
the action and resize logs.  The Q-head's floats differ from XLA's in the
last bits (matmul order, ``tanh``, the mean over 16 rows); the tolerances
below are set from what was measured on the CPU:

- ``_q_values`` and one ``_td_step`` on identical inputs: rtol 1e-5,
  atol 1e-7 (measured max abs 7.2e-7 on Q values of magnitude ~1-5,
  2.4e-7 on the velocity, 6e-8 on the weights);
- the Q-head after the 32 burn-in updates: atol 1e-6 (measured 1.2e-7 on
  weights of magnitude <= 0.8);
- after 100 more decisions: atol 1e-5 (measured 1.7e-6 on weights of
  magnitude <= 1.6); the actions stay equal, because features and rewards
  are quantized to 1e-3 before they reach the head.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as R
from repro.core.control.global_batch import policy as ref_policy
from repro_torch import core as T
from repro_torch.core.control.global_batch import policy

# ------------------------------------------------- the Q-head on its own


def _random_head(rng, hidden):
    shapes = ({"w1": (8, hidden), "b1": (hidden,), "w2": (hidden, 3),
               "b2": (3,)} if hidden else {"w": (8, 3), "b": (3,)})
    return {k: (0.5 * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def _random_batch(rng, n=16):
    return {"s": rng.uniform(-1, 1, (n, 8)).round(3).astype(np.float32),
            "a": rng.integers(0, 3, n).astype(np.int32),
            "r": rng.uniform(-1, 1, n).round(3).astype(np.float32),
            "s2": rng.uniform(-1, 1, (n, 8)).round(3).astype(np.float32)}


def _as_ref(head):
    return {k: jnp.asarray(v) for k, v in head.items()}


@pytest.mark.parametrize("hidden", [16, 0, 5])
def test_q_values_and_td_step_match_reference(hidden):
    rng = np.random.default_rng(hidden)
    head = _random_head(rng, hidden)
    vel = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in head.items()}
    batch = _random_batch(rng)
    q_ref = np.asarray(ref_policy._q_values(_as_ref(head),
                                            jnp.asarray(batch["s"])))
    q = policy._q_values(policy.policy_params_from_jax(head),
                         torch.from_numpy(batch["s"])).numpy()
    np.testing.assert_allclose(q, q_ref, rtol=1e-5, atol=1e-7)

    scalars = dict(gamma=0.7, lr=0.1, momentum=0.9)
    p_ref, v_ref = ref_policy._td_step(
        _as_ref(head), _as_ref(vel),
        {**{k: jnp.asarray(v) for k, v in batch.items()},
         **{k: jnp.float32(x) for k, x in scalars.items()}})
    port_batch = {"s": torch.from_numpy(batch["s"]),
                  "a": torch.from_numpy(batch["a"].astype(np.int64)),
                  "r": torch.from_numpy(batch["r"]),
                  "s2": torch.from_numpy(batch["s2"]),
                  **{k: float(np.float32(x)) for k, x in scalars.items()}}
    head_t = policy.policy_params_from_jax(head)
    vel_t = policy.policy_params_from_jax(vel)
    p, v = policy._td_step(head_t, vel_t, port_batch)
    for k in head:
        np.testing.assert_allclose(v[k].numpy(), np.asarray(v_ref[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(p[k].numpy(), np.asarray(p_ref[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        assert p[k].dtype == torch.float32 and v[k].dtype == torch.float32
        # the inputs are not modified
        assert torch.equal(head_t[k], torch.from_numpy(head[k]))
        assert torch.equal(vel_t[k], torch.from_numpy(vel[k]))


def test_params_serde_is_bit_exact_across_packages():
    head = _random_head(np.random.default_rng(1), 16)
    as_lists = json.loads(json.dumps(ref_policy._tree_to_lists(
        _as_ref(head))))
    port = policy._tree_from_lists(as_lists)
    for k in head:
        assert np.array_equal(port[k].numpy(), head[k])
    assert json.loads(json.dumps(policy._tree_to_lists(port))) == as_lists
    back = ref_policy._tree_from_lists(policy._tree_to_lists(port))
    for k in head:
        assert np.array_equal(np.asarray(back[k]), head[k])


def test_port_init_is_seeded_and_shaped_like_the_reference():
    a, b = policy._init_params(0, 16), policy._init_params(0, 16)
    ref = ref_policy._init_params(jax.random.PRNGKey(0), 16)
    for k in ref:
        assert a[k].shape == tuple(ref[k].shape)
        assert a[k].dtype == torch.float32
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["w1"], policy._init_params(1, 16)["w1"])
    assert float(a["w1"].std()) == pytest.approx(0.3, rel=0.35)
    for k in ("b1", "w2", "b2"):
        assert not a[k].any()
    assert set(policy._init_params(0, 0)) == {"w", "b"}


# --------------------------------- the controller from the reference's head


def _cfg(pkg, **kw):
    base = dict(kind="dynamix", warmup=2, cooldown=1, bandit_window=2,
                gns_min_samples=2, seed=0)
    base.update(kw)
    return pkg.GlobalBatchConfig(**base)


def _stats(pkg, b_global, sqn=4.0, combined=1.0):
    k = 3
    per = [b_global // k] * k
    per[0] += b_global - sum(per)
    return pkg.GradStats(per_worker_sqnorm=[sqn] * k, batches=per,
                         combined_sqnorm=combined)


def _drive(pkg, ctrl, steps, *, loss0=5.0, rate=0.05, seconds=1.0,
           with_stats=True, context=None):
    loss = loss0
    fired = []
    for t in range(steps):
        stats = _stats(pkg, ctrl.b_global) if with_stats else None
        new = ctrl.observe(loss=loss, seconds=seconds, stats=stats,
                           context=context)
        if new is not None:
            fired.append((t, new))
        loss -= rate
    return fired


def _ref_head(cfg):
    return {k: np.asarray(v) for k, v in ref_policy._init_params(
        jax.random.PRNGKey(cfg.seed), cfg.policy_hidden).items()}


def _port_from_ref_head(monkeypatch, cfg, b0):
    head = _ref_head(cfg)
    monkeypatch.setattr(policy, "_init_params",
                        lambda seed, hidden: policy.policy_params_from_jax(
                            head))
    ctrl = T.make_global_controller(cfg, b0=b0)
    monkeypatch.undo()
    return ctrl


def _head_gap(ref, port):
    return max(float(np.abs(np.asarray(ref.params[k])
                            - port.params[k].numpy()).max())
               for k in ref.params)


def _q_gap_at_decisions(ref, port):
    """The reference's and the port's Q(s) at the pending state."""
    s = ref._pending[0]
    q_ref = np.asarray(ref_policy._q_values(ref.params, jnp.asarray(s)))
    q = policy._q_values(port.params, torch.from_numpy(s)).numpy()
    return q_ref, q


@pytest.mark.parametrize("hidden", [16, 0])
def test_dynamix_from_the_reference_head_decides_identically(monkeypatch,
                                                             hidden):
    ref = R.make_global_controller(_cfg(R, policy_hidden=hidden), b0=12)
    port = _port_from_ref_head(monkeypatch, _cfg(T, policy_hidden=hidden),
                               b0=12)
    # after the seeded replay ring and the 32 burn-in updates
    assert port.replay == ref.replay
    assert port._replay_pos == ref._replay_pos
    assert port._rng.bit_generator.state == ref._rng.bit_generator.state
    assert _head_gap(ref, port) <= 1e-6
    fired_ref = _drive(R, ref, 200)
    fired = _drive(T, port, 200)
    q_ref, q = _q_gap_at_decisions(ref, port)
    msg = f"Q at the last decision: ref {q_ref}, port {q}"
    assert fired == fired_ref, msg
    assert port.action_log == ref.action_log, msg
    assert len(port.action_log) == 100
    assert port.resize_log == ref.resize_log
    assert port.replay == ref.replay
    assert port._rng.bit_generator.state == ref._rng.bit_generator.state
    assert _head_gap(ref, port) <= 1e-5
    np.testing.assert_allclose(q, q_ref, rtol=1e-5, atol=1e-5)
    # every non-float field of the state dicts is equal
    a, b = port.state_dict(), ref.state_dict()
    for key in ("replay", "replay_pos", "rng_state", "decisions",
                "action_log", "pending", "ep_steps"):
        assert a["extra"][key] == b["extra"][key], key
    assert {k: v for k, v in a.items() if k != "extra"} == \
        {k: v for k, v in b.items() if k != "extra"}


@pytest.mark.parametrize("direction", ["ref->port", "port->ref"])
def test_dynamix_payload_loads_in_the_other_package(monkeypatch, direction):
    ref = R.make_global_controller(_cfg(R), b0=12)
    port = _port_from_ref_head(monkeypatch, _cfg(T), b0=12)
    _drive(R, ref, 31)
    _drive(T, port, 31)
    src, dst = (ref, T) if direction == "ref->port" else (port, R)
    payload = json.loads(json.dumps(src.state_dict()))
    clone = dst.global_batch_from_state_dict(payload)
    assert type(clone).__name__ == "DynamixGlobalBatch"
    assert clone.state_dict() == src.state_dict()
    # the clone continues as the controller it came from does
    src_pkg = R if direction == "ref->port" else T
    assert (_drive(dst, clone, 40, loss0=5.0 - 31 * 0.05)
            == _drive(src_pkg, src, 40, loss0=5.0 - 31 * 0.05))
    assert clone.action_log == src.action_log
    assert clone.replay == src.replay


# ------------------------------------------ mirrors of tests/test_policy.py


def _weights(ctrl):
    return {k: v.numpy() for k, v in ctrl.params.items()}


def test_dynamix_registered_and_needs_stats():
    assert "dynamix" in T.GLOBAL_BATCH_KINDS
    assert _cfg(T).needs_grad_stats
    ctrl = T.make_global_controller(_cfg(T), b0=12)
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in ctrl.params.values())


def test_same_seed_bit_identical_actions_and_weights():
    a = T.make_global_controller(_cfg(T), b0=12)
    b = T.make_global_controller(_cfg(T), b0=12)
    assert _drive(T, a, 60) == _drive(T, b, 60)
    assert a.action_log == b.action_log and a.resize_log == b.resize_log
    for k in a.params:
        assert np.array_equal(_weights(a)[k], _weights(b)[k]), k
    c = T.make_global_controller(_cfg(T, seed=7), b0=12)
    _drive(T, c, 60)
    assert (c.action_log != a.action_log) or any(
        not np.array_equal(_weights(c)[k], _weights(a)[k]) for k in a.params)


def test_linear_head_also_deterministic():
    a = T.make_global_controller(_cfg(T, policy_hidden=0), b0=12)
    b = T.make_global_controller(_cfg(T, policy_hidden=0), b0=12)
    _drive(T, a, 40)
    _drive(T, b, 40)
    assert a.action_log == b.action_log
    assert set(a.params) == {"w", "b"}
    for k in a.params:
        assert np.array_equal(_weights(a)[k], _weights(b)[k]), k


def test_roundtrip_is_bit_identical_and_json_safe():
    ctrl = T.make_global_controller(_cfg(T), b0=12)
    _drive(T, ctrl, 31)   # mid-episode: pending transition + partial window
    back = T.global_batch_from_state_dict(
        json.loads(json.dumps(ctrl.state_dict())))
    assert type(back).__name__ == "DynamixGlobalBatch"
    assert back.state_dict() == ctrl.state_dict()
    assert back.rung == ctrl.rung and back.rungs == ctrl.rungs
    assert back.replay == ctrl.replay and back._replay_pos == ctrl._replay_pos
    assert back._rng.bit_generator.state == ctrl._rng.bit_generator.state
    for k in ctrl.params:
        assert torch.equal(back.params[k], ctrl.params[k]), k
        assert torch.equal(back.velocity[k], ctrl.velocity[k]), k


def test_restored_controller_continues_identically():
    a = T.make_global_controller(_cfg(T), b0=12)
    b = T.make_global_controller(_cfg(T), b0=12)
    _drive(T, a, 25)
    _drive(T, b, 25)
    b = T.global_batch_from_state_dict(json.loads(json.dumps(b.state_dict())))
    assert (_drive(T, a, 30, loss0=5.0 - 25 * 0.05)
            == _drive(T, b, 30, loss0=5.0 - 25 * 0.05))
    assert a.action_log == b.action_log
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 200), st.integers(0, 999),
       st.lists(st.tuples(st.floats(-10.0, 10.0), st.floats(0.0, 5.0),
                          st.floats(0.1, 1e6), st.booleans()),
                min_size=5, max_size=60))
def test_b_global_always_on_the_frozen_ladder(b0, seed, stream):
    ctrl = T.make_global_controller(
        _cfg(T, seed=seed, warmup=1, bandit_window=1, gns_min_samples=1),
        b0=b0)
    rungs = list(ctrl.rungs)
    for loss, seconds, sqn, with_stats in stream:
        stats = _stats(T, ctrl.b_global, sqn=sqn) if with_stats else None
        ctrl.observe(loss=loss, seconds=seconds, stats=stats,
                     context={"worker_times": [seconds] * 3,
                              "prices": [1.0, 2.0, 0.5], "queue": 3.0})
        assert ctrl.b_global in rungs
        assert ctrl.rungs == rungs
        assert all(a in (0, 1, 2) for a in ctrl.action_log)


def test_context_features_are_clipped_and_quantized():
    ctrl = T.make_global_controller(_cfg(T), b0=12)
    ctrl.observe(loss=1.0, seconds=1e-9, stats=_stats(T, 12, sqn=1e12),
                 context={"worker_times": [1e9, 1.0], "prices": [1e6],
                          "queue": 1e9})
    f = ctrl._features()
    assert f.dtype == np.float32
    assert np.all(f >= -1.0) and np.all(f <= 1.0)
    assert np.array_equal(f, np.round(f.astype(float), 3))


def test_subnormal_step_time_leaves_the_throughput_signal():
    """b / 5e-324 overflows to inf; the reference's EWMA then turns inf and
    its next ``_features`` fails on log2(0) (found by the ladder property
    above).  The port skips such a step's throughput instead."""
    ctrl = T.make_global_controller(_cfg(T, warmup=1, bandit_window=1), b0=2)
    for seconds in (0.0, 0.0, 5e-324, 1.0, 2.0):
        ctrl.observe(loss=0.0, seconds=seconds)
    assert math.isfinite(ctrl._xput_ewma) and ctrl._xput_ewma > 0
    assert np.all(np.isfinite(ctrl._features()))


RATES = [0.02, 0.06, 0.01]      # planted best: rung 1 (middle)


def _planted(ctrl, steps):
    best = max(RATES)
    loss, regret, occupancy = 50.0, 0.0, [0] * len(RATES)
    for _ in range(steps):
        r = RATES[ctrl.rung]
        regret += best - r
        occupancy[ctrl.rung] += 1
        ctrl.observe(loss=loss, seconds=1.0)
        loss -= r
    return regret, occupancy


def test_policy_finds_planted_rung_like_the_reference(monkeypatch):
    """``tests/test_policy.py``'s convergence claim on the port, from the
    reference's Q-head: the action log is the reference's, the policy
    settles on the planted rung and beats epsilon-greedy's regret."""
    steps = 800
    knobs = dict(ladder_growth=2.0, max_factor=4.0, warmup=2,
                 bandit_window=2, time_signal="steps", policy_shaping=0.0,
                 policy_lr=0.3, policy_momentum=0.5, policy_gamma=0.3,
                 epsilon=0.3, epsilon_decay=0.96, epsilon_min=0.05)
    dyn = _port_from_ref_head(monkeypatch, _cfg(T, **knobs), b0=8)
    ref = R.make_global_controller(_cfg(R, **knobs), b0=8)
    bandit = T.make_global_controller(T.GlobalBatchConfig(
        kind="bandit", ladder_growth=2.0, max_factor=4.0, warmup=2,
        cooldown=1, bandit_window=2, time_signal="steps", epsilon=0.4,
        seed=0), b0=8)
    assert len(dyn.rungs) == 3 and dyn.rungs == bandit.rungs
    r_dyn, occ_dyn = _planted(dyn, steps)
    r_ref, occ_ref = _planted(ref, steps)
    r_band, occ_band = _planted(bandit, steps)
    assert dyn.action_log == ref.action_log
    assert (r_dyn, occ_dyn) == (r_ref, occ_ref)
    assert occ_dyn[1] > steps // 2, occ_dyn
    assert r_dyn < r_band, (r_dyn, r_band, occ_dyn, occ_band)


@pytest.mark.parametrize("kw", [
    dict(policy_hidden=-1), dict(policy_lr=0.0), dict(policy_momentum=1.0),
    dict(policy_gamma=1.0), dict(policy_shaping=-0.1), dict(replay_batch=0),
    dict(replay_capacity=4, replay_batch=8), dict(epsilon_min=1.5),
    dict(epsilon_decay=0.0), dict(time_signal="wallclock"),
])
def test_rejects_bad_policy_knobs(kw):
    with pytest.raises(ValueError):
        _cfg(T, **kw)


def test_epsilon_floor_and_decay():
    ctrl = T.make_global_controller(
        _cfg(T, epsilon=0.8, epsilon_decay=0.5, epsilon_min=0.1), b0=12)
    ctrl.decisions = 100
    eps = max(ctrl.config.epsilon_min,
              ctrl.config.epsilon * ctrl.config.epsilon_decay ** 100)
    assert math.isclose(eps, 0.1)
