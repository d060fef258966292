"""The port's outer global-batch controllers (``core/control/global_batch``:
``gns.py`` and ``outer.py``) against the reference's, on shared inputs.

Both modules are pure Python in both packages, so the bar is equality:
the GNS estimator's floats, the geometric / gns / bandit rung walks, resize
logs and whole state dicts must be ``==`` on the reference's own test
inputs (``tests/test_global_batch.py``), and a state dict written by either
package must load in the other and continue identically.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import json
import math

import numpy as np
import pytest

import repro.core as R
from repro_torch import core as T
from repro_torch.core.control.global_batch import outer as port_outer

# ------------------------------------------------------------- GNS estimator


def _synthetic_stream(seed, batches, n, s_per_example=80.0, d=256):
    """``tests/test_global_batch.py::_synthetic_stats``'s stream, as plain
    tuples (per-worker sqnorms, batches, combined sqnorm)."""
    rng = np.random.default_rng(seed)
    g_true = rng.normal(size=d)
    g_true *= 2.0 / np.linalg.norm(g_true)
    out = []
    for _ in range(n):
        grads = [g_true + rng.normal(0.0, math.sqrt(s_per_example / (b * d)),
                                     size=d) for b in batches]
        total = sum(batches)
        combined = sum((b / total) * g for b, g in zip(batches, grads))
        out.append(([float(g @ g) for g in grads], list(batches),
                    float(combined @ combined)))
    return out


def _feed(pkg, stream, **kw):
    est = pkg.GNSEstimator(**kw)
    for sq, b, comb in stream:
        est.observe(pkg.GradStats(list(sq), list(b), comb))
    return est


@pytest.mark.parametrize("batches,alpha,min_samples", [
    ([6, 10, 16], 0.05, 8), ([4, 4], 0.5, 2), ([1, 30], 1.0, 1)])
def test_gns_estimator_is_bit_identical(batches, alpha, min_samples):
    stream = _synthetic_stream(0, batches, 200)
    ref, port = (_feed(pkg, stream, alpha=alpha, min_samples=min_samples)
                 for pkg in (R, T))
    assert port.state_dict() == ref.state_dict()
    assert port.b_noise == ref.b_noise and port.ready == ref.ready
    if batches == [6, 10, 16]:   # the reference's recovery claim holds too
        assert port.b_noise == pytest.approx(20.0, rel=0.35)


def test_gns_estimator_singular_nonfinite_and_serde():
    streams = [
        [([4.0], [8], 3.5)] * 10,                               # K = 1
        [([float("nan"), 2.0], [4, 4], 1.0), ([3.0, 2.0], [4, 4], 1.5),
         ([3.1, 2.2], [4, 4], 1.4), ([2.0, 2.0], [4, 4], float("inf")),
         ([5.0, 0.1], [2, 6], 4.0)],
    ]
    for stream in streams:
        ref, port = (_feed(pkg, stream, alpha=0.5, min_samples=1)
                     for pkg in (R, T))
        assert port.state_dict() == ref.state_dict()
        assert port.b_noise == ref.b_noise
        back = T.GNSEstimator.from_state_dict(
            json.loads(json.dumps(ref.state_dict())))
        assert back.state_dict() == ref.state_dict()
    # K = 1 never becomes ready; the skipped NaN/inf steps are not counted
    assert not _feed(T, streams[0]).ready
    assert _feed(T, streams[1], alpha=0.5).samples == 3
    # a vanishing true gradient saturates b_noise at +inf in both
    for pkg in (R, T):
        est = pkg.GNSEstimator()
        est.g2_ewma, est.s_ewma = -0.5, 5.0
        assert est.b_noise == math.inf


def test_gns_estimator_validation():
    for kw in (dict(alpha=0.0), dict(min_samples=0)):
        with pytest.raises(ValueError):
            T.GNSEstimator(**kw)
    with pytest.raises(ValueError):
        T.GNSEstimator().observe(T.GradStats([1.0], [4, 4], 1.0))


# ----------------------------------------------------------- config validity


@pytest.mark.parametrize("kw", [
    dict(kind="adaptive"), dict(max_factor=0.5), dict(ladder_growth=1.0),
    dict(warmup=-1), dict(max_rungs_per_resize=0), dict(geo_factor=1.0),
    dict(geo_every=0), dict(gns_alpha=1.5), dict(gns_min_samples=0),
    dict(hysteresis=-0.1), dict(epsilon=1.5), dict(bandit_window=0),
])
def test_config_rejects_what_the_reference_rejects(kw):
    for pkg in (R, T):
        with pytest.raises(ValueError):
            pkg.GlobalBatchConfig(**kw)


def test_needs_grad_stats_and_ladders_match():
    for kind in T.GLOBAL_BATCH_KINDS:
        assert (T.GlobalBatchConfig(kind=kind).needs_grad_stats
                == R.GlobalBatchConfig(kind=kind).needs_grad_stats)
    for b0 in (7, 12, 24, 100):
        for growth, cap in ((1.25, 8.0), (2.0, 4.0), (1.5, 1.0)):
            cfgs = [pkg.GlobalBatchConfig(kind="geometric",
                                          ladder_growth=growth,
                                          max_factor=cap) for pkg in (R, T)]
            ref, port = (pkg.make_global_controller(c, b0=b0)
                         for pkg, c in zip((R, T), cfgs))
            assert port.rungs == ref.rungs and port.rungs[0] == b0


# -------------------------------------------------------- outer ladder logic
# each scenario drives both packages' controllers with the same calls
# (tests/test_global_batch.py, l.133-264) and returns what it observed


def _geometric(pkg):
    ctrl = pkg.make_global_controller(pkg.GlobalBatchConfig(
        kind="geometric", geo_factor=8.0, geo_every=1, warmup=3, cooldown=2,
        max_rungs_per_resize=1), b0=16)
    fired = [ctrl.observe(loss=1.0, seconds=0.1) for _ in range(20)]
    return ctrl, fired


def _force(ctrl, b_noise):
    ctrl.estimator.g2_ewma = 1.0
    ctrl.estimator.s_ewma = float(b_noise)
    ctrl.estimator.samples = ctrl.estimator.min_samples


def _gns(pkg, hysteresis=0.1, allow_shrink=True):
    ctrl = pkg.make_global_controller(pkg.GlobalBatchConfig(
        kind="gns", gns_min_samples=1, warmup=0, cooldown=0,
        hysteresis=hysteresis, allow_shrink=allow_shrink), b0=24)
    fired = []
    for bn in (28.0, 40.0, 192.0, 400.0, 400.0, 400.0, 24.0, 1.0):
        _force(ctrl, bn)
        fired.append(ctrl.observe(loss=1.0, seconds=0.1))
    ctrl.estimator.g2_ewma, ctrl.estimator.s_ewma = -0.5, 5.0
    fired.append(ctrl.observe(loss=1.0, seconds=0.1))
    return ctrl, fired


def _gns_from_stats(pkg):
    """gns fed real GradStats (no forced estimates): the estimator's EWMA,
    its readiness gate and the hysteresis band together."""
    ctrl = pkg.make_global_controller(pkg.GlobalBatchConfig(
        kind="gns", warmup=2, cooldown=2, gns_min_samples=3,
        ladder_growth=1.5), b0=12)
    fired = []
    stream = _synthetic_stream(3, [4, 4, 4], 30, s_per_example=400.0)
    for sq, _b, comb in stream:
        per = [ctrl.b_global // 3] * 3
        per[0] += ctrl.b_global - sum(per)
        fired.append(ctrl.observe(loss=1.0, seconds=0.1, stats=pkg.GradStats(
            list(sq), per, comb)))
    return ctrl, fired


def _bandit(pkg, seed=7, epsilon=0.5, time_signal="measured"):
    ctrl = pkg.make_global_controller(pkg.GlobalBatchConfig(
        kind="bandit", warmup=2, cooldown=1, bandit_window=3, epsilon=epsilon,
        seed=seed, time_signal=time_signal), b0=16)
    fired = [ctrl.observe(loss=1.0 / (i + 1), seconds=0.05 * (1 + i % 3))
             for i in range(60)]
    return ctrl, fired


SCENARIOS = {
    "geometric": _geometric,
    "gns-forced": _gns,
    "gns-no-shrink": lambda pkg: _gns(pkg, allow_shrink=False),
    "gns-wide-band": lambda pkg: _gns(pkg, hysteresis=0.25),
    "gns-from-stats": _gns_from_stats,
    "bandit": _bandit,
    "bandit-steps": lambda pkg: _bandit(pkg, seed=3, epsilon=0.3,
                                        time_signal="steps"),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_rung_walks_and_state_dicts_are_identical(name):
    (ref, ref_fired), (port, port_fired) = (SCENARIOS[name](pkg)
                                            for pkg in (R, T))
    assert port_fired == ref_fired
    assert port.resize_log == ref.resize_log and port.rung == ref.rung
    assert port.state_dict() == ref.state_dict()
    assert port.num_resizes > 0, "the scenario must move the ladder"
    for _, b in port.resize_log:
        assert b in port.rungs


@pytest.mark.parametrize("name", list(SCENARIOS))
@pytest.mark.parametrize("direction", ["ref->port", "port->ref"])
def test_state_dict_loads_in_the_other_package(name, direction):
    src, dst = (R, T) if direction == "ref->port" else (T, R)
    ctrl, _ = SCENARIOS[name](src)
    payload = json.loads(json.dumps(ctrl.state_dict()))
    clone = dst.global_batch_from_state_dict(payload)
    assert type(clone).__name__ == type(ctrl).__name__
    assert clone.state_dict() == ctrl.state_dict()
    # both continue identically (the bandit's RNG state moved across too)
    seq_a = [ctrl.observe(loss=0.1 / (i + 1), seconds=0.1) for i in range(9)]
    seq_b = [clone.observe(loss=0.1 / (i + 1), seconds=0.1) for i in range(9)]
    assert seq_a == seq_b
    assert clone.state_dict() == ctrl.state_dict()


def test_roundtrip_rejects_ladder_mismatch_and_unknown_kind():
    state = T.make_global_controller(
        T.GlobalBatchConfig(kind="geometric"), b0=24).state_dict()
    with pytest.raises(ValueError, match="ladder"):
        T.global_batch_from_state_dict({**state, "rungs": [24, 999]})
    with pytest.raises(ValueError, match="unknown"):
        T.global_batch_from_state_dict({**state, "kind": "fuzzy"})


def test_every_kind_resolves_to_its_class():
    for kind in T.GLOBAL_BATCH_KINDS:
        port, ref = (pkg.make_global_controller(
            pkg.GlobalBatchConfig(kind=kind), b0=8) for pkg in (T, R))
        assert port.kind == kind
        assert type(port).__name__ == type(ref).__name__
    assert (port_outer._controller_cls("dynamix").__module__
            == "repro_torch.core.control.global_batch.policy")
