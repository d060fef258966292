"""The launch slice: the port's CLI (``launch/train.py``), step programs
(``launch/steps.py``) and roofline (``launch/roofline.py``) against the
reference's ``repro.launch``, on the CPU.

Both CLIs run in process with ``--quiet``; the port's with ``--device
cpu``.  The token stream is numpy and the same in both packages, and the
port's workload starts from the reference's initial parameters (its
``init`` patched to ``params_from_jax`` of what the reference's drew), so
the per-step batches and ``sim_time`` must be ``==`` and the losses agree
to rtol 1e-4.  The measured backend's runs take the fake clocks and the
keyword ``shard_map`` of ``test_torch_mesh.py``'s ``clocks`` fixture.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.roofline as ref_roofline
import repro.launch.steps as ref_steps
import repro.launch.train as ref_train
from repro.configs import get_config as ref_get_config
from repro.configs.shapes import SHAPES
from repro.models import init_caches as ref_init_caches
from repro.models import init_lm as ref_init_lm
from repro.models import reduced as ref_reduced
from repro.optim import Optimizer as RefOptimizer
from repro.optim import adam as ref_adam
from repro_torch.configs import get_config, list_architectures
from repro_torch.launch import roofline, steps, train
from repro_torch.models import (block_pattern, caches_from_jax,
                                caches_to_jax, init_caches, params_from_jax,
                                params_to_jax, reduced)
from repro_torch.optim import Optimizer, adam

from test_torch_mesh import clocks  # noqa: F401  (a fixture)

ARCHS = list_architectures()
CLI = ["--arch", "gemma-2b", "--steps", "4", "--b0", "8", "--microbatch",
       "4", "--seq-len", "32", "--quiet"]


def _run_both(monkeypatch, extra=()):
    """Both CLIs' ``main`` on the same flags; the port's workload starts
    from the reference's initial parameters."""
    drawn = {}
    ref_lm_workload = ref_train.lm_workload

    def ref_recording(*a, **k):
        wl = ref_lm_workload(*a, **k)
        init = wl.init

        def recorded(key):
            drawn["params"] = init(key)
            return drawn["params"]

        wl.init = recorded
        return wl

    monkeypatch.setattr(ref_train, "lm_workload", ref_recording)
    ref = ref_train.main(CLI + list(extra))
    port_lm_workload = train.lm_workload

    def port_from_reference(cfg, *a, **k):
        wl = port_lm_workload(cfg, *a, **k)
        p0 = jax.tree_util.tree_map(np.asarray, drawn["params"])
        wl.init = lambda gen: params_from_jax(p0, cfg, device=gen.device)
        return wl

    monkeypatch.setattr(train, "lm_workload", port_from_reference)
    ours = train.main(CLI + list(extra) + ["--device", "cpu"])
    return ours, ref


def _assert_same_run(ours, ref):
    assert ours["steps"] == ref["steps"] == 4
    for a, b in zip(ours["history"], ref["history"]):
        assert a.batches == b.batches
        assert a.sim_time == b.sim_time
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4)
    assert ours["sim_time"] == ref["sim_time"]
    assert ours["final_batches"] == ref["final_batches"]


def test_cli_matches_the_reference_cli(monkeypatch):
    _assert_same_run(*_run_both(monkeypatch))


def test_cli_on_the_measured_backend_matches(monkeypatch, clocks):
    _assert_same_run(*_run_both(monkeypatch, ["--backend", "mesh"]))


@pytest.mark.parametrize("flags", [
    ["--backend", "mesh", "--interference"],
    ["--serve"],
    ["--backend", "mesh", "--serve", "--sync", "asp"],
    ["--global-batch-kind", "gns", "--sync", "asp"],
    ["--global-batch-kind", "dynamix", "--sync", "asp"],
], ids=["interference-mesh", "serve-sim", "serve-asp", "gns-asp",
        "dynamix-asp"])
def test_cli_errors_match(flags, capsys):
    """The reference's ``ap.error`` checks: exit 2 with the same message."""
    errors = []
    for main in (ref_train.main, train.main):
        with pytest.raises(SystemExit) as exc:
            main(CLI + flags + (["--device", "cpu"] if main is train.main
                                else []))
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.splitlines()[-1])
    assert errors[0] == errors[1]


def test_cli_dedicated_serving_names_slice_5b():
    """``--serve-mode dedicated`` withholds a device from training: on one
    device both CLIs raise the reference's reserve error, word for word;
    over four CPU rows the port's CLI trains on three while the decode
    loop owns the fourth."""
    flags = ["--backend", "mesh", "--serve", "--serve-mode", "dedicated"]
    errors = []
    for main, extra in ((ref_train.main, []),
                        (train.main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="fully preempted") as exc:
            main(CLI + flags + extra)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
    assert errors[1].startswith("reserving 1 of 1 data-axis devices")
    out = train.main(CLI + flags + ["--device", "cpu,cpu,cpu,cpu"])
    assert out["steps"] == 4
    assert all(sum(r.batches) == 3 * 8 for r in out["history"])
    serve = out["serve"]
    assert (serve["mode"], serve["reserve"], serve["serve_slice"]) == \
        ("dedicated", 1, (3, 1))
    assert serve["charged_seconds"] == 0.0


# ------------------------------------------------------------ step programs

B, S = 8, 16


def _setup(arch, seed=1):
    ref_cfg, cfg = ref_reduced(ref_get_config(arch)), reduced(get_config(arch))
    p0 = jax.tree_util.tree_map(np.asarray,
                                ref_init_lm(jax.random.PRNGKey(0), ref_cfg))
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)),
             "weights": np.linspace(0.5, 1.0, B).astype(np.float32)}
    return ref_cfg, cfg, p0, batch


def test_accum_train_step_matches_single_step():
    """``tests/test_engine.py::test_accum_train_step_matches_single_step``:
    accum_steps 4 reproduces the plain step for an aux-free model."""
    _, cfg, p0, batch = _setup("gemma-2b")
    opt = adam(1e-3)
    params = params_from_jax(p0, cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["weights"] = torch.ones(B)
    p1, _, m1 = steps.make_train_step(cfg, opt)(params, opt.init(params), 0,
                                                tb)
    p4, _, m4 = steps.make_train_step(cfg, opt, accum_steps=4)(
        params, opt.init(params), 0, tb)
    assert np.isclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    assert float(m1["weight_sum"]) == float(m4["weight_sum"])
    for k in p1:
        np.testing.assert_allclose(p1[k].numpy(), p4[k].numpy(), rtol=2e-4,
                                   atol=2e-5)
    with pytest.raises(ValueError, match="divisible"):
        steps.make_train_step(cfg, opt, accum_steps=3)(
            params, opt.init(params), 0, tb)


def _assert_trees_close(got: dict, want: dict) -> None:
    """Element by element at rtol 1e-5 and 1e-5 of each leaf's max."""
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(),
                                   err_msg=str(path))


@pytest.mark.parametrize("accum", [1, 4])
@pytest.mark.parametrize("arch", ["gemma-2b", "grok-1-314b"])
def test_train_step_matches_the_reference(arch, accum):
    """The port's train step against the reference's jitted one on the same
    parameters and batch (grok: the MoE aux, per microbatch under
    accumulation).  The gradients each step hands its optimizer (an
    optimizer that returns them as the new parameters) element by element;
    then two Adam steps: loss, aux and weight sum at rtol 1e-5, and Adam's
    moments after the first step element by element (after the second they
    hold gradients taken at parameters that Adam's first update moved by
    about lr * sign(g), which for a gradient near zero is no sign the two
    packages share)."""
    ref_cfg, cfg, p0, batch = _setup(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = params_from_jax(p0, cfg, device="cpu")

    def grads_out(p, g, s, i):
        return g, s

    ref_grads, _, _ = jax.jit(ref_steps.make_train_step(
        ref_cfg, RefOptimizer("grads", lambda p: {}, grads_out), accum))(
            p0, {}, jnp.asarray(0, jnp.int32), jb)
    grads, _, _ = steps.make_train_step(
        cfg, Optimizer("grads", lambda p: {}, grads_out), accum)(
            params, {}, 0, tb)
    _assert_trees_close(params_to_jax(grads, cfg), ref_grads)

    ref_step = jax.jit(ref_steps.make_train_step(ref_cfg, ref_adam(1e-3),
                                                 accum))
    step = steps.make_train_step(cfg, adam(1e-3), accum)
    ref_p, ref_s = p0, ref_adam(1e-3).init(p0)
    state = adam(1e-3).init(params)
    for i in range(2):
        ref_p, ref_s, ref_m = ref_step(ref_p, ref_s,
                                       jnp.asarray(i, jnp.int32), jb)
        params, state, m = step(params, state, i, tb)
        for key in ("loss", "aux", "weight_sum"):
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]),
                                       rtol=1e-5, atol=1e-7)
        if i == 0:
            for key in ("m", "v"):
                _assert_trees_close(params_to_jax(state[key], cfg),
                                    ref_s[key])


def test_prefill_and_serve_steps_match_the_reference():
    """The prefill step's last logits, then 4 serve steps from empty caches
    (logits and caches), against the reference's on the same inputs."""
    ref_cfg, cfg, p0, batch = _setup("recurrentgemma-9b")
    params = params_from_jax(p0, cfg, device="cpu")
    toks = batch["tokens"][:2]
    want = jax.jit(ref_steps.make_prefill_step(ref_cfg))(
        p0, {"tokens": jnp.asarray(toks)})
    got = steps.make_prefill_step(cfg)(params,
                                       {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    ref_serve = jax.jit(ref_steps.make_serve_step(ref_cfg))
    serve = steps.make_serve_step(cfg)
    ref_caches = ref_init_caches(ref_cfg, 2, S, jnp.float32)
    caches = init_caches(cfg, 2, S, device="cpu")
    for i in range(4):
        lw, ref_caches = ref_serve(p0, {
            "token": jnp.asarray(toks[:, i:i + 1]),
            "position": jnp.asarray(i, jnp.int32), "caches": ref_caches})
        lg, caches = serve(params, {
            "token": torch.from_numpy(toks[:, i:i + 1]),
            "position": torch.tensor(i, dtype=torch.int32),
            "caches": caches})
        np.testing.assert_allclose(lg.numpy(), np.asarray(lw), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(lw)).max())
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(caches_to_jax(caches, cfg)),
            jax.tree_util.tree_leaves_with_path(ref_caches)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=str(path))
    assert caches_from_jax(caches_to_jax(caches, cfg), cfg,
                           device="cpu").keys() == caches.keys()


def _port_cache_leaves(caches, cfg) -> dict:
    """The port's flat caches as the reference's leaf paths -> (shape,
    dtype): groups stacked on a leading axis, the tail unstacked (the
    layout ``caches_to_jax`` writes)."""
    period = len(block_pattern(cfg)) if cfg.family != "encdec" else 1
    grouped = cfg.num_layers // period * period
    out = {}
    for name, t in caches.items():
        parts = name.split(".")
        i = int(parts[1])
        if parts[0] == "dec":
            key, lead = (parts[2],), (cfg.num_layers,)
        elif i < grouped:
            key = ("groups", f"b{i % period}", *parts[2:])
            lead = (cfg.num_layers // period,)
        else:
            key, lead = ("tail", f"t{i - grouped}", *parts[2:]), ()
        out[key] = (lead + tuple(t.shape), str(t.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch):
    """Every shape's specs: ``meta`` tensors with the reference's shapes and
    dtypes (decode caches compared leaf by leaf through the stacking)."""
    for shape in SHAPES.values():
        ref_cfg = ref_steps.adapt_for_shape(ref_get_config(arch), shape)
        cfg = steps.adapt_for_shape(get_config(arch), shape)
        assert cfg.window == ref_cfg.window
        assert steps.supported(cfg, shape) == ref_steps.supported(ref_cfg,
                                                                  shape)
        if not steps.supported(cfg, shape)[0]:
            continue
        want, got = ref_steps.input_specs(ref_cfg, shape), \
            steps.input_specs(cfg, shape)
        assert list(got) == list(want)
        for key, spec in got.items():
            if key == "caches":
                ref_leaves = {
                    tuple(k.key for k in path): (tuple(x.shape), x.dtype.name)
                    for path, x in jax.tree_util.tree_leaves_with_path(
                        want[key])}
                assert _port_cache_leaves(spec, cfg) == ref_leaves
                assert all(t.device.type == "meta" for t in spec.values())
                continue
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(want[key].shape), key
            assert str(spec.dtype).split(".")[-1] == want[key].dtype.name


@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_choice_and_roofline_counts_match(arch):
    """``pick_optimizer`` (by the reference's parameter count),
    ``active_params`` and ``model_flops`` for every shape ``==``."""
    n = ref_steps.param_count(ref_get_config(arch))
    assert steps.pick_optimizer(get_config(arch), n).name == \
        ref_steps.pick_optimizer(ref_get_config(arch), n).name
    assert roofline.active_params(arch, n) == \
        ref_roofline.active_params(arch, n)
    for shape in SHAPES:
        rec = {"arch": arch, "shape": shape, "params": n}
        assert roofline.model_flops(rec) == ref_roofline.model_flops(rec)


def test_pick_optimizer_counts_parameters_itself():
    assert steps.pick_optimizer(get_config("gemma-2b")).name == "adam"
    assert steps.pick_optimizer(get_config("grok-1-314b")).name == "momentum"


def test_init_params_struct_is_meta_and_counts_the_parameters():
    cfg = get_config("llama3-8b")
    struct = steps.init_params_struct(cfg)
    assert all(t.device.type == "meta" for t in struct.values())
    assert sum(t.numel() for t in struct.values()) == \
        ref_steps.param_count(ref_get_config("llama3-8b"))


def _record(**kw):
    rec = {"arch": "llama3-8b", "shape": "train_4k", "mesh": "16x16",
           "status": "ok", "kind": "train", "devices": 256,
           "params": 8_030_261_248, "optimizer": "adam",
           "argument_size_in_bytes": 3 << 30, "temp_size_in_bytes": 5 << 30,
           "output_size_in_bytes": 1 << 30,
           "probe": {"flops_total": 7.9e14, "bytes_accessed_total": 2.1e12,
                     "collective_bytes_total": 4.0e10}}
    rec.update(kw)
    return rec


def test_analyze_matches_the_reference_at_the_same_constants(monkeypatch):
    """A hand-made record through both ``analyze`` and ``table``, the
    reference's constants set to the port's H100 ones: every number ``==``
    (only the suggestion strings name other hardware)."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(ref_roofline, name, getattr(roofline, name))
    recs = [_record(), _record(shape="train_4k_x2"),
            _record(probe={"flops_total": 1e12, "bytes_accessed_total": 9e12,
                           "collective_bytes_total": 1e9}, shape="decode_32k"),
            _record(probe={}, flops_scanned=1e13, bytes_scanned=1e9,
                    shape="prefill_32k"),
            _record(status="error")]
    for rec in recs[:4]:
        got, want = roofline.analyze(rec), ref_roofline.analyze(rec)
        assert got.pop("fix") and want.pop("fix")
        assert got == want
    assert roofline.table(recs) == ref_roofline.table(recs)
    assert roofline.batch_ramp(recs) == ref_roofline.batch_ramp(recs)
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
