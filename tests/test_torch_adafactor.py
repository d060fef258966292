"""The port's ``adafactor_mini`` and ``get_optimizer`` against the
reference's, on shared numpy inputs.

Adafactor is the first optimizer here that is not elementwise: a leaf's
row and column means of g^2 and its update's RMS clip span the whole leaf.
The reference runs it on its stacked parameter tree (each block position
of every layer group on one leading axis; the encoder-decoder's ``enc`` /
``dec`` stacks), so the port groups its per-layer tensors into those
leaves (``models.convert.reference_leaves``).  States are compared at rtol
1e-6; parameters at rtol 1e-6 with an atol of 1e-6 of the leaf's largest
value: where an update nearly cancels a parameter the two packages' fp32
means (another summation order) leave ~1 ulp of the leaf's scale (measured
up to 2.5e-7 of the largest value), which is no relative error of the
small result.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as R
from repro.checkpoint import load_checkpoint as ref_load_checkpoint
from repro.configs import get_config as ref_get_config
from repro.models import init_encdec as ref_init_encdec
from repro.models import init_lm as ref_init_lm
from repro.models import reduced as ref_reduced
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.models import params_from_jax, params_to_jax, reduced
from repro_torch.models.convert import reference_leaves
from repro_torch.optim import adafactor_mini, get_optimizer

STEPS = 5
LR = 1e-2


def _tree_np(tree):
    return jax.tree_util.tree_map(
        lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x),
        tree)


def _assert_trees(got, want, params: bool):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        atol = 1e-6 * np.abs(b).max() if params else 0.0
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=atol,
                                   err_msg=str(path))


def _loss(p):
    return (((p["w"] - 3.0) ** 2).sum() + ((p["b"] + 1.0) ** 2).sum())


def test_adafactor_converges_as_the_reference():
    """``test_substrate.py::test_optimizers_converge``'s adafactor case:
    300 steps on the same quadratic, the loss below 0.05, and the final
    parameters the reference's."""
    ref_opt, opt = R.adafactor_mini(0.08), adafactor_mini(0.08)
    ref_p = {"w": jnp.zeros((4, 3)), "b": jnp.zeros((5,))}
    p = {"w": torch.zeros((4, 3)), "b": torch.zeros((5,))}
    ref_s, s = ref_opt.init(ref_p), opt.init(p)
    ref_update = jax.jit(ref_opt.update)
    for i in range(300):
        ref_p, ref_s = ref_update(ref_p, jax.grad(_loss)(ref_p), ref_s,
                                  jnp.asarray(i, jnp.int32))
        grads = {"w": 2 * (p["w"] - 3.0), "b": 2 * (p["b"] + 1.0)}
        p, s = opt.update(p, grads, s, i)
    assert float(_loss(p)) < 0.05, opt.name
    for k in p:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(ref_p[k]),
                                   rtol=1e-5, atol=1e-5)


def test_adafactor_memory_shape():
    """Factored state stores O(rows+cols), not O(rows*cols)."""
    state = adafactor_mini(0.1).init({"w": torch.zeros((64, 32))})
    assert sum(x.numel() for x in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: isinstance(x, torch.Tensor))) == 64 + 32


def _ref_params(arch):
    cfg = ref_reduced(ref_get_config(arch))
    init = ref_init_encdec if cfg.family == "encdec" else ref_init_lm
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0),
                                                   cfg))


def _grads(params0, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: 0.1 * rng.standard_normal(x.shape).astype(np.float32),
        params0)


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-9b",
                                  "whisper-medium"])
def test_adafactor_on_stacked_leaves_matches_the_reference(arch):
    """5 steps on the reduced model's parameters, the reference on its
    stacked tree and the port on its per-layer tensors grouped into the
    same leaves: a stacked norm scale (G, d) is a matrix whose column
    means couple the layers, and a stacked weight's RMS clip spans all G
    layers.  Gemma has 2 groups of 1 block, recurrentgemma 1 group of 3
    blocks and an unstacked tail of 2, whisper its enc and dec stacks."""
    cfg = reduced(get_config(arch))
    p0 = _ref_params(arch)
    ref_opt = R.adafactor_mini(LR)
    ref_p, ref_s = p0, ref_opt.init(p0)
    params = params_from_jax(p0, cfg, device="cpu")
    opt = adafactor_mini(LR, leaves=reference_leaves(params, cfg))
    state = opt.init(params)
    _assert_trees(_tree_np(state), ref_s, params=False)
    ref_update = jax.jit(ref_opt.update)
    for step in range(STEPS):
        g = _grads(p0, step)
        ref_p, ref_s = ref_update(ref_p, g, ref_s,
                                  jnp.asarray(step, jnp.int32))
        params, state = opt.update(params, params_from_jax(g, cfg,
                                                           device="cpu"),
                                   state, step)
    _assert_trees(_tree_np(state), ref_s, params=False)
    _assert_trees(params_to_jax(params, cfg), ref_p, params=True)


def test_adafactor_state_round_trips_through_a_checkpoint(tmp_path):
    """The state is the reference's tree: saved by the port's checkpoint
    module it loads back into the port, and continues bit for bit, and
    the reference's loader reads it as its own state's tree."""
    cfg = reduced(get_config("gemma-2b"))
    p0 = _ref_params("gemma-2b")
    params = params_from_jax(p0, cfg, device="cpu")
    opt = adafactor_mini(LR, leaves=reference_leaves(params, cfg))
    state = opt.init(params)
    for step in range(2):
        params, state = opt.update(
            params, params_from_jax(_grads(p0, step), cfg, device="cpu"),
            state, step)
    path = str(tmp_path / "adafactor.npz")
    save_checkpoint(path, {"opt": state}, {"step": 2})
    loaded, meta = load_checkpoint(path, device="cpu")
    assert meta == {"step": 2}
    _assert_trees(_tree_np(loaded["opt"]), _tree_np(state), params=False)
    g = params_from_jax(_grads(p0, 2), cfg, device="cpu")
    p_a, s_a = opt.update(params, g, state, 2)
    p_b, s_b = opt.update(params, g, loaded["opt"], 2)
    assert all(torch.equal(p_a[k], p_b[k]) for k in p_a)
    ref_tree, _ = ref_load_checkpoint(path)
    ref_state = R.adafactor_mini(LR).init(p0)
    assert jax.tree_util.tree_structure(ref_tree["opt"]) == \
        jax.tree_util.tree_structure(ref_state)
    for a, b in zip(jax.tree_util.tree_leaves(ref_tree["opt"]),
                    jax.tree_util.tree_leaves(ref_state)):
        assert a.shape == b.shape


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw",
                                  "adafactor"])
def test_get_optimizer_takes_every_name(name):
    """Each name gives the reference's optimizer: 3 steps on the same
    parameters and gradients agree to fp32 rounding."""
    rng = np.random.default_rng(0)
    p_np = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
    ref_opt, opt = R.get_optimizer(name, 1e-2), get_optimizer(name, 1e-2)
    assert opt.name == ref_opt.name
    ref_p = {k: jnp.asarray(v) for k, v in p_np.items()}
    p = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    ref_s, s = ref_opt.init(ref_p), opt.init(p)
    for step in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p_np.items()}
        ref_p, ref_s = ref_opt.update(ref_p, {k: jnp.asarray(v) for k, v in
                                              g.items()}, ref_s,
                                      jnp.asarray(step, jnp.int32))
        p, s = opt.update(p, {k: torch.from_numpy(v) for k, v in g.items()},
                          s, step)
    for k in p:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(ref_p[k]),
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(KeyError):
        get_optimizer("lamb", 1e-2)
