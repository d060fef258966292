"""The port's partition rules (``launch/sharding.py``), the sharded decode
attention's rule functions (``models/sharded_attn.py``) and the shard hooks
(``models/shard_hooks.py``), held against the JAX package's pure rule
functions on stand-in meshes (an object with ``axis_names`` and a ``shape``
mapping, as ``tests/test_sharding.py`` uses; ``jax.sharding.AbstractMesh``
where the reference builds a ``NamedSharding``).  No process group is made
in this process."""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_config
from repro.configs import list_architectures
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.launch import sharding as RSH
from repro.launch import steps as RST
from repro.models import init_caches as ref_init_caches
from repro.models import sharded_attn as RSA
from repro.optim import adafactor_mini as ref_adafactor

from repro_torch.compat import (Replicate, Shard, local_shape,
                                to_placements)
from repro_torch.configs import get_config
from repro_torch.configs.shapes import get_shape
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models import (apply_lm, encdec_loss, init_caches,
                                init_model, lm_loss, reduced, shard_hooks)
from repro_torch.models import sharded_attn as SA
from repro_torch.models.convert import reference_leaves
from repro_torch.models.transformer import block_pattern
from repro_torch.optim import adafactor_mini

ARCHS = list_architectures()


class Mesh16:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


class Mesh2x16:
    shape = {"pod": 2, "data": 16, "model": 16}
    axis_names = ("pod", "data", "model")


MESHES = (Mesh16, Mesh2x16)
ABSTRACT = {Mesh16: AbstractMesh((16, 16), ("data", "model")),
            Mesh2x16: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}

# the heuristic (no rule names the leaf) shards the stacked layer dim of
# these reference leaves at 16x16 with FSDP on, in both modes: the port's
# per-layer tensors replicate that axis (ROADMAP queue 3)
STACKED_DIM_CASES = sorted(
    (arch, mode, path)
    for arch, paths in {
        "grok-1-314b": ("norm1.scale", "norm2.scale"),
        "command-r-plus-104b": ("norm1.scale", "norm2.scale"),
        "yi-9b": ("norm1.scale", "norm2.scale"),
        "phi-3-vision-4.2b": ("norm1.scale", "norm2.scale"),
        "llama3-8b": ("norm1.scale", "norm2.scale"),
        "mamba2-1.3b": ("norm1.scale", "ssd.conv_b", "ssd.gate_norm.scale"),
    }.items()
    for mode in ("train", "decode2d")
    for path in paths)


@pytest.fixture(autouse=True)
def no_process_group():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _norm(spec) -> tuple:
    """Spec entries as jax canonicalises them: a one-axis tuple is that
    axis, trailing Nones dropped."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
           for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _ref_leaves(arch):
    return list(RSH._tree_paths(RST.init_params_struct(ref_config(arch))))


def _port_meta(arch):
    cfg = get_config(arch)
    return cfg, ST.init_params_struct(cfg)


def _ref_device_bytes(shape, spec, itemsize, mesh) -> int:
    n = math.prod(shape)
    for e in spec:
        if e is not None:
            n //= math.prod(mesh.shape[a] for a in (
                e if isinstance(e, tuple) else (e,)))
    return n * itemsize


# ------------------------------------------------------------ param_spec


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_reference(arch):
    """All stacked leaves x {16x16, 2x16x16} x {train, decode2d} x FSDP
    on / off: 1752 cases over the ten configs, each ``==``.  The port's
    view of the reference leaves (through ``reference_leaves``) has the
    reference's paths and stacked shapes, and no case maps an axis
    twice."""
    leaves = _ref_leaves(arch)
    cfg, meta = _port_meta(arch)
    n = 0
    for mesh in MESHES:
        for mode in ("train", "decode2d"):
            for fsdp in (True, False):
                mine = SH.leaf_specs(meta, cfg, mesh, fsdp, mode)
                assert set(mine) == {p for p, _ in leaves}
                for path, leaf in leaves:
                    ref = tuple(RSH.param_spec(path, tuple(leaf.shape), mesh,
                                               fsdp, mode))
                    assert SH.param_spec(path, tuple(leaf.shape), mesh,
                                         fsdp, mode) == ref, path
                    assert mine[path][0] == tuple(leaf.shape)
                    axes = [a for e in ref if e is not None
                            for a in (e if isinstance(e, tuple) else (e,))]
                    assert len(axes) == len(set(axes))
                    n += 1
    assert n == 8 * len(leaves)


class TestParamSpecRules:
    """``tests/test_sharding.py::TestParamSpecRules`` on the port."""

    def test_attention_rules(self):
        m = Mesh16()
        assert SH.param_spec(("groups", "b0", "attn", "wq", "w"),
                             (32, 4096, 4096), m) == (None, "data", "model")
        assert SH.param_spec(("groups", "b0", "attn", "wo", "w"),
                             (32, 4096, 4096), m) == (None, "model", "data")

    def test_moe_expert_parallel_when_divisible(self):
        spec = SH.param_spec(("groups", "b0", "moe", "w_gate"),
                             (60, 160, 5120, 1536), Mesh16())
        assert spec == (None, "model", "data", None)

    def test_moe_fallback_when_not_divisible(self):
        spec = SH.param_spec(("groups", "b0", "moe", "w_gate"),
                             (64, 8, 6144, 32768), Mesh16())
        assert spec == (None, None, "data", "model")

    def test_small_leaves_replicated(self):
        m = Mesh16()
        assert SH.param_spec(("groups", "b0", "norm1", "scale"),
                             (64, 512), m) in ((), (None, None))
        assert SH.param_spec(("groups", "b0", "norm1", "scale"),
                             (64, 4096), m) == ("data", "model")

    def test_indivisible_dims_dropped(self):
        assert SH.param_spec(("embed", "table"), (50280, 2048),
                             Mesh16())[0] is None

    def test_fsdp_off(self):
        assert SH.param_spec(("mlp", "w_gate", "w"), (4096, 14336),
                             Mesh16(), fsdp=False) == (None, "model")


def test_stacked_dim_cases_listed_exactly():
    """The 26 cases where the reference's heuristic shards a stacked leaf's
    layer dim, at 16x16 with FSDP on; the port's view of the leaves
    (``leaf_specs``) finds the same ones, and ``params_shardings`` drops
    that entry."""
    found, via_port = [], []
    for arch in ARCHS:
        cfg, meta = _port_meta(arch)
        for mode in ("train", "decode2d"):
            for path, leaf in _ref_leaves(arch):
                spec = tuple(RSH.param_spec(path, tuple(leaf.shape), Mesh16,
                                            True, mode))
                if path[0] in ("groups", "enc", "dec") and spec \
                        and spec[0] is not None:
                    assert spec == ("data", "model")
                    found.append((arch, mode, ".".join(path[2:])))
            leaves = reference_leaves(meta, cfg)
            specs = SH.params_shardings(meta, Mesh16, True, mode, cfg=cfg)
            for path, (_, spec) in SH.leaf_specs(meta, cfg, Mesh16, True,
                                                 mode).items():
                if leaves[path].stacked and spec[0] is not None:
                    via_port.append((arch, mode, ".".join(path[2:])))
                    assert all(specs[name] == ("model",)
                               for name in leaves[path].names)
    assert len(found) == 26
    assert sorted(found) == sorted(via_port) == STACKED_DIM_CASES


@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_parameter_bytes(arch):
    """Each config's per-device parameter bytes from ``params_shardings``
    ``==`` the sum over the reference's specs, plus what replicating the
    stacked dim of the listed leaves costs."""
    cfg, meta = _port_meta(arch)
    specs = SH.params_shardings(meta, Mesh16, cfg=cfg)
    port = SH.per_device_bytes(meta, specs, Mesh16)
    ref = extra = 0
    for path, leaf in _ref_leaves(arch):
        shape, item = tuple(leaf.shape), np.dtype(leaf.dtype).itemsize
        spec = tuple(RSH.param_spec(path, shape, Mesh16))
        ref += _ref_device_bytes(shape, spec, item, Mesh16)
        if path[0] == "groups" and spec and spec[0] is not None:
            extra += (_ref_device_bytes(shape, (None,) + spec[1:], item,
                                        Mesh16)
                      - _ref_device_bytes(shape, spec, item, Mesh16))
    assert port == ref + extra
    assert (extra > 0) == any(a == arch for a, _, _ in STACKED_DIM_CASES)


# ------------------------------------------------- optimizer state / batch


@pytest.mark.parametrize("arch", ["gemma-2b", "grok-1-314b",
                                  "deepseek-v2-236b", "mamba2-1.3b",
                                  "whisper-medium"])
def test_opt_state_shardings_match_reference(arch):
    """Adam's moments (keyed by parameter) take their parameter's spec,
    the reference's moment spec without the stacked entry; adafactor_mini's
    factored states (at the reference's leaf paths, stacked shapes) get
    the reference's entries (its ``NamedSharding`` built on an
    ``AbstractMesh``)."""
    cfg, meta = _port_meta(arch)
    p_spec = SH.params_shardings(meta, Mesh16, cfg=cfg)
    leaf_specs = SH.leaf_specs(meta, cfg, Mesh16)
    adam_state = {"m": {k: v for k, v in meta.items()},
                  "v": {k: v for k, v in meta.items()}}
    assert SH.opt_state_shardings(adam_state, p_spec, leaf_specs,
                                  Mesh16) == {"m": p_spec, "v": p_spec}

    rparams = RST.init_params_struct(ref_config(arch))
    amesh = ABSTRACT[Mesh16]
    r_pshard = RSH.params_shardings(rparams, amesh)
    ropt = ref_adafactor(1e-3)
    r_state = jax.eval_shape(ropt.init, rparams)
    r_oshard = RSH.opt_state_shardings(r_state, rparams, r_pshard, amesh)
    port_state = adafactor_mini(
        1e-3, leaves=reference_leaves(meta, cfg)).init(meta)
    mine = SH.opt_state_shardings(port_state, p_spec, leaf_specs, Mesh16)
    ref_flat = {tuple(k.key for k in kp): _norm(s.spec) for kp, s in
                jax.tree_util.tree_flatten_with_path(r_oshard)[0]}
    mine_flat = {}

    def walk(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                mine_flat[prefix + (k,)] = _norm(v)

    walk(mine)
    assert mine_flat == ref_flat


@pytest.mark.parametrize("mesh", MESHES, ids=["16x16", "2x16x16"])
def test_batch_shardings_match_reference(mesh):
    """Every input of every config and shape that is not a cache."""
    amesh = ABSTRACT[mesh]
    for arch in ARCHS:
        for name in REF_SHAPES:
            specs = ST.input_specs(get_config(arch), get_shape(name))
            batch = {k: v for k, v in specs.items() if k != "caches"}
            ref = RSH.batch_shardings(
                {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
                 for k, v in batch.items()}, amesh)
            mine = SH.batch_shardings(batch, mesh)
            assert {k: _norm(v) for k, v in mine.items()} == \
                {k: _norm(s.spec) for k, s in ref.items()}, (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_reference(arch):
    """The port's per-layer caches (batch on dim 0) get the reference's
    entries without its stacked dim; tail blocks (unstacked on both sides)
    get them as they are.  Batches 128 (divides the data axes) and 1."""
    cfg = get_config(arch)
    period = len(block_pattern(cfg))
    n_groups = cfg.num_layers // period
    for mesh in MESHES:
        for batch in (128, 1):
            ref_tree = jax.eval_shape(
                lambda: ref_init_caches(ref_config(arch), batch, 64)) \
                if cfg.family != "encdec" else None
            if ref_tree is None:
                from repro.models.encdec import init_dec_caches

                ref_tree = jax.eval_shape(lambda: init_dec_caches(
                    ref_config(arch), batch, 64))
                port = ST.E.init_dec_caches(cfg, batch, 64, device="meta")
            else:
                port = init_caches(cfg, batch, 64, device="meta")
            ref = RSH.cache_shardings(ref_tree, ABSTRACT[mesh])
            ref_flat = {tuple(k.key for k in kp): s.spec for kp, s in
                        jax.tree_util.tree_flatten_with_path(ref)[0]}
            mine = SH.cache_shardings(port, mesh)
            for name, spec in mine.items():
                parts = name.split(".")
                i = int(parts[1])
                if parts[0] == "dec":
                    key, stacked = (parts[2],), True
                elif i < n_groups * period:
                    key = ("groups", f"b{i % period}", *parts[2:])
                    stacked = True
                else:
                    key = ("tail", f"t{i - n_groups * period}", *parts[2:])
                    stacked = False
                r = tuple(ref_flat[key])
                if stacked:
                    assert r[:1] in ((), (None,))
                    r = r[1:]
                assert _norm(spec) == _norm(r), (arch, mesh, batch, name)


# ----------------------------------------------------- sharded_attn rules


def test_sharded_attn_rules_match_reference():
    """``normalize``, ``applicable`` and ``mla_applicable`` ``==`` the
    reference's over the ten configs, batches 1, 4 and 128, both meshes."""
    n = 0
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), ref_config(arch)
        for mesh in MESHES:
            dp = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
            for info in (None, (mesh, dp, "model"),
                         (mesh, ("data",), "model")):
                for b in (1, 4, 128):
                    assert SA.normalize(info, b) == RSA.normalize(info, b)
                    for dh in {cfg.head_dim, 32, 64}:
                        assert SA.applicable(cfg, b, dh, info) == \
                            RSA.applicable(rcfg, b, dh, info)
                    assert SA.mla_applicable(cfg, b, info) == \
                        RSA.mla_applicable(rcfg, b, info)
                    n += 1
    assert n == 10 * 2 * 3 * 3


# ------------------------------------------------------------ placements


def test_to_placements_and_local_shapes():
    """A tuple entry puts ``Shard(d)`` on each of its mesh dims (DTensor
    splits them in mesh-dim order); a mesh axis used twice raises; local
    shapes divide each dim by its entry's devices."""
    m = Mesh2x16()
    assert to_placements((("pod", "data"), None, "model"), m) == \
        [Shard(0), Shard(0), Shard(2)]
    assert to_placements((("model", "data"), None), Mesh16()) == \
        [Shard(0), Shard(0)]
    assert to_placements((), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="twice"):
        to_placements(("data", "data"), Mesh16())
    assert local_shape((256, 4096, 6144), (("pod", "data"), None, "model"),
                       m) == (8, 4096, 384)
    with pytest.raises(ValueError):
        local_shape((10,), ("model",), Mesh16())


# ----------------------------------------------------------- shard hooks


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _run(cfg, params, monkeypatch, patched: bool):
    from repro_torch.models import encdec, layers, transformer

    if patched:
        for mod in (encdec, layers, transformer):
            monkeypatch.setattr(mod, "constrain", lambda x, kind: x)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with _OpCount() as ops:
        if cfg.family == "encdec":
            frames = torch.from_numpy(rng.standard_normal(
                (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
            ls = encdec_loss(leaves, cfg, frames, toks, toks,
                             torch.ones(2))[0]
            logits = ls[None]
        else:
            logits, _ = apply_lm(leaves, cfg, toks)
            ls = lm_loss(leaves, cfg, toks, toks, torch.ones(2))[0]
        grads = torch.autograd.grad(ls, list(leaves.values()),
                                    allow_unused=True)
    monkeypatch.undo()
    return logits.detach(), grads, ops.n


@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-v2-236b",
                                  "whisper-medium"])
def test_hooks_change_nothing_without_rules(arch, monkeypatch):
    """With no rules set, logits and gradients are bit-equal to a run with
    ``constrain`` patched out, and the same number of ops runs."""
    cfg = reduced(get_config(arch))
    params = init_model(torch.Generator().manual_seed(0), cfg)
    assert shard_hooks.get_rules() == {}
    a = _run(cfg, params, monkeypatch, patched=False)
    b = _run(cfg, params, monkeypatch, patched=True)
    assert torch.equal(a[0], b[0])
    assert all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a[1], b[1]))
    assert a[2] == b[2]


def test_constrain_is_identity_without_a_rule_and_refuses_plain_tensors():
    x = torch.ones(2, 3)
    assert shard_hooks.constrain(x, "activations") is x
    shard_hooks.set_rules({"activations": (object(), [])})
    try:
        assert shard_hooks.get_rules().keys() == {"activations"}
        with pytest.raises(TypeError, match="plain"):
            shard_hooks.constrain(x, "activations")
        assert shard_hooks.constrain(x, "logits") is x
    finally:
        shard_hooks.set_rules(None)
    assert shard_hooks.get_rules() == {}
