"""Partition specs for parameters, optimizer state, batches and caches (the
reference's ``launch/sharding.py``).

Strategy (DESIGN.md §7): tensor parallel over ``model``, FSDP (ZeRO-3-style
parameter sharding) over ``data`` for large models, batch over (``pod``,
``data``).  Rules are name-based (the reference's leaf paths); a leaf
without a matching rule falls back to a divisibility-checked heuristic.

A spec is a tuple of entries, one per tensor dim: None, a mesh axis name,
or a tuple of names (the reference's ``PartitionSpec`` entries).
``compat.to_placements`` turns one into DTensor placements on a
``DeviceMesh``.  The rule functions take any mesh with axis sizes: a
``DeviceMesh`` or a jax-style stand-in (``axis_names`` and a ``shape``
mapping).

``param_spec`` and its tables are the reference's.  The port's parameters
are per layer where the reference stacks them, so ``params_shardings``
asks ``param_spec`` about the reference's stacked leaf (through
``models.convert.reference_leaves``) and keeps the spec of the trailing
dims, in the port's orientation (a linear's ``weight`` is the reference's
``w`` transposed).  The rule path always leaves the stacked dim
unsharded; the heuristic (a leaf no rule names) can shard it, e.g. a
stacked norm scale (64, 6144) gets ('data', 'model').  A per-layer tensor
has no such dim: the port replicates that axis for those leaves (ROADMAP
queue 3).
"""

from __future__ import annotations

import math
from typing import Optional

from repro_torch.compat import axis_names, axis_size, local_shape, \
    to_placements
from repro_torch.models.config import ModelConfig

__all__ = ["batch_shardings", "cache_shardings", "leaf_specs",
           "local_shape", "opt_state_shardings", "param_spec",
           "params_shardings", "per_device_bytes", "to_placements"]

Spec = tuple


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    return dim % axis_size(mesh, axis) == 0


def _checked(spec_entries, shape, mesh) -> Spec:
    """Drop axis assignments that don't divide evenly."""
    return tuple(ax if _fits(dim, mesh, ax) else None
                 for dim, ax in zip(shape, spec_entries))


# --------------------------------------------------------------- parameters

# rules: map from leaf path (joined by '.') suffix -> spec entries for the
# *unstacked* trailing dims. Leading stacked layer/group dims get None.
_RULES: list[tuple[tuple[str, ...], tuple]] = [
    # embeddings / head: V over `model` so logits inherit V/model sharding
    (("embed", "table"), ("model", "data")),
    (("lm_head", "w"), ("data", "model")),
    # attention (gqa + whisper variants)
    (("wq", "w"), ("data", "model")),
    (("wk", "w"), ("data", "model")),
    (("wv", "w"), ("data", "model")),
    (("wo", "w"), ("model", "data")),
    # mla
    (("wq_a", "w"), ("data", "model")),
    (("wq_b", "w"), ("data", "model")),
    (("wkv_a", "w"), ("data", "model")),
    (("wkv_b", "w"), ("data", "model")),
    # dense mlp
    (("w_gate", "w"), ("data", "model")),
    (("w_up", "w"), ("data", "model")),
    (("w_down", "w"), ("model", "data")),
    # moe experts: (E, D, F) / (E, F, D) — expert-parallel when E divides
    (("moe", "w_gate"), ("model", "data", None)),
    (("moe", "w_up"), ("model", "data", None)),
    (("moe", "w_down"), ("model", None, "data")),
    (("router", "w"), ("data", None)),
    # ssd
    (("in_proj", "w"), ("data", "model")),
    (("out_proj", "w"), ("model", "data")),
    (("conv_w",), (None, "model")),
    # rglru
    (("in_x", "w"), ("data", "model")),
    (("in_gate", "w"), ("data", "model")),
    (("w_a", "w"), ("data", "model")),
    (("w_x", "w"), ("data", "model")),
    (("out", "w"), ("model", "data")),
]

# MoE fallback when num_experts doesn't divide the model axis (e.g. grok's 8
# experts on a 16-way model axis): tensor-parallel inside each expert.
_MOE_FALLBACK = {
    "w_gate": (None, "data", "model"),
    "w_up": (None, "data", "model"),
    "w_down": (None, "model", "data"),
}

# decode2d mode: weights stay fully resident, sharded over BOTH axes (a
# 'data'-sharded weight would be gathered again on every decode step; the
# per-step activations are tiny, so per-layer activation all-reduces are
# the cheaper trade)
_DECODE2D_RULES: list[tuple[tuple[str, ...], tuple]] = [
    (("embed", "table"), (("model", "data"), None)),
    (("lm_head", "w"), (None, ("model", "data"))),
    (("wq", "w"), ("data", "model")),
    (("wk", "w"), ("data", "model")),
    (("wv", "w"), ("data", "model")),
    (("wo", "w"), ("model", "data")),
    (("wq_a", "w"), ("data", "model")),
    (("wq_b", "w"), ("data", "model")),
    (("wkv_a", "w"), ("data", "model")),
    (("wkv_b", "w"), ("data", "model")),
    (("w_gate", "w"), ("data", "model")),
    (("w_up", "w"), ("data", "model")),
    (("w_down", "w"), ("model", "data")),
    (("moe", "w_gate"), ("model", None, "data")),
    (("moe", "w_up"), ("model", None, "data")),
    (("moe", "w_down"), ("model", "data", None)),
    (("router", "w"), (None, None)),
    (("in_proj", "w"), ("data", "model")),
    (("out_proj", "w"), ("model", "data")),
    (("conv_w",), (None, "model")),
    (("in_x", "w"), ("data", "model")),
    (("in_gate", "w"), ("data", "model")),
    (("w_a", "w"), ("data", "model")),
    (("w_x", "w"), ("data", "model")),
    (("out", "w"), ("model", "data")),
]

_MOE_FALLBACK_2D = {
    "w_gate": (None, None, ("data", "model")),
    "w_up": (None, None, ("data", "model")),
    "w_down": (None, ("data", "model"), None),
}


def _match_mode(path: tuple[str, ...], mode: str):
    rules = _DECODE2D_RULES if mode == "decode2d" else _RULES
    for suffix, entries in rules:
        if path[-len(suffix):] == suffix:
            return entries
    return None


def param_spec(path: tuple[str, ...], shape: tuple[int, ...], mesh,
               fsdp: bool = True, mode: str = "train") -> Spec:
    """Spec entries for one leaf of the reference's tree (its path and its
    stacked shape); ``()`` replicates."""
    entries = _match_mode(path, mode)
    n_lead = 0
    if entries is not None:
        n_lead = len(shape) - len(entries)
        if n_lead < 0:  # rule matched something structurally different
            entries = None
    if entries is None:
        # heuristic: biggest dim -> model, next -> data (if divisible)
        if len(shape) <= 1 or max(shape) < 1024:
            return ()
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        ent = [None] * len(shape)
        ent[order[0]] = "model"
        if fsdp and len(order) > 1:
            ent[order[1]] = "data"
        return _checked(ent, shape, mesh)

    ent = list(entries)
    # MoE expert-dim fallback when E doesn't divide the model axis
    if len(ent) == 3 and ent[0] == "model" and not _fits(
            shape[n_lead], mesh, "model"):
        name = path[-1]
        fb = _MOE_FALLBACK_2D if mode == "decode2d" else _MOE_FALLBACK
        if name in fb:
            ent = list(fb[name])
    if not fsdp and mode != "decode2d":
        ent = [None if e == "data" else e for e in ent]
    full = [None] * n_lead + ent
    return _checked(full, shape, mesh)


def _padded(spec, ndim: int) -> Spec:
    return tuple(spec) + (None,) * (ndim - len(spec))


def leaf_specs(params, cfg: ModelConfig, mesh, fsdp: bool = True,
               mode: str = "train") -> dict[tuple, tuple[tuple, Spec]]:
    """The reference's view: for each of its leaves (path), its stacked
    shape and its full ``param_spec``, from the port's ``params`` (tensors
    or anything with a ``shape``)."""
    from repro_torch.models.convert import reference_leaves

    out = {}
    for path, leaf in reference_leaves(params, cfg).items():
        shape = tuple(params[leaf.names[0]].shape)
        if leaf.transposed:
            shape = shape[::-1]
        if leaf.stacked:
            shape = (len(leaf.names),) + shape
        out[path] = (shape, _padded(param_spec(path, shape, mesh, fsdp,
                                               mode), len(shape)))
    return out


def params_shardings(params, mesh, fsdp: bool = True, mode: str = "train",
                     *, cfg: ModelConfig) -> dict[str, Spec]:
    """Spec of each of the port's parameters: its reference leaf's spec
    without the stacked dim, in the port's orientation."""
    from repro_torch.models.convert import reference_leaves

    specs = leaf_specs(params, cfg, mesh, fsdp, mode)
    out = {}
    for path, leaf in reference_leaves(params, cfg).items():
        ent = specs[path][1][1 if leaf.stacked else 0:]
        if leaf.transposed:
            ent = ent[::-1]
        for name in leaf.names:
            out[name] = ent
    return out


def per_device_bytes(tensors: dict, specs: dict, mesh) -> int:
    """Bytes of one device's shards of ``tensors`` under ``specs``."""
    return sum(math.prod(local_shape(t.shape, specs[k], mesh))
               * t.element_size() for k, t in tensors.items())


def opt_state_shardings(opt_state, params_shard: dict, leaf_specs_: dict,
                        mesh):
    """Specs for an optimizer state tree.

    A moment keyed by a parameter's name (momentum, adam) takes that
    parameter's spec.  ``adafactor_mini``'s states sit at the reference's
    leaf paths with the stacked leaf's shape (or one dim less, factored):
    they follow the reference's shape rule over the stacked leaves
    (``leaf_specs``): an equal shape takes that leaf's spec, a shape one
    dim short takes it with the missing dim dropped, anything else
    replicates."""
    by_shape: dict = {}
    for shape, spec in leaf_specs_.values():
        by_shape.setdefault(tuple(shape), spec)

    def assign(key, leaf):
        shp = tuple(leaf.shape)
        if key in params_shard:
            return params_shard[key]
        if shp in by_shape:
            return by_shape[shp]
        # factored second moments: match a leaf shape missing one dim
        for pshape, spec in by_shape.items():
            if len(shp) == len(pshape) - 1:
                entries = _padded(spec, len(pshape))
                for drop in range(len(pshape)):
                    if pshape[:drop] + pshape[drop + 1:] == shp:
                        ent = entries[:drop] + entries[drop + 1:]
                        return _checked(ent, shp, mesh)
        return ()

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else assign(k, v)
                for k, v in tree.items()}

    return walk(opt_state)


# ------------------------------------------------------------ batch / cache


def _dp(mesh) -> tuple[str, ...]:
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def batch_shardings(batch: dict, mesh) -> dict[str, Spec]:
    """Shard the leading (batch) dim over ('pod', 'data') where divisible."""
    dp = _dp(mesh)

    def assign(leaf):
        if leaf.dim() == 0:
            return ()
        return ((dp if _fits(leaf.shape[0], mesh, dp) else None,)
                + (None,) * (leaf.dim() - 1))

    return {k: assign(v) for k, v in batch.items()}


_CACHE_RULES = {
    # leaf name -> (batch_dim_index, {dim_index: axis}); the port's caches
    # are per layer with the batch on dim 0 (the reference's are stacked
    # per group, the same dims after its leading one)
    "k": (0, {3: "model"}),        # (B, T, Hkv, Dh): shard head_dim
    "v": (0, {3: "model"}),
    "c_kv": (0, {2: "model"}),     # (B, T, R)
    "k_rope": (0, {3: "model"}),   # (B, T, 1, Dr)
    "state": (0, {1: "model"}),    # (B, H, P, N): shard ssd heads
    "conv": (0, {2: "model"}),     # (B, K-1, C)
    "h": (0, {1: "model"}),        # (B, W)
    "idx": (0, {}),                # (B,) per-row write positions
}


def cache_shardings(caches: dict, mesh) -> dict[str, Spec]:
    """Specs for the port's flat decode caches (``layers.{i}.{name}``,
    ``dec.{i}.{name}``)."""
    dp = _dp(mesh)
    out: dict[str, Spec] = {}
    for key, leaf in caches.items():
        rule = _CACHE_RULES.get(key.rsplit(".", 1)[-1])
        if rule is None or leaf.dim() == 0:
            out[key] = ()
            continue
        bdim, axmap = rule
        ent: list[Optional[object]] = [None] * leaf.dim()
        if bdim < leaf.dim() and _fits(leaf.shape[bdim], mesh, dp):
            ent[bdim] = dp
        for d, ax in axmap.items():
            if d < leaf.dim() and _fits(leaf.shape[d], mesh, ax):
                ent[d] = ax
        out[key] = tuple(ent)
    return out
