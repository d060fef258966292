"""Map the reference's parameter pytree to the port's flat parameters and
back, through numpy.

The reference (``repro.models.transformer.init_lm``) stacks the repeated
block groups along a leading axis: ``params["groups"]["b{j}"]`` holds block j
of each of the ``n_groups = num_layers // period`` groups of the block
pattern (period 1 for the dense and ssm families), and a hybrid model's
remainder layers sit unstacked under ``params["tail"]["t{i}"]``.  Group g's
block j is the port's ``layers.{g * period + j}``, tail block i its
``layers.{n_groups * period + i}``.  The reference stores linear weights as
``w`` of shape (d_in, d_out), the port PyTorch's ``weight`` of shape
(d_out, d_in).  Only leaves named ``w`` are transposed: ``conv_w`` (ssm and
rec blocks) keeps the reference's (K, C) layout and ``rglru/lam`` is a
vector; MoE expert weights (``moe/w_gate``, ``w_up``, ``w_down``) are bare
(E, D, F) / (E, F, D) leaves and stay as they are, while the router's
``moe/router/w`` (D, E) becomes ``moe.router.weight`` (E, D) like every
``w``.  The encoder-decoder's ``enc`` and ``dec`` stacks (leading axis the
layer) become ``enc.{i}.*`` and ``dec.{i}.*``.  Both directions are exact:
no arithmetic touches a value.

``caches_from_jax`` / ``caches_to_jax`` map decode caches the same way:
the reference's ``caches["groups"]["b{j}"]`` leaves are (groups, B, ...),
the port's ``layers.{i}.*`` (B, ...), no leaf transposed, the write index
int32 on both sides (MLA caches hold ``c_kv``, ``k_rope`` and ``idx``).  The
encoder-decoder's ``init_dec_caches`` leaves are (layers, B, ...), the
port's ``dec.{i}.*``.

``reference_leaves`` groups the port's parameter names into the
reference's leaves (the stacks above), for an optimizer that treats a
stacked leaf as one array.

``paper_params_from_jax`` does the same for the paper workloads
(``models/simple.py``), whose parameters are one flat dict on both sides:
conv kernels go from the reference's HWIO to PyTorch's OIHW, every other
leaf as it is (the port's CNN flattens NHWC activations, so ``w1``'s rows
keep the reference's order).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import block_pattern
from repro_torch.optim.optimizers import Leaf

_TO_TORCH = {"w": "weight", "b": "bias"}
_TO_JAX = {v: k for k, v in _TO_TORCH.items()}


def _flatten(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _leaf_to_torch(path: tuple, x: np.ndarray):
    name = _TO_TORCH.get(path[-1], path[-1])
    if path[-1] == "w":
        x = x.T
    return ".".join(path[:-1] + (name,)), torch.from_numpy(
        np.array(x, order="C", copy=True))


def params_from_jax(tree: dict, cfg: ModelConfig,
                    device: DeviceLike = None) -> dict[str, torch.Tensor]:
    """Reference pytree (jax or numpy leaves) -> flat port parameters on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    period, n_groups = _layout(cfg)
    out = {}
    for path, x in _flatten(tree).items():
        if path[0] in _STACKS:
            n = _stack_depth(cfg, path[0])
            if x.shape[0] != n:
                raise ValueError(f"unexpected stacked leaf {path} {x.shape}")
            for i in range(n):
                name, t = _leaf_to_torch(path[1:], x[i])
                out[f"{path[0]}.{i}.{name}"] = t
        elif path[0] == "groups":
            j = _index(path[1], "b", period)
            if x.shape[0] != n_groups:
                raise ValueError(f"unexpected stacked leaf {path} {x.shape}")
            for g in range(n_groups):
                name, t = _leaf_to_torch(path[2:], x[g])
                out[f"layers.{g * period + j}.{name}"] = t
        elif path[0] == "tail":
            i = _index(path[1], "t", cfg.num_layers - n_groups * period)
            name, t = _leaf_to_torch(path[2:], x)
            out[f"layers.{n_groups * period + i}.{name}"] = t
        else:
            name, t = _leaf_to_torch(path, x)
            out[name] = t
    return {k: v.to(device) for k, v in out.items()}


def paper_params_from_jax(name: str, tree: dict,
                          device: DeviceLike = None) -> dict[str, torch.Tensor]:
    """A paper workload's reference parameters (jax or numpy leaves) -> the
    port's, on ``device`` (the card unless the caller asks for the CPU).
    ``name`` is a ``paper_workloads()`` key; 4-d leaves are conv kernels."""
    from repro_torch.models.simple import paper_workloads

    if name not in paper_workloads():
        raise ValueError(f"unknown paper workload {name!r}")
    device = resolve_device(device)
    out = {}
    for key, x in tree.items():
        x = np.asarray(x)
        if x.ndim == 4:
            x = x.transpose(3, 2, 0, 1)   # HWIO -> OIHW
        out[key] = torch.from_numpy(np.array(x, order="C",
                                             copy=True)).to(device)
    return out


def params_to_jax(params: dict[str, torch.Tensor], cfg: ModelConfig) -> dict:
    """Flat port parameters -> the reference's nested pytree of numpy arrays."""
    tree: dict = {}
    stacked: dict[tuple, list] = {}
    for name, t in params.items():
        path, index, depth = _reference_leaf(name, params, cfg)
        x = t.detach().cpu().numpy()
        if name.endswith(".weight"):
            x = x.T
        if index is None:
            _put(tree, path, np.ascontiguousarray(x))
        else:
            stacked.setdefault(path, [None] * depth)[index] = x
    for path, xs in stacked.items():
        _put(tree, path, np.stack(xs))
    return tree


def reference_leaves(names, cfg: ModelConfig) -> dict[tuple, Leaf]:
    """The port's parameter ``names`` grouped into the reference's leaves,
    keyed by the leaf's path in the reference's tree (the layout
    ``params_to_jax`` writes).  An optimizer that is not elementwise (the
    factored ``adafactor_mini``) needs them: the reference runs it on each
    stacked leaf as one array."""
    names = list(names)
    present = set(names)
    out: dict[tuple, list] = {}
    for name in names:
        path, index, depth = _reference_leaf(name, present, cfg)
        slots = out.setdefault(path, [None] * (1 if index is None else depth))
        slots[index or 0] = name
    return {path: Leaf(tuple(slots), path[0] in ("groups", *_STACKS),
                       slots[0].endswith(".weight"))
            for path, slots in out.items()}


def _reference_leaf(name: str, present, cfg: ModelConfig):
    """(path of the reference leaf that holds the port's ``name``, its index
    along that leaf's stacking axis or None when unstacked, the depth of
    the stack).  ``present`` holds every parameter name."""
    period, n_groups = _layout(cfg)
    parts = name.split(".")
    # a LayerNorm's bias sits beside its scale and keeps its name
    if not (parts[-1] == "bias"
            and ".".join(parts[:-1] + ["scale"]) in present):
        parts[-1] = _TO_JAX.get(parts[-1], parts[-1])
    if parts[0] in _STACKS:
        return ((parts[0], *parts[2:]), int(parts[1]),
                _stack_depth(cfg, parts[0]))
    if parts[0] == "layers":
        i = int(parts[1])
        if i < n_groups * period:
            g, j = divmod(i, period)
            return ("groups", f"b{j}", *parts[2:]), g, n_groups
        return ("tail", f"t{i - n_groups * period}", *parts[2:]), None, 1
    return tuple(parts), None, 1


def caches_from_jax(tree: dict, cfg: ModelConfig,
                    device: DeviceLike = None) -> dict[str, torch.Tensor]:
    """Reference decode caches (``init_caches`` / ``apply_lm(caches=)``, jax
    or numpy leaves) -> the port's flat caches on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    period, n_groups = _layout(cfg)
    out = {}
    for path, x in _flatten(tree).items():
        if cfg.family == "encdec":
            if len(path) != 1 or x.shape[0] != cfg.num_layers:
                raise ValueError(f"unexpected cache leaf {path} {x.shape}")
            for i in range(cfg.num_layers):
                out[f"dec.{i}.{path[0]}"] = torch.from_numpy(
                    np.array(x[i], copy=True))
        elif path[0] == "groups":
            j = _index(path[1], "b", period)
            for g in range(n_groups):
                out[".".join(("layers", str(g * period + j)) + path[2:])] = \
                    torch.from_numpy(np.array(x[g], copy=True))
        elif path[0] == "tail":
            i = _index(path[1], "t", cfg.num_layers - n_groups * period)
            out[".".join(("layers", str(n_groups * period + i)) + path[2:])] \
                = torch.from_numpy(np.array(x, copy=True))
        else:
            raise ValueError(f"unexpected cache leaf {path}")
    return {k: v.to(device) for k, v in out.items()}


def caches_to_jax(caches: dict[str, torch.Tensor], cfg: ModelConfig) -> dict:
    """The port's flat caches -> the reference's nested tree of numpy
    arrays (groups stacked on a leading axis, the tail unstacked)."""
    period, n_groups = _layout(cfg)
    tree: dict = {}
    stacked: dict[tuple, list] = {}
    for name, t in caches.items():
        parts = name.split(".")
        i, x = int(parts[1]), t.detach().cpu().numpy()
        if parts[0] == "dec":
            stacked.setdefault((parts[2],), [None] * cfg.num_layers)[i] = x
        elif i < n_groups * period:
            g, j = divmod(i, period)
            stacked.setdefault(("groups", f"b{j}", *parts[2:]),
                               [None] * n_groups)[g] = x
        else:
            _put(tree, ["tail", f"t{i - n_groups * period}", *parts[2:]], x)
    for path, xs in stacked.items():
        _put(tree, path, np.stack(xs))
    return tree


_STACKS = ("enc", "dec")   # the encoder-decoder's layer stacks


def _stack_depth(cfg: ModelConfig, stack: str) -> int:
    return cfg.encoder_layers if stack == "enc" else cfg.num_layers


def _layout(cfg: ModelConfig) -> tuple[int, int]:
    """(period of the block pattern, number of stacked groups)."""
    period = len(block_pattern(cfg))
    return period, cfg.num_layers // period


def _index(key: str, letter: str, n: int) -> int:
    """j of a ``b{j}`` / ``t{j}`` key, checked against ``n`` blocks."""
    if not (key.startswith(letter) and key[1:].isdigit()
            and int(key[1:]) < n):
        raise ValueError(f"unexpected block key {key!r} (want {letter}0.."
                         f"{letter}{n - 1})")
    return int(key[1:])


def _put(tree: dict, path, x) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = x
