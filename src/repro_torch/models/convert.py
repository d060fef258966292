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
vector.  Both directions are exact: no arithmetic touches a value.

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
from repro_torch.models.transformer import block_pattern, check_supported

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
    check_supported(cfg)
    device = resolve_device(device)
    period, n_groups = _layout(cfg)
    out = {}
    for path, x in _flatten(tree).items():
        if path[0] == "groups":
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
    check_supported(cfg)
    period, n_groups = _layout(cfg)
    tree: dict = {}
    stacked: dict[tuple, list] = {}
    for name, t in params.items():
        parts = name.split(".")
        x = t.detach().cpu().numpy()
        if parts[-1] == "weight":
            x = x.T
        parts[-1] = _TO_JAX.get(parts[-1], parts[-1])
        if parts[0] == "layers":
            i = int(parts[1])
            if i < n_groups * period:
                g, j = divmod(i, period)
                stacked.setdefault(("groups", f"b{j}", *parts[2:]),
                                   [None] * n_groups)[g] = x
                continue
            parts = ["tail", f"t{i - n_groups * period}", *parts[2:]]
        _put(tree, parts, np.ascontiguousarray(x))
    for path, xs in stacked.items():
        _put(tree, path, np.stack(xs))
    return tree


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
