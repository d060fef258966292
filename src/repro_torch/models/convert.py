"""Map the reference's parameter pytree to the port's flat parameters and
back, through numpy.

The reference (``repro.models.transformer.init_lm``) stacks the repeated
blocks along a leading layer axis under ``params["groups"]["b0"]`` and stores
linear weights as ``w`` of shape (d_in, d_out).  The port keeps one
``layers.{i}.`` entry per layer and PyTorch's ``weight`` of shape
(d_out, d_in).  Only leaves named ``w`` are transposed: the ssm family's
``ssd/conv_w`` keeps the reference's (K, C) layout, which ``ssd_block``
reads as it is.  Both directions are exact: no arithmetic touches a value.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import check_supported

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
    out = {}
    for path, x in _flatten(tree).items():
        if path[0] == "groups":
            if path[1] != "b0" or x.shape[0] != cfg.num_layers:
                raise ValueError(f"unexpected stacked leaf {path} {x.shape}")
            for i in range(cfg.num_layers):
                name, t = _leaf_to_torch(path[2:], x[i])
                out[f"layers.{i}.{name}"] = t
        else:
            name, t = _leaf_to_torch(path, x)
            out[name] = t
    return {k: v.to(device) for k, v in out.items()}


def params_to_jax(params: dict[str, torch.Tensor], cfg: ModelConfig) -> dict:
    """Flat port parameters -> the reference's nested pytree of numpy arrays."""
    check_supported(cfg)
    tree: dict = {}
    layers: dict[tuple, list] = {}
    for name, t in params.items():
        parts = name.split(".")
        x = t.detach().cpu().numpy()
        if parts[-1] == "weight":
            x = x.T
        parts[-1] = _TO_JAX.get(parts[-1], parts[-1])
        if parts[0] == "layers":
            layers.setdefault(tuple(parts[2:]), [None] * cfg.num_layers)[
                int(parts[1])] = x
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(x)
    for path, xs in layers.items():
        node = tree.setdefault("groups", {}).setdefault("b0", {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.stack(xs)
    return tree
