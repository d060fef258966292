"""Checkpointing: tree of tensors <-> npz with atomic writes + metadata.

Flat-key encoding: nested dict/list paths joined by '/' (list items as
``#i``, an empty list or tuple as ``@empty``, ``None`` as ``@none``);
arrays stored in a single .npz, scalars and metadata (the controller's
state, data cursors, step counter) in a JSON sidecar inside the archive.
Tensors go in as numpy arrays and come back as tensors of their dtype on
the device ``load_checkpoint`` is given.  The file format is the JAX
package's.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
        if len(tree) == 0:
            out[prefix + "@empty"] = np.asarray(0)
    elif tree is None:
        out[prefix + "@none"] = np.asarray(0)
    else:
        out[prefix.rstrip("/")] = _leaf(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray], device: torch.device) -> Any:
    if len(flat) == 1 and next(iter(flat)) in ("@none",):
        return None
    if len(flat) == 1 and next(iter(flat)) in ("@empty",):
        return ()
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return torch.from_numpy(np.array(node)).to(device)
        if "@none" in node:
            return None
        if "@empty" in node:
            return ()
        keys = list(node.keys())
        if all(k.startswith("#") for k in keys):
            idx = sorted(keys, key=lambda k: int(k[1:]))
            return tuple(rebuild(node[k]) for k in idx)
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def save_checkpoint(path: str, tree: Any, metadata: dict | None = None) -> None:
    """Atomic save: write to a temporary file beside ``path``, then rename."""
    flat = _flatten(tree)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    meta = json.dumps(metadata or {}).encode()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(len(meta).to_bytes(8, "little"))
            f.write(meta)
            f.write(buf.getvalue())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, device: DeviceLike = None):
    """Returns (tree, metadata), the tree's tensors on ``device`` (the card
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(n).decode())
        data = np.load(io.BytesIO(f.read()))
        flat = {k: data[k] for k in data.files}
    return _unflatten(flat, device), meta
