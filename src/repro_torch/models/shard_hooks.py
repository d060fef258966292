"""Activation-sharding hooks (the reference's ``models/shard_hooks.py``).

Model code is mesh-agnostic; the launch layer registers a rule for a
well-known activation kind ('activations', 'logits') and the model calls
``constrain(x, kind)`` at those points.  A rule is ``(mesh, placements)``:
``constrain`` redistributes the DTensor ``x`` to those placements.  With no
rule for ``kind`` (every single-device path) it returns ``x`` itself: no
op, no copy.  A plain tensor under a rule raises: a program that runs
unsharded where its launch asked for a sharding is another program.

The rule ``decode_attn`` = ``(mesh, dp_axes, tp_axis)`` sends cached
one-token attention through ``models/sharded_attn.py``, and the port's
rules ``attention`` and ``experts`` (same form) the full-sequence
attention, the SSD scan, the embedding gather and the MoE experts to each
rank's block there; ``constrain`` never reads them.  The port also
constrains the attention output and the MoE's flat tokens to
'activations'.

Without the 'logits' rule a sharded program keeps the (B, S, V) logits
as its matmul leaves them (replicated over the model axis for a
vocabulary-sharded head), the memory the reference's rule avoids for the
256k-vocabulary configs.
"""

from __future__ import annotations

import sys
from typing import Optional

_RULES: dict = {}


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing the distributed tensor
    API on a plain path (no DTensor exists before it is imported)."""
    for name in ("torch.distributed.tensor", "torch.distributed._tensor"):
        mod = sys.modules.get(name)
        if mod is not None and isinstance(x, mod.DTensor):
            return True
    return False


def refuse_dtensor(kernel: str, *tensors) -> None:
    """The hand-written kernels take plain tensors on one card: a sharded
    program (DTensors) runs the plain path, ``use_pallas=False``, as the
    reference's dry run does.  Raise rather than fall back silently."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"the {kernel} kernels take no DTensor: run the "
                        f"sharded program with use_pallas=False (its plain "
                        f"path)")


def set_rules(rules: Optional[dict]) -> None:
    global _RULES
    _RULES = dict(rules or {})


def get_rules() -> dict:
    return dict(_RULES)


def constrain(x, kind: str):
    rule = _RULES.get(kind)
    if rule is None:
        return x
    if not is_dtensor(x):
        raise TypeError(f"a {kind!r} sharding rule is set but the model got "
                        f"a plain {tuple(x.shape)} tensor: place the inputs "
                        f"and parameters as DTensors on the rule's mesh")
    mesh, placements = rule
    return x.redistribute(mesh, placements)
