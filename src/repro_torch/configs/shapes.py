"""Assigned input shapes (public pool)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    # outer global-batch ramp rungs (DESIGN.md §15): the two-level batch
    # controller grows B_global by up to max_factor, so the dry-run and
    # roofline sweep the 2x / 4x points of the ramp on the same mesh
    "train_4k_x2": InputShape("train_4k_x2", 4_096, 512, "train"),
    "train_4k_x4": InputShape("train_4k_x4", 4_096, 1_024, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> InputShape:
    return SHAPES[name]
