"""Deterministic synthetic data pipeline, variable-batch aware.

Real corpora are unavailable offline, so the pipeline generates *structured*
synthetic data with deterministic per-(worker, iteration) seeding: LM token
streams from a mixture of Markov-chain "languages" over the vocab.

`TokenStream` is numpy and yields exactly the reference's tokens for the same
seed; `DataPipeline.next_batch` hands them over as int64 tensors on the
pipeline's device.  Worker k's example stream is indexed by a counter, so a
controller resize never skips or repeats data.

The vlm and encdec families also get a stub frontend's embeddings under
``"prefix"``: (n, num_patches, d_model) patches or (n, encoder_seq,
d_model) audio frames, 0.02 x N(0, 1).  Example i of worker k draws its
prefix on the pipeline's device from a ``torch.Generator`` seeded with a
hash of (seed, k, i), a pure function of (seed, worker, example index) like
its tokens, so the cursors alone resume the prefix stream bit for bit on
the same kind of device (the CPU's and the card's generators draw
different numbers).  Drawn on the host with numpy, phi-3-vision's 12
prefixes a step (576 x 3072 normals each) left an H100 idle 45 % of a
training step (PERF.md section 6).  The reference draws its prefixes from one ``jax.random`` key
split per ``next_batch`` call, which depends on the order of all calls;
the port cannot reproduce those bits in any case, and its tests hand the
reference's prefixes in.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class LMStreamConfig:
    vocab_size: int
    seq_len: int
    num_chains: int = 4         # mixture components ("languages")
    branching: int = 32         # out-degree of each Markov state
    seed: int = 0


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 — stateless per-element hashing (uint64)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class TokenStream:
    """Markov-mixture LM stream with *per-example* deterministic access.

    Example i of worker k is a pure function of (seed, worker, i) — a
    controller batch-resize can re-slice the stream arbitrarily without
    skipping or repeating data (tested by test_stream_resize_stable)."""

    def __init__(self, cfg: LMStreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v, b = cfg.vocab_size, min(cfg.branching, cfg.vocab_size)
        # per-chain transition tables: state -> b candidate successors
        self.tables = rng.integers(0, v, size=(cfg.num_chains, v, b),
                                   dtype=np.int64)

    def batch(self, worker: int, start_index: int, n: int) -> dict:
        """Examples [start_index, start_index+n) of worker `worker`'s stream."""
        cfg = self.cfg
        with np.errstate(over="ignore"):
            idx = np.arange(start_index, start_index + n, dtype=np.uint64)
            base = _splitmix64(
                idx * np.uint64(0x9E3779B97F4A7C15)
                ^ (np.uint64(worker) << np.uint64(40))
                ^ np.uint64(cfg.seed * 2654435761 % (2**63)))
            chains = (base % np.uint64(cfg.num_chains)).astype(np.int64)
            toks = np.empty((n, cfg.seq_len + 1), dtype=np.int32)
            toks[:, 0] = (_splitmix64(base ^ np.uint64(0xABCDEF))
                          % np.uint64(cfg.vocab_size)).astype(np.int32)
            # per-(example, t) branch choices, stateless
            tt = np.arange(1, cfg.seq_len + 1, dtype=np.uint64)
            choice = (_splitmix64(base[:, None] + tt[None, :]
                                  * np.uint64(0xD1B54A32D192ED03))
                      % np.uint64(self.tables.shape[-1])).astype(np.int64)
        for t in range(cfg.seq_len):
            toks[:, t + 1] = self.tables[chains, toks[:, t], choice[:, t]]
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


PREFIX_STREAM = 99   # tells the prefix draws apart from any other stream


def prefix_seeds(seed: int, worker: int, start_index: int,
                 n: int) -> list[int]:
    """The generator seed of each example [start_index, start_index + n) of
    ``worker``'s prefix stream: splitmix64 of (seed, worker, index)."""
    with np.errstate(over="ignore"):
        idx = np.arange(start_index, start_index + n, dtype=np.uint64)
        mixed = _splitmix64(
            idx * np.uint64(0x9E3779B97F4A7C15)
            ^ (np.uint64(worker) << np.uint64(40))
            ^ np.uint64((seed * 2654435761 + PREFIX_STREAM) % (2**63)))
    return [int(x) for x in mixed]


def modality_prefix(cfg: ModelConfig, seed: int, worker: int,
                    start_index: int, n: int,
                    device) -> Optional[torch.Tensor]:
    """Stub frontend embeddings (n, P, d_model) f32 on ``device`` of
    examples [start_index, start_index + n) of ``worker``'s stream for the
    vlm (P = num_patches) and encdec (P = encoder_seq) families, else
    None; each example drawn from its own generator."""
    p = {"vlm": cfg.num_patches, "encdec": cfg.encoder_seq}.get(cfg.family)
    if p is None:
        return None
    out = torch.empty((n, p, cfg.d_model), dtype=torch.float32,
                      device=device)
    for j, s in enumerate(prefix_seeds(seed, worker, start_index, n)):
        gen = torch.Generator(device=device).manual_seed(s)
        torch.randn((p, cfg.d_model), generator=gen, out=out[j])
    return out.mul_(0.02)


@dataclasses.dataclass
class WorkerDataState:
    """Per-worker stream cursor; survives batch-size replanning."""

    worker: int
    cursor: int = 0


class DataPipeline:
    """Variable-batch LM data feed for K heterogeneous workers.

    ``device``: where batches land; ``None`` means the CUDA card (and raises
    when there is none).  ``SimBackend`` moves the pipeline to its own device
    through :meth:`to`.  vlm and encdec batches carry ``"prefix"``
    (:func:`modality_prefix`).
    """

    def __init__(self, cfg: ModelConfig, seq_len: int, num_workers: int,
                 seed: int = 0, device: DeviceLike = None):
        self.model_cfg = cfg
        self.seed = seed
        self.device = resolve_device(device)
        self.stream = TokenStream(LMStreamConfig(
            vocab_size=cfg.vocab_size, seq_len=seq_len, seed=seed))
        self.states = [WorkerDataState(k) for k in range(num_workers)]

    def to(self, device: DeviceLike) -> "DataPipeline":
        self.device = resolve_device(device)
        return self

    def next_batch(self, worker: int, n: int) -> dict:
        st = self.states[worker]
        batch = {k: torch.from_numpy(v.astype(np.int64)).to(self.device)
                 for k, v in self.stream.batch(worker, st.cursor, n).items()}
        prefix = modality_prefix(self.model_cfg, self.seed, worker,
                                 st.cursor, n, self.device)
        if prefix is not None:
            batch["prefix"] = prefix
        st.cursor += n
        return batch

    def state_dict(self):
        return {"cursors": [s.cursor for s in self.states]}

    def load_state_dict(self, state):
        for s, c in zip(self.states, state["cursors"]):
            s.cursor = int(c)
