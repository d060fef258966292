"""Batched serving engine: prefill + KV-cache decode (DESIGN.md §6, §17).

``serve_step`` is ONE new token against a cache; :func:`generate` drives it
for a batch of same-length prompts.  The continuous-batching scheduler
(``repro_torch.serve.scheduler``) drives the same decode path slot by slot,
and the co-located serving trainer (``repro_torch.train.colocate``) runs
that scheduler on the training device, so a decode step's cost is what the
batch controller ends up absorbing.

:class:`PrefillProgram` is the disaggregated admission path (DESIGN.md
§17): a prompt runs through one B=1 program and the single-sequence cache
it produces is installed into a free decode slot by
:class:`repro_torch.serve.slots.KVSlotManager`.  The reference pads the fed
sequence up to a rung of a geometric length ladder (``bucket_up``) and
masks the padded steps, so that XLA traces once per rung; eager PyTorch
traces nothing, so the port runs exactly ``len(fed)`` decode steps.  The
padded steps leave the reference's state untouched, so the lane and the
position come out the same; ``traces`` counts the distinct rungs first
used, which is what the reference's trace count is.

Decoding is greedy (or tempered sampling from an explicit
``torch.Generator``); there is no decode kernel, in the reference either:
attention over the cache is the plain scores.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.batching import bucket_up
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serve.scheduler import on_device


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 2048         # cache length
    temperature: float = 0.0    # 0 => greedy


def cache_length(cfg: ModelConfig, seq_len: int) -> int:
    """Effective attention-cache length for a decode shape (window-capped)."""
    if cfg.window is not None:
        return min(seq_len, cfg.window)
    return seq_len


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, cache_len: int):
    """Run the prompt through the decode path token by token (one
    full-parameter pass a token), filling fresh caches on the tokens'
    device.  tokens (B, S) -> (last logits (B, V), caches)."""
    b, s = tokens.shape
    caches = T.init_caches(cfg, b, cache_len, device=tokens.device)
    logits = None
    for i in range(s):
        pos = torch.full((b, 1), i, dtype=torch.int64, device=tokens.device)
        logits, caches, _ = T.apply_lm(params, cfg, tokens[:, i:i + 1],
                                       caches=caches, positions=pos)
    return logits[:, 0], caches


class PrefillProgram:
    """Single-sequence prefill over a bucketed length ladder.

    ``run(fed)`` replays the *fed* token sequence (the exact tokens the
    decode path would have consumed: the prompt for a fresh request; the
    prompt and the replayed continuations for a migration resume) through
    B=1 decode steps and returns ``(slot_state, position)``:

      * ``slot_state`` — the per-slot cache lane (every cache tensor with
        its batch dim stripped, the write index included), the unit
        :meth:`repro_torch.serve.slots.LMShard.install` consumes;
      * ``position`` — ``len(fed)``, the RoPE position of the next token.

    ``traces`` counts the ladder rungs (``bucket_up``) that runs have
    reached, the reference's one program per rung (module docstring).
    """

    def __init__(self, params, cfg: ModelConfig, *, cache_len: int,
                 device: DeviceLike = None, base: int = 4,
                 growth: float = 1.25):
        self.device = resolve_device(device)
        self.params = on_device(params, self.device)
        self.cfg = cfg
        self.cache_len = cache_len
        self.base = base
        self.growth = growth
        self._rungs: set[int] = set()
        self.calls = 0
        self.traces = 0

    def bucket_for(self, length: int) -> int:
        return bucket_up(length, base=self.base, growth=self.growth)

    def run(self, fed) -> tuple[dict, int]:
        fed = np.asarray(fed, dtype=np.int32)
        if fed.ndim != 1 or fed.size < 1:
            raise ValueError(
                f"fed token sequence must be a non-empty 1-D array, got "
                f"shape {fed.shape}")
        if fed.size > self.cache_len:
            raise ValueError(
                f"fed sequence of {fed.size} tokens exceeds the "
                f"{self.cache_len}-slot cache")
        bucket = self.bucket_for(fed.size)
        if bucket not in self._rungs:
            self._rungs.add(bucket)
            self.traces += 1
        tokens = torch.from_numpy(fed.astype(np.int64)).to(self.device)
        _, caches = prefill(self.params, self.cfg, tokens[None, :],
                            self.cache_len)
        self.calls += 1
        # strip the B=1 batch dim -> one slot lane
        return {k: v[0] for k, v in caches.items()}, int(fed.size)

    def warmup(self, max_len: Optional[int] = None) -> None:
        """Run the rungs up to ``max_len`` (default: the smallest) once with
        throwaway results, as the reference does to compile them."""
        if max_len is None:
            rungs = [1]
        else:
            max_len = min(max_len, self.cache_len)
            rungs = sorted({self.bucket_for(n)
                            for n in range(1, max_len + 1)})
        for n in rungs:
            self.run(np.zeros(min(n, self.cache_len), dtype=np.int32))
            self.calls -= 1


def fed_sequence(req) -> tuple[np.ndarray, int]:
    """The token stream a request's decode has consumed so far, plus the
    next token to feed — the replay unit for prefill and migration resume.

    The prompt is fed at positions ``0..L-1``, then the LAST prompt token is
    fed again at position L to produce the first continuation, and each
    produced token is fed back to produce the next.  So:

      * fresh request  — fed = prompt,                       next = prompt[-1]
      * after m tokens — fed = prompt + [prompt[-1]] + tokens[:m-1],
                         next = tokens[m-1]
    """
    prompt = np.asarray(req.prompt, dtype=np.int32)
    if not req.tokens:
        return prompt, int(prompt[-1])
    fed = np.concatenate([
        prompt, prompt[-1:],
        np.asarray(req.tokens[:-1], dtype=np.int32)])
    return fed.astype(np.int32), int(req.tokens[-1])


@torch.no_grad()
def serve_step(params, cfg: ModelConfig, token, caches, position):
    """One decode step: token (B, 1) -> (logits (B, V), new caches);
    ``position`` is an int or a (B,) tensor."""
    b = token.shape[0]
    pos = torch.as_tensor(position, device=token.device).reshape(-1, 1)
    logits, caches, _ = T.apply_lm(params, cfg, token, caches=caches,
                                   positions=pos.expand(b, 1))
    return logits[:, 0], caches


def sample(logits, generator: Optional[torch.Generator],
           temperature: float):
    """Greedy argmax at temperature 0, else a draw from
    softmax(logits / temperature) with ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(params, cfg: ModelConfig, prompts, num_tokens: int,
             serve_cfg: ServeConfig,
             generator: Optional[torch.Generator] = None):
    """Greedy/temperature generation for a batch of same-length prompts
    (B, S) on their device -> (B, num_tokens)."""
    if generator is None:
        generator = torch.Generator(device=prompts.device).manual_seed(0)
    s = prompts.shape[1]
    clen = cache_length(cfg, serve_cfg.max_seq)
    _, caches = prefill(params, cfg, prompts, clen)
    tok = prompts[:, -1:]
    out = []
    for i in range(num_tokens):
        logits, caches = serve_step(params, cfg, tok, caches, s + i)
        nxt = sample(logits, generator, serve_cfg.temperature)
        out.append(nxt)
        tok = nxt[:, None]
    return torch.stack(out, dim=1)
