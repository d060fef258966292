"""Continuous-batching request scheduler (DESIGN.md §6; co-location §13).

The paper applies dynamic batching to training; serving has the mirror
problem: request arrival is bursty and sequence lengths vary, so a *static*
serving batch either queues requests (latency) or runs underfilled
(throughput).  This scheduler keeps a fixed-shape decode batch of ``slots``
sequences and fills freed slots from the queue every step — per-slot
masking plays the role the per-example weights play in training.

Host logic over the shared decode step (:func:`decode_step`): a plain
function over tensors on the batcher's device, a masked greedy argmax read
back to the host once a step (that read synchronizes the card, so the
step's host wall covers its device work).  Driven round by round by the
co-located serving trainer (``repro_torch.train.colocate``); read
:meth:`ContinuousBatcher.stats` for the queue-pressure signal the SLO
preemption policy consumes.

Decode builds new cache tensors each step and never writes the old ones,
so holding the old dict is a complete snapshot (what :meth:`warmup`
relies on, as the reference relies on immutable arrays).  Slot lanes are
addressed by the batch dim, dim 0 of every cache tensor.
"""

from __future__ import annotations

import dataclasses
import time as _time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (prompt_len,) int32
    max_new_tokens: int
    arrived_step: int = 0
    # filled by the scheduler:
    started_step: Optional[int] = None
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, caches, token, positions, live):
    """One synchronized decode step over all rows: token (B, 1), positions
    (B,), live (B,) bool -> (next tokens (B,) with 0 on dead rows, new
    caches).  Every row's cache advances, live or not, as in the
    reference."""
    logits, caches, _ = T.apply_lm(params, cfg, token, caches=caches,
                                   positions=positions[:, None])
    nxt = torch.argmax(logits[:, 0], dim=-1)
    return torch.where(live, nxt, torch.zeros_like(nxt)), caches


def on_device(params: dict, device: torch.device) -> dict:
    """``params`` on ``device``; a tensor already there is the same tensor
    (one copy of the weights, however many programs share them)."""
    return {k: v.to(device) for k, v in params.items()}


class ContinuousBatcher:
    """Slot-based continuous batching over a fixed-shape decode step."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 cache_len: int = 256, eos_id: Optional[int] = None,
                 device: DeviceLike = None):
        """``device`` holds params, caches and every decode step (the card
        unless the caller asks for the CPU)."""
        self.device = resolve_device(device)
        self.params = on_device(params, self.device)
        self.cfg = cfg
        self.slots = slots
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.queue: deque[Request] = deque()
        self.active: list[Optional[Request]] = [None] * slots
        self.positions = np.zeros(slots, dtype=np.int32)
        self.caches = T.init_caches(cfg, slots, cache_len,
                                    device=self.device)
        self.step_count = 0
        self.finished: list[Request] = []
        # admission delays of the most recent admissions: the SLO policy's
        # queue-pressure signal must reflect *current* latency, not a
        # lifetime average an old burst could latch high forever
        self.recent_delays: deque[int] = deque(maxlen=64)
        # per-step decode walls, same windowed rationale, reset by warmup()
        self.recent_step_ms: deque[float] = deque(maxlen=256)
        self._next_token = np.zeros(slots, dtype=np.int32)

    def warmup(self) -> None:
        """One throwaway masked step, then the pre-warmup state restored
        exactly (decode never writes the cache it reads, so the old dict is
        a complete snapshot): safe on a fresh batcher and mid-flight.  The
        port compiles nothing here; the step stands in for the reference's
        compile so that both run the same steps, and the decode-latency
        window starts fresh."""
        caches = self.caches
        positions = self.positions.copy()
        next_token = self._next_token.copy()
        self._decode_one(slot_token=(0, 0))
        self.caches = caches
        self.positions = positions
        self._next_token = next_token
        self.recent_step_ms.clear()

    # ------------------------------------------------------------ intake

    def submit(self, req: Request) -> None:
        req.arrived_step = self.step_count
        self.queue.append(req)

    def _zero_slot_cache(self, slot: int) -> None:
        """Reset one slot's lane: row ``slot`` (dim 0) of every cache
        tensor, the write index included."""
        for leaf in self.caches.values():
            leaf[slot] = 0

    def _admit(self) -> None:
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            req.started_step = self.step_count
            self.recent_delays.append(req.started_step - req.arrived_step)
            self.active[slot] = req
            # prefill the slot token by token through the decode step
            # (the disaggregated engine's PrefillProgram replaces this)
            self.positions[slot] = 0
            for tok in req.prompt:
                self._decode_one(slot_token=(slot, int(tok)))
            self._next_token[slot] = int(req.prompt[-1])

    # ------------------------------------------------------------- steps

    def _decode_one(self, slot_token=None) -> np.ndarray:
        """One synchronized decode step for all slots (masked)."""
        token = np.zeros((self.slots, 1), dtype=np.int64)
        live = np.zeros((self.slots,), dtype=bool)
        if slot_token is None:
            for s, req in enumerate(self.active):
                if req is not None:
                    token[s, 0] = self._next_token[s]
                    live[s] = True
        else:
            s, tok = slot_token
            token[s, 0] = tok
            live[s] = True
        dev = self.device
        nxt, self.caches = decode_step(
            self.params, self.cfg, self.caches,
            torch.from_numpy(token).to(dev),
            torch.from_numpy(self.positions.astype(np.int64)).to(dev),
            torch.from_numpy(live).to(dev))
        nxt = nxt.cpu().numpy()
        self.positions[live] += 1
        return nxt

    def step(self) -> None:
        """Admit from the queue, decode one token for every active slot,
        retire finished requests."""
        t0 = _time.perf_counter()
        self._admit()
        if not any(r is not None for r in self.active):
            self.step_count += 1
            return
        nxt = self._decode_one()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(nxt[s])
            req.tokens.append(tok)
            if (len(req.tokens) >= req.max_new_tokens
                    or (self.eos_id is not None and tok == self.eos_id)
                    or self.positions[s] >= self.cache_len - 1):
                req.done = True
                self.finished.append(req)
                self.active[s] = None
                self._zero_slot_cache(s)
                self.positions[s] = 0
            else:
                self._next_token[s] = tok
        self.step_count += 1
        # the wall includes admission work on purpose: token-by-token
        # prefill inside step() is what the disaggregated engine removes
        self.recent_step_ms.append(1e3 * (_time.perf_counter() - t0))

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.active)

    def run_until_idle(self, max_steps: int = 10_000) -> list[Request]:
        for _ in range(max_steps):
            if self.idle:
                break
            self.step()
        return self.finished

    # ----------------------------------------------------------- metrics

    def stats(self) -> dict:
        """Queue-pressure snapshot; every entry is a plain float/int and is
        well-defined on a completely idle batcher (the SLO policy polls it
        between training rounds, also before any traffic arrived)."""
        lat = list(self.recent_delays)
        walls = list(self.recent_step_ms)
        occ = np.mean([r is not None for r in self.active]) if self.active \
            else 0.0
        return {
            "finished": len(self.finished),
            "queued": len(self.queue),
            "free_slots": sum(r is None for r in self.active),
            "mean_queue_delay_steps": float(np.mean(lat)) if lat else 0.0,
            "p95_queue_delay_steps": (float(np.percentile(lat, 95))
                                      if lat else 0.0),
            "occupancy_now": float(occ),
            "p50_decode_step_ms": (float(np.percentile(walls, 50))
                                   if walls else 0.0),
            "p95_decode_step_ms": (float(np.percentile(walls, 95))
                                   if walls else 0.0),
        }
