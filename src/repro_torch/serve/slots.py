"""Sharded multi-slot decode with prefill/decode disaggregation
(DESIGN.md §17).

The :class:`~repro_torch.serve.scheduler.ContinuousBatcher` is one decode
step on ONE device, and its admission path stalls the whole decode batch
for L token-by-token steps per prompt.  This module is the production-shaped
replacement:

  * a :class:`KVSlotManager` owns ``shards × slots_per_shard`` KV-cache
    slots spread over a serve region — one decode shard per region device,
    lease-backed by a :class:`repro_torch.core.placement.DevicePool` (one
    1-device lease per shard, packed; shard removals shift later leases
    down and the pool's ``migrations`` counter prices the reconfiguration);
  * admission is **disaggregated**: prompts run through a dedicated
    prefill program (:class:`repro_torch.serve.engine.PrefillProgram`) and
    the produced cache lane is handed to the decode loop through a FIFO
    **handoff queue**, so decode steps stay uniform;
  * grow/shrink **migrates live slots**: a removed shard's occupied slots
    are extracted and installed into free survivor slots (cache lane +
    write index travel together); when no free slot exists the request is
    re-queued at the FRONT as a *resume* whose replay feeds the exact
    token stream already consumed
    (:func:`repro_torch.serve.engine.fed_sequence`), so token prefixes
    survive arbitrary grow/shrink interleavings.

The shard/prefill substrate is pluggable: :class:`LMShard` runs the real
decode step on a device, :class:`FakeShard`/:class:`FakePrefill` are
pure-host deterministic stand-ins so property tests explore long admission
interleavings in milliseconds.  Everything below :class:`LMShard` is host
logic, the reference's as it is.
"""

from __future__ import annotations

import time as _time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.placement import DevicePool
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import PrefillProgram, fed_sequence
from repro_torch.serve.scheduler import Request, decode_step, on_device


class LMShard:
    """One decode shard: a fixed-shape multi-slot decode step on one device
    of the serve region.

    The decode math is :class:`ContinuousBatcher`'s step (masked greedy
    argmax over all slots), but admission never goes through it — slots are
    filled by :meth:`install` from a prefilled cache lane (every cache
    tensor's row, the write index included).  A slot's lane is row ``slot``
    of dim 0 of every cache tensor.  The shard's ``key`` in the manager's
    pool is its id: the port's device is never None, and two shards may
    share one.
    """

    def __init__(self, params, cfg, *, slots: int, cache_len: int,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = on_device(params, self.device)
        self.cfg = cfg
        self.slots = slots
        self.cache_len = cache_len
        self.key = id(self)
        self.caches = T.init_caches(cfg, slots, cache_len,
                                    device=self.device)

    # ------------------------------------------------------------ slot lanes

    def install(self, slot: int, state) -> None:
        """Write a prefilled/extracted cache lane into ``slot``; a lane from
        another device (a migration's) is moved here."""
        for name, leaf in self.caches.items():
            leaf[slot] = state[name].to(device=leaf.device, dtype=leaf.dtype)

    def extract(self, slot: int):
        """Read ``slot``'s cache lane back to the host (for migration)."""
        return {name: leaf[slot].to("cpu", copy=True)
                for name, leaf in self.caches.items()}

    def clear(self, slot: int) -> None:
        for leaf in self.caches.values():
            leaf[slot] = 0

    # ---------------------------------------------------------------- decode

    def decode(self, tokens: np.ndarray, live: np.ndarray,
               positions: np.ndarray) -> np.ndarray:
        """One synchronized decode step over all slots (masked)."""
        dev = self.device
        nxt, self.caches = decode_step(
            self.params, self.cfg, self.caches,
            torch.from_numpy(np.asarray(tokens, dtype=np.int64)
                             .reshape(self.slots, 1)).to(dev),
            torch.from_numpy(np.asarray(positions, dtype=np.int64)).to(dev),
            torch.from_numpy(np.asarray(live, dtype=bool)).to(dev))
        return nxt.cpu().numpy()

    def warmup(self) -> None:
        """One throwaway step, the pre-warmup caches restored (decode never
        writes the caches it reads), so a mid-flight re-warm never perturbs
        live slots."""
        caches = self.caches
        self.decode(np.zeros(self.slots, dtype=np.int32),
                    np.zeros(self.slots, dtype=bool),
                    np.zeros(self.slots, dtype=np.int32))
        self.caches = caches


class LMPrefill(PrefillProgram):
    """Alias kept next to :class:`LMShard` for symmetry — the real prefill
    substrate IS the engine's program."""


class FakeShard:
    """Pure-host deterministic decode shard for property tests.

    A slot's state is the list of tokens its decode has consumed; the next
    token is a deterministic hash of that history, so ANY schedule of
    installs/extracts/migrations that preserves the consumed stream also
    preserves every future token — which is exactly the property the
    hypothesis tests assert.
    """

    def __init__(self, *, slots: int, vocab: int = 97, key=None):
        self.slots = slots
        self.vocab = vocab
        self.key = key if key is not None else id(self)
        self._fed: list[Optional[list[int]]] = [None] * slots

    @staticmethod
    def next_token(fed: list[int], vocab: int) -> int:
        acc = 17
        for t in fed:
            acc = (acc * 31 + int(t) + 1) % 1_000_003
        return acc % vocab

    def install(self, slot: int, state) -> None:
        self._fed[slot] = list(state["fed"])

    def extract(self, slot: int):
        return {"fed": list(self._fed[slot])}

    def clear(self, slot: int) -> None:
        self._fed[slot] = None

    def decode(self, tokens, live, positions) -> np.ndarray:
        out = np.zeros(self.slots, dtype=np.int64)
        for s in range(self.slots):
            if live[s]:
                self._fed[s].append(int(tokens[s]))
                out[s] = self.next_token(self._fed[s], self.vocab)
        return out

    def warmup(self) -> None:
        pass


class FakePrefill:
    """Host-side prefill matching :class:`FakeShard`'s state model."""

    def __init__(self):
        self.calls = 0
        self.traces = 0

    def run(self, fed) -> tuple[dict, int]:
        fed = [int(t) for t in np.asarray(fed).ravel()]
        self.calls += 1
        return {"fed": fed}, len(fed)

    def warmup(self) -> None:
        pass


class KVSlotManager:
    """Sharded continuous batching behind a prefill→decode handoff queue.

    Drop-in for the trainer-facing :class:`ContinuousBatcher` surface
    (``submit`` / ``step`` / ``stats`` / ``warmup`` / ``finished`` /
    ``queue`` / ``run_until_idle``), but the decode batch is the union of
    every shard's slots and admission is disaggregated (module docstring).

    Slot bookkeeping invariants — :meth:`check` raises on any violation,
    and the hypothesis suite calls it after every operation:

      * no aliasing: a request occupies at most one (shard, slot) and a
        slot holds at most one request;
      * conservation: total slots == Σ shard.slots == pool leased devices
        × slots_per_shard; occupied + free == total at all times;
      * no loss: submitted == finished + active + handoff + queued.
    """

    def __init__(self, shards, prefill, *, eos_id: Optional[int] = None,
                 cache_len: Optional[int] = None, extent: Optional[int] = None,
                 prefills_per_step: int = 1):
        shards = list(shards)
        if not shards:
            raise ValueError("need at least one decode shard")
        if prefills_per_step < 1:
            raise ValueError("prefills_per_step must be >= 1")
        self.prefill = prefill
        self.eos_id = eos_id
        self.cache_len = cache_len
        self.prefills_per_step = prefills_per_step
        # lease-backed region: one 1-device lease per shard, packed — the
        # pool's migrations counter prices shard shifts on grow/shrink
        self.pool = DevicePool(extent if extent is not None else
                               max(len(shards), 1))
        self.shards: dict[object, object] = {}
        for sh in shards:
            self.pool.lease(str(sh.key), 1)
            self.shards[sh.key] = sh
        self.queue: deque[Request] = deque()
        self.handoff: deque[tuple[Request, object, int, int]] = deque()
        self.active: dict[tuple[object, int], Request] = {}
        self.positions: dict[tuple[object, int], int] = {}
        self.next_token: dict[tuple[object, int], int] = {}
        self.finished: list[Request] = []
        self.step_count = 0
        self.submitted = 0
        self.slot_migrations = 0      # live lanes moved between shards
        self.resumes = 0              # live requests re-queued for replay
        self.recent_delays: deque[int] = deque(maxlen=64)
        # windowed per-step decode walls: reset by warmup() so a migration
        # re-warm never mixes pre/post-migration latencies into one p95
        # (same contract as ContinuousBatcher.stats, DESIGN.md §17)
        self.recent_step_ms: deque[float] = deque(maxlen=256)

    # -------------------------------------------------------------- queries

    @property
    def total_slots(self) -> int:
        return sum(sh.slots for sh in self.shards.values())

    @property
    def free_slots(self) -> int:
        return self.total_slots - len(self.active)

    @property
    def idle(self) -> bool:
        return not self.queue and not self.handoff and not self.active

    def _slot_order(self):
        for key, sh in self.shards.items():
            for s in range(sh.slots):
                yield (key, s)

    def _first_free(self) -> Optional[tuple[object, int]]:
        for slot in self._slot_order():
            if slot not in self.active:
                return slot
        return None

    # --------------------------------------------------------------- intake

    def submit(self, req: Request) -> None:
        req.arrived_step = self.step_count
        self.queue.append(req)
        self.submitted += 1

    def _resubmit_front(self, req: Request) -> None:
        """Migration fallback: replay later, keeping FIFO order ahead of
        everything that arrived after it."""
        self.queue.appendleft(req)
        self.resumes += 1

    def _admit(self) -> None:
        # prefill (bounded per step — the dedicated prefill program runs a
        # fixed budget so decode steps stay uniform), then install in FIFO
        # handoff order into the lowest free slot
        budget = self.prefills_per_step
        while self.queue and budget > 0 and \
                len(self.handoff) < self.total_slots + 1:
            req = self.queue.popleft()
            fed, nxt = fed_sequence(req)
            state, position = self.prefill.run(fed)
            self.handoff.append((req, state, position, nxt))
            budget -= 1
        while self.handoff:
            slot = self._first_free()
            if slot is None:
                break
            req, state, position, nxt = self.handoff.popleft()
            key, s = slot
            self.shards[key].install(s, state)
            req.started_step = self.step_count if req.started_step is None \
                else req.started_step
            self.recent_delays.append(req.started_step - req.arrived_step)
            self.active[slot] = req
            self.positions[slot] = position
            self.next_token[slot] = nxt

    # ---------------------------------------------------------------- steps

    def _decode_all(self) -> dict[tuple[object, int], int]:
        """One synchronized decode step on every shard with live slots."""
        produced: dict[tuple[object, int], int] = {}
        for key, sh in self.shards.items():
            tokens = np.zeros(sh.slots, dtype=np.int64)
            live = np.zeros(sh.slots, dtype=bool)
            positions = np.zeros(sh.slots, dtype=np.int64)
            for s in range(sh.slots):
                slot = (key, s)
                if slot in self.active:
                    tokens[s] = self.next_token[slot]
                    live[s] = True
                    positions[s] = self.positions[slot]
            if not live.any():
                continue
            nxt = sh.decode(tokens, live, positions)
            for s in range(sh.slots):
                if live[s]:
                    produced[(key, s)] = int(nxt[s])
                    self.positions[(key, s)] += 1
        return produced

    def step(self) -> None:
        t0 = _time.perf_counter()
        self._admit()
        if not self.active:
            self.step_count += 1
            return
        produced = self._decode_all()
        for slot, tok in produced.items():
            req = self.active[slot]
            req.tokens.append(tok)
            limit = self.cache_len if self.cache_len is not None else 1 << 30
            if (len(req.tokens) >= req.max_new_tokens
                    or (self.eos_id is not None and tok == self.eos_id)
                    or self.positions[slot] >= limit - 1):
                req.done = True
                self.finished.append(req)
                self._release(slot)
            else:
                self.next_token[slot] = tok
        self.step_count += 1
        self.recent_step_ms.append(1e3 * (_time.perf_counter() - t0))

    def _release(self, slot) -> None:
        key, s = slot
        self.shards[key].clear(s)
        del self.active[slot], self.positions[slot], self.next_token[slot]

    def run_until_idle(self, max_steps: int = 10_000) -> list[Request]:
        for _ in range(max_steps):
            if self.idle:
                break
            self.step()
        return self.finished

    # ------------------------------------------------------------ grow/shrink

    def set_shards(self, shards) -> None:
        """Reconcile the shard fleet against a new region (grow, shrink, or
        device moves after a replan).

        Kept shards must be the SAME objects (they hold live cache lanes);
        removed shards' occupied slots migrate into free survivor slots
        (extract → install, positions and next token carried over) and fall
        back to a front-of-queue resume when the shrunk fleet has no free
        slot.  The pool releases removed leases and grants new ones —
        packed, so later shards shifting down register in
        ``pool.migrations``.
        """
        shards = list(shards)
        if not shards:
            raise ValueError("cannot shrink the serve region to zero shards")
        new = {sh.key: sh for sh in shards}
        if len(new) != len(shards):
            raise ValueError("duplicate shard keys in the new region")
        removed = [k for k in self.shards if k not in new]
        # stage live slots off outgoing shards first (their lanes are
        # still installable — extraction is host-side)
        displaced: list[tuple[Request, object, int, int]] = []
        for key in removed:
            sh = self.shards[key]
            for s in range(sh.slots):
                slot = (key, s)
                if slot not in self.active:
                    continue
                displaced.append((self.active[slot], sh.extract(s),
                                  self.positions[slot],
                                  self.next_token[slot]))
                del self.active[slot], self.positions[slot], \
                    self.next_token[slot]
            self.pool.release(str(key))
            del self.shards[key]
        if self.pool.extent < len(new):
            raise ValueError(
                f"{len(new)} shards exceed the {self.pool.extent}-device "
                f"region the manager's pool was sized for")
        for sh in shards:
            if sh.key not in self.shards:
                self.pool.lease(str(sh.key), 1)
                self.shards[sh.key] = sh
        # keep shard iteration (and the packed leases) in region order
        self.shards = {sh.key: sh for sh in shards}
        overflow = []
        for req, state, position, nxt in displaced:
            slot = self._first_free()
            if slot is not None:
                key, s = slot
                self.shards[key].install(s, state)
                self.active[slot] = req
                self.positions[slot] = position
                self.next_token[slot] = nxt
                self.slot_migrations += 1
            else:
                overflow.append(req)
        # resume at the queue FRONT (displaced requests were admitted before
        # anything still queued), reversed so appendleft keeps their own
        # relative order too
        for req in reversed(overflow):
            self._resubmit_front(req)

    # ---------------------------------------------------------------- admin

    def warmup(self) -> None:
        """Warm every shard's decode step + the smallest prefill rung;
        clears the decode-latency window (the §17 re-warm contract)."""
        for sh in self.shards.values():
            sh.warmup()
        self.prefill.warmup()
        self.recent_step_ms.clear()

    def check(self) -> None:
        """Raise if any slot-bookkeeping invariant is violated."""
        self.pool.check()
        if set(self.pool.tenants) != {str(k) for k in self.shards}:
            raise AssertionError(
                f"pool tenants {self.pool.tenants} != shards "
                f"{[str(k) for k in self.shards]}")
        valid = set(self._slot_order())
        uids: dict[int, tuple] = {}
        for slot, req in self.active.items():
            if slot not in valid:
                raise AssertionError(f"active slot {slot} not in any shard")
            if req.uid in uids:
                raise AssertionError(
                    f"request {req.uid} aliased into {uids[req.uid]} "
                    f"and {slot}")
            uids[req.uid] = slot
            if slot not in self.positions or slot not in self.next_token:
                raise AssertionError(f"slot {slot} missing decode state")
        if len(self.active) + self.free_slots != self.total_slots:
            raise AssertionError("slot conservation violated")
        accounted = (len(self.finished) + len(self.active)
                     + len(self.handoff) + len(self.queue))
        if accounted != self.submitted:
            raise AssertionError(
                f"request conservation violated: {accounted} accounted, "
                f"{self.submitted} submitted")

    # --------------------------------------------------------------- metrics

    def stats(self) -> dict:
        """SLO-policy snapshot — same keys (and windowed semantics) as
        :meth:`ContinuousBatcher.stats`, plus the sharding counters."""
        lat = list(self.recent_delays)
        walls = list(self.recent_step_ms)
        total = self.total_slots

        def pct(xs, q):
            return float(np.percentile(xs, q)) if xs else 0.0

        return {
            "finished": len(self.finished),
            "queued": len(self.queue) + len(self.handoff),
            "free_slots": self.free_slots,
            "mean_queue_delay_steps": float(np.mean(lat)) if lat else 0.0,
            "p95_queue_delay_steps": pct(lat, 95),
            "occupancy_now": (len(self.active) / total) if total else 0.0,
            "p50_decode_step_ms": pct(walls, 50),
            "p95_decode_step_ms": pct(walls, 95),
            "shards": len(self.shards),
            "slots_total": total,
            "lease_layout": self.pool.regions(),
            "handoff_depth": len(self.handoff),
            "pool_migrations": self.pool.migrations,
            "slot_migrations": self.slot_migrations,
            "resumes": self.resumes,
            "prefill_calls": getattr(self.prefill, "calls", 0),
            "prefill_traces": getattr(self.prefill, "traces", 0),
        }
