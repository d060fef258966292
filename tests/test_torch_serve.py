"""The port's serving stack (``repro_torch.serve``: engine, continuous
batching, the KV slot manager, traffic) against the JAX package's, on the
CPU.

The decode model is the reduced gemma-2b with the reference's parameters
(``init_lm``, PRNGKey 0) carried over by ``params_from_jax``; prompts come
from seeded numpy generators.  Greedy token streams, fed sequences, cache
lengths, prefill positions and trace counts, slot bookkeeping, traffic
traces and the manager's ``stats()`` must be ``==`` the reference's;
prefilled cache lanes agree to rtol and atol 1e-5.  The mirrors of
``tests/test_serve_scheduler.py``, ``tests/test_serve_slots.py`` and
``tests/test_traffic.py`` run here against the port; their Hypothesis
properties draw integers only and keep no example database.  Each
reference program runs once per configuration (module-scoped).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.serve.slots as ref_slots_mod
import repro_torch.serve.slots as slots_mod
from repro.configs import get_config as ref_get_config
from repro.models import init_lm as ref_init_lm
from repro.models import reduced as ref_reduced
from repro.serve import engine as ref_engine
from repro.serve import traffic as ref_traffic
from repro.serve.scheduler import ContinuousBatcher as RefBatcher
from repro.serve.scheduler import Request as RefRequest
from repro.serve.slots import KVSlotManager as RefManager
from repro.serve.slots import LMShard as RefShard
from repro_torch.configs import get_config
from repro_torch.models import (apply_lm, caches_from_jax, init_caches,
                                params_from_jax, reduced)
from repro_torch.serve import (ContinuousBatcher, DiurnalTraffic,
                               FakePrefill, FakeShard, KVSlotManager,
                               LMShard, PoissonTraffic, PrefillProgram,
                               QueueSim, Request, ServeConfig, ServeTraffic,
                               SLOPolicy, TrafficTrace, cache_length,
                               fed_sequence, generate, make_traffic, prefill,
                               replay_latency_summary, sample)

CPU = dict(device="cpu")
VOCAB = 97
PROPS = dict(database=None, deadline=None)


class FakeClock:
    """``perf_counter()`` that advances by exactly 1.0 a read."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


@pytest.fixture(scope="module")
def lm():
    """(ref cfg, ref params, port cfg, port params): reduced gemma-2b."""
    ref_cfg = ref_reduced(ref_get_config("gemma-2b"))
    rp = ref_init_lm(jax.random.PRNGKey(0), ref_cfg)
    cfg = reduced(get_config("gemma-2b"))
    return ref_cfg, rp, cfg, params_from_jax(
        jax.tree_util.tree_map(np.asarray, rp), cfg, **CPU)


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _lane(ref_state, cfg):
    """A reference slot lane (leaves (groups, ...)) as a port lane."""
    batched = jax.tree_util.tree_map(lambda x: np.asarray(x)[:, None],
                                     ref_state)
    return {k: v[0] for k, v in caches_from_jax(batched, cfg, **CPU).items()}


# -------------------------------------------------------------- engine


def test_fed_sequence_and_cache_length_match_reference():
    for prompt, tokens in (([5], []), ([1, 2, 3], []), ([1, 2, 3], [9]),
                           ([4, 4], [7, 8, 9])):
        ours = fed_sequence(Request(uid=0, prompt=np.asarray(prompt),
                                    max_new_tokens=4, tokens=list(tokens)))
        ref = ref_engine.fed_sequence(RefRequest(
            uid=0, prompt=np.asarray(prompt), max_new_tokens=4,
            tokens=list(tokens)))
        assert ours[0].dtype == ref[0].dtype
        assert ours[0].tolist() == ref[0].tolist() and ours[1] == ref[1]
    base, ref_base = reduced(get_config("gemma-2b")), ref_reduced(
        ref_get_config("gemma-2b"))
    for window in (None, 4, 64):
        for seq in (1, 16, 2048):
            assert cache_length(base.with_(window=window), seq) == \
                ref_engine.cache_length(ref_base.with_(window=window), seq)


LADDER = (1, 3, 4, 5, 7, 9)


@pytest.fixture(scope="module")
def ref_prefills(lm):
    """The reference's padded prefill runs over LADDER, one program."""
    ref_cfg, rp, _, _ = lm
    prog = ref_engine.PrefillProgram(rp, ref_cfg, cache_len=16)
    feds = _prompts(7, LADDER, ref_cfg.vocab_size)
    runs = [prog.run(f) for f in feds]
    return feds, [(jax.tree_util.tree_map(np.asarray, s), p)
                  for s, p in runs], prog.calls, prog.traces


def test_prefill_program_matches_reference_padded_run(lm, ref_prefills):
    """Exactly len(fed) steps give the lane the reference's padded run
    gives; positions, calls and per-rung trace counts ``==``."""
    _, _, cfg, params = lm
    feds, runs, calls, traces = ref_prefills
    prog = PrefillProgram(params, cfg, cache_len=16, **CPU)
    for fed, (ref_state, ref_pos) in zip(feds, runs):
        state, pos = prog.run(fed)
        assert pos == ref_pos == len(fed)
        want = _lane(ref_state, cfg)
        assert state.keys() == want.keys()
        for key in state:
            np.testing.assert_allclose(state[key].numpy(),
                                       want[key].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=key)
    assert (prog.calls, prog.traces) == (calls, traces)
    assert prog.traces < len(LADDER)
    prog.warmup(max_len=9)
    assert prog.calls == calls
    with pytest.raises(ValueError, match="exceeds"):
        prog.run(np.zeros(17, np.int32))
    with pytest.raises(ValueError, match="non-empty"):
        prog.run(np.zeros(0, np.int32))


def test_prefill_matches_reference(lm):
    ref_cfg, rp, cfg, params = lm
    toks = np.stack(_prompts(8, (6, 6), cfg.vocab_size))
    ref_last, ref_caches = ref_engine.prefill(rp, ref_cfg, jnp.asarray(toks),
                                              12)
    last, caches = prefill(params, cfg, torch.from_numpy(toks.astype(
        np.int64)), 12)
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last),
                               rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(ref_last)).max())
    want = caches_from_jax(jax.tree_util.tree_map(np.asarray, ref_caches),
                           cfg, **CPU)
    for key in caches:
        np.testing.assert_allclose(caches[key].numpy(), want[key].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_generate_greedy_matches_reference(lm):
    ref_cfg, rp, cfg, params = lm
    prompts = np.stack(_prompts(9, (5, 5, 5), cfg.vocab_size))
    serve_cfg = ServeConfig(max_seq=32)
    ref = ref_engine.generate(rp, ref_cfg, jnp.asarray(prompts), 4,
                              ref_engine.ServeConfig(max_seq=32))
    ours = generate(params, cfg, torch.from_numpy(prompts.astype(np.int64)),
                    4, serve_cfg)
    assert ours.shape == (3, 4)
    assert ours.tolist() == np.asarray(ref).tolist()


def test_sampling_is_seeded_and_greedy_at_zero():
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    assert torch.equal(sample(logits, None, 0.0), logits.argmax(-1))
    draw = [sample(logits, torch.Generator().manual_seed(3), 1.5)
            for _ in range(2)]
    assert torch.equal(draw[0], draw[1])
    assert draw[0].shape == (4,) and int(draw[0].max()) < 50
    from repro_torch.models import init_lm

    cfg = reduced(get_config("gemma-2b"))
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    prompts = torch.zeros(2, 3, dtype=torch.int64)
    outs = [generate(params, cfg, prompts, 3, ServeConfig(max_seq=16,
                                                          temperature=1.0),
                     torch.Generator().manual_seed(11)) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


# ----------------------------------- scheduler (test_serve_scheduler.py)


def _greedy(params, cfg, prompt, n):
    """Single-sequence greedy decode through the plain model path."""
    caches = init_caches(cfg, 1, 64, **CPU)
    with torch.no_grad():
        for i, t in enumerate(prompt):
            logits, caches, _ = apply_lm(params, cfg, torch.tensor([[int(t)]]),
                                         caches=caches,
                                         positions=torch.tensor([[i]]))
        nxt, out, pos = int(logits[0, 0].argmax()), [], len(prompt)
        for j in range(n):
            out.append(nxt)
            logits, caches, _ = apply_lm(params, cfg, torch.tensor([[nxt]]),
                                         caches=caches,
                                         positions=torch.tensor([[pos + j]]))
            nxt = int(logits[0, 0].argmax())
    return out


def _interleaved(make, req_cls, prompts):
    sched = make()
    sched.submit(req_cls(uid=0, prompt=prompts[0], max_new_tokens=5))
    sched.step()
    sched.submit(req_cls(uid=1, prompt=prompts[1], max_new_tokens=5))
    sched.step()
    sched.submit(req_cls(uid=2, prompt=prompts[2], max_new_tokens=5))
    done = sched.run_until_idle()
    return {r.uid: (r.tokens, r.started_step) for r in done}


def _overflow(make, req_cls, prompts):
    sched = make()
    for uid, p in enumerate(prompts):
        sched.submit(req_cls(uid=uid, prompt=p, max_new_tokens=4))
    done = sched.run_until_idle()
    return [(r.uid, r.tokens, r.started_step) for r in done], sched.stats()


SCHED_PROMPTS = {"single": (0, (5,)), "interleaved": (1, (4, 7, 3)),
                 "overflow": (2, (3, 3, 3)), "ring": (4, (2, 3, 2, 2, 3))}


@pytest.fixture(scope="module")
def ref_sched(lm):
    """The reference batcher's runs of every scheduler scenario."""
    ref_cfg, rp, _, _ = lm
    pr = {k: _prompts(seed, lens, ref_cfg.vocab_size)
          for k, (seed, lens) in SCHED_PROMPTS.items()}
    single = RefBatcher(rp, ref_cfg, slots=2, cache_len=64)
    single.submit(RefRequest(uid=1, prompt=pr["single"][0],
                             max_new_tokens=6))
    out = {"single": single.run_until_idle()[0].tokens}
    out["interleaved"] = _interleaved(
        lambda: RefBatcher(rp, ref_cfg, slots=2, cache_len=64), RefRequest,
        pr["interleaved"])
    out["overflow"] = _overflow(
        lambda: RefBatcher(rp, ref_cfg, slots=1, cache_len=32), RefRequest,
        pr["overflow"])
    ring = RefBatcher(rp, ref_cfg, slots=4, cache_len=4)
    for uid, p in enumerate(pr["ring"]):
        ring.submit(RefRequest(uid=uid, prompt=p, max_new_tokens=3))
    out["ring"] = [(r.uid, r.tokens, r.started_step)
                   for r in ring.run_until_idle()]
    return pr, out


def test_single_request_matches_plain_decode(lm, ref_sched):
    _, _, cfg, params = lm
    prompts, ref = ref_sched
    sched = ContinuousBatcher(params, cfg, slots=2, cache_len=64, **CPU)
    sched.submit(Request(uid=1, prompt=prompts["single"][0],
                         max_new_tokens=6))
    done = sched.run_until_idle()
    assert len(done) == 1
    assert done[0].tokens == _greedy(params, cfg, prompts["single"][0], 6)
    assert done[0].tokens == ref["single"]


def test_interleaved_requests_are_isolated(lm, ref_sched):
    """Requests admitted at different times (different cache positions in
    the same decode step) each match their solo decode, and the
    reference's streams."""
    _, _, cfg, params = lm
    prompts, ref = ref_sched
    got = _interleaved(lambda: ContinuousBatcher(params, cfg, slots=2,
                                                 cache_len=64, **CPU),
                       Request, prompts["interleaved"])
    assert got == ref["interleaved"]
    for uid, p in enumerate(prompts["interleaved"]):
        assert got[uid][0] == _greedy(params, cfg, p, 5), \
            f"request {uid} corrupted by batching"


def test_migration_rewarm_resets_decode_latency_window(lm):
    _, _, cfg, params = lm
    rng = np.random.default_rng(5)
    sched = ContinuousBatcher(params, cfg, slots=2, cache_len=32, **CPU)
    sched.submit(Request(uid=0, prompt=rng.integers(0, cfg.vocab_size,
                                                    size=3),
                         max_new_tokens=4))
    sched.run_until_idle()
    assert len(sched.recent_step_ms) > 0
    assert sched.stats()["p95_decode_step_ms"] > 0.0
    sched.recent_step_ms.extend([1e6] * 8)
    assert sched.stats()["p95_decode_step_ms"] > 1e5
    sched.warmup()
    assert len(sched.recent_step_ms) == 0
    assert sched.stats()["p95_decode_step_ms"] == 0.0
    sched.submit(Request(uid=1, prompt=rng.integers(0, cfg.vocab_size,
                                                    size=3),
                         max_new_tokens=4))
    sched.run_until_idle()
    assert 0.0 < sched.stats()["p95_decode_step_ms"] < 1e5
    assert sched.stats()["finished"] == 2


def test_queue_overflow_waits(lm, ref_sched):
    _, _, cfg, params = lm
    prompts, ref = ref_sched
    done, stats = _overflow(lambda: ContinuousBatcher(
        params, cfg, slots=1, cache_len=32, **CPU), Request,
        prompts["overflow"])
    assert len(done) == 3
    assert stats["finished"] == 3 and stats["queued"] == 0
    assert done[-1][2] > done[0][2]
    keys = ("finished", "queued", "free_slots", "mean_queue_delay_steps",
            "p95_queue_delay_steps", "occupancy_now")
    assert done == ref["overflow"][0]
    assert {k: stats[k] for k in keys} == {k: ref["overflow"][1][k]
                                           for k in keys}


def test_slot_reset_uses_the_batch_dim(lm, ref_sched):
    """cache_len == slots: a shape test on the port's (B, T, ...) caches
    could not tell the slot axis from the time axis.  Retiring a request
    zeroes its row of every cache tensor and nothing else, and the streams
    equal the reference's."""
    _, _, cfg, params = lm
    prompts, ref = ref_sched
    sched = ContinuousBatcher(params, cfg, slots=4, cache_len=4, **CPU)
    zeroed, reset = [], sched._zero_slot_cache

    def checked_reset(slot):
        before = {k: v.clone() for k, v in sched.caches.items()}
        reset(slot)
        zeroed.append(slot)
        for k, v in sched.caches.items():
            assert not v[slot].any(), k
            rest = [r for r in range(sched.slots) if r != slot]
            assert torch.equal(v[rest], before[k][rest]), k

    sched._zero_slot_cache = checked_reset
    for uid, p in enumerate(prompts["ring"]):
        sched.submit(Request(uid=uid, prompt=p, max_new_tokens=3))
    sched.run_until_idle()
    assert len(zeroed) == len(prompts["ring"])
    assert [(r.uid, r.tokens, r.started_step)
            for r in sched.finished] == ref["ring"]


def test_slot_reset_covers_a_hybrid_tail():
    """A hybrid model with a tail layer (4 = one rec-rec-local group + one
    rec): retiring a request zeroes its row of the tail's conv state and
    hidden too, which the reference's shape test, built for its stacked
    (groups, B, ...) leaves, would not find."""
    from repro_torch.models import init_lm

    cfg = reduced(get_config("recurrentgemma-9b")).with_(num_layers=4)
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    sched = ContinuousBatcher(params, cfg, slots=2, cache_len=8, **CPU)
    tail = [k for k in sched.caches if k.startswith("layers.3.")]
    assert sorted(tail) == ["layers.3.conv", "layers.3.h"]
    retired, reset = [], sched._zero_slot_cache

    def checked_reset(slot):
        assert all(sched.caches[k][slot].any() for k in tail)
        reset(slot)
        retired.append(slot)
        assert all(not sched.caches[k][slot].any() for k in tail)

    sched._zero_slot_cache = checked_reset
    for uid, p in enumerate(_prompts(13, (3, 2), cfg.vocab_size)):
        sched.submit(Request(uid=uid, prompt=p, max_new_tokens=2))
    sched.run_until_idle()
    assert len(retired) == 2


def test_midflight_warmup_leaves_streams_unchanged(lm):
    """Warm-up in the middle of a run restores every cache, position and
    next token: the streams equal an undisturbed run's."""
    _, _, cfg, params = lm
    prompts = _prompts(6, (4, 6, 3), cfg.vocab_size)

    def run(warm_every):
        sched = ContinuousBatcher(params, cfg, slots=2, cache_len=32, **CPU)
        for uid, p in enumerate(prompts):
            sched.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
        n = 0
        while not sched.idle:
            sched.step()
            n += 1
            if warm_every and n % warm_every == 0:
                sched.warmup()
        return [(r.uid, r.tokens) for r in sched.finished]

    assert run(2) == run(0)


# ------------------------------------ slots (test_serve_slots.py mirrors)


def oracle_tokens(prompt, max_new_tokens):
    """Exact expected stream for a FakeShard decode of one request."""
    fed = [int(t) for t in prompt]
    nxt = fed[-1]
    out = []
    for _ in range(max_new_tokens):
        fed.append(nxt)
        nxt = FakeShard.next_token(fed, VOCAB)
        out.append(nxt)
    return out


def make_manager(shard_slots, **kw):
    shards = [FakeShard(slots=s, vocab=VOCAB, key=f"sh{i}")
              for i, s in enumerate(shard_slots)]
    kw.setdefault("extent", 8)
    return KVSlotManager(shards, FakePrefill(), **kw)


def assert_prefixes(mgr, reqs):
    for r in reqs:
        want = oracle_tokens(r.prompt, r.max_new_tokens)
        assert r.tokens == want[:len(r.tokens)], (
            f"request {r.uid} diverged: {r.tokens} vs oracle {want}")


SUBMIT, STEP, GROW, SHRINK = range(4)


@settings(max_examples=40, **PROPS)
@given(st.data())
def test_admission_interleavings_preserve_order_and_streams(data):
    slots = data.draw(st.lists(st.integers(1, 3), min_size=1, max_size=3))
    mgr = make_manager(slots, prefills_per_step=data.draw(st.integers(1, 4)))
    reqs, seen = [], set()
    # op codes: 0 submit, 1-2 step (steps twice as likely)
    ops = data.draw(st.lists(st.integers(0, 2), min_size=4, max_size=30))
    for op in ops:
        if op == SUBMIT:
            n = data.draw(st.integers(1, 4))
            prompt = [data.draw(st.integers(0, VOCAB - 1)) for _ in range(n)]
            req = Request(uid=len(reqs), prompt=np.asarray(prompt, np.int32),
                          max_new_tokens=data.draw(st.integers(1, 5)))
            reqs.append(req)
            mgr.submit(req)
        else:
            mgr.step()
        mgr.check()
        seen.update(r.uid for r in mgr.active.values())
        assert_prefixes(mgr, reqs)
    mgr.run_until_idle()
    mgr.check()
    admitted = sorted((r.started_step, r.uid) for r in reqs)
    assert [u for _, u in admitted] == sorted(r.uid for r in reqs), (
        f"admission order {admitted} broke submission (FIFO) order")
    assert len(mgr.finished) == len(reqs)
    for r in reqs:
        assert r.tokens == oracle_tokens(r.prompt, r.max_new_tokens)


@settings(max_examples=40, **PROPS)
@given(st.data())
def test_grow_shrink_migration_conserves_slots_and_prefixes(data):
    mgr = make_manager([2], prefills_per_step=4)
    next_shard, reqs = 1, []
    # op codes: 0 submit, 1-2 step, 3 grow, 4 shrink
    ops = data.draw(st.lists(st.integers(0, 4), min_size=6, max_size=40))
    for op in ops:
        if op == SUBMIT:
            n = data.draw(st.integers(1, 4))
            prompt = [data.draw(st.integers(0, VOCAB - 1)) for _ in range(n)]
            req = Request(uid=len(reqs), prompt=np.asarray(prompt, np.int32),
                          max_new_tokens=data.draw(st.integers(2, 6)))
            reqs.append(req)
            mgr.submit(req)
        elif op == 3 and len(mgr.shards) < 4:
            sh = FakeShard(slots=data.draw(st.integers(1, 3)), vocab=VOCAB,
                           key=f"g{next_shard}")
            next_shard += 1
            mgr.set_shards(list(mgr.shards.values()) + [sh])
        elif op == 4 and len(mgr.shards) > 1:
            keep = list(mgr.shards.values())
            del keep[data.draw(st.integers(0, len(keep) - 1))]
            mgr.set_shards(keep)
        else:
            mgr.step()
        mgr.check()
        assert mgr.total_slots == sum(sh.slots for sh in mgr.shards.values())
        assert len(mgr.pool.tenants) == len(mgr.shards)
        assert_prefixes(mgr, reqs)
    mgr.run_until_idle()
    mgr.check()
    assert len(mgr.finished) == len(reqs)
    for r in reqs:
        assert r.tokens == oracle_tokens(r.prompt, r.max_new_tokens), (
            f"request {r.uid} corrupted by migration "
            f"(migrations={mgr.slot_migrations}, resumes={mgr.resumes})")


@settings(max_examples=25, **PROPS)
@given(st.integers(1, 3), st.integers(1, 3), st.integers(0, 6))
def test_no_aliasing_under_load(s1, s2, extra):
    mgr = make_manager([s1, s2], prefills_per_step=2)
    total = s1 + s2 + extra
    for uid in range(total):
        mgr.submit(Request(uid=uid,
                           prompt=np.asarray([uid % VOCAB], np.int32),
                           max_new_tokens=3))
    for _ in range(6):
        mgr.step()
        mgr.check()
        uids = [r.uid for r in mgr.active.values()]
        assert len(uids) == len(set(uids))
        assert len(mgr.active) <= mgr.total_slots
    mgr.run_until_idle()
    mgr.check()
    assert len(mgr.finished) == total


@settings(max_examples=20, **PROPS)
@given(st.lists(st.integers(0, 4), min_size=4, max_size=24),
       st.integers(0, 2 ** 16))
def test_fake_manager_schedules_match_reference(ops, seed):
    """The same op schedule through the port's and the reference's
    FakeShard managers: streams, counters and stats ``==``."""
    rng = np.random.default_rng(seed)
    mgrs = []
    for mod_shard, mod_prefill, mod_mgr, mod_req in (
            (FakeShard, FakePrefill, KVSlotManager, Request),
            (ref_slots_mod.FakeShard, ref_slots_mod.FakePrefill,
             RefManager, RefRequest)):
        mgrs.append((mod_mgr([mod_shard(slots=2, vocab=VOCAB, key="a")],
                             mod_prefill(), extent=4, prefills_per_step=2),
                     mod_shard, mod_req, []))
    prompts = [rng.integers(0, VOCAB, size=rng.integers(1, 5))
               for _ in ops]
    for i, op in enumerate(ops):
        for mgr, shard_cls, req_cls, reqs in mgrs:
            if op == SUBMIT:
                req = req_cls(uid=i, prompt=prompts[i].astype(np.int32),
                              max_new_tokens=3)
                reqs.append(req)
                mgr.submit(req)
            elif op == 3 and len(mgr.shards) < 3:
                mgr.set_shards(list(mgr.shards.values())
                               + [shard_cls(slots=1, vocab=VOCAB,
                                            key=f"g{i}")])
            elif op == 4 and len(mgr.shards) > 1:
                mgr.set_shards(list(mgr.shards.values())[1:])
            else:
                mgr.step()
    for mgr, *_ in mgrs:
        mgr.run_until_idle()
    (ours, *_, our_reqs), (ref, *_, ref_reqs) = mgrs
    assert [r.tokens for r in our_reqs] == [r.tokens for r in ref_reqs]
    drop = ("p50_decode_step_ms", "p95_decode_step_ms")
    assert {k: v for k, v in ours.stats().items() if k not in drop} == \
        {k: v for k, v in ref.stats().items() if k not in drop}


def test_shrink_to_zero_shards_rejected():
    mgr = make_manager([2])
    with pytest.raises(ValueError, match="zero shards"):
        mgr.set_shards([])


def test_duplicate_shard_keys_rejected():
    mgr = make_manager([1])
    dup = [FakeShard(slots=1, key="x"), FakeShard(slots=2, key="x")]
    with pytest.raises(ValueError, match="duplicate"):
        mgr.set_shards(dup)


def test_region_overflow_rejected():
    mgr = make_manager([1], extent=2)
    fleet = [FakeShard(slots=1, key=f"n{i}") for i in range(3)]
    with pytest.raises(ValueError, match="exceed"):
        mgr.set_shards(fleet)


def test_displaced_requests_resume_in_order():
    a = FakeShard(slots=1, vocab=VOCAB, key="a")
    b = FakeShard(slots=2, vocab=VOCAB, key="b")
    mgr = KVSlotManager([a, b], FakePrefill(), extent=4,
                        prefills_per_step=4)
    live = [Request(uid=i, prompt=np.asarray([i + 1], np.int32),
                    max_new_tokens=8) for i in range(3)]
    for r in live:
        mgr.submit(r)
    mgr.step()
    assert len(mgr.active) == 3
    mgr.submit(Request(uid=9, prompt=np.asarray([9], np.int32),
                       max_new_tokens=2))
    mgr.set_shards([a])
    mgr.check()
    assert mgr.resumes == 2
    assert [r.uid for r in mgr.queue] == [1, 2, 9]
    mgr.run_until_idle()
    mgr.check()
    for r in live:
        assert r.tokens == oracle_tokens(r.prompt, r.max_new_tokens)


def test_migration_moves_live_lane_into_free_slot():
    a = FakeShard(slots=2, vocab=VOCAB, key="a")
    b = FakeShard(slots=1, vocab=VOCAB, key="b")
    mgr = KVSlotManager([a, b], FakePrefill(), extent=4,
                        prefills_per_step=4)
    short = [Request(uid=i, prompt=np.asarray([3 + i], np.int32),
                     max_new_tokens=2) for i in range(2)]
    long = Request(uid=9, prompt=np.asarray([8, 9], np.int32),
                   max_new_tokens=10)
    for r in (*short, long):
        mgr.submit(r)
    mgr.step()
    mgr.step()
    assert list(mgr.active) == [("b", 0)]
    mgr.set_shards([a])
    mgr.check()
    assert mgr.slot_migrations == 1 and mgr.resumes == 0
    mgr.run_until_idle()
    assert long.tokens == oracle_tokens(long.prompt, 10)


def test_warmup_resets_decode_latency_window():
    mgr = make_manager([2], prefills_per_step=2)
    mgr.submit(Request(uid=0, prompt=np.asarray([1, 2], np.int32),
                       max_new_tokens=3))
    mgr.run_until_idle()
    assert len(mgr.recent_step_ms) > 0
    assert mgr.stats()["p95_decode_step_ms"] >= 0.0
    mgr.warmup()
    assert len(mgr.recent_step_ms) == 0
    assert mgr.stats()["p95_decode_step_ms"] == 0.0


def test_stats_shape_matches_policy_contract():
    mgr = make_manager([1, 2])
    stats = mgr.stats()
    for key in ("finished", "queued", "free_slots",
                "mean_queue_delay_steps", "p95_queue_delay_steps",
                "occupancy_now"):
        assert key in stats
    assert stats["shards"] == 2 and stats["slots_total"] == 3
    assert stats["lease_layout"] == {"sh0": (0, 1), "sh1": (1, 1)}
    assert SLOPolicy().decide(stats) in ("grow", "shrink", "hold")


def test_lmshard_manager_matches_batcher_solo(lm, ref_sched):
    """Disaggregated prefill -> install -> decode reproduces the batcher's
    stream for a solo request (the same fed-token semantics)."""
    _, _, cfg, params = lm
    prompts, ref = ref_sched
    prompt = prompts["single"][0]
    mgr = KVSlotManager(
        [LMShard(params, cfg, slots=2, cache_len=64, **CPU)],
        PrefillProgram(params, cfg, cache_len=64, **CPU),
        cache_len=64, extent=1, prefills_per_step=2)
    req = Request(uid=1, prompt=prompt.copy(), max_new_tokens=6)
    mgr.submit(req)
    mgr.run_until_idle()
    mgr.check()
    assert req.tokens == ref["single"]


LM_PROMPTS = (1, (4, 7, 3, 5))


@pytest.fixture(scope="module")
def ref_manager(lm):
    """The reference's two-shard manager over ragged prompts, its stats
    timed by a fake clock."""
    ref_cfg, rp, _, _ = lm
    prompts = _prompts(LM_PROMPTS[0], LM_PROMPTS[1], ref_cfg.vocab_size)
    saved, ref_slots_mod._time = ref_slots_mod._time, FakeClock()
    try:
        mgr = RefManager(
            [RefShard(rp, ref_cfg, slots=2, cache_len=64) for _ in range(2)],
            ref_engine.PrefillProgram(rp, ref_cfg, cache_len=64),
            cache_len=64, extent=4, prefills_per_step=2)
        reqs = [RefRequest(uid=i, prompt=p.copy(), max_new_tokens=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            mgr.submit(r)
        mgr.run_until_idle()
    finally:
        ref_slots_mod._time = saved
    return prompts, [r.tokens for r in reqs], mgr.stats()


def test_lmshard_batched_requests_match_solo_and_reference(
        lm, ref_manager, monkeypatch):
    """Ragged prompts across two real shards: each stream equals its solo
    decode and the reference's, the ladder bounds prefill traces below the
    request count, and ``stats()`` (fake clock) equals the reference's."""
    _, _, cfg, params = lm
    prompts, ref_tokens, ref_stats = ref_manager
    monkeypatch.setattr(slots_mod, "_time", FakeClock())

    def manager(slots_list):
        return KVSlotManager(
            [LMShard(params, cfg, slots=s, cache_len=64, **CPU)
             for s in slots_list],
            PrefillProgram(params, cfg, cache_len=64, **CPU),
            cache_len=64, extent=4, prefills_per_step=2)

    mgr = manager([2, 2])
    reqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=4)
            for i, p in enumerate(prompts)]
    for r in reqs:
        mgr.submit(r)
    mgr.run_until_idle()
    mgr.check()
    assert mgr.prefill.traces < len(reqs)
    assert [r.tokens for r in reqs] == ref_tokens
    stats = mgr.stats()
    assert list(stats["lease_layout"].values()) == \
        list(ref_stats["lease_layout"].values())
    assert {k: v for k, v in stats.items() if k != "lease_layout"} == \
        {k: v for k, v in ref_stats.items() if k != "lease_layout"}
    for r, p in zip(reqs, prompts):
        solo = manager([1])
        rr = Request(uid=r.uid, prompt=p.copy(), max_new_tokens=4)
        solo.submit(rr)
        solo.run_until_idle()
        assert rr.tokens == r.tokens, \
            f"request {r.uid} corrupted by sharded batching"


def test_lmshard_lanes_migrate_and_warm_without_state_leak(lm):
    """A live lane extracted from one shard and installed into another
    continues its stream exactly; a shard's warm-up mid-run changes
    nothing."""
    _, _, cfg, params = lm
    prompts = _prompts(12, (5, 4), cfg.vocab_size)

    def run(migrate):
        a = LMShard(params, cfg, slots=1, cache_len=32, **CPU)
        b = LMShard(params, cfg, slots=2, cache_len=32, **CPU)
        mgr = KVSlotManager([a, b], PrefillProgram(params, cfg, cache_len=32,
                                                   **CPU),
                            cache_len=32, extent=4, prefills_per_step=2)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            mgr.submit(r)
        mgr.step()
        mgr.step()
        if migrate:
            b.warmup()
            mgr.set_shards([b])
            mgr.check()
            assert mgr.slot_migrations == 1
        mgr.run_until_idle()
        return [r.tokens for r in reqs]

    assert run(True) == run(False)


# ------------------------------------------- traffic (test_traffic.py)


def mk(kind, module=None, **kw):
    base = dict(rate=2.0, prompt_len=8, max_new_tokens=4, vocab_size=97,
                seed=42)
    base.update(kw)
    return (module or make_traffic)(kind, **base)


POISSON_GOLDEN = (4, 1, 3, 2, 3, 0, 4, 1, 2, 3, 2, 3, 1, 3, 1, 2, 3, 1, 2, 3)

DIURNAL_SUMMARY_GOLDEN = {
    "admitted": 48,
    "finished": 45,
    "wait_mean": 16.729166666666668,
    "wait_p50": 16.0,
    "wait_p95": 34.65,
    "wait_p99": 35.0,
    "wait_max": 35.0,
}


def test_poisson_trace_is_golden():
    t = mk("poisson")
    for _ in range(20):
        t.next_round()
    trace = t.trace()
    assert trace.arrivals == POISSON_GOLDEN
    assert trace.rates == (2.0,) * 20
    assert trace.kind == "poisson" and trace.seed == 42
    assert trace.rounds == 20 and trace.total == sum(POISSON_GOLDEN)


@pytest.mark.parametrize("kind", ["steady", "poisson", "diurnal"])
def test_traffic_replays_the_reference_bit_identically(kind):
    ours, ref = mk(kind), mk(kind, ref_traffic.make_traffic)
    for _ in range(24):
        ra, rb = ours.next_round(), ref.next_round()
        assert [(r.uid, r.prompt.tolist(), r.prompt.dtype, r.max_new_tokens)
                for r in ra] == [(r.uid, r.prompt.tolist(), r.prompt.dtype,
                                  r.max_new_tokens) for r in rb]
    if kind != "steady":
        assert ours.trace().arrivals == ref.trace().arrivals
        assert ours.trace().rates == ref.trace().rates
        assert ours.trace().to_csv() == ref.trace().to_csv()


def test_same_seed_bit_identical_requests():
    a, b = mk("poisson"), mk("poisson")
    for _ in range(10):
        ra, rb = a.next_round(), b.next_round()
        assert [r.prompt.tolist() for r in ra] == \
            [r.prompt.tolist() for r in rb]
        assert [r.uid for r in ra] == [r.uid for r in rb]
    assert a.trace() == b.trace()


def test_different_seed_diverges():
    a, b = mk("poisson"), mk("poisson", seed=43)
    for _ in range(20):
        a.next_round(), b.next_round()
    assert a.trace().arrivals != b.trace().arrivals


def test_diurnal_latency_summary_is_golden():
    kw = dict(rate=0.5, peak_rate=6.0, period=16, prompt_len=8,
              max_new_tokens=4, vocab_size=97, seed=7)
    summary = replay_latency_summary(make_traffic("diurnal", **kw), 48,
                                     slots=4, tokens_per_request=4)
    assert summary == DIURNAL_SUMMARY_GOLDEN
    assert summary == ref_traffic.replay_latency_summary(
        ref_traffic.make_traffic("diurnal", **kw), 48, slots=4,
        tokens_per_request=4)


def test_trace_csv_format():
    t = mk("poisson")
    t.next_round(), t.next_round()
    lines = t.trace().to_csv().strip().split("\n")
    assert lines[0] == "round,rate,arrivals"
    assert lines[1] == f"0,2,{POISSON_GOLDEN[0]}"
    assert len(lines) == 3


def test_diurnal_envelope_shape():
    t = make_traffic("diurnal", rate=1.0, peak_rate=9.0, period=8,
                     prompt_len=4, max_new_tokens=2, vocab_size=97)
    rates = []
    for _ in range(17):
        t.next_round()
        rates.append(t.trace().rates[-1])
    assert rates[0] == pytest.approx(1.0)
    assert rates[4] == pytest.approx(9.0)
    assert rates[8] == pytest.approx(1.0)
    assert rates[12] == pytest.approx(9.0)
    assert all(1.0 <= r <= 9.0 for r in rates)


def test_diurnal_preset_forces_grow_and_shrink():
    t = make_traffic("diurnal", rate=0.0, peak_rate=8.0, period=24,
                     prompt_len=4, max_new_tokens=2, vocab_size=97, seed=0)
    sim = QueueSim(slots=2, tokens_per_request=3)
    policy = SLOPolicy(slo_queue_delay=1.0, idle_patience=2)
    actions = []
    for _ in range(48):
        sim.step(len(t.next_round()))
        action = policy.decide(sim.stats())
        if action == "grow":
            sim.slots += 2
        elif action == "shrink":
            sim.slots = max(2, sim.slots - 2)
        if action != "hold":
            actions.append(action)
    assert "grow" in actions, f"peak never grew capacity: {actions}"
    assert "shrink" in actions, f"trough never shrank capacity: {actions}"


def test_drain_idiom_via_zero_rate():
    t = make_traffic("diurnal", rate=2.0, peak_rate=8.0, period=8,
                     prompt_len=4, max_new_tokens=2, vocab_size=97)
    t.next_round()
    t.rate = t.peak_rate = 0.0
    assert all(len(t.next_round()) == 0 for _ in range(8))


def test_make_traffic_kinds_and_validation():
    assert isinstance(mk("steady"), ServeTraffic)
    assert isinstance(mk("poisson"), PoissonTraffic)
    d = mk("diurnal")
    assert isinstance(d, DiurnalTraffic)
    assert d.peak_rate == pytest.approx(8.0)
    with pytest.raises(ValueError, match="kind"):
        mk("bursty")
    with pytest.raises(ValueError, match="peak_rate"):
        mk("diurnal", peak_rate=0.5)
    with pytest.raises(ValueError, match="period"):
        mk("diurnal", period=1)
    with pytest.raises(ValueError, match="rate"):
        mk("poisson", rate=-1.0)


def test_ragged_prompts_within_bounds():
    t = mk("poisson", rate=4.0)
    lens = set()
    for _ in range(20):
        for r in t.next_round():
            lens.add(len(r.prompt))
    assert lens and min(lens) >= 1 and max(lens) <= 8
    assert len(lens) > 1, "ragged prompts should vary in length"


def test_queue_sim_stats_contract():
    sim = QueueSim(slots=2, tokens_per_request=2)
    sim.step(3)
    stats = sim.stats()
    assert stats["queued"] == 1 and stats["free_slots"] == 0
    assert stats["occupancy_now"] == 1.0
    assert SLOPolicy().decide(stats) == "grow"
    assert stats == (lambda s: (s.step(3), s.stats())[1])(
        ref_traffic.QueueSim(slots=2, tokens_per_request=2))
    with pytest.raises(ValueError):
        QueueSim(slots=0, tokens_per_request=1)


def test_trace_is_frozen():
    trace = TrafficTrace(kind="poisson", seed=0, rates=(1.0,), arrivals=(2,))
    with pytest.raises(Exception):
        trace.arrivals = (3,)
