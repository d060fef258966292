"""All ten architectures through the port at ``reduced`` size, on the CPU: a
mirror of ``tests/test_models.py``, then the port held against the JAX
package on shared inputs.

Mirrors (the port alone): forward shapes and finiteness, one Adam step,
decode through the caches against the full pass (atol 2e-4, rtol 2e-3, the
reference's), sliding-window decode through rings, and the vlm prefix's
weights.  MoE configs run at capacity factor 8.0 there, as the reference's
test does, so that no choice drops.

Against the reference (its parameters through ``params_from_jax``, numpy
inputs): the parameters' round trip through ``params_from_jax`` /
``params_to_jax``, exact; logits and the loss of ``apply_lm`` / ``lm_loss`` /
``encdec_loss`` at rtol 1e-5, with every MoE token's k-th routing
probability asserted to clear its (k+1)-th by 1e-4; the ten full configs'
parameter counts ``==`` the reference's ``param_count``; a three-worker
sim-backend BSP run of a MoE (MLA + MoE deepseek-v2 at its own capacity
factor 1.25, aux weight 0.01), a vlm and an encdec config on the
reference's own batches (its prefixes included) with batches and sim_time
bit-identical and losses at rtol 1e-4; and, in the port alone, a save /
restore round trip of each of the three that continues bit for bit.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as R
from repro.configs import get_config as ref_get_config
from repro.core import ControllerConfig as RefControllerConfig
from repro.data import DataPipeline as RefDataPipeline
from repro.launch.steps import param_count as ref_param_count
from repro.models import apply_lm as ref_apply_lm
from repro.models import encdec_loss as ref_encdec_loss
from repro.models import init_encdec as ref_init_encdec
from repro.models import init_lm as ref_init_lm
from repro.models import lm_loss as ref_lm_loss
from repro.models import reduced as ref_reduced
from repro.optim import adam as ref_adam
from repro_torch import api as T
from repro_torch.configs import get_config, list_architectures
from repro_torch.core import ControllerConfig
from repro_torch.data import DataPipeline
from repro_torch.models import (apply_lm, encdec_decode, encdec_encode,
                                encdec_loss, init_caches, init_dec_caches,
                                init_model, layers, lm_loss, param_count,
                                params_from_jax, params_to_jax, reduced)
from repro_torch.optim import adam

ARCHS = list_architectures()
CPU = dict(device="cpu")
MARGIN = 1e-4


def _reduced(arch, ref=False):
    cfg = (ref_reduced(ref_get_config(arch)) if ref
           else reduced(get_config(arch)))
    if cfg.num_experts:  # no capacity drops, as tests/test_models.py
        cfg = cfg.with_(moe_capacity_factor=8.0)
    return cfg


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
           "targets": rng.integers(0, cfg.vocab_size, (b, s)),
           "weights": np.ones((b,), np.float32)}
    n = {"vlm": cfg.num_patches, "encdec": cfg.encoder_seq}.get(cfg.family)
    if n:
        out["prefix"] = (0.02 * rng.standard_normal(
            (b, n, cfg.d_model))).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _loss(params, cfg, bt):
    if cfg.family == "encdec":
        return encdec_loss(params, cfg, bt["prefix"], bt["tokens"],
                           bt["targets"], bt["weights"])
    return lm_loss(params, cfg, bt["tokens"], bt["targets"], bt["weights"],
                   prefix_embeds=bt.get("prefix"))


# ------------------------------------------------ mirrors of test_models.py


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_and_finite(arch):
    cfg = _reduced(arch)
    b, s = 2, 16
    bt = _t(_batch(cfg, b, s))
    params = init_model(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        if cfg.family == "encdec":
            enc = encdec_encode(params, cfg, bt["prefix"])
            assert enc.shape == (b, cfg.encoder_seq, cfg.d_model)
            logits, _ = encdec_decode(params, cfg, bt["tokens"], enc)
        else:
            logits, aux = apply_lm(params, cfg, bt["tokens"],
                                   prefix_embeds=bt.get("prefix"))
            assert torch.isfinite(aux)
            assert (aux > 0) == bool(cfg.num_experts)
    assert logits.shape == (b, s, cfg.vocab_size)
    assert torch.isfinite(logits).all(), f"{arch}: non-finite logits"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_updates_and_finite(arch):
    cfg = _reduced(arch)
    bt = _t(_batch(cfg))
    params = init_model(torch.Generator().manual_seed(0), cfg)
    opt = adam(1e-3)
    state = opt.init(params)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    ls, ws, aux = _loss(leaves, cfg, bt)
    loss = ls / torch.clamp(ws, min=1e-9) + 0.01 * aux
    grads = dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()), allow_unused=True)))
    assert torch.isfinite(loss), f"{arch}: non-finite loss"
    used = {k: g for k, g in grads.items() if g is not None}
    gnorm = sum(float(g.square().sum()) for g in used.values())
    assert np.isfinite(gnorm) and gnorm > 0, f"{arch}: bad grads"
    grads = {k: g if g is not None else torch.zeros_like(params[k])
             for k, g in grads.items()}
    new, _ = opt.update(params, grads, state, 0)
    delta = sum(float((new[k] - params[k]).abs().sum()) for k in params)
    assert delta > 0, f"{arch}: params unchanged"


def _decode(params, cfg, batch, s, length):
    b = batch["tokens"].shape[0]
    toks = torch.from_numpy(batch["tokens"])
    outs = []
    with torch.no_grad():
        if cfg.family == "encdec":
            enc = encdec_encode(params, cfg, torch.from_numpy(batch["prefix"]))
            full, _ = encdec_decode(params, cfg, toks, enc)
            caches = init_dec_caches(cfg, b, length, **CPU)
            for i in range(s):
                lg, caches = encdec_decode(
                    params, cfg, toks[:, i:i + 1], enc, caches=caches,
                    positions=torch.full((b, 1), i))
                outs.append(lg)
        else:
            prefix = batch.get("prefix")
            prefix = None if prefix is None else torch.from_numpy(prefix)
            full, _ = apply_lm(params, cfg, toks, prefix_embeds=prefix)
            caches = init_caches(cfg, b, length, **CPU)
            for i in range(s):
                # a vlm's first positions feed its patch embeddings
                pe = (prefix[:, i:i + 1] if prefix is not None
                      and i < prefix.shape[1] else None)
                lg, caches, _ = apply_lm(
                    params, cfg, toks[:, i:i + 1], caches=caches,
                    positions=torch.full((b, 1), i), prefix_embeds=pe)
                outs.append(lg)
    return torch.cat(outs, dim=1), full, caches


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    cfg = _reduced(arch)
    s = 10
    params = init_model(torch.Generator().manual_seed(0), cfg)
    dec, full, _ = _decode(params, cfg, _batch(cfg, 2, s, seed=1), s, s)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=2e-4,
                               rtol=2e-3)


@pytest.mark.parametrize("arch", ["llama3-8b", "recurrentgemma-9b"])
def test_sliding_window_decode(arch):
    """Windowed attention decode (ring cache) == windowed full pass."""
    cfg = _reduced(arch).with_(window=4)
    if cfg.family == "hybrid":
        cfg = cfg.with_(local_window=4)
    s = 12
    params = init_model(torch.Generator().manual_seed(0), cfg)
    batch = _batch(cfg, 1, s, seed=2)
    dec, full, caches = _decode(params, cfg, batch, s, s)
    ring = [k for k in caches if k.endswith(".k")]
    assert ring and all(caches[k].shape[1] == 4 for k in ring)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=2e-4,
                               rtol=2e-3)


def test_vlm_prefix_positions_excluded_from_loss():
    cfg = _reduced("phi-3-vision-4.2b")
    b, s = 2, 16
    bt = _t(_batch(cfg, b, s))
    params = init_model(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        _, ws, _ = lm_loss(params, cfg, bt["tokens"], bt["targets"],
                           bt["weights"], prefix_embeds=bt["prefix"])
        _, ws_tok, _ = lm_loss(params, cfg, bt["tokens"], bt["targets"],
                               torch.ones(b, s), prefix_embeds=bt["prefix"])
    assert float(ws) == float(ws_tok) == b * (s - cfg.num_patches)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-medium",
                                  "gemma-2b"])
def test_prefix_is_a_pure_function_of_seed_worker_and_index(arch):
    """However the stream is sliced, example i of worker k gets the same
    prefix; other workers and seeds get others; N(0, 0.02^2) entries."""
    cfg = reduced(get_config(arch))
    p = {"vlm": cfg.num_patches, "encdec": cfg.encoder_seq}.get(cfg.family)
    a = DataPipeline(cfg, seq_len=16, num_workers=2, seed=3, **CPU)
    b = DataPipeline(cfg, seq_len=16, num_workers=2, seed=3, **CPU)
    first = [a.next_batch(0, 2), a.next_batch(0, 3)]
    whole = b.next_batch(0, 5)
    if p is None:
        assert "prefix" not in whole
        return
    assert whole["prefix"].shape == (5, p, cfg.d_model)
    assert whole["prefix"].dtype == torch.float32
    assert torch.equal(torch.cat([x["prefix"] for x in first]),
                       whole["prefix"])
    other = b.next_batch(1, 5)["prefix"]
    assert not torch.equal(other, whole["prefix"])
    reseeded = DataPipeline(cfg, seq_len=16, num_workers=2, seed=4,
                            **CPU).next_batch(0, 5)["prefix"]
    assert not torch.equal(reseeded, whole["prefix"])
    assert abs(whole["prefix"].std().item() - 0.02) < 0.002
    c = DataPipeline(cfg, seq_len=16, num_workers=2, seed=3, **CPU)
    c.load_state_dict({"cursors": [2, 0]})
    assert torch.equal(c.next_batch(0, 3)["prefix"], first[1]["prefix"])


# ------------------------------------------------------ against the JAX


def _ref_params(arch, ref_cfg):
    init = ref_init_encdec if ref_cfg.family == "encdec" else ref_init_lm
    return jax.tree_util.tree_map(np.asarray,
                                  init(jax.random.PRNGKey(0), ref_cfg))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_params_roundtrip_exact(arch):
    """Reference tree -> port -> reference tree, bit for bit, with the
    port's names and shapes those of its own ``init_model``."""
    cfg, ref_cfg = _reduced(arch), _reduced(arch, ref=True)
    rp = _ref_params(arch, ref_cfg)
    params = params_from_jax(rp, cfg, **CPU)
    ours = init_model(torch.Generator().manual_seed(0), cfg)
    assert params.keys() == ours.keys()
    for k, v in ours.items():
        assert params[k].shape == v.shape and params[k].dtype == v.dtype, k
    back, want = _flat(params_to_jax(params, cfg)), _flat(rp)
    assert back.keys() == want.keys()
    for key in want:
        assert back[key].dtype == want[key].dtype, key
        assert np.array_equal(back[key], want[key]), key


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match_reference(arch, monkeypatch):
    cfg, ref_cfg = _reduced(arch), _reduced(arch, ref=True)
    rp = _ref_params(arch, ref_cfg)
    params = params_from_jax(rp, cfg, **CPU)
    batch = _batch(cfg, 2, 16, seed=3)
    batch["weights"] = np.array([1.0, 0.5], np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    bt = _t(batch)
    routed = []
    route = layers.moe_route

    def recording_route(p, xt, c):
        out = route(p, xt, c)
        routed.append(out[0].detach())
        return out

    monkeypatch.setattr(layers, "moe_route", recording_route)
    with torch.no_grad():
        ls, ws, aux = _loss(params, cfg, bt)
        if cfg.family == "encdec":
            ref_ls, ref_ws, ref_aux = ref_encdec_loss(
                rp, ref_cfg, jb["prefix"], jb["tokens"], jb["targets"],
                jb["weights"])
            logits, _ = encdec_decode(params, cfg, bt["tokens"],
                                      encdec_encode(params, cfg,
                                                    bt["prefix"]))
            from repro.models import encdec_decode as ref_dec
            from repro.models import encdec_encode as ref_enc

            ref_logits, _ = ref_dec(rp, ref_cfg, jb["tokens"],
                                    ref_enc(rp, ref_cfg, jb["prefix"]))
        else:
            ref_ls, ref_ws, ref_aux = ref_lm_loss(
                rp, ref_cfg, jb["tokens"], jb["targets"], jb["weights"],
                prefix_embeds=jb.get("prefix"))
            logits, aux2 = apply_lm(params, cfg, bt["tokens"],
                                    prefix_embeds=bt.get("prefix"))
            ref_logits, _, ref_aux2 = ref_apply_lm(
                rp, ref_cfg, jb["tokens"], prefix_embeds=jb.get("prefix"))
            np.testing.assert_allclose(aux2.item(), float(ref_aux2),
                                       rtol=1e-5, atol=1e-7)
    if cfg.num_experts:
        k = cfg.moe_top_k
        assert len(routed) == 2 * cfg.num_layers
        for probs in routed:
            top = torch.sort(probs.reshape(-1, probs.shape[-1]), dim=-1,
                             descending=True).values
            margin = (top[:, k - 1] - top[:, k]).min().item()
            assert margin > MARGIN, f"router near-tie ({margin:.3g})"
    else:
        assert not routed
    ref_logits = np.asarray(ref_logits)
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-5,
                               atol=1e-5 * np.abs(ref_logits).max())
    assert ws.item() == float(ref_ws)
    np.testing.assert_allclose(ls.item(), float(ref_ls), rtol=1e-5)
    np.testing.assert_allclose(aux.item(), float(ref_aux), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    """The full config, counted on tensors without storage."""
    assert param_count(get_config(arch)) == ref_param_count(
        ref_get_config(arch))


def test_reduced_matches_reference():
    import dataclasses

    for arch in ARCHS:
        ours = dataclasses.asdict(reduced(get_config(arch)))
        assert ours == dataclasses.asdict(ref_reduced(ref_get_config(arch)))


# ---------------------------------------------------- trajectories, resume

TRAJ = {"deepseek-v2-236b": 0.01, "phi-3-vision-4.2b": 0.0,
        "whisper-medium": 0.0}
SEQ, WORKERS, STEPS = 16, 3, 3


def _train_cfg(mod, ctrl, steps):
    return mod.TrainConfig(b0=4, microbatch=2, batching="dynamic", sync="bsp",
                           max_steps=steps, controller=ctrl(kind="p"))


@pytest.mark.parametrize("arch", list(TRAJ))
def test_sim_trajectory_matches_reference(arch):
    ref_cfg = ref_reduced(ref_get_config(arch))
    ref_wl = R.lm_workload(ref_cfg, RefDataPipeline(ref_cfg, seq_len=SEQ,
                                                    num_workers=WORKERS),
                           aux_weight=TRAJ[arch], use_kernel=True)
    fed = []
    ref_next = ref_wl.next_batch

    def recording(worker, n):
        batch = ref_next(worker, n)
        fed.append((worker, n, {k: np.array(v) for k, v in batch.items()}))
        return batch

    ref_wl.next_batch = recording
    params0 = jax.tree_util.tree_map(
        np.asarray, ref_wl.init(jax.random.PRNGKey(0)))
    ref = R.Experiment(
        workload=ref_wl,
        cluster=R.ClusterSpec.hlevel(39, 6.0, WORKERS, workload="transformer",
                                     seed=0),
        optimizer=ref_adam(1e-3),
        config=_train_cfg(R, RefControllerConfig, STEPS)).session().run()
    assert all(("prefix" in b) == (ref_cfg.family in ("vlm", "encdec"))
               for _, _, b in fed)

    cfg = reduced(get_config(arch))
    wl = T.lm_workload(cfg, DataPipeline(cfg, seq_len=SEQ,
                                         num_workers=WORKERS, **CPU),
                       aux_weight=TRAJ[arch], use_kernel=True)
    wl.init = lambda gen: params_from_jax(params0, cfg, device=gen.device)
    replay = iter(fed)

    def injected(worker, n):
        w, m, batch = next(replay)
        assert (w, m) == (worker, n)
        return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                    else v) for k, v in batch.items()}

    wl.next_batch = injected
    ours = T.Experiment(
        workload=wl,
        cluster=T.ClusterSpec.hlevel(39, 6.0, WORKERS, workload="transformer",
                                     seed=0, backend=T.SimBackend(**CPU)),
        optimizer=adam(1e-3),
        config=_train_cfg(T, ControllerConfig, STEPS)).session().run()
    assert next(replay, None) is None
    assert ours["steps"] == ref["steps"] == STEPS
    for a, b in zip(ours["history"], ref["history"]):
        assert a.batches == b.batches
        assert a.sim_time == b.sim_time
        assert a.adjusted == b.adjusted
        assert a.worker_times == b.worker_times
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4)
    assert ours["sim_time"] == ref["sim_time"]
    assert sum(ours["final_batches"]) == sum(ref["final_batches"]) == 12


@pytest.mark.parametrize("arch", list(TRAJ))
def test_save_restore_round_trip(arch, tmp_path):
    path = str(tmp_path / "ckpt.npz")
    cfg = reduced(get_config(arch))

    def experiment():
        return T.Experiment(
            workload=T.lm_workload(cfg, DataPipeline(
                cfg, seq_len=SEQ, num_workers=WORKERS, **CPU),
                aux_weight=TRAJ[arch], use_kernel=True),
            cluster=T.ClusterSpec.hlevel(39, 6.0, WORKERS,
                                         workload="transformer", seed=0,
                                         backend=T.SimBackend(**CPU)),
            optimizer=adam(1e-3),
            config=_train_cfg(T, ControllerConfig, 4))

    sess = experiment().session()
    for rec in sess:
        if rec.step == 1:
            sess.save(path)
            break
    resumed = experiment().session(resume_from=path)
    assert resumed.workload.state_dict() == sess.workload.state_dict()
    out = resumed.run()
    straight = experiment().session()
    ref = straight.run()
    assert len(out["history"]) == 2
    for a, b in zip(ref["history"][2:], out["history"]):
        assert (a.step, a.loss, a.sim_time, a.batches) == (
            b.step, b.loss, b.sim_time, b.batches)
    assert resumed.params.keys() == straight.params.keys()
    for k, v in straight.params.items():
        assert torch.equal(resumed.params[k], v), k
    for part in ("m", "v"):
        for k, v in straight.trainer.opt_state[part].items():
            assert torch.equal(resumed.trainer.opt_state[part][k], v), k
