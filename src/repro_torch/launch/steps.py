"""Step programs and input specs for every (arch x shape): the reference's
``launch/steps.py``.

  * ``train_step``   - forward, weighted loss (Eq. 2-3 through per-example
                       weights), backward and optimizer update; remat per
                       block group when the config asks for it;
  * ``prefill_step`` - full-sequence forward, returning the last token's
                       logits;
  * ``serve_step``   - ONE token against a KV / state cache.

Parameters and optimizer state are the port's flat dicts.  The input specs
and ``init_params_struct`` are tensors on the ``meta`` device: shapes and
dtypes, no storage.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.core.grad import accumulate_microbatch_grads, loss_grads
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import param_count
from repro_torch.optim.optimizers import Optimizer, adam, momentum
from repro_torch.serve.engine import cache_length

AUX_WEIGHT = 0.01
LONG_CONTEXT_WINDOW = 4096

__all__ = ["AUX_WEIGHT", "LONG_CONTEXT_WINDOW", "adapt_for_shape",
           "init_params_struct", "input_specs", "make_prefill_step",
           "make_serve_step", "make_train_step", "param_count",
           "pick_optimizer", "supported"]


def pick_optimizer(cfg: ModelConfig,
                   n_params: Optional[int] = None) -> Optimizer:
    """Adam below 50B parameters, the paper's momentum-SGD from there on
    (fp32 Adam moments of the 236B and 314B configs fit no device set the
    reference plans for)."""
    n = n_params if n_params is not None else param_count(cfg)
    return momentum(0.01) if n >= 50e9 else adam(1e-4)


def adapt_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Per-shape config adaptation (a sliding window for long_500k)."""
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        return cfg.with_(window=LONG_CONTEXT_WINDOW)
    return cfg


def supported(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    if cfg.family == "encdec" and shape.name == "long_500k":
        return False, ("whisper decoder max target length << 500k; "
                       "skip per DESIGN.md §5")
    return True, ""


# ------------------------------------------------------------- input specs


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Stand-ins for every model input: tensors on the ``meta`` device with
    the reference's shapes and dtypes (decode caches in the port's flat
    layout)."""
    b, s = shape.global_batch, shape.seq_len
    tok, act = torch.int32, cfg.act_dtype

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _spec((b, s), tok)}
        if shape.kind == "train":
            specs["targets"] = _spec((b, s), tok)
            specs["weights"] = _spec((b,), torch.float32)
        if cfg.family == "vlm":
            specs["prefix"] = _spec((b, cfg.num_patches, cfg.d_model), act)
        if cfg.family == "encdec":
            specs["frames"] = _spec((b, cfg.encoder_seq, cfg.d_model), act)
        return specs

    # decode
    clen = cache_length(cfg, s)
    specs = {"token": _spec((b, 1), tok), "position": _spec((), tok)}
    if cfg.family == "encdec":
        specs["caches"] = E.init_dec_caches(cfg, b, clen, act, device="meta")
        specs["enc_out"] = _spec((b, cfg.encoder_seq, cfg.d_model), act)
    else:
        specs["caches"] = T.init_caches(cfg, b, clen, act, device="meta")
    return specs


# ------------------------------------------------------------------- steps


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    accum_steps: int = 1):
    """The train step; ``accum_steps > 1`` splits the global batch into that
    many microbatches and accumulates gradient SUMS
    (``core.accumulate_microbatch_grads``) before the one optimizer update,
    trading peak activation memory for sequential steps.  The main
    weighted-mean loss gradient is exact under accumulation; the auxiliary
    (MoE load-balance) term becomes a weight-averaged per-microbatch aux,
    since routing fractions are computed per microbatch, so aux-bearing
    models differ slightly from ``accum_steps=1``.

    ``step(params, opt_state, step, batch) -> (params, opt_state, metrics)``
    with metrics ``loss``, ``aux`` and ``weight_sum`` (0-d tensors)."""

    def loss_terms(p, b):
        if cfg.family == "encdec":
            return E.encdec_loss(p, cfg, b["frames"], b["tokens"],
                                 b["targets"], b["weights"])
        return T.lm_loss(p, cfg, b["tokens"], b["targets"], b["weights"],
                         prefix_embeds=b.get("prefix"))

    def train_step(params, opt_state, step, batch):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        ls, ws, aux = loss_terms(leaves, batch)
        loss = ls / torch.clamp(ws, min=1e-9) + AUX_WEIGHT * aux
        grads = loss_grads(loss, leaves)
        del leaves
        params, opt_state = optimizer.update(params, grads, opt_state, step)
        metrics = {"loss": loss.detach(), "aux": aux.detach(),
                   "weight_sum": ws.detach()}
        return params, opt_state, metrics

    if accum_steps == 1:
        return train_step

    def accum_train_step(params, opt_state, step, batch):
        def split(x):
            if x.shape[0] % accum_steps:
                raise ValueError(
                    f"batch dim {x.shape[0]} not divisible by "
                    f"accum_steps={accum_steps}")
            return x.reshape((accum_steps, x.shape[0] // accum_steps)
                             + tuple(x.shape[1:]))

        micro = {k: split(v) for k, v in batch.items()}

        # differentiate the SUM form per microbatch; divide once at the end
        def sum_grad(p, mb, mb_weights):
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            ls, ws, aux = loss_terms(leaves, mb)
            grads = loss_grads(ls + AUX_WEIGHT * aux * ws, leaves)
            return (ls.detach(), ws.detach(), aux.detach()), grads

        # the per-example weights already live in each microbatch; the
        # helper's mask slot just passes them again (sum_grad ignores it)
        g_sum, ls, ws, aux_w = accumulate_microbatch_grads(
            sum_grad, params, micro, micro["weights"])
        denom = torch.clamp(ws, min=1e-9)
        grads = {k: g / denom for k, g in g_sum.items()}
        del g_sum
        aux = aux_w / denom
        loss = ls / denom + AUX_WEIGHT * aux
        params, opt_state = optimizer.update(params, grads, opt_state, step)
        return params, opt_state, {"loss": loss, "aux": aux,
                                   "weight_sum": ws}

    return accum_train_step


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.family == "encdec":
            enc = E.encode(params, cfg, batch["frames"])
            logits, _ = E.decode(params, cfg, batch["tokens"], enc)
        else:
            logits, _ = T.apply_lm(params, cfg, batch["tokens"],
                                   prefix_embeds=batch.get("prefix"))
        return logits[:, -1]

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(params, batch):
        b = batch["token"].shape[0]
        pos = batch["position"].reshape(1, 1).expand(b, 1)
        if cfg.family == "encdec":
            logits, caches = E.decode(params, cfg, batch["token"],
                                      batch["enc_out"],
                                      caches=batch["caches"], positions=pos)
        else:
            logits, caches, _ = T.apply_lm(params, cfg, batch["token"],
                                           caches=batch["caches"],
                                           positions=pos)
        return logits[:, 0], caches

    return serve_step


def init_params_struct(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The model's parameters as ``meta`` tensors (nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = T.init_model(torch.Generator(), cfg)
    return {k: _spec(v.shape, v.dtype) for k, v in params.items()}
