"""Workload: what to train — model init, SUM-loss gradient, and a data feed.

The trainer's contract: ``loss_and_grad(params, batch, mask)`` returns the
gradient of the *weighted SUM* loss, never the mean — gradient sums are
accumulated across microbatches and divided by the total weight exactly
once, which is what makes variable per-worker batch sizes weight examples
correctly (paper Eq. 2-3).  :func:`sum_loss_adapter` implements it once;
every constructor below goes through it:

  * :func:`mean_loss_workload` — a plain per-example loss
    ``per_example_loss(params, batch) -> (n,)``;
  * :func:`sum_loss_workload` — a loss in the ``(loss_sum, weight_sum,
    aux)`` convention (``repro_torch.models.simple``);
  * :func:`paper_workload` — the paper's LinReg / MNIST-CNN / ResNet by
    name;
  * :func:`lm_workload` — LM training from a model config + ``DataPipeline``.

Parameters are flat ``dict[str, Tensor]``; ``init(generator)`` draws them on
the generator's device.  ``to(device)`` (optional) moves the data feed to the
device the backend runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.grad import loss_grads
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class Workload:
    """Bundle satisfying the trainer contract: init + SUM-loss grad + data."""

    name: str
    init: Callable
    loss_and_grad: Callable
    next_batch: Callable
    state_dict: Optional[Callable[[], dict]] = None
    load_state_dict: Optional[Callable[[dict], None]] = None
    to: Optional[Callable] = None


class CounterBatchSource:
    """Deterministic per-(worker, call) batch stream.

    Call *i* of worker *k* draws its examples from
    ``numpy.random.default_rng((seed + k, i))`` through ``make_batch(rng,
    n)`` (numpy arrays), a pure function of (seed, worker, call index): a
    controller batch-resize changes only ``n``, never which stream the
    examples come from, the CPU and the card see the same examples, and a
    checkpoint resumes the stream exactly (``state_dict`` round-trips the
    per-worker counters).  The arrays become tensors on the device set by
    :meth:`to`; with none set, on the card (raising when there is none).
    """

    def __init__(self, make_batch: Callable, seed: int = 0):
        self.make_batch = make_batch
        self.seed = seed
        self.counters: dict[int, int] = {}
        self.device = None

    def to(self, device: DeviceLike) -> "CounterBatchSource":
        self.device = resolve_device(device)
        return self

    def __call__(self, worker: int, n: int) -> dict:
        if self.device is None:
            self.device = resolve_device(None)
        self.counters[worker] = self.counters.get(worker, 0) + 1
        rng = np.random.default_rng((self.seed + worker,
                                     self.counters[worker]))
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in self.make_batch(rng, n).items()}

    def state_dict(self) -> dict:
        return {"seed": self.seed, "counters": dict(self.counters)}

    def load_state_dict(self, state: dict) -> None:
        if "seed" in state and int(state["seed"]) != self.seed:
            raise ValueError(
                f"checkpoint batch stream used seed {state['seed']}, this "
                f"workload uses {self.seed} — resuming would silently train "
                f"on a different data stream")
        self.counters = {int(k): int(v)
                         for k, v in state["counters"].items()}


# --------------------------------------------------------------- adapters


def sum_loss_adapter(loss_fn: Callable, aux_weight: float = 0.0) -> Callable:
    """Trainer-contract ``loss_and_grad`` from a SUM-convention loss
    ``loss_fn(params, batch, mask) -> (loss_sum, weight_sum, aux)``.

    The gradient is of ``loss_sum + aux_weight * aux * max(weight_sum, 1)``;
    the returned metas carry the plain SUM loss (THE single implementation
    of the SUM-semantics contract)."""

    def loss_and_grad(params, batch, mask):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        ls, ws, aux = loss_fn(leaves, batch, mask)
        total = (ls + aux_weight * aux * torch.clamp(ws, min=1.0)
                 if aux_weight else ls)
        return ((ls.detach(), ws.detach(), aux.detach()),
                loss_grads(total, leaves))

    return loss_and_grad


def mean_loss_adapter(per_example_loss: Callable) -> Callable:
    """Trainer-contract ``loss_and_grad`` from an ordinary per-example loss
    ``per_example_loss(params, batch) -> (n,)``, written as if computing a
    plain mean; masking and summation happen here, the SUM contract in
    :func:`sum_loss_adapter`."""

    def loss_fn(params, batch, mask):
        ls = (per_example_loss(params, batch) * mask).sum()
        return ls, mask.sum(), torch.zeros((), device=mask.device)

    return sum_loss_adapter(loss_fn)


# ----------------------------------------------------------- constructors


def _counter_workload(name, init, loss_and_grad, make_batch, seed):
    src = CounterBatchSource(make_batch, seed)
    return Workload(name, init, loss_and_grad, src, src.state_dict,
                    src.load_state_dict, src.to)


def mean_loss_workload(name: str, init: Callable,
                       per_example_loss: Callable, make_batch: Callable,
                       *, seed: int = 0) -> Workload:
    """Workload from an ordinary per-example mean-style loss (see
    :func:`mean_loss_adapter`) + a ``make_batch(rng, n)`` sampler."""
    return _counter_workload(name, init, mean_loss_adapter(per_example_loss),
                             make_batch, seed)


def sum_loss_workload(name: str, init: Callable, loss_fn: Callable,
                      make_batch: Callable, *, seed: int = 0) -> Workload:
    """Workload from a ``(loss_sum, weight_sum, aux)``-convention loss."""
    return _counter_workload(name, init, sum_loss_adapter(loss_fn),
                             make_batch, seed)


def paper_workload(name: str, *, seed: int = 100) -> Workload:
    """One of the paper's evaluation workloads ('linreg' | 'mnist-cnn' |
    'resnet'), on synthetic data with a planted ground truth."""
    from repro_torch.models.simple import paper_workloads

    wl = paper_workloads()[name]
    return sum_loss_workload(name, wl.init, wl.loss_fn, wl.make_batch,
                             seed=seed)


def lm_workload(model_cfg, pipe, *, aux_weight: float = 0.0,
                use_kernel: bool = False) -> Workload:
    """Transformer-LM training from a model config + ``DataPipeline``:
    decoder-only (dense, MoE, ssm, hybrid, vlm) or encoder-decoder.

    vlm batches carry ``"prefix"`` patch embeddings, whose positions the
    loss leaves out; encdec batches carry the encoder's frames there.
    ``aux_weight`` scales an auxiliary loss (the MoE load-balance loss;
    zero in the other families) by the weight sum, so it stays commensurate
    with the SUM-convention main loss; the metas report the plain SUM loss.

    ``use_kernel=True`` sets ``use_pallas`` (never for encdec, as in the
    reference).  In the dense, MoE and vlm families' GQA attention, and in
    the hybrid family's local-attention blocks, it routes attention through
    the flash kernels and derives their ``num_valid`` on the device from the
    very mask the trainer built when it padded the batch: rows the loss
    masks out are exactly the rows the kernels skip (valid rows form a
    prefix).  MLA attention stays plain.  In the ssm family it routes the
    SSD scan's intra-chunk part through the SSD kernel pair, and in the
    hybrid family's recurrent blocks the RG-LRU scan through the RG-LRU
    kernel pair, forward and backward.  This differs from the reference on
    purpose: its SSD and RG-LRU kernel paths have no VJP, so its
    ``use_kernel=True`` cannot train those families; the port trains the
    same functions through its kernels.
    """
    from repro_torch.models import encdec_loss, init_model, lm_loss

    encdec = model_cfg.family == "encdec"
    if use_kernel and not encdec:
        model_cfg = model_cfg.with_(use_pallas=True)

    def loss_fn(params, batch, mask):
        if encdec:
            return encdec_loss(params, model_cfg, batch["prefix"],
                               batch["tokens"], batch["targets"], mask)
        num_valid = None
        if use_kernel:
            row_w = mask if mask.dim() == 1 else mask.amax(-1)
            num_valid = (row_w > 0).sum().to(torch.int32)
        return lm_loss(params, model_cfg, batch["tokens"], batch["targets"],
                       mask, prefix_embeds=batch.get("prefix"),
                       num_valid=num_valid)

    return Workload(
        name=getattr(model_cfg, "name", model_cfg.family),
        init=lambda gen: init_model(gen, model_cfg),
        loss_and_grad=sum_loss_adapter(loss_fn, aux_weight),
        next_batch=pipe.next_batch,
        state_dict=pipe.state_dict,
        load_state_dict=pipe.load_state_dict,
        to=pipe.to,
    )
