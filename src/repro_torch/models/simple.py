"""The paper's own evaluation workloads, in PyTorch.

The paper trains (IV): ResNet on CIFAR-10, an MNIST CNN (Adam), and Linear
Regression on the bar-crawl dataset.  As in the JAX package, each runs on
*synthetic data with a planted ground truth* at the widths below (16x16
images, channels 8 and 16, ResNet width 16): convergence is real, only the
data is synthetic.

Each workload exposes:
    init(generator)                -> params (flat dict, on the generator's
                                      device)
    loss_fn(params, batch, mask)   -> (weighted loss sum, weight sum, aux)
    make_batch(rng, n)             -> batch of numpy arrays (leading dim n)
so the heterogeneous training loop treats them like the LMs.  ``rng`` is a
``numpy.random.Generator``: the batch source
(:class:`repro_torch.api.workload.CounterBatchSource`) derives one per
(worker, call) and moves the arrays to the training device.  The planted
truths and class templates come from fixed numpy seeds (1234, 7, 11), with
the JAX package's distributions and noise levels; the JAX package draws
them from ``jax.random``, so the two streams differ and parity tests inject
one side's batches into the other.

Images are NHWC and convolution kernels OIHW (``torch.nn.functional``'s
layout); the CNN flattens its NHWC activations, so ``w1``'s rows are in
(h, w, c) order, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

# ------------------------------------------------------------ linear regression


@dataclasses.dataclass(frozen=True)
class LinRegConfig:
    dim: int = 32
    noise: float = 0.05
    name: str = "paper-linreg"


def linreg_init(gen: torch.Generator, cfg: LinRegConfig) -> dict:
    dev = gen.device
    return {"w": torch.zeros(cfg.dim, device=dev),
            "b": torch.zeros((), device=dev)}


@functools.lru_cache(maxsize=None)
def linreg_true_params(cfg: LinRegConfig):
    w = np.random.default_rng(1234).standard_normal(cfg.dim, np.float32)
    return w, np.float32(0.5)


def linreg_batch(rng: np.random.Generator, n: int, cfg: LinRegConfig) -> dict:
    w, b = linreg_true_params(cfg)
    x = rng.standard_normal((n, cfg.dim), np.float32)
    y = x @ w + b + np.float32(cfg.noise) * rng.standard_normal(n, np.float32)
    return {"x": x, "y": y}


def linreg_loss(params, batch, mask, cfg: LinRegConfig):
    pred = batch["x"] @ params["w"] + params["b"]
    per_ex = 0.5 * (pred - batch["y"]) ** 2
    return (per_ex * mask).sum(), mask.sum(), torch.zeros((), device=mask.device)


# ------------------------------------------------------------------ MNIST CNN


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    image: int = 16           # synthetic "MNIST" at 16x16
    classes: int = 10
    channels: tuple = (8, 16)
    hidden: int = 64
    name: str = "paper-mnist-cnn"


def _conv_init(gen, k, cin, cout):
    std = 1.0 / math.sqrt(k * k * cin)
    return torch.randn((cout, cin, k, k), generator=gen,
                       device=gen.device) * std


def _normal(gen, shape, scale):
    return torch.randn(shape, generator=gen, device=gen.device) / scale


def cnn_init(gen: torch.Generator, cfg: CNNConfig) -> dict:
    feat = (cfg.image // 4) ** 2 * cfg.channels[1]
    dev = gen.device
    return {
        "c1": _conv_init(gen, 3, 1, cfg.channels[0]),
        "c2": _conv_init(gen, 3, cfg.channels[0], cfg.channels[1]),
        "w1": _normal(gen, (feat, cfg.hidden), math.sqrt(feat)),
        "b1": torch.zeros(cfg.hidden, device=dev),
        "w2": _normal(gen, (cfg.hidden, cfg.classes), math.sqrt(cfg.hidden)),
        "b2": torch.zeros(cfg.classes, device=dev),
    }


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: the output has
    ceil(size / stride) entries and the lower side gets the smaller half of
    the padding (0 above and 1 below for k 3, stride 2 on an even size)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """"SAME" convolution of NCHW ``x`` with an OIHW kernel."""
    top, bottom = _same_pads(x.shape[2], w.shape[2], stride)
    left, right = _same_pads(x.shape[3], w.shape[3], stride)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def cnn_forward(params, images):
    x = images.permute(0, 3, 1, 2)                  # NHWC -> NCHW
    x = torch.relu(_conv(x, params["c1"], 2))
    x = torch.relu(_conv(x, params["c2"], 2))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten as NHWC
    x = torch.relu(x @ params["w1"] + params["b1"])
    return x @ params["w2"] + params["b2"]


@functools.lru_cache(maxsize=None)
def _templates(seed: int, classes: int, image: int, channels: int):
    return np.random.default_rng(seed).standard_normal(
        (classes, image, image, channels), np.float32)


def _class_images(rng, n, classes, image, channels, seed, noise):
    """Class templates (fixed by ``seed``) plus Gaussian noise."""
    labels = rng.integers(0, classes, n)
    imgs = _templates(seed, classes, image, channels)[labels] + np.float32(
        noise) * rng.standard_normal((n, image, image, channels), np.float32)
    return {"x": imgs, "y": labels}


def cnn_batch(rng: np.random.Generator, n: int, cfg: CNNConfig) -> dict:
    """Synthetic class-conditional images: class templates + noise."""
    return _class_images(rng, n, cfg.classes, cfg.image, 1, 7, 0.5)


def _nll_sums(logits, labels, mask):
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return (nll * mask).sum(), mask.sum(), torch.zeros((), device=mask.device)


def cnn_loss(params, batch, mask, cfg: CNNConfig):
    return _nll_sums(cnn_forward(params, batch["x"]), batch["y"], mask)


def cnn_accuracy(params, batch):
    logits = cnn_forward(params, batch["x"])
    return (logits.argmax(-1) == batch["y"]).float().mean()


# -------------------------------------------------------------- mini ResNet


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    image: int = 16           # synthetic CIFAR at 16x16x3
    classes: int = 10
    width: int = 16
    blocks: int = 3
    name: str = "paper-resnet"


def resnet_init(gen: torch.Generator, cfg: ResNetConfig) -> dict:
    p = {"stem": _conv_init(gen, 3, 3, cfg.width)}
    for i in range(cfg.blocks):
        p[f"blk{i}_a"] = _conv_init(gen, 3, cfg.width, cfg.width)
        p[f"blk{i}_b"] = _conv_init(gen, 3, cfg.width, cfg.width)
    p["head_w"] = _normal(gen, (cfg.width, cfg.classes), math.sqrt(cfg.width))
    p["head_b"] = torch.zeros(cfg.classes, device=gen.device)
    return p


def resnet_forward(params, images, cfg: ResNetConfig):
    x = torch.relu(_conv(images.permute(0, 3, 1, 2), params["stem"]))
    for i in range(cfg.blocks):
        h = torch.relu(_conv(x, params[f"blk{i}_a"]))
        h = _conv(h, params[f"blk{i}_b"])
        x = torch.relu(x + h)
    x = x.mean(dim=(2, 3))  # global average pool
    return x @ params["head_w"] + params["head_b"]


def resnet_batch(rng: np.random.Generator, n: int, cfg: ResNetConfig) -> dict:
    return _class_images(rng, n, cfg.classes, cfg.image, 3, 11, 0.7)


def resnet_loss(params, batch, mask, cfg: ResNetConfig):
    return _nll_sums(resnet_forward(params, batch["x"], cfg), batch["y"], mask)


def resnet_accuracy(params, batch, cfg: ResNetConfig):
    logits = resnet_forward(params, batch["x"], cfg)
    return (logits.argmax(-1) == batch["y"]).float().mean()


# --------------------------------------------------------------- registry


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    init: Callable
    loss_fn: Callable          # (params, batch, mask) -> (loss_sum, w_sum, aux)
    make_batch: Callable       # (rng, n) -> batch of numpy arrays
    metric_fn: Optional[Callable] = None  # optional accuracy


def paper_workloads() -> dict[str, Workload]:
    lr_cfg, cnn_cfg, rn_cfg = LinRegConfig(), CNNConfig(), ResNetConfig()
    return {
        "linreg": Workload(
            "linreg",
            partial(linreg_init, cfg=lr_cfg),
            partial(linreg_loss, cfg=lr_cfg),
            partial(linreg_batch, cfg=lr_cfg),
        ),
        "mnist-cnn": Workload(
            "mnist-cnn",
            partial(cnn_init, cfg=cnn_cfg),
            partial(cnn_loss, cfg=cnn_cfg),
            partial(cnn_batch, cfg=cnn_cfg),
            partial(cnn_accuracy),
        ),
        "resnet": Workload(
            "resnet",
            partial(resnet_init, cfg=rn_cfg),
            partial(resnet_loss, cfg=rn_cfg),
            partial(resnet_batch, cfg=rn_cfg),
            partial(resnet_accuracy, cfg=rn_cfg),
        ),
    }
