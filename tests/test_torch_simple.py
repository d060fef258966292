"""The paper workloads (``models/simple.py``) against the reference on the
reference's own batches: loss sum, weight sum and every gradient of the
port's ``loss_fn`` (autograd) equal the reference's under
``jax.value_and_grad``, the parameters carried over by
``paper_params_from_jax`` (HWIO conv kernels to OIHW).  Tolerance rtol 1e-5
/ atol 1e-6: fp32 on both sides, other summation orders in the
convolutions and products.  One microbatch slot is masked out.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models.simple import paper_workloads as ref_paper_workloads
from repro_torch.models import paper_params_from_jax, paper_workloads
from repro_torch.models import simple

RTOL, ATOL = 1e-5, 1e-6
NAMES = ["linreg", "mnist-cnn", "resnet"]


def _to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_reference(name):
    ref = ref_paper_workloads()[name]
    ours = paper_workloads()[name]
    params = jax.tree_util.tree_map(np.asarray,
                                    ref.init(jax.random.PRNGKey(3)))
    if name == "linreg":   # the reference starts it at zero: move it off
        params = {"w": np.linspace(-1, 1, params["w"].size, dtype=np.float32),
                  "b": np.float32(0.25)}
    batch = jax.tree_util.tree_map(np.asarray,
                                   ref.make_batch(jax.random.PRNGKey(5), 8))
    mask = np.array([1, 1, 1, 1, 1, 1, 0, 1], np.float32)

    def lf(p):
        ls, ws, aux = ref.loss_fn(p, batch, jnp.asarray(mask))
        return ls, (ls, ws)

    (_, (ls_r, ws_r)), g_r = jax.value_and_grad(lf, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    leaves = {k: v.requires_grad_() for k, v in
              paper_params_from_jax(name, params, device="cpu").items()}
    ls, ws, aux = ours.loss_fn(leaves, _to_torch(batch),
                               torch.from_numpy(mask))
    grads = dict(zip(leaves, torch.autograd.grad(ls, list(leaves.values()))))
    np.testing.assert_allclose(ls.item(), float(ls_r), rtol=RTOL, atol=ATOL)
    assert ws.item() == float(ws_r) == 7.0
    assert aux.item() == 0.0
    assert set(grads) == set(g_r)
    for k, g in grads.items():
        want = np.asarray(g_r[k])
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)   # HWIO -> OIHW
        np.testing.assert_allclose(g.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} grad {k}")


@pytest.mark.parametrize("name", ["mnist-cnn", "resnet"])
def test_forward_and_accuracy_match_reference(name):
    """Logits through the forward, and the accuracy metric, on a batch of
    64 with the reference's parameters."""
    ref = ref_paper_workloads()[name]
    ours = paper_workloads()[name]
    params = jax.tree_util.tree_map(np.asarray,
                                    ref.init(jax.random.PRNGKey(9)))
    batch = jax.tree_util.tree_map(np.asarray,
                                   ref.make_batch(jax.random.PRNGKey(2), 64))
    acc_r = float(ref.metric_fn(params, batch))
    acc = ours.metric_fn(paper_params_from_jax(name, params, device="cpu"),
                         _to_torch(batch)).item()
    assert acc == acc_r


def test_stride2_same_padding_is_asymmetric():
    """XLA's "SAME" at stride 2 pads 0 above/left and 1 below/right on a
    16x16 input; ``_conv`` matches it, PyTorch's symmetric ``padding=1``
    gives the right shape and the wrong values."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)     # NHWC
    w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)       # HWIO
    want = np.asarray(jax.lax.conv_general_dilated(
        x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    got = simple._conv(xt, wt, 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    symmetric = F.conv2d(xt, wt, stride=2, padding=1).permute(0, 2, 3, 1)
    assert symmetric.shape == want.shape
    assert not np.allclose(symmetric.numpy(), want, rtol=RTOL, atol=ATOL)
    assert simple._same_pads(16, 3, 2) == (0, 1)
    assert simple._same_pads(16, 3, 1) == (1, 1)


@pytest.mark.parametrize("name", NAMES)
def test_batches_match_reference_shapes_and_statistics(name):
    """The port's numpy stream has the reference's shapes and dtypes (int
    labels widened to int64 for ``gather``), draws labels over every class
    and, for linreg, fits its planted truth to the noise level."""
    ref = ref_paper_workloads()[name].make_batch(jax.random.PRNGKey(0), 512)
    ours = paper_workloads()[name].make_batch(np.random.default_rng(0), 512)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].shape == ref[k].shape
        assert ours[k].dtype == (np.int64 if k == "y" and name != "linreg"
                                 else np.float32)
    if name == "linreg":
        w, b = simple.linreg_true_params(simple.LinRegConfig())
        resid = ours["y"] - ours["x"] @ w - b
        assert abs(resid.std() - 0.05) < 0.01
    else:
        assert set(np.unique(ours["y"])) == set(range(10))


def test_paper_params_from_jax_rejects_unknown_workload():
    with pytest.raises(ValueError, match="unknown paper workload"):
        paper_params_from_jax("mlp", {}, device="cpu")
