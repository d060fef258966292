"""The SSD kernels against their plain versions on the card.

Marked ``cuda``: they skip without a GPU.  This file imports no JAX, so it
also runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssd_cuda.py

Tolerances: forward 1e-4 abs and rel, backward 1e-4 x max|plain| (fp32,
other summation order over at most 128 terms per product).
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import (LAUNCHES, reset_launches, ssd,
                                          ssd_chunked, ssd_intra_chunk,
                                          ssd_intra_chunk_bwd,
                                          ssd_intra_chunk_bwd_plain,
                                          ssd_intra_chunk_plain)

# (b, nc, cl, h, p, n): tests/test_kernels.py::SSD_CASES in chunks, the
# reduced mamba2 (chunk 8), the mamba2-1.3b cell's shapes, and ragged shapes
# whose cl, P and N are no multiples of the mma tiles (P and N no multiples
# of 4 in "odd", so its rows go by 4-byte copies), down to one step
CASES = [(2, 4, 16, 4, 16, 8), (1, 4, 32, 2, 32, 16), (2, 4, 64, 8, 64, 32),
         (1, 2, 64, 64, 64, 128), (2, 4, 8, 16, 16, 16),
         (2, 32, 64, 64, 64, 128), (1, 3, 40, 3, 20, 12),
         (1, 2, 13, 3, 7, 9), (1, 1, 1, 1, 1, 1)]
IDS = ["small", "mid", "wide", "mamba2", "reduced", "cell", "ragged-40",
       "odd", "one-step"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, device, seed=0):
    b, nc, cl, h, p, n = case
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((b, nc, cl, h, p)),
              -np.abs(rng.standard_normal((b, nc, cl, h))) * 0.1,
              rng.standard_normal((b, nc, cl, h, n)),
              rng.standard_normal((b, nc, cl, h, n)))
    return [torch.from_numpy(v.astype(np.float32)).to(device) for v in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cuda_kernels_match_plain_versions(case, cuda_device):
    xs = _inputs(case, cuda_device)
    reset_launches()
    y, s = ssd_intra_chunk(*xs)
    y_p, s_p = ssd_intra_chunk_plain(*xs)
    torch.testing.assert_close(y, y_p, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, s_p, atol=1e-4, rtol=1e-4)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    dy = torch.randn(y.shape, generator=g, device=cuda_device)
    ds = torch.randn(s.shape, generator=g, device=cuda_device)
    got = ssd_intra_chunk_bwd(*xs, dy, ds)
    want = ssd_intra_chunk_bwd_plain(*xs, dy, ds)
    for name, a, b in zip(("dx", "da", "db", "dc"), got, want):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), (name, err)
    assert LAUNCHES == {"ssd_fwd": 1, "ssd_bwd": 1}
    # no atomics: a second launch is bit-equal
    again = ssd_intra_chunk_bwd(*xs, dy, ds)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
def test_cuda_ssd_trains_through_the_kernel_pair(cuda_device):
    """ssd's gradients through the kernels equal the plain scan's."""
    b, nc, cl, h, p, n = CASES[3]
    xs = [t.reshape(b, nc * cl, *t.shape[3:]) for t in
          _inputs(CASES[3], cuda_device, seed=2)]
    grads = {}
    for name, fn in (("kernel", lambda *v: ssd(*v, chunk=cl)),
                     ("plain", lambda *v: ssd_chunked(*v, cl))):
        leaves = [t.clone().requires_grad_() for t in xs]
        y, s = fn(*leaves)
        grads[name] = torch.autograd.grad(y.square().sum() + s.sum(), leaves)
    for a, b_ in zip(grads["kernel"], grads["plain"]):
        assert (a - b_).abs().max() <= 1e-4 * b_.abs().max()


@pytest.mark.cuda
def test_cuda_shape_rule_raises(cuda_device):
    x = torch.zeros(1, 1, 128, 1, 16, device=cuda_device)
    a = torch.zeros(1, 1, 128, 1, device=cuda_device)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        ssd_intra_chunk(x, a, x, x)


# (b, nc, cl, h, g, p, n): B and C per group: the mamba2-1.3b cell as its
# main path runs it (G 1), a ragged shape with 1 < G < H (runs of heads
# shorter than ssd_fwd's), and G == H at the cell's head geometry
GROUPED = [(2, 32, 64, 64, 1, 64, 128), (1, 3, 40, 6, 2, 20, 12),
           (1, 2, 64, 64, 64, 64, 128)]
GROUP_IDS = ["cell-g1", "ragged-g2", "g-eq-h"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GROUPED, ids=GROUP_IDS)
def test_cuda_grouped_kernels_match_plain_versions(case, cuda_device):
    b, nc, cl, h, grp, p, n = case
    rng = np.random.default_rng(3)
    arrays = (rng.standard_normal((b, nc, cl, h, p)),
              -np.abs(rng.standard_normal((b, nc, cl, h))) * 0.1,
              rng.standard_normal((b, nc, cl, grp, n)),
              rng.standard_normal((b, nc, cl, grp, n)))
    xs = [torch.from_numpy(v.astype(np.float32)).to(cuda_device)
          for v in arrays]
    reset_launches()
    y, s = ssd_intra_chunk(*xs)
    y2, s2 = ssd_intra_chunk(*xs)
    y_p, s_p = ssd_intra_chunk_plain(*xs)
    torch.testing.assert_close(y, y_p, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, s_p, atol=1e-4, rtol=1e-4)
    # no atomics: a second launch is bit-equal
    assert torch.equal(y, y2) and torch.equal(s, s2)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    dy = torch.randn(y.shape, generator=g, device=cuda_device)
    ds = torch.randn(s.shape, generator=g, device=cuda_device)
    got = ssd_intra_chunk_bwd(*xs, dy, ds)
    again = ssd_intra_chunk_bwd(*xs, dy, ds)
    want = ssd_intra_chunk_bwd_plain(*xs, dy, ds)
    for name, a, b_ in zip(("dx", "da", "db", "dc"), got, want):
        assert a.shape == b_.shape, name
        err = (a - b_).abs().max().item()
        assert err <= 1e-4 * b_.abs().max().item(), (name, err)
    assert all(torch.equal(a, b_) for a, b_ in zip(again, got))
    # the launch alone writes dB and dC per head; the wrapper sums each group's
    per_head = K.ssd_bwd_per_head(*xs, dy, ds)
    for a, b_ in zip(per_head[2:], got[2:]):
        assert a.shape == (b, nc, cl, h, n)
        assert torch.equal(a.reshape(b, nc, cl, grp, h // grp, n).sum(4), b_)
    assert LAUNCHES == {"ssd_fwd": 2, "ssd_bwd": 3}
