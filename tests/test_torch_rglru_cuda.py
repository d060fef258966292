"""The RG-LRU kernels against their plain versions on the card.

Marked ``cuda``: they skip without a GPU.  This file imports no JAX, so it
also runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_rglru_cuda.py

Kernel and plain version round every product and sum on its own in the same
order, so they must agree to the bit; the scan through the kernel pair is
held to the doubling scan (autograd) at 1e-5 x max|plain| (fp32, another
summation order over up to 2048 steps).
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import pytest
import torch

from repro_torch.kernels.rglru_scan import (LAUNCHES, reset_launches, rglru,
                                            rglru_linear_scan,
                                            rglru_linear_scan_bwd,
                                            rglru_linear_scan_bwd_plain,
                                            rglru_linear_scan_plain,
                                            rglru_scan)

# (b, l, w): tests/test_kernels.py::RGLRU_CASES, the recurrentgemma-9b
# cell's shapes (B 1-2, L 2048, W 4096), a W that is no multiple of 128, an
# L that is no multiple of the kernels' unroll, and a long L that is no
# multiple of rglru_bwd's ring stage (16 steps) with a W that is no
# multiple of 32
CASES = [(2, 32, 128), (1, 64, 256), (3, 16, 128), (1, 128, 512),
         (1, 2048, 4096), (2, 2048, 4096), (2, 100, 200), (3, 37, 33),
         (2, 2045, 4100)]
IDS = ["b2-l32", "b1-l64", "b3-l16", "b1-l128", "cell-b1", "cell-b2",
       "w200", "odd", "l-ragged"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(case, device, seed=0):
    b, l, w = case
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.sigmoid(torch.randn((b, l, w), generator=g, device=device))
    rest = [torch.randn(shape, generator=g, device=device)
            for shape in ((b, l, w), (b, w), (b, l, w), (b, w))]
    return [a, *rest]


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cuda_kernels_equal_plain_versions(case, with_h0, cuda_device):
    a, bx, h0, dh, dh_t = _inputs(case, cuda_device)
    h0 = h0 if with_h0 else None
    reset_launches()
    h, h_t = rglru_linear_scan(a, bx, h0)
    h_p, h_t_p = rglru_linear_scan_plain(a, bx, h0)
    got = rglru_linear_scan_bwd(a, h, h0, dh, dh_t)
    want = rglru_linear_scan_bwd_plain(a, h_p, h0, dh, dh_t)
    torch.cuda.synchronize()
    assert torch.equal(h, h_p) and torch.equal(h_t, h_t_p)
    for name, x, y in zip(("da", "dbx", "dh0"), got, want):
        assert (x is None) == (y is None) == (name == "dh0" and not with_h0)
        assert x is None or torch.equal(x, y), (name, (x - y).abs().max())
    assert LAUNCHES == {"rglru_fwd": 1, "rglru_bwd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CASES[3], CASES[5]], ids=["b1-l128", "cell"])
def test_cuda_rglru_trains_through_the_kernel_pair(case, cuda_device):
    """rglru's gradients through the kernels equal the doubling scan's."""
    a, bx, h0, dh, dh_t = _inputs(case, cuda_device, seed=2)
    grads = {}
    for name in ("kernel", "scan"):
        leaves = [t.clone().requires_grad_() for t in (a, bx, h0)]
        if name == "kernel":
            h, h_t = rglru(*leaves)
        else:
            h = rglru_scan(*leaves[:2], initial=leaves[2])
            h_t = h[:, -1]
        grads[name] = torch.autograd.grad(
            (h * dh).sum() + (h_t * dh_t).sum(), leaves)
    for x, y in zip(grads["kernel"], grads["scan"]):
        assert (x - y).abs().max() <= 1e-5 * y.abs().max()


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    a = torch.zeros(1, 8, 16, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        rglru_linear_scan(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_linear_scan(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_linear_scan(a, a.cpu())


# (b, l, w) at the forward ring's edges: one step, one step past a stage,
# an L that ends inside a stage after wrapping the ring, a W that is no
# multiple of 32, and one that is no multiple of 4 (4-byte copies)
RING_EDGES = [(2, 1, 64), (2, 17, 64), (2, 100, 128), (2, 100, 200),
              (1, 300, 4097)]
RING_IDS = ["l1", "l17", "l100", "w200", "w4097"]


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [True, False], ids=["h0", "no-h0"])
@pytest.mark.parametrize("case", RING_EDGES, ids=RING_IDS)
def test_cuda_rglru_fwd_ring_edges_repeat_and_equal_plain(case, with_h0,
                                                          cuda_device):
    a, bx, h0 = _inputs(case, cuda_device, seed=3)[:3]
    h0 = h0 if with_h0 else None
    reset_launches()
    first = rglru_linear_scan(a, bx, h0)
    again = rglru_linear_scan(a, bx, h0)
    want = rglru_linear_scan_plain(a, bx, h0)
    torch.cuda.synchronize()
    for x, y, z in zip(first, again, want):
        assert torch.equal(x, y), (x - y).abs().max()
        assert torch.equal(x, z), (x - z).abs().max()
    assert LAUNCHES == {"rglru_fwd": 2, "rglru_bwd": 0}
