"""The port stands alone: no module of ``src/repro_torch/`` (nor
``chip_smoke.py``) imports jax or the reference package, and its entry points
refuse to fall back to the CPU silently."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


EMULATOR_FILES = sorted((ROOT / "tools" / "cuda_emu").glob("*.py"))


@pytest.mark.parametrize("path", EMULATOR_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_cuda_emulator_imports_neither_jax_nor_reference(path):
    """The CPU rehearsal of the kernels (tools/cuda_emu) loads the port's
    modules only: ``repro_torch`` is allowed, ``repro`` and jax are not."""
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES[:-1]}
    for must in ("kernels/flash_attention/kernel.py", "train/loop.py",
                 "api/backend.py", "models/convert.py",
                 "kernels/ssd_scan/kernel.py", "kernels/ssd_scan/ops.py",
                 "kernels/ssd_scan/ref.py", "models/ssm.py",
                 "configs/mamba2_1_3b.py", "kernels/rglru_scan/kernel.py",
                 "kernels/rglru_scan/ops.py", "kernels/rglru_scan/ref.py",
                 "models/recurrent.py", "configs/recurrentgemma_9b.py",
                 "core/control/global_batch/gns.py",
                 "core/control/global_batch/policy.py", "het/traces.py",
                 "het/spot.py", "het/chaos.py", "core/placement.py",
                 "train/mesh.py", "serve/__init__.py", "serve/engine.py",
                 "serve/scheduler.py", "serve/slots.py", "serve/traffic.py",
                 "serve/colocate.py", "train/colocate.py"):
        assert must in names


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-GPU refusal does not "
                    "apply")


def _lm_parts(device):
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.models import reduced

    cfg = reduced(get_config("gemma-2b"))
    return cfg, DataPipeline(cfg, seq_len=8, num_workers=2, device=device)


def _experiment(backend):
    from repro_torch.api import (ClusterSpec, Experiment, TrainConfig,
                                 lm_workload)
    from repro_torch.optim import adam

    cfg, pipe = _lm_parts("cpu")
    return Experiment(
        workload=lm_workload(cfg, pipe),
        cluster=ClusterSpec.hlevel(39, 2.0, 2, workload="transformer",
                                   backend=backend),
        optimizer=adam(1e-3),
        config=TrainConfig(b0=2, microbatch=2, max_steps=1))


def test_entry_points_raise_without_gpu(no_gpu):
    from repro_torch.api import SimBackend
    from repro_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _lm_parts(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _experiment(None).session()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _experiment(SimBackend()).session()


def test_params_from_jax_follows_the_device_rule(no_gpu):
    from repro_torch.models import init_lm, params_from_jax, params_to_jax

    cfg, _ = _lm_parts("cpu")
    tree = params_to_jax(init_lm(torch.Generator().manual_seed(0), cfg), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(tree, cfg)
    params = params_from_jax(tree, cfg, device="cpu")
    assert all(p.device.type == "cpu" for p in params.values())


def test_entry_points_run_on_cpu_when_asked(no_gpu):
    from repro_torch.api import SimBackend

    session = _experiment(SimBackend(device="cpu")).session()
    assert all(p.device.type == "cpu" for p in session.params.values())
    rec = session.step()
    assert torch.isfinite(torch.tensor(rec.loss))


def test_kernel_wrappers_take_plain_version_only_for_cpu_tensors():
    from repro_torch.kernels.flash_attention import LAUNCHES, flash_fwd

    before = dict(LAUNCHES)
    q = torch.zeros(1, 128, 2, 32)
    k = torch.zeros(1, 128, 1, 32)
    out, lse = flash_fwd(q, k, k)
    assert out.shape == q.shape and lse.shape == (1, 2, 128)
    assert LAUNCHES == before    # the plain version is not a launch
    with pytest.raises(ValueError, match="CUDA"):
        from repro_torch.kernels.flash_attention.kernel import _check

        _check("flash_fwd", q, k, k)


def test_unported_paths_of_the_ssm_slice_raise():
    """What stays unported after the serving slice raises, naming its
    slice: the unported configs and the MoE family (slice 7).  The SSD and
    RG-LRU decode branches (slice 6) now run: one token through each cache
    gives finite outputs and caches of the cache's shapes."""
    from repro_torch.configs import get_config
    from repro_torch.models import (init_caches, init_lm, recurrent_block,
                                    reduced, ssd_block)
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.layers import sub

    cfg = reduced(get_config("mamba2-1.3b"))
    params = sub(init_lm(torch.Generator().manual_seed(0), cfg),
                 "layers.0.ssd")
    cache = sub(init_caches(cfg, 1, 8, device="cpu"), "layers.0")
    out, new = ssd_block(params, torch.ones(1, 1, cfg.d_model), cfg,
                         cache=cache)
    assert out.shape == (1, 1, cfg.d_model) and torch.isfinite(out).all()
    assert new.keys() == cache.keys()
    assert all(new[k].shape == cache[k].shape and torch.isfinite(new[k]).all()
               for k in new)
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("llama3-8b")
    moe = ModelConfig(name="moe", family="moe", num_layers=2, d_model=64,
                      vocab_size=32, num_heads=2, num_kv_heads=1,
                      head_dim=32, mlp="moe", num_experts=4, moe_top_k=2,
                      moe_d_ff=32)
    with pytest.raises(NotImplementedError, match="slice 7"):
        init_lm(torch.Generator().manual_seed(0), moe)
    hybrid = reduced(get_config("recurrentgemma-9b"))
    rec = sub(init_lm(torch.Generator().manual_seed(0), hybrid),
              "layers.0.rec")
    cache = sub(init_caches(hybrid, 1, 8, device="cpu"), "layers.0")
    out, new = recurrent_block(rec, torch.ones(1, 1, hybrid.d_model), hybrid,
                               cache=cache)
    assert out.shape == (1, 1, hybrid.d_model) and torch.isfinite(out).all()
    assert new.keys() == cache.keys() == {"conv", "h"}
    assert all(new[k].shape == cache[k].shape and torch.isfinite(new[k]).all()
               for k in new)
