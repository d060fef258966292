"""The port stands alone: no module of ``src/repro_torch/`` (nor
``chip_smoke.py``) imports jax or the reference package, and its entry points
refuse to fall back to the CPU silently."""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
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
                 "serve/colocate.py", "train/colocate.py",
                 "models/encdec.py", "configs/shapes.py",
                 "configs/deepseek_v2_236b.py", "configs/whisper_medium.py",
                 "configs/phi_3_vision_4_2b.py", "configs/grok_1_314b.py",
                 "compat.py", "launch/dryrun.py", "launch/mesh.py",
                 "launch/sharding.py", "models/shard_hooks.py",
                 "models/sharded_attn.py"):
        assert must in names


def test_every_reference_module_has_a_counterpart():
    """A diff of the two packages' module lists is empty."""
    ref = ROOT / "src" / "repro"
    port = ROOT / "src" / "repro_torch"
    missing = sorted(p.relative_to(ref).as_posix() for p in ref.rglob("*.py")
                     if not (port / p.relative_to(ref)).exists())
    assert missing == []


def test_importing_the_port_makes_no_process_group():
    """Every module of the port imports in a fresh interpreter without
    starting a process group (meshes and groups are made by functions)."""
    import subprocess
    import sys

    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(
            ROOT / "src" / "repro_torch").with_suffix("").parts)
        for p in PORT_FILES[:-1])
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            "import torch.distributed as dist\n"
            "for m in sys.argv[1:]:\n"
            "    importlib.import_module(m)\n"
            "    assert not dist.is_initialized(), m\n"
            "print('ok', len(sys.argv) - 1)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, *mods], capture_output=True, text=True,
        timeout=120, env={"PYTHONPATH": str(ROOT / "src"),
                          "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["ok", str(len(mods))]


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
    """What slice 5b ported runs: ``MeshBackend`` over a list of two
    devices builds two one-device slices.  Remat, which the launch slice
    ported, runs for every architecture with the loss ``==`` the run
    without it.  Every architecture's config loads, and the SSD
    and RG-LRU decode branches (slice 6) run: one token through each cache
    gives finite outputs and caches of the cache's shapes."""
    from repro_torch.api import (ClusterSpec, Experiment, MeshBackend,
                                 TrainConfig, paper_workload)
    from repro_torch.configs import ARCHITECTURES, get_config
    from repro_torch.models import (encdec_loss, init_caches, init_lm,
                                    init_model, lm_loss, recurrent_block,
                                    reduced, ssd_block)
    from repro_torch.models.layers import sub
    from repro_torch.optim import sgd

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
    families = set()
    for arch in ARCHITECTURES:
        full = get_config(arch)
        assert full.name == arch
        families.add(full.family)
        small = reduced(full)
        params = init_model(torch.Generator().manual_seed(0), small)
        assert params
        tokens = torch.arange(16).reshape(2, 8) % small.vocab_size
        losses = []
        for c in (small, small.with_(remat=True)):
            leaves = {k: v.detach().requires_grad_()
                      for k, v in params.items()}
            if c.family == "encdec":
                ls = encdec_loss(leaves, c, torch.ones(
                    2, c.encoder_seq, c.d_model), tokens, tokens,
                    torch.ones(2))[0]
            else:
                ls = lm_loss(leaves, c, tokens, tokens, torch.ones(2))[0]
            ls.backward()
            losses.append(ls.item())
        assert losses[0] == losses[1]
    assert families == {"dense", "moe", "ssm", "hybrid", "encdec", "vlm"}
    trainer = Experiment(
        workload=paper_workload("linreg"),
        cluster=ClusterSpec.homogeneous(
            20, 2, backend=MeshBackend(device=["cpu", "cpu"])),
        optimizer=sgd(0.05),
        config=TrainConfig(b0=8, microbatch=4, batching="uniform")).build()
    assert trainer.concurrent
    assert trainer.slice_plan.slices == ((0, 1), (1, 1))
    assert [list(rec.rows) for rec in trainer._exec] == [[0], [1]]
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
