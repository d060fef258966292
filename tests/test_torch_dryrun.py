"""The port's dry run (``launch/dryrun.py``): fake process groups of 8 and
256 ranks, DTensors of fake tensors, one traced step program each.

The dry runs go in one fresh interpreter (``SCRIPT``), which makes and
destroys every group; this process makes none.  The reference's own dry run
cannot be the oracle here (its sharded programs fail on the installed
jax), so the records are held against exact counts from the partition
rules, against the same programs traced on one fake rank (the FLOPs of all
devices together), and the roofline reads them.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.shapes import get_shape
from repro_torch.launch import dryrun, roofline
from repro_torch.models import reduced

HERE = os.path.dirname(__file__)
TIMEOUT = 240

# (arch, shape, mesh, sharding mode, reduced)
CASES = (
    ("gemma-2b", "train_4k", "4x2", "train", True),
    ("deepseek-v2-236b", "decode_32k", "4x2", "decode2d", True),
    ("mamba2-1.3b", "prefill_32k", "4x2", "train", True),
    ("llama3-8b", "decode_32k", "16x16", "decode2d", False),
)
# the most FLOPs the devices of a case may count together, over the same
# program traced on one rank: every matmul and contraction of these
# programs is split over the mesh but for a few DTensor keeps whole on
# 'model' (gemma 1.027 counted); a count of global FLOPs would be the
# devices' number (8, 256) times over
SPLIT_CEILING = 1.05

SCRIPT = r"""
import json, sys
from repro_torch.launch import dryrun
import test_torch_dryrun as T

records, one_rank = [], []
for arch, shape, mesh, mode, small in T.CASES:
    for m, out in ((mesh, records), ("1x1", one_rank)):
        out.append(dryrun.run_one(
            arch, shape, mesh=m, sharding_mode=mode,
            config_overrides=T.overrides(arch) if small else None,
            verbose=False))
records += dryrun.main(["--arch", "whisper-medium", "--shape", "long_500k",
                        "--out", sys.argv[1] + ".cli"])
with open(sys.argv[1], "w") as f:
    json.dump([records, one_rank], f)
"""


def overrides(arch) -> dict:
    """The fields ``reduced`` changes, as ``run_one``'s overrides."""
    full = get_config(arch)
    small = reduced(full)
    return {f.name: getattr(small, f.name)
            for f in dataclasses.fields(full)
            if getattr(small, f.name) != getattr(full, f.name)}


@pytest.fixture(autouse=True)
def no_process_group():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "records.json"
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([os.path.join(HERE, "..", "src"),
                                          HERE])}
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(out)],
                          capture_output=True, text=True, timeout=TIMEOUT,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(str(out) + ".cli") as f:
        cli = json.load(f)
    with open(out) as f:
        recs, one_rank = json.load(f)
    return recs, cli, one_rank


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CASES])
def test_record_has_the_roofline_keys(records, i):
    rec = records[0][i]
    arch, shape, mesh, mode, small = CASES[i]
    assert rec["status"] == "ok", rec.get("traceback")
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["sharding_mode"]) \
        == (arch, shape, mesh, mode)
    assert rec["devices"] == (256 if mesh == "16x16" else 8)
    assert rec["params"] > 0
    # not measured: null, never 0
    assert rec["temp_size_in_bytes"] is None
    assert rec["peak_memory_in_bytes"] is None
    p = rec["probe"]
    assert p["flops_total"] > 0 and p["flops_per_group"] > 0
    assert set(p["collective_bytes"]) == set(p["collective_counts"]) == set(
        ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute"))
    assert p["collective_bytes_total"] == sum(p["collective_bytes"].values())
    if mode == "decode2d":
        # the sharded decode attention: one logits all-reduce a layer
        n = get_config(arch).num_layers if not small else \
            reduced(get_config(arch)).num_layers
        assert p["collective_counts"]["all-reduce"] >= n


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CASES])
def test_devices_together_count_the_one_rank_flops(records, i):
    """Per-device FLOPs x devices against the same program traced on one
    fake rank: at least as many (a count that missed a shard's work would
    be fewer) and at most ``SPLIT_CEILING`` times as many (a count of
    global FLOPs, or an op rerun replicated, would be many times more).
    No op is rerun replicated."""
    rec, one = records[0][i], records[2][i]
    assert one["status"] == "ok" and one["devices"] == 1, one.get("traceback")
    assert rec["probe"]["replicated_ops"] == 0, rec["probe"]["replicated_why"]
    assert one["probe"]["replicated_ops"] == 0
    ratio = rec["probe"]["flops_total"] * rec["devices"] \
        / one["probe"]["flops_total"]
    assert 1 - 1e-9 <= ratio <= SPLIT_CEILING, ratio


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CASES])
def test_argument_bytes_equal_the_rules_count(records, i):
    """The record's argument bytes (DTensor's own local shards) ``==`` the
    count from the partition specs, counted here without a group."""
    arch, shape, mesh, mode, small = CASES[i]
    cfg = dryrun.run_config(arch, get_shape(shape),
                            overrides(arch) if small else None)
    assert records[0][i]["argument_size_in_bytes"] == \
        dryrun.rules_argument_bytes(cfg, get_shape(shape),
                                    dryrun.MeshShape(mesh), True, mode)


def test_roofline_reads_the_records(records):
    """Every record goes through ``analyze`` and ``table``; the useful
    ratio (the full config's analytic FLOPs over the counted ones) is
    meaningful for the full-width record only."""
    for rec, case in zip(records[0], CASES):
        out = roofline.analyze(rec)
        assert out["dominant"] in ("compute", "memory", "collective")
        assert out["hbm_per_dev_bytes"] is None      # temporaries unmeasured
        if not case[4]:
            assert 0 < out["useful_ratio"] < 1
    assert "| llama3-8b | decode_32k |" in roofline.table(records[0])


def test_cli_writes_out_and_skips_unsupported(records):
    recs, cli, _ = records
    assert cli == [recs[-1]]
    assert cli[0]["status"] == "skipped"
    assert "whisper" in cli[0]["reason"]
