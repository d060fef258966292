"""The port's sharded programs over four gloo CPU processes (a 2 x 2
``("data", "model")`` mesh), in fresh interpreters.

    PYTHONPATH=src python tests/torch_spmd_runner.py WORKDIR [INPUTS.npz]

The parent starts four rank processes of this script, which share one
``FileStore`` under WORKDIR (no TCP), waits for them with a time limit
and prints one JSON line a scenario.  Each rank makes its group through
``repro_torch.compat.init_group`` and destroys it in a ``finally``.  Rank 0
writes the arrays to WORKDIR/out.npz.

Scenarios:

  * ``decode/{arch}``: llama3-8b, gemma-2b and deepseek-v2-236b reduced
    (deepseek with ``kv_lora_rank=16, qk_rope_dim=8``, MoE capacity 8.0),
    the parameters given in INPUTS.npz (the reference's, flattened; the
    port takes them through ``params_from_jax``), replicated; the caches
    DTensors placed by ``cache_shardings``, the ``decode_attn`` rule set: 8
    tokens for a batch of 4, one step at a time.  Writes the logits and
    each rank's collective counts.
  * ``train/{name}``: llama3-8b, grok-1-314b, mamba2-1.3b,
    recurrentgemma-9b and deepseek-v2-236b reduced with the reference
    runner's width overrides, and grok-1 with 2 experts on a (1, 4) mesh
    (``TRAIN_CASES``); parameters from ``init_model`` (seed 0) as
    DTensors placed by ``params_shardings``; the paper's momentum SGD (its
    state placed as the parameters; Adam's first step, g / (|g| + eps),
    would turn summation-order noise in near-zero gradients into
    lr-sized differences); the batch placed by ``batch_shardings`` (6 of 8
    rows weighted); the 'logits', 'activations' and 'attention' rules set,
    and 'experts' for the MoE archs; 3 steps of ``make_train_step``.
    Writes the losses and the parameters after step 0.

Every scenario runs under a strict ``DeviceCounter``: an op that DTensor
cannot run on its placements raises.

``tests/test_torch_spmd.py`` holds them against the reference's plain
decode and the port's plain decode and unsharded step.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

WORLD = 4
RANK_TIMEOUT = 180
DECODE_ARCHS = ("llama3-8b", "gemma-2b", "deepseek-v2-236b")
# ordered so that each reuses the most of DTensor's sharding-propagation
# cache left by the ones before (MoE after MoE)
TRAIN_ARCHS = ("llama3-8b", "grok-1-314b", "deepseek-v2-236b",
               "mamba2-1.3b", "recurrentgemma-9b")
# name -> (arch, config overrides, mesh): the five archs on the 2 x 2 mesh,
# and grok-1 with 2 experts on a (1, 4) mesh, where two ranks share each
# expert (grok-1's 8 experts on a 16-way 'model' axis)
TRAIN_CASES = {**{arch: (arch, {}, (2, 2)) for arch in TRAIN_ARCHS},
               "grok-1-314b/2-experts-1x4": ("grok-1-314b",
                                             {"num_experts": 2}, (1, 4))}
DECODE_B, DECODE_S = 4, 8
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 16, 3


def decode_config(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import reduced

    cfg = reduced(get_config(arch))
    if cfg.attention == "mla":
        # ranks divisible by the 2-way model axis, rope pairs intact
        cfg = cfg.with_(kv_lora_rank=16, qk_rope_dim=8)
    if cfg.num_experts:
        cfg = cfg.with_(moe_capacity_factor=8.0)
    return cfg


def train_config(name):
    from repro_torch.configs import get_config
    from repro_torch.models import reduced

    arch, overrides, _ = TRAIN_CASES[name]
    cfg = reduced(get_config(arch)).with_(**overrides).with_(
        d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        vocab_size=512)
    if cfg.family == "hybrid":
        cfg = cfg.with_(num_heads=2, num_kv_heads=1, head_dim=64,
                        lru_width=128)
    if cfg.attention == "mla":
        cfg = cfg.with_(num_heads=4, head_dim=0)
    return cfg


def train_optimizer():
    from repro_torch.optim import momentum

    return momentum(0.1)


def train_batch(cfg):
    import torch

    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int64)),
            "targets": torch.from_numpy(toks[:, 1:].astype(np.int64)),
            "weights": torch.tensor([1, 1, 1, 1, 1, 1, 0, 0],
                                    dtype=torch.float32)}


def unflatten(flat: dict, prefix: str) -> dict:
    """``{prefix}/a/b`` arrays -> a nested dict."""
    tree: dict = {}
    for key, x in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = x
    return tree


def placed(tensors: dict, specs: dict, mesh) -> dict:
    """Whole tensors held by every rank -> DTensors placed by ``specs``
    (each rank keeps its slice; no collective)."""
    from repro_torch import compat

    return {k: compat.place(v, mesh, compat.to_placements(specs[k], mesh))
            for k, v in tensors.items()}


def run_decode(arch, inputs, mesh, out):
    import torch

    from repro_torch.launch import sharding as SH
    from repro_torch.launch.dryrun import sharded_program
    from repro_torch.models import apply_lm, init_caches, params_from_jax
    from repro_torch.models import shard_hooks

    cfg = decode_config(arch)
    params = params_from_jax(unflatten(inputs, f"decode/{arch}"), cfg,
                             device="cpu")
    toks = torch.from_numpy(inputs[f"decode/{arch}/tokens"].astype(np.int64))
    caches = init_caches(cfg, DECODE_B, DECODE_S, device="cpu")
    caches = placed(caches, SH.cache_shardings(caches, mesh), mesh)
    shard_hooks.set_rules({"decode_attn": (mesh, ("data",), "model")})
    try:
        logits = []
        with sharded_program() as counter, torch.no_grad():
            for i in range(DECODE_S):
                lg, caches, _ = apply_lm(
                    params, cfg, toks[:, i:i + 1], caches=caches,
                    positions=torch.full((DECODE_B, 1), i))
                logits.append(lg)
    finally:
        shard_hooks.set_rules(None)
    out[f"decode/{arch}/logits"] = torch.cat(logits, 1).numpy()
    placements = sorted({str(tuple(v.placements)) for k, v in caches.items()
                         if k.endswith((".k", ".v", ".c_kv", ".k_rope"))})
    return {"collectives": counter.collectives,
            "replicated_ops": counter.replicated_ops,
            "cache_placements": placements, "layers": cfg.num_layers,
            "steps": DECODE_S}


def run_train(name, mesh, out):
    import torch

    from repro_torch import compat
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.dryrun import sharded_program
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_model, shard_hooks
    cfg = train_config(name)
    full = init_model(torch.Generator().manual_seed(0), cfg)
    params = placed(full, SH.params_shardings(full, mesh, cfg=cfg), mesh)
    batch = train_batch(cfg)
    batch = placed(batch, SH.batch_shardings(batch, mesh), mesh)
    opt = train_optimizer()
    state = opt.init(params)
    rules = {
        "logits": (mesh, compat.to_placements(("data", None, "model"),
                                              mesh)),
        "activations": (mesh, compat.to_placements(("data", None, None),
                                                   mesh)),
        "attention": (mesh, ("data",), "model")}
    if cfg.num_experts:
        rules["experts"] = (mesh, ("data",), "model")
    shard_hooks.set_rules(rules)
    step = make_train_step(cfg, opt)
    losses = []
    try:
        with sharded_program() as counter:
            for i in range(TRAIN_STEPS):
                new_p, state, metrics = step(params, state, i, batch)
                params = {k: v.redistribute(mesh, params[k].placements)
                          for k, v in new_p.items()}
                losses.append(metrics["loss"].full_tensor().item())
                if i == 0:
                    after0 = {k: v.full_tensor() for k, v in params.items()}
                    ws = metrics["weight_sum"].full_tensor().item()
    finally:
        shard_hooks.set_rules(None)
    out[f"train/{name}/loss"] = np.asarray(losses)
    for k, v in after0.items():
        out[f"train/{name}/params0/{k}"] = v.float().numpy()
    return {"losses": losses, "weight_sum": ws,
            "replicated_ops": counter.replicated_ops,
            "collectives": counter.collectives}


def rank_main(rank: int, workdir: str, inputs_path: str) -> None:
    import torch

    from repro_torch import compat
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh

    torch.set_num_threads(1)
    inputs = dict(np.load(inputs_path)) if inputs_path else {}
    compat.init_group("gloo", WORLD, rank,
                      store=os.path.join(workdir, "store"))
    out: dict = {}
    lines = []
    try:
        mesh = make_debug_mesh(WORLD)
        for arch in DECODE_ARCHS if inputs else ():
            t0 = time.time()
            res = run_decode(arch, inputs, mesh, out)
            lines.append({"name": f"decode/{arch}", "rank": rank,
                          "seconds": time.time() - t0, "result": res})
        meshes = {(2, 2): mesh, (1, 4): make_mesh((1, 4), ("data", "model"))}
        for name, (_, _, dims) in TRAIN_CASES.items():
            t0 = time.time()
            res = run_train(name, meshes[dims], out)
            lines.append({"name": f"train/{name}", "rank": rank,
                          "seconds": time.time() - t0, "result": res})
    finally:
        compat.destroy_group()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(lines, f)
    if rank == 0:
        np.savez(os.path.join(workdir, "out.npz"), **out)


def main(workdir: str, inputs_path: str = "") -> int:
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), workdir, inputs_path],
        env=env) for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        print(json.dumps({"name": "ranks", "codes": codes}))
        return 1
    for r in range(WORLD):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            for line in json.load(f):
                print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    if sys.argv[1] == "--rank":
        rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        sys.exit(main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else ""))
