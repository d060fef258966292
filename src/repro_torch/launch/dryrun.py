"""Dry run of the sharded step programs on the production meshes, without
devices (the reference's ``launch/dryrun.py``).

A ``fake`` process group of 256 or 512 ranks (``compat.init_group``) holds
the production ``DeviceMesh``; parameters, optimizer state and batch are
DTensors of fake tensors (shapes, no storage) placed by
``launch/sharding.py``; the hooks' rules are set as the reference sets
them (and the port's own, ``_rules``); and the step program of
``launch/steps.py`` at 1 and 2 block groups runs under
``FakeTensorMode``.  What one device would run is counted on the way
(``DeviceCounter``): the FLOPs of its local ops, the bytes they touch, and
the bytes and counts of its collectives, by the reference's opcodes.

The record has the keys the port's roofline reads
(``python -m repro_torch.launch.roofline <out>``):

  * ``argument_size_in_bytes``: exact, the local shards of every input of
    the full-depth program;
  * ``probe``: per-device totals extrapolated from 1- and 2-group programs
    as the reference's ``cost_probe`` does: FLOPs, bytes touched, and the
    bytes (each collective's result buffer, as the reference reads them
    from HLO) and counts of the collectives by opcode;
  * ``temp_size_in_bytes`` / ``peak_memory_in_bytes``: null, not measured
    (nothing here traces the allocator under fake tensors).

An op that DTensor cannot run on its placements is rerun on replicated
inputs and counted in ``replicated_ops`` (``DeviceCounter``'s
``replicate_failed``, an option of the dry run only): the record then
counts more than a partitioner would run, and says so.

Redistributions are planned greedily where that is sound
(``compat.sharded_run``), so the collectives counted are that plan's.

The sharded programs run the plain paths (``use_pallas`` is off, as in
the reference's dry run): the hand-written kernels refuse DTensors.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \
        --shape train_4k --mesh pod [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from typing import NamedTuple, Optional

import torch
from torch._subclasses.fake_tensor import (FakeTensorMode,
                                           unset_fake_temporarily)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only
from torch.utils.flop_counter import flop_registry

from repro_torch import compat
from repro_torch.configs import get_config, list_architectures
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import data_axes, make_mesh
from repro_torch.models import shard_hooks
from repro_torch.models.transformer import block_pattern

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collectives (torch.ops._c10d_functional) -> reference opcode
_OPCODES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class DeviceCounter(TorchDispatchMode):
    """Runs a DTensor program and counts what one device runs: FLOPs
    (``torch.utils.flop_counter``'s formulas) and bytes touched by its
    local ops, and the result bytes and count of each collective.

    A DTensor op is run by DTensor with this mode pushed again, so that
    its local ops, collectives included, come back here with the local
    shapes (a FlopCounterMode around DTensor ops counts global FLOPs).
    DTensor's sharding propagation runs with the fake mode unset: it
    computes shard offsets from real index tensors.  Its shape inference
    runs ops on fake tensors of its own mode, which are not counted
    (``fake_mode``: the mode of the program's fake tensors, None for real
    tensors).  Views move no bytes.

    An op that DTensor cannot run on its placements raises, unless
    ``replicate_failed`` (the dry run's option): then it runs again on
    inputs redistributed to replicated, as a partitioner would gather
    them; the failed attempt counts nothing and ``replicated_ops`` counts
    the retries.  An op that writes an input is never redone: it raises."""

    def __init__(self, fake_mode=None, replicate_failed: bool = False):
        super().__init__()
        self.fake_mode = fake_mode
        self.replicate_failed = replicate_failed
        self.flops = 0
        self.bytes = 0
        self.replicated_ops = 0
        self.replicated: dict[str, int] = {}     # op name -> retries
        self.replicated_why: dict[str, str] = {}  # op name -> first error
        self.collectives = {op: 0 for op in COLLECTIVES}
        self.collectives.update({f"{op}_count": 0 for op in COLLECTIVES})
        self._in_dtensor = False

    def _counts(self):
        return self.flops, self.bytes, dict(self.collectives)

    def _restore(self, counts) -> None:
        self.flops, self.bytes, self.collectives = counts

    def _ours(self, tensors) -> bool:
        return all(getattr(t, "fake_mode", None) is self.fake_mode
                   for t in tensors)

    def _run_dtensor(self, func, args, kwargs, replicate: bool = False):
        self._in_dtensor = True
        try:
            with unset_fake_temporarily(), self:
                if replicate:
                    args, kwargs = tree_map_only(compat.DTensor, _replicated,
                                                 (args, kwargs))
                return func(*args, **kwargs)
        finally:
            self._in_dtensor = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = _tensors(args, kwargs.values())
        if any(isinstance(a, compat.DTensor) for a in flat):
            if self._in_dtensor:
                return NotImplemented
            writes = any(a.alias_info is not None and a.alias_info.is_write
                         for a in func._schema.arguments)
            counts = self._counts()
            if not self.replicate_failed:
                return self._run_dtensor(func, args, kwargs)
            try:
                return self._run_dtensor(func, args, kwargs)
            except (RuntimeError, ValueError) as exc:
                if writes or isinstance(exc, torch.OutOfMemoryError):
                    raise
                why = f"{type(exc).__name__}: {str(exc)[-300:]}"
            self._restore(counts)     # the failed attempt counts nothing
            self.replicated_ops += 1
            name = str(func.overloadpacket)
            self.replicated[name] = self.replicated.get(name, 0) + 1
            self.replicated_why.setdefault(name, why)
            return self._run_dtensor(func, args, kwargs, replicate=True)
        if self.fake_mode is not None and not any(
                getattr(t, "fake_mode", None) is not None for t in flat):
            # real tensors in a fake run: DTensor's own index arithmetic
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if not self._ours(flat):
            return out
        outs = _tensors(out if isinstance(out, (tuple, list)) else (out,))
        if func.namespace == "_c10d_functional":
            op = _OPCODES.get(func._overloadpacket.__name__)
            if op is not None:
                self.collectives[op] += sum(o.numel() * o.element_size()
                                            for o in outs)
                self.collectives[f"{op}_count"] += 1
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in flat + outs)
        return out


@contextlib.contextmanager
def sharded_program(fake_mode=None, replicate_failed: bool = False):
    """Run a DTensor program (``compat.sharded_run``) under a
    ``DeviceCounter``, which counts one device's work.  Yields the
    counter."""
    counter = DeviceCounter(fake_mode, replicate_failed)
    with compat.sharded_run(), counter:
        yield counter


def _tensors(*groups) -> list:
    """The tensors among an op's arguments (aten ops nest one list deep)."""
    out = []
    for group in groups:
        for a in group:
            if isinstance(a, torch.Tensor):
                out.append(a)
            elif isinstance(a, (list, tuple)):
                out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _replicated(t):
    mesh = t.device_mesh
    return t.redistribute(mesh, [compat.Replicate()] * mesh.ndim)


def _rules(cfg, mesh, shape, sharding_mode: str) -> dict:
    """The hooks' rules of the reference's ``_lower_and_compile``, and the
    port's own: 'attention' (full-sequence attention, SSD scan and
    embedding on each rank's block) and 'experts' (the MoE experts on each
    rank's block, where the experts and 'model' divide one another; left
    to DTensor, the dispatch and combine contractions run whole on every
    rank of 'model')."""
    dp = data_axes(mesh)
    ndp = math.prod(compat.axis_size(mesh, a) for a in dp)
    bdim = dp if shape.global_batch % ndp == 0 else None
    if sharding_mode == "decode2d":
        # activations replicated over 'data' (it carries weight shards);
        # cached attention runs through models/sharded_attn.py
        return {"logits": (mesh, compat.to_placements(
                    (None, None, ("model", "data")), mesh)),
                "decode_attn": (mesh, dp, "model")}
    rules = {"logits": (mesh, compat.to_placements((bdim, None, "model"),
                                                   mesh)),
             "activations": (mesh, compat.to_placements((bdim, None, None),
                                                        mesh)),
             "attention": (mesh, dp, "model")}
    tp = compat.axis_size(mesh, "model")
    if cfg.num_experts and (cfg.num_experts % tp == 0
                            or tp % cfg.num_experts == 0):
        rules["experts"] = (mesh, dp, "model")
    return rules


def _placed(like: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A DTensor of zeros shaped ``like``, placed by ``spec``; DTensor's
    own factory computes the local shard (fake under a fake mode)."""
    return compat.dtensor_zeros(*like.shape, dtype=like.dtype,
                                device_mesh=mesh,
                                placements=compat.to_placements(spec, mesh))


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size()
               for t in tree_flatten(tree)[0]
               if isinstance(t, compat.DTensor))


class Placed(NamedTuple):
    """One step program's inputs as DTensors, and what it needs to run."""

    args: tuple
    optimizer: object          # None for prefill / decode


def place_inputs(cfg, shape, mesh, fsdp: bool = True,
                 sharding_mode: str = "train",
                 n_params: Optional[int] = None) -> Placed:
    """The step program's arguments for ``shape`` as DTensors on ``mesh``
    (parameters, optimizer state, batch, caches), placed by
    ``launch/sharding.py``.  Call under a ``FakeTensorMode`` to allocate
    nothing."""
    meta = ST.init_params_struct(cfg)
    p_spec = SH.params_shardings(meta, mesh, fsdp, sharding_mode, cfg=cfg)
    specs = ST.input_specs(cfg, shape)
    params = {k: _placed(v, p_spec[k], mesh) for k, v in meta.items()}
    inputs = {k: v for k, v in specs.items() if k != "caches"}
    b_spec = SH.batch_shardings(inputs, mesh)
    batch = {k: _placed(v, b_spec[k], mesh) for k, v in inputs.items()}
    if shape.kind == "decode":
        c_spec = SH.cache_shardings(specs["caches"], mesh)
        batch["caches"] = {k: _placed(v, c_spec[k], mesh)
                           for k, v in specs["caches"].items()}
    if shape.kind != "train":
        return Placed((params, batch), None)
    opt = ST.pick_optimizer(cfg, n_params)
    with unset_fake_temporarily():
        state_meta = opt.init(meta)
    o_spec = SH.opt_state_shardings(
        state_meta, p_spec, SH.leaf_specs(meta, cfg, mesh, fsdp,
                                          sharding_mode), mesh)
    state = _map_specs(state_meta, o_spec, lambda v, s: _placed(v, s, mesh))
    return Placed((params, state, 0, batch), opt)


def trace_step(cfg, shape, mesh, fsdp: bool = True,
               sharding_mode: str = "train",
               n_params: Optional[int] = None) -> dict:
    """Place one step program's inputs on ``mesh`` and run it once under
    ``FakeTensorMode`` with the hooks' rules set, counting one device's
    work.  Returns the counts, the trace time and the optimizer's
    name."""
    # DTensor's own index tensors are real
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        placed = place_inputs(cfg, shape, mesh, fsdp, sharding_mode,
                              n_params)
    args, opt = placed
    shard_hooks.set_rules(_rules(cfg, mesh, shape, sharding_mode))
    t0 = time.time()
    try:
        with fake, sharded_program(fake, replicate_failed=True) as counter:
            if shape.kind == "train":
                params, state = args[0], args[1]
                new_p, new_s, _ = ST.make_train_step(cfg, opt)(*args)
                # params and state feed the next step: they go back to the
                # input placements (the reference's out_shardings)
                for k, v in new_p.items():
                    v.redistribute(mesh, params[k].placements)
                _map_specs(new_s, state, lambda v, s: v.redistribute(
                    mesh, s.placements))
            elif shape.kind == "prefill":
                ST.make_prefill_step(cfg)(*args)
            else:
                caches = args[1]["caches"]
                _, new_c = ST.make_serve_step(cfg)(*args)
                for k, v in new_c.items():
                    v.redistribute(mesh, caches[k].placements)
    finally:
        shard_hooks.set_rules(None)
    return {"flops": counter.flops, "bytes": counter.bytes,
            "collectives": dict(counter.collectives),
            "trace_s": time.time() - t0,
            "replicated_ops": counter.replicated_ops,
            "replicated": dict(counter.replicated),
            "replicated_why": dict(counter.replicated_why),
            "optimizer": opt.name if opt else None}


def _map_specs(tree, like, fn):
    """``fn(leaf, like_leaf)`` over a nested dict and its twin."""
    return {k: _map_specs(v, like[k], fn) if isinstance(v, dict)
            else fn(v, like[k]) for k, v in tree.items()}


class MeshShape:
    """A mesh's axis names and sizes, without devices or a group: what the
    partition rules read."""

    def __init__(self, name: str):
        dims, self.axis_names = MESHES.get(name) or (
            tuple(int(d) for d in name.split("x")), ("data", "model"))
        self.shape = dict(zip(self.axis_names, dims))


def rules_argument_bytes(cfg, shape, mesh, fsdp: bool = True,
                         sharding_mode: str = "train") -> int:
    """One device's bytes of every input of the step program, counted from
    the partition specs alone (``launch/sharding.py``): what a record's
    ``argument_size_in_bytes``, read from the DTensors' local shards, must
    equal."""
    meta = ST.init_params_struct(cfg)
    p_spec = SH.params_shardings(meta, mesh, fsdp, sharding_mode, cfg=cfg)
    total = SH.per_device_bytes(meta, p_spec, mesh)
    specs = ST.input_specs(cfg, shape)
    inputs = {k: v for k, v in specs.items() if k != "caches"}
    total += SH.per_device_bytes(inputs, SH.batch_shardings(inputs, mesh),
                                 mesh)
    if "caches" in specs:
        total += SH.per_device_bytes(
            specs["caches"], SH.cache_shardings(specs["caches"], mesh), mesh)
    if shape.kind == "train":
        state = ST.pick_optimizer(cfg).init(meta)
        o_spec = SH.opt_state_shardings(
            state, p_spec, SH.leaf_specs(meta, cfg, mesh, fsdp,
                                         sharding_mode), mesh)
        sizes = _map_specs(state, o_spec, lambda t, sp: math.prod(
            compat.local_shape(t.shape, sp, mesh)) * t.element_size())
        total += sum(tree_flatten(sizes)[0])
    return total


def run_config(arch: str, shape, config_overrides: Optional[dict] = None):
    """The config ``run_one`` traces: the reference's dry-run overrides
    (bf16, remat), then ``config_overrides``, then the shape's."""
    overrides = dict(param_dtype="bfloat16", dtype="bfloat16", remat=True)
    overrides.update(config_overrides or {})
    return ST.adapt_for_shape(get_config(arch).with_(**overrides), shape)


def cost_probe(cfg, shape, mesh, fsdp: bool = True,
               sharding_mode: str = "train",
               n_params: Optional[int] = None) -> dict:
    """Per-device totals extrapolated from UNROLLED shallow programs of 1
    and 2 block groups at the same widths and shapes, as the reference's
    ``cost_probe`` (there because XLA counts a scan body once):
        cost(L groups) = base + per_group * L,
        per_group = c2 - c1, base = c1 - per_group.
    A hybrid tail (< one pattern period) counts as a fraction of a group;
    remat recompute is traced, so it is counted."""
    period = len(block_pattern(cfg))
    n_groups = cfg.num_layers // period
    tail = cfg.num_layers % period
    probes = {}
    for g in (1, 2):
        pc = cfg.with_(num_layers=g * period, scan_unroll=True)
        if cfg.family == "encdec":
            pc = pc.with_(encoder_layers=g)
        probes[g] = trace_step(pc, shape, mesh, fsdp, sharding_mode,
                               n_params)

    def extrap(c1, c2):
        per = max(c2 - c1, 0)
        base = max(c1 - per, 0)
        return base + per * (n_groups + tail / period), per, base

    flops, flops_per, flops_base = extrap(probes[1]["flops"],
                                          probes[2]["flops"])
    byts, _, _ = extrap(probes[1]["bytes"], probes[2]["bytes"])
    coll = {op: int(extrap(probes[1]["collectives"][op],
                           probes[2]["collectives"][op])[0])
            for op in COLLECTIVES}
    counts = {op: int(extrap(probes[1]["collectives"][f"{op}_count"],
                             probes[2]["collectives"][f"{op}_count"])[0])
              for op in COLLECTIVES}
    return {
        "flops_total": flops,
        "flops_per_group": flops_per,
        "flops_base": flops_base,
        "bytes_accessed_total": byts,
        "collective_bytes": coll,
        "collective_bytes_total": int(sum(coll.values())),
        "collective_counts": counts,
        # ops DTensor could not run sharded, rerun replicated (2-group
        # program)
        "replicated_ops": probes[2]["replicated_ops"],
        "replicated": probes[2]["replicated"],
        "replicated_why": probes[2]["replicated_why"],
    }


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            fsdp: bool = True, verbose: bool = True,
            config_overrides: Optional[dict] = None,
            sharding_mode: str = "train", mesh: Optional[str] = None) -> dict:
    """One (arch x shape x mesh) record.  ``mesh``: "16x16", "2x16x16" or
    a small "AxB" data x model mesh (default: from ``multi_pod``)."""
    t_start = time.time()
    shape = get_shape(shape_name)
    cfg = run_config(arch, shape, config_overrides)
    ok, why = ST.supported(cfg, shape)
    mesh_name = mesh or ("2x16x16" if multi_pod else "16x16")
    sizes = MeshShape(mesh_name)
    dims, names = tuple(sizes.shape.values()), sizes.axis_names
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "fsdp": fsdp, "sharding_mode": sharding_mode}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    if cfg.use_pallas:
        raise ValueError("the sharded programs run the plain attention: "
                         "the flash kernels take no DTensor")
    try:
        compat.init_group("fake", world_size=math.prod(dims))
        m = make_mesh(dims, names)
        rec["params"] = ST.param_count(cfg)
        rec.update(status="ok", devices=math.prod(dims))
        with FakeTensorMode():
            placed = place_inputs(cfg, shape, m, fsdp, sharding_mode,
                                  rec["params"])
            rec["argument_size_in_bytes"] = _local_bytes(placed.args)
        if shape.kind == "train":
            rec["optimizer"] = ST.pick_optimizer(cfg, rec["params"]).name
        # no allocator runs under fake tensors: not measured, never 0
        rec.update(temp_size_in_bytes=None, peak_memory_in_bytes=None)
        p = rec["probe"] = cost_probe(cfg, shape, m, fsdp, sharding_mode,
                                      rec["params"])
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
                  f"flops={p['flops_total']:.3e}/dev "
                  f"args={rec['argument_size_in_bytes']}B/dev "
                  f"replicated_ops={p['replicated_ops']}")
            print(f"  probe: bytes={p['bytes_accessed_total']:.3e} "
                  f"coll={p['collective_bytes_total'] / 1e9:.2f}GB "
                  + ", ".join(f"{k}={v / 1e9:.2f}GB"
                              for k, v in p["collective_bytes"].items()
                              if v))
    except Exception as exc:  # noqa: BLE001 - record and continue
        rec.update(status="error", error=f"{type(exc).__name__}: {exc}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
                  f"FAILED {rec['error']}")
    finally:
        compat.destroy_group()
    rec["wall_s"] = round(time.time() - t_start, 1)
    return rec


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list_architectures())
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="beyond-paper profile: decode2d sharding + the "
                         "sharded decode attention for decode shapes, "
                         "chunked attention for train/prefill")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list_architectures() if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[
        args.mesh]

    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                overrides, mode = None, "train"
                if args.optimized:
                    if SHAPES[shape].kind == "decode":
                        mode = "decode2d"
                    else:
                        overrides = {"attn_chunk": 512}
                rec = run_one(arch, shape, mp, fsdp=not args.no_fsdp,
                              config_overrides=overrides,
                              sharding_mode=mode)
                results.append(rec)
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    print(f"\n[dryrun] done: {n_ok} ok, {n_skip} skipped, "
          f"{len(results) - n_ok - n_skip} failed / {len(results)} total")
    return results


if __name__ == "__main__":
    main()
