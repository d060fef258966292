"""Slice 5b, the measured backend over several devices, against the
reference's own concurrent ``MeshTrainer`` on the CPU.

The reference's concurrent round needs several JAX devices, and this
process's jax has started with one.  So the reference side runs in one
fresh interpreter for the module (``tests/concurrent_runner.py``, started
when the module's tests start, read when the first comparison needs it),
over the 8-device debug mesh (a data axis of 4), with its ``shard_map``
taking the mesh by keyword, fake clocks, and the awaiters' completion
stamps fixed by worker (dispatch stamp + ``duration(worker)``).  The port
runs the same scenarios here, over ``["cpu"] * 4``, with the same clocks
and stamps patched in, the reference's linreg batches and initial
parameters, and the reference's decode parameters.

Held ``==``: slice plans, batches, per-worker buckets and quanta,
``timing_reruns``, the engine clock, membership logs, round stamps,
``policy_log``, reserves, ``exec_state_dict``, serve stats and streams;
losses at rtol 1e-4.  The port alone: a worker over 1, 2 or 4 devices
gives the unpadded combine's mean gradient; replicas stay bit-equal to the
master; a repeated CUDA device raises; a checkpoint of one extent is
refused by another; a worker thread's exception reaches the caller; and a
stress run with more workers than cores keeps the trajectory.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import json
import os
import subprocess
import sys
import tempfile
import threading

import jax
import numpy as np
import pytest
import torch

import concurrent_runner as runner
import repro_torch.serve.scheduler as sched_mod
import repro_torch.serve.slots as slots_mod
import repro_torch.train.colocate as colo_mod
from repro.configs import get_config as ref_get_config
from repro.models import init_lm as ref_init_lm
from repro.models import reduced as ref_reduced
from repro.models.simple import paper_workloads as ref_paper_workloads
from repro_torch import api as T
from repro_torch import core as TC
from repro_torch.device import resolve_devices
from repro_torch.het import WorkerSpec
from repro_torch.het.spot import storm_market
from repro_torch.models import (paper_params_from_jax, paper_workloads,
                                params_from_jax)
from repro_torch.optim import sgd
from repro_torch.serve.colocate import ServeSpec
from repro_torch.train import mesh as port_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXIS = ["cpu"] * 4          # the debug mesh's data extent
REF_TIMEOUT = 600


# ------------------------------------------------------- the reference


class _Reference:
    """The runner's process; a thread files each scenario's JSON line as
    it arrives, so the port's side of later scenarios runs meanwhile."""

    def __init__(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        self._err = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "concurrent_runner.py")],
            stdout=subprocess.PIPE, stderr=self._err, text=True, env=env,
            cwd=ROOT)
        self.results = {}
        self._ended = False
        self._cond = threading.Condition()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            rec = json.loads(line)
            with self._cond:
                self.results[rec["name"]] = rec["result"]
                self._cond.notify_all()
        self.proc.wait()
        with self._cond:
            self._ended = True
            self._cond.notify_all()

    def result(self, name: str):
        with self._cond:
            self._cond.wait_for(
                lambda: name in self.results or self._ended,
                timeout=REF_TIMEOUT)
        if name not in self.results:
            self._err.seek(0)
            raise AssertionError(
                f"the reference gave no {name!r} (exit "
                f"{self.proc.poll()}):\n{self._err.read()[-4000:]}")
        return self.results[name]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)
        self._reader.join(timeout=60)
        self._err.close()


@pytest.fixture(scope="module", autouse=True)
def reference():
    ref = _Reference()
    yield ref
    ref.close()


# ------------------------------------------------------------ the port


class _RefStream:
    """The reference's ``CounterBatchSource`` stream as CPU tensors, with
    its cursors, so a checkpoint resumes it."""

    def __init__(self, make_batch, seed=100):
        self.make_batch = make_batch
        self.seed = seed
        self.counters = {}

    def __call__(self, worker, n):
        self.counters[worker] = self.counters.get(worker, 0) + 1
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed + worker),
                                 self.counters[worker])
        return {k: torch.from_numpy(np.array(v))
                for k, v in self.make_batch(key, n).items()}

    def state_dict(self):
        return {"seed": self.seed, "counters": dict(self.counters)}

    def load_state_dict(self, state):
        self.counters = {int(k): int(v)
                         for k, v in state["counters"].items()}


_CACHE = {}


def _ref_linreg_params():
    if "linreg" not in _CACHE:
        _CACHE["linreg"] = jax.tree_util.tree_map(
            np.asarray,
            ref_paper_workloads()["linreg"].init(jax.random.PRNGKey(0)))
    return _CACHE["linreg"]


def _ref_serve_params(arch, seed):
    key = ("serve", arch, seed)
    if key not in _CACHE:
        _CACHE[key] = jax.tree_util.tree_map(
            np.asarray, ref_init_lm(jax.random.PRNGKey(seed),
                                    ref_reduced(ref_get_config(arch))))
    return _CACHE[key]


def _stamp(d):
    """The port's awaiter, completion fixed by worker as the runner's."""
    d.call.result()
    return d.t0 + runner.duration(d.worker)


class PortSide:
    """The runner's side object for the port over ``AXIS``."""

    api = T
    sgd = staticmethod(sgd)
    WorkerSpec = WorkerSpec
    ServeSpec = ServeSpec
    storm_market = staticmethod(storm_market)

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        monkeypatch.setattr(port_mesh, "_ready_timestamp", _stamp)

    def backend(self, **kw):
        return T.MeshBackend(device=AXIS, **kw)

    def workload(self):
        params0 = _ref_linreg_params()
        src = _RefStream(ref_paper_workloads()["linreg"].make_batch)
        return T.Workload(
            name="linreg",
            init=lambda gen: paper_params_from_jax("linreg", params0,
                                                   device=gen.device),
            loss_and_grad=T.sum_loss_adapter(
                paper_workloads()["linreg"].loss_fn),
            next_batch=src, state_dict=src.state_dict,
            load_state_dict=src.load_state_dict)

    def inject(self, trainer):
        sp = trainer.serve_spec
        params = params_from_jax(_ref_serve_params(sp.arch, sp.seed),
                                 trainer.serve_model_cfg, device="cpu")
        trainer._serve_params = params
        if trainer.prefill is not None:
            trainer.prefill.params = params
            for shard in trainer.batcher.shards.values():
                shard.params = params
        else:
            trainer.batcher.params = params

    def fresh_clocks(self):
        for mod in (port_mesh, colo_mod, sched_mod, slots_mod):
            self.mp.setattr(mod, "_time", runner.FakeClock())


def _split_losses(obj, path=""):
    """``obj`` without its "losses" entries, and those entries by path."""
    if isinstance(obj, dict):
        rest, losses = {}, {}
        for k, v in obj.items():
            if k == "losses":
                losses[path] = v
            else:
                rest[k], sub = _split_losses(v, f"{path}/{k}")
                losses.update(sub)
        return rest, losses
    return obj, {}


def _port_result(name, monkeypatch):
    return runner.run(PortSide(monkeypatch), name)


# ------------------------------------------- port-only properties first
# (they run while the reference's interpreter works)


_BATCHES = ([5, 17, 29, 1], [1, 2, 3, 4], [31, 8, 19, 3])


@pytest.mark.parametrize("batches", _BATCHES, ids=["ragged", "small",
                                                   "large"])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_slice_gradient_equals_unpadded_combine(width, batches):
    """Padded, split over a slice of ``width`` devices, summed there by
    ``weighted_psum``, then lambda-combined: the unpadded combine's mean
    gradient over the same examples, at
    ``test_padded_masked_equals_unpadded_combine``'s tolerance."""
    k = len(AXIS) // width
    batches = batches[:k]
    wl = T.paper_workload("linreg")
    fetched = []

    def nb(worker, n):
        fetched.append(wl.next_batch(worker, n))
        return fetched[-1]

    wl.to("cpu")
    trainer = port_mesh.MeshTrainer(
        num_workers=k, init_params=wl.init, loss_and_grad=wl.loss_and_grad,
        next_batch=nb, optimizer=sgd(0.05),
        cfg=T.TrainConfig(b0=16, microbatch=4, batching="uniform",
                          max_steps=5),
        device=AXIS)
    assert [len(rec.rows) for rec in trainer._exec] == [width] * k
    mesh_grads, ref_grads = [], []
    for w, b in enumerate(batches):
        fetched.clear()
        g, ls, ws, _t = trainer._measured_worker_grad(w, b)
        assert ws == b
        (padded,) = fetched
        bucket = trainer.bucket_for(w, b)
        assert padded["x"].shape[0] == bucket >= b and bucket % width == 0
        sliced = {key: x[:b] for key, x in padded.items()}
        (ls_ref, _, _), g_sum = wl.loss_and_grad(trainer.params, sliced,
                                                 torch.ones(b))
        np.testing.assert_allclose(ls, float(ls_ref), rtol=1e-5)
        ref_grads.append({n: x / b for n, x in g_sum.items()})
        mesh_grads.append(g)
    got = TC.combine_weighted(mesh_grads, batches)
    want = TC.combine_weighted(ref_grads, batches)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   rtol=1e-5, atol=1e-6)


def _linreg_session(k=3, steps=4, axis=AXIS, **backend):
    return T.Experiment(
        workload=T.paper_workload("linreg"),
        cluster=T.ClusterSpec.homogeneous(
            10 * k, k, backend=T.MeshBackend(device=axis, **backend)),
        optimizer=sgd(0.05),
        config=T.TrainConfig(b0=8, microbatch=4, batching="dynamic",
                             max_steps=steps)).session()


def test_replicas_stay_bit_equal_to_the_master():
    session = _linreg_session(k=2)
    t = session.trainer
    assert t.concurrent and sorted(t._replicas) == [1, 2, 3]
    for _rec in session:
        for rep in t._replicas.values():
            for name, x in t.params.items():
                assert torch.equal(rep[name], x)
                assert rep[name].data_ptr() != x.data_ptr()


def test_a_repeated_card_raises():
    for devices in (["cuda:0", "cuda:0"], ["cuda", "cpu", "cuda:0"]):
        with pytest.raises(ValueError, match="more than once"):
            resolve_devices(devices)
        with pytest.raises(ValueError, match="more than once"):
            T.MeshBackend(device=devices).build_trainer(
                workload=None, cluster=None, optimizer=None, cfg=None)
    assert resolve_devices(["cpu"] * 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="empty"):
        resolve_devices([])


def test_restore_rejects_a_list_of_another_extent(tmp_path):
    """A checkpoint of a 4-row axis restores into 4 rows and is refused
    by 2, with the reference's message, before anything is loaded."""
    path = str(tmp_path / "wide.ckpt")
    first = _linreg_session(k=2, steps=2)
    first.run()
    first.save(path)
    same = _linreg_session(k=2, steps=2)
    same.restore(path)
    assert same.trainer.exec_state_dict() == first.trainer.exec_state_dict()
    narrow = _linreg_session(k=2, steps=2, axis=["cpu"] * 2)
    data = narrow.workload.state_dict()
    with pytest.raises(ValueError, match="data extent 4, this mesh has 2"):
        narrow.restore(path)
    assert narrow.workload.state_dict() == data


def test_a_worker_exception_fails_the_round():
    session = _linreg_session()
    t = session.trainer
    inner = t._loss_and_grad
    raised = []

    def loss_and_grad(params, batch, mask):
        if threading.current_thread() is not threading.main_thread():
            raised.append(threading.current_thread().name)
            raise RuntimeError("worker call failed")
        return inner(params, batch, mask)

    t._loss_and_grad = loss_and_grad
    step = t.step_idx
    with pytest.raises(RuntimeError, match="worker call failed"):
        session.step()
    assert raised and t.step_idx == step
    t._loss_and_grad = inner
    assert session.step().step == step     # the next round runs


def test_many_workers_on_few_cores_keep_the_trajectory(monkeypatch):
    """Eight workers over eight CPU rows, twice: with the interpreter's
    switch interval at 1e-6 s the concurrent round makes the same
    decisions as with the default (completion stamps fixed by worker)."""
    monkeypatch.setattr(port_mesh, "_ready_timestamp", _stamp)
    runs = []
    for interval in (None, 1e-6):
        monkeypatch.setattr(port_mesh, "_time", runner.FakeClock())
        old = sys.getswitchinterval()
        if interval is not None:
            sys.setswitchinterval(interval)
        try:
            session = _linreg_session(k=8, steps=3, axis=["cpu"] * 8)
            out = session.run()
        finally:
            sys.setswitchinterval(old)
        t = session.trainer
        runs.append(runner.decisions(out, t, [8] * 8))
        assert t.concurrent and len(t.last_round_stamps) == 8
    np.testing.assert_allclose(runs[0].pop("losses"), runs[1].pop("losses"),
                               rtol=1e-6)
    assert runs[0] == runs[1]


# ---------------------------------------------- == the reference's rounds


@pytest.mark.parametrize("name", list(runner.SCENARIOS))
def test_scenario_matches_reference(name, monkeypatch, reference):
    got, got_losses = _split_losses(_port_result(name, monkeypatch))
    want, want_losses = _split_losses(reference.result(name))
    assert got == want
    assert got_losses.keys() == want_losses.keys()
    for path, losses in want_losses.items():
        np.testing.assert_allclose(got_losses[path], losses, rtol=1e-4,
                                   err_msg=path)


def test_reference_rounds_ran_concurrently(reference):
    """What the comparison stands on: the reference's scenarios took its
    concurrent round (slices over the 4-wide axis, stamps recorded), its
    policy grew and shrank the dedicated slice, and its storm stormed."""
    bsp = reference.result("bsp")["run"]
    assert bsp["exec"]["slices"] == [[0, 2], [2, 1], [3, 1]]
    assert bsp["quanta"] == [2, 1, 1] and bsp["stamps"] is not None
    policy = reference.result("dedicated_policy")
    kinds = [a for _, a, _ in policy["policy_log"]]
    assert "grow" in kinds and "shrink" in kinds
    assert policy["restored"]["exec"]["reserve"] > 1
    assert reference.result("disaggregated")["shards"] == [2, 3, 2]
    assert {"remove", "add", "reallocate"} <= {
        e[1] for e in reference.result("storm")["membership"]}
