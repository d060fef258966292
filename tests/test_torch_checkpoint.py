"""Checkpoint and resume in the port (``repro_torch.checkpoint``,
``Session.save`` / ``restore``, ``CheckpointHook``): mirrors of
``tests/test_api.py``'s resume tests and ``tests/test_substrate.py``'s
round trip, on the CPU.  A resumed sim-backend BSP run must continue bit
for bit: params, Adam's moments, batches, simulated clock and losses, on a
paper workload (``CounterBatchSource`` cursors) and on a reduced LM
(``TokenStream`` cursors).  The file format is the reference's, so a
checkpoint written by either package loads in the other.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as ref_load_checkpoint
from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro_torch import api as T
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import ControllerConfig
from repro_torch.data import DataPipeline
from repro_torch.het import WorkerSpec
from repro_torch.models import reduced
from repro_torch.optim import adam, sgd

CPU = T.SimBackend(device="cpu")


def _cfg(**kw):
    kw.setdefault("b0", 32)
    kw.setdefault("microbatch", 8)
    kw.setdefault("batching", "dynamic")
    kw.setdefault("max_steps", 12)
    return T.TrainConfig(**kw)


def _experiment(cfg, *, workload="linreg", seed=100, schedule=()):
    cluster = T.ClusterSpec.hlevel(39, 6, workload=workload, seed=0,
                                   backend=CPU)
    if schedule:
        cluster.with_schedule(*schedule)
    return T.Experiment(
        workload=T.paper_workload(workload, seed=seed),
        cluster=cluster,
        optimizer=sgd(0.05) if workload == "linreg" else adam(2e-3),
        config=cfg)


def _assert_histories_identical(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.step == rb.step
        assert ra.loss == rb.loss                      # bit-for-bit
        assert ra.sim_time == rb.sim_time
        assert ra.iteration_time == rb.iteration_time
        assert ra.batches == rb.batches
        assert ra.adjusted == rb.adjusted
        assert ra.straggler_waste == rb.straggler_waste


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "params": {"w": torch.arange(6.0).reshape(2, 3),
                   "layers": ({"a": torch.ones(2)}, {"a": torch.zeros(2)})},
        "opt": (),
        "none_field": None,
        "step": torch.tensor(7),
    }
    meta = {"controller": {"batches": [16, 48]}, "step": 7}
    path = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(path, tree, meta)
    loaded, meta2 = load_checkpoint(path, device="cpu")
    assert meta2 == meta
    assert torch.equal(loaded["params"]["w"], tree["params"]["w"])
    assert isinstance(loaded["params"]["layers"], tuple)
    assert torch.equal(loaded["params"]["layers"][0]["a"], torch.ones(2))
    assert loaded["none_field"] is None
    assert loaded["opt"] == ()
    assert int(loaded["step"]) == 7 and loaded["step"].dtype == torch.int64
    assert not [f for f in os.listdir(tmp_path) if f != "ckpt.npz"]


def test_checkpoint_files_load_in_either_package(tmp_path):
    """Same flat-key npz + JSON sidecar as the reference's."""
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    save_checkpoint(ours, {"a": {"w": torch.arange(4.0)}, "s": ()}, {"k": 1})
    ref_save_checkpoint(theirs, {"a": {"w": jnp.arange(4.0)}, "s": ()},
                        {"k": 1})
    tree, meta = ref_load_checkpoint(ours)
    assert meta == {"k": 1} and tree["s"] == ()
    np.testing.assert_array_equal(np.asarray(tree["a"]["w"]), np.arange(4.0))
    tree, meta = load_checkpoint(theirs, device="cpu")
    assert meta == {"k": 1} and tree["s"] == ()
    assert torch.equal(tree["a"]["w"], torch.arange(4.0))


def test_checkpoint_resume_bitwise(tmp_path):
    """Save at step 6 via CheckpointHook, resume a fresh Session, and the
    continued run must match an uninterrupted one bit-for-bit."""
    path = str(tmp_path / "sess.npz")
    exp = _experiment(_cfg(max_steps=14))
    straight = _experiment(_cfg(max_steps=14)).run()

    hook = T.CheckpointHook(path, every=6, at_end=False)
    first = exp.session(hooks=[hook])
    for rec in first:
        if rec.step == 7:  # saved after step 5 (every=6); run a bit past it
            break
    assert hook.saves == 1

    resumed = _experiment(_cfg(max_steps=14)).session(resume_from=path)
    assert resumed.step_idx == 6
    out = resumed.run()
    assert out["steps"] == 14
    _assert_histories_identical(straight["history"][6:], out["history"])


def test_checkpoint_resume_final_params_match(tmp_path):
    path = str(tmp_path / "sess2.npz")
    sess = _experiment(_cfg(max_steps=10)).session()
    for rec in sess:
        if rec.step == 4:
            sess.save(path)
            break
    resumed = _experiment(_cfg(max_steps=10)).session(resume_from=path)
    resumed.run()
    straight = _experiment(_cfg(max_steps=10)).session()
    straight.run()
    _assert_trees_equal(resumed.params, straight.params)


def test_resume_is_bitwise_with_adam_on_a_cnn(tmp_path):
    """mnist-cnn under Adam: params, both moments, batches, simulated clock
    and losses of a resumed run equal the uninterrupted run's."""
    path = str(tmp_path / "cnn.npz")
    cfg = dict(max_steps=8, controller=ControllerConfig(kind="pid"))
    sess = _experiment(_cfg(**cfg), workload="mnist-cnn").session()
    for rec in sess:
        if rec.step == 3:
            sess.save(path)
            break
    resumed = _experiment(_cfg(**cfg), workload="mnist-cnn").session(
        resume_from=path)
    assert resumed.smoothed_loss == sess.smoothed_loss
    out = resumed.run()
    straight = _experiment(_cfg(**cfg), workload="mnist-cnn").session()
    ref = straight.run()
    _assert_histories_identical(ref["history"][4:], out["history"])
    assert out["sim_time"] == ref["sim_time"]
    assert out["final_loss"] == ref["final_loss"]
    _assert_trees_equal(resumed.params, straight.params)
    _assert_trees_equal(resumed.trainer.opt_state, straight.trainer.opt_state)


def test_resume_of_a_reduced_lm_continues_its_token_stream(tmp_path):
    path = str(tmp_path / "lm.npz")
    cfg = reduced(get_config("gemma-2b"))

    def experiment():
        return T.Experiment(
            workload=T.lm_workload(cfg, DataPipeline(cfg, seq_len=16,
                                                     num_workers=3,
                                                     device="cpu")),
            cluster=T.ClusterSpec.hlevel(39, 6.0, 3, workload="transformer",
                                         seed=0, backend=CPU),
            optimizer=adam(1e-3),
            config=T.TrainConfig(b0=4, microbatch=2, batching="dynamic",
                                 max_steps=5,
                                 controller=ControllerConfig(kind="p")))

    sess = experiment().session()
    for rec in sess:
        if rec.step == 1:
            sess.save(path)
            break
    resumed = experiment().session(resume_from=path)
    assert resumed.workload.state_dict() == sess.workload.state_dict()
    out = resumed.run()
    straight = experiment().session()
    ref = straight.run()
    _assert_histories_identical(ref["history"][2:], out["history"])
    _assert_trees_equal(resumed.params, straight.params)
    _assert_trees_equal(resumed.trainer.opt_state, straight.trainer.opt_state)


def test_restore_rejects_seed_mismatch(tmp_path):
    path = str(tmp_path / "seed.npz")
    sess = _experiment(_cfg(max_steps=4)).session()
    sess.step()
    sess.save(path)
    other = _experiment(_cfg(max_steps=4), seed=7)  # another data stream
    with pytest.raises(ValueError, match="seed"):
        other.session(resume_from=path)


def test_restore_rejects_mismatched_cluster(tmp_path):
    path = str(tmp_path / "sess3.npz")
    sess = _experiment(_cfg(max_steps=4)).session()
    sess.step()
    sess.save(path)
    two_worker = T.Experiment(
        workload=T.paper_workload("linreg", seed=100),
        cluster=T.ClusterSpec.explicit([WorkerSpec(cores=8),
                                        WorkerSpec(cores=16)],
                                       workload="linreg", backend=CPU),
        optimizer=sgd(0.05),
        config=_cfg(max_steps=4))
    with pytest.raises(ValueError, match="workers"):
        two_worker.session(resume_from=path)


def test_restore_rejects_a_step_past_membership_events(tmp_path):
    path = str(tmp_path / "sess4.npz")
    sess = _experiment(_cfg(max_steps=6)).session()
    for rec in sess:
        if rec.step == 3:
            sess.save(path)
            break
    scheduled = _experiment(_cfg(max_steps=6),
                            schedule=(T.RemoveWorker(step=2, worker=2),))
    with pytest.raises(ValueError, match="membership events"):
        scheduled.session(resume_from=path)


@pytest.mark.parametrize("field,value,match", [
    ("backend", "mesh", "backend"),
    ("outer", {"kind": "gns"}, "global-batch config mismatch"),
])
def test_restore_rejects_other_backend_or_outer_kind(tmp_path, field, value,
                                                     match):
    """A checkpoint written by another backend kind, or with an outer
    global-batch controller into a session that runs the fixed kind, is
    refused."""
    path = str(tmp_path / "sess5.npz")
    sess = _experiment(_cfg(max_steps=4)).session()
    sess.step()
    sess.save(path)
    tree, meta = load_checkpoint(path, device="cpu")
    meta["session"][field] = value
    save_checkpoint(path, tree, meta)
    with pytest.raises(ValueError, match=match):
        _experiment(_cfg(max_steps=4)).session(resume_from=path)


def test_checkpoint_hook_saves_every_n_and_at_end(tmp_path):
    path = str(tmp_path / "hook.npz")
    hook = T.CheckpointHook(path, every=2, extra_meta={"tag": "x"})
    _experiment(_cfg(max_steps=5)).run(hooks=[hook])
    assert hook.saves == 3   # after steps 1 and 3, and at the end
    _, meta = load_checkpoint(path, device="cpu")
    assert meta["tag"] == "x" and meta["session"]["step"] == 5
