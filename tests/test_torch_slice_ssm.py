"""The ssm slice end to end: the same heterogeneous LM Experiment on a
reduced mamba2-1.3b through the reference and the port.

Reduced mamba2 (2 layers, d_model 128, 16 heads x head_dim 16, state 16,
chunk 8), seq 32, three h-level workers, b0 4, microbatch 2, P controller.
The reference runs ``lm_workload(use_kernel=False)``: its SSD kernel path
has no VJP and cannot train.  The port runs ``use_kernel=True``: its SSD
kernel pair, whose wrappers take their plain versions on the CPU.  The
reference's initial parameters are injected through ``params_from_jax``;
the token streams are the same numpy stream.  The per-step batch split,
simulated clock and adjustment flags depend only on the simulated clock and
must be bit-identical; losses agree at rtol 1e-4.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a worker)
import jax
import numpy as np
import pytest

import repro.api as R
from repro.configs import get_config as ref_get_config
from repro.core import ControllerConfig as RefControllerConfig
from repro.data import DataPipeline as RefDataPipeline
from repro.models import reduced as ref_reduced
from repro.optim import adam as ref_adam
from repro_torch import api as T
from repro_torch.configs import get_config
from repro_torch.core import ControllerConfig
from repro_torch.data import DataPipeline
from repro_torch.kernels.ssd_scan import LAUNCHES
from repro_torch.models import params_from_jax, reduced
from repro_torch.optim import adam

SEQ, WORKERS = 32, 3


def _ref_run(sync, steps):
    cfg = ref_reduced(ref_get_config("mamba2-1.3b"))
    wl = R.lm_workload(cfg, RefDataPipeline(cfg, seq_len=SEQ,
                                            num_workers=WORKERS),
                       use_kernel=False)
    params0 = jax.tree_util.tree_map(
        np.asarray, wl.init(jax.random.PRNGKey(0)))
    out = R.Experiment(
        workload=wl,
        cluster=R.ClusterSpec.hlevel(39, 6.0, WORKERS,
                                     workload="transformer", seed=0),
        optimizer=ref_adam(1e-3),
        config=R.TrainConfig(b0=4, microbatch=2, batching="dynamic",
                             sync=sync, max_steps=steps,
                             controller=RefControllerConfig(kind="p")),
    ).session().run()
    return params0, out


def _port_run(params0, sync, steps):
    cfg = reduced(get_config("mamba2-1.3b"))
    wl = T.lm_workload(cfg, DataPipeline(cfg, seq_len=SEQ,
                                         num_workers=WORKERS, device="cpu"),
                       use_kernel=True)
    wl.init = lambda gen: params_from_jax(params0, cfg, device=gen.device)
    return T.Experiment(
        workload=wl,
        cluster=T.ClusterSpec.hlevel(39, 6.0, WORKERS, workload="transformer",
                                     seed=0,
                                     backend=T.SimBackend(device="cpu")),
        optimizer=adam(1e-3),
        config=T.TrainConfig(b0=4, microbatch=2, batching="dynamic",
                             sync=sync, max_steps=steps,
                             controller=ControllerConfig(kind="p")),
    ).session().run()


@pytest.mark.parametrize("sync,steps", [("bsp", 3), ("asp", 4)])
def test_ssm_experiment_matches_reference(sync, steps):
    params0, ref = _ref_run(sync, steps)
    launches = dict(LAUNCHES)
    ours = _port_run(params0, sync, steps)
    assert LAUNCHES == launches          # CPU tensors: plain versions only
    assert ours["steps"] == ref["steps"] == steps
    for a, b in zip(ours["history"], ref["history"]):
        assert a.batches == b.batches
        assert a.sim_time == b.sim_time
        assert a.adjusted == b.adjusted
        assert a.iteration_time == b.iteration_time
        assert a.worker_times == b.worker_times
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4)
    assert ours["final_batches"] == ref["final_batches"]
    assert ours["sim_time"] == ref["sim_time"]
    assert ours["batch_adjustments"] == ref["batch_adjustments"]
    np.testing.assert_allclose(ours["final_loss"], ref["final_loss"],
                               rtol=1e-4)
