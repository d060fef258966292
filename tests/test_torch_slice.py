"""The slice end to end: the same heterogeneous LM Experiment through the
reference and the port.

Reduced gemma-2b, seq 128 (the reference takes its Pallas kernel branch in
interpret mode, the port its kernels' plain versions on the CPU), three
h-level workers, b0 4, microbatch 2, P controller, BSP.  The reference's
initial parameters are injected into the port's workload through
``params_from_jax``; the token streams are the same numpy stream.  The
per-step batch split, simulated clock and adjustment flags depend only on
the simulated clock and must be bit-identical; losses agree in fp32.
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
from repro_torch.models import params_from_jax, reduced
from repro_torch.optim import adam

SEQ, WORKERS = 128, 3


def _ref_run(sync, steps):
    cfg = ref_reduced(ref_get_config("gemma-2b"))
    wl = R.lm_workload(cfg, RefDataPipeline(cfg, seq_len=SEQ,
                                            num_workers=WORKERS),
                       aux_weight=0.01, use_kernel=True)
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
    cfg = reduced(get_config("gemma-2b"))
    wl = T.lm_workload(cfg, DataPipeline(cfg, seq_len=SEQ,
                                         num_workers=WORKERS, device="cpu"),
                       aux_weight=0.01, use_kernel=True)
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
def test_experiment_matches_reference(sync, steps):
    params0, ref = _ref_run(sync, steps)
    ours = _port_run(params0, sync, steps)
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


def test_non_fixed_outer_kinds_name_their_slice():
    """Slice 4 landed: every outer kind constructs through
    ``make_global_controller`` and ``TrainConfig``, and gns / dynamix on
    ASP raise the reference's ``ValueError``, as the reference does."""
    from repro.core import GlobalBatchConfig as RefGlobalBatchConfig
    from repro_torch.core import GlobalBatchConfig, make_global_controller

    for kind in ("gns", "geometric", "bandit", "dynamix"):
        ctrl = make_global_controller(GlobalBatchConfig(kind=kind), b0=8)
        assert ctrl.kind == kind and ctrl.b_global == 8
        cfg = T.TrainConfig(global_batch=GlobalBatchConfig(kind=kind))
        assert cfg.global_batch.kind == kind
        if kind in ("gns", "dynamix"):
            with pytest.raises(ValueError, match="sync='bsp'") as port:
                T.TrainConfig(sync="asp",
                              global_batch=GlobalBatchConfig(kind=kind))
            with pytest.raises(ValueError) as ref:
                R.TrainConfig(sync="asp",
                              global_batch=RefGlobalBatchConfig(kind=kind))
            assert str(port.value) == str(ref.value)
        else:
            T.TrainConfig(sync="asp",
                          global_batch=GlobalBatchConfig(kind=kind))
