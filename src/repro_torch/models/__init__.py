from repro_torch.models.config import ModelConfig, reduced
from repro_torch.models.convert import (caches_from_jax, caches_to_jax,
                                       paper_params_from_jax,
                                       params_from_jax, params_to_jax)
from repro_torch.models.recurrent import apply_rglru, recurrent_block
from repro_torch.models.simple import Workload, paper_workloads
from repro_torch.models.ssm import ssd_block, ssd_chunked
from repro_torch.models.transformer import (apply_lm, block_pattern,
                                            init_caches, init_lm, lm_loss)

__all__ = [
    "ModelConfig",
    "Workload",
    "apply_lm",
    "apply_rglru",
    "block_pattern",
    "caches_from_jax",
    "caches_to_jax",
    "init_caches",
    "init_lm",
    "lm_loss",
    "paper_params_from_jax",
    "paper_workloads",
    "params_from_jax",
    "params_to_jax",
    "recurrent_block",
    "reduced",
    "ssd_block",
    "ssd_chunked",
]
