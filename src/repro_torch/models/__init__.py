from repro_torch.models.config import ModelConfig, reduced
from repro_torch.models.convert import (caches_from_jax, caches_to_jax,
                                       paper_params_from_jax,
                                       params_from_jax, params_to_jax)
from repro_torch.models.encdec import decode as encdec_decode
from repro_torch.models.encdec import encode as encdec_encode
from repro_torch.models.encdec import (encdec_loss, init_dec_caches,
                                       init_encdec)
from repro_torch.models.recurrent import apply_rglru, recurrent_block
from repro_torch.models.simple import Workload, paper_workloads
from repro_torch.models.ssm import ssd_block, ssd_chunked
from repro_torch.models.transformer import (apply_lm, block_pattern,
                                            init_caches, init_lm, init_model,
                                            lm_loss, param_count)

__all__ = [
    "ModelConfig",
    "Workload",
    "apply_lm",
    "apply_rglru",
    "block_pattern",
    "caches_from_jax",
    "caches_to_jax",
    "encdec_decode",
    "encdec_encode",
    "encdec_loss",
    "init_caches",
    "init_dec_caches",
    "init_encdec",
    "init_lm",
    "init_model",
    "lm_loss",
    "paper_params_from_jax",
    "paper_workloads",
    "param_count",
    "params_from_jax",
    "params_to_jax",
    "recurrent_block",
    "reduced",
    "ssd_block",
    "ssd_chunked",
]
