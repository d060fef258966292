from repro_torch.models.config import ModelConfig, reduced
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.transformer import apply_lm, init_lm, lm_loss

__all__ = [
    "ModelConfig",
    "apply_lm",
    "init_lm",
    "lm_loss",
    "params_from_jax",
    "params_to_jax",
    "reduced",
]
