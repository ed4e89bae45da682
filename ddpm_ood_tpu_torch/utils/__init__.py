from .checkpoint import find_checkpoint, save_checkpoint
from .convert import jax_unet_params_to_state_dict

__all__ = [
    "find_checkpoint",
    "jax_unet_params_to_state_dict",
    "save_checkpoint",
]
