from .checkpoint import find_checkpoint, load_checkpoint, save_checkpoint, write_checkpoint
from .convert import jax_lpips_params_to_state_dict, jax_unet_params_to_state_dict

__all__ = [
    "find_checkpoint",
    "jax_lpips_params_to_state_dict",
    "jax_unet_params_to_state_dict",
    "load_checkpoint",
    "save_checkpoint",
    "write_checkpoint",
]
