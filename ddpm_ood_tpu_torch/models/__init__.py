from .unet import DiffusionModelUNet, make_unet, random_init_
from .vqvae import VQVAE

__all__ = ["DiffusionModelUNet", "VQVAE", "make_unet", "random_init_"]
