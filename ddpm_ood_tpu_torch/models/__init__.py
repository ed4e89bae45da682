from .discriminator import PatchDiscriminator
from .unet import DiffusionModelUNet, make_unet, random_init_
from .vqvae import VQVAE

__all__ = ["DiffusionModelUNet", "PatchDiscriminator", "VQVAE", "make_unet", "random_init_"]
