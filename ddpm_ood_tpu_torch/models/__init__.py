from .unet import DiffusionModelUNet, make_unet, random_init_

__all__ = ["DiffusionModelUNet", "make_unet", "random_init_"]
