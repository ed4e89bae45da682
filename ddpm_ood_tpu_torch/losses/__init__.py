from .gan import discriminator_loss, generator_adversarial_loss
from .lpips import LPIPS, PerceptualLoss, load_lpips_state_dict, pad_to_min_32
from .spectral import jukebox_loss

__all__ = ["LPIPS", "PerceptualLoss", "discriminator_loss", "generator_adversarial_loss",
           "jukebox_loss", "load_lpips_state_dict", "pad_to_min_32"]
