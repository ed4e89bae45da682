from .ddpm import DDPMTrainStep
from .vqvae import VQVAETrainStep, adversarial_weight

__all__ = ["DDPMTrainStep", "VQVAETrainStep", "adversarial_weight"]
