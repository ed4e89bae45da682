from .base import BaseTrainer
from .ddpm_trainer import DDPMTrainer
from .reconstruct import Reconstruct
from .vqvae_trainer import VQVAETrainer

__all__ = ["BaseTrainer", "DDPMTrainer", "Reconstruct", "VQVAETrainer"]
