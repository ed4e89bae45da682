from .base import BaseTrainer
from .ddpm_trainer import DDPMTrainer
from .reconstruct import Reconstruct

__all__ = ["BaseTrainer", "DDPMTrainer", "Reconstruct"]
