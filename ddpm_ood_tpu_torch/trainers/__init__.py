from .base import BaseTrainer
from .reconstruct import Reconstruct

__all__ = ["BaseTrainer", "Reconstruct"]
