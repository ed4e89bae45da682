from .ddpm import DDPMTrainStep

__all__ = ["DDPMTrainStep"]
