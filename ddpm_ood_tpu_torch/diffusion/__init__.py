from .ddpm import ddpm_sample, ddpm_step
from .plms import PLMSState, plms_init_state, plms_step, pndm_start_points, pndm_timesteps
from .schedules import NoiseSchedule, add_noise, make_schedule, training_target

__all__ = [
    "NoiseSchedule",
    "PLMSState",
    "add_noise",
    "ddpm_sample",
    "ddpm_step",
    "make_schedule",
    "plms_init_state",
    "plms_step",
    "pndm_start_points",
    "pndm_timesteps",
    "training_target",
]
