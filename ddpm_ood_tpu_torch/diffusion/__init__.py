from .plms import PLMSState, plms_init_state, plms_step, pndm_start_points, pndm_timesteps
from .schedules import NoiseSchedule, add_noise, make_schedule

__all__ = [
    "NoiseSchedule",
    "PLMSState",
    "add_noise",
    "make_schedule",
    "plms_init_state",
    "plms_step",
    "pndm_start_points",
    "pndm_timesteps",
]
