from .sweep import ReconProgram, ddim_sweep, dpm_sweep, group_t_starts, plms_sweep

__all__ = ["ReconProgram", "ddim_sweep", "dpm_sweep", "group_t_starts", "plms_sweep"]
