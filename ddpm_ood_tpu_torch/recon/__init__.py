from .sweep import ReconProgram, group_t_starts, plms_sweep

__all__ = ["ReconProgram", "group_t_starts", "plms_sweep"]
