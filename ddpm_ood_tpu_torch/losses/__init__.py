from .lpips import LPIPS, PerceptualLoss, load_lpips_state_dict, pad_to_min_32

__all__ = ["LPIPS", "PerceptualLoss", "load_lpips_state_dict", "pad_to_min_32"]
