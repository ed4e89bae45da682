from .simplex import Simplex, generate_simplex_noise, simplex_noise_device

__all__ = ["Simplex", "generate_simplex_noise", "simplex_noise_device"]
