"""ddpm_ood_tpu_torch: the PyTorch/CUDA port of ddpm_ood_tpu for NVIDIA Hopper.

It imports ``torch`` and never JAX. Its layout mirrors the JAX package, which
stays the reference the port is tested against. The first slice is OOD
scoring: ``python -m ddpm_ood_tpu_torch.reconstruct``.
"""

__version__ = "0.1.0"
