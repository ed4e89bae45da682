"""ddpm_ood_tpu_torch: the PyTorch/CUDA port of ddpm_ood_tpu for NVIDIA Hopper.

It imports ``torch`` and never JAX, nor anything of the JAX package. Its
layout mirrors the JAX package, which stays the reference the port is tested
against. It serves OOD scoring (``python -m ddpm_ood_tpu_torch.reconstruct``),
its AUROCs (``python -m ddpm_ood_tpu_torch.ood_detection``), DDPM training
in 2D and 3D, in pixel space or on VQ-VAE latents (``python -m
ddpm_ood_tpu_torch.train_ddpm``), VQ-VAE + PatchGAN training (``python -m
ddpm_ood_tpu_torch.train_vqvae``), the online scoring service (``python -m
ddpm_ood_tpu_torch.serve``), sample generation (``python -m
ddpm_ood_tpu_torch.sample``), dataset prep (``python -m
ddpm_ood_tpu_torch.data.get_*``) and the pipeline scripts: the demo
(``python -m ddpm_ood_tpu_torch.demo``), the 3D latent-diffusion smoke
(``smoke_3d_ldm``), the parity run and report (``parity_run``,
``parity_report``) and the library example (``minimal_library_usage``).
"""

__version__ = "0.1.0"
