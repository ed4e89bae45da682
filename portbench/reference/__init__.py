"""Plain PyTorch reference of what the benchmark's cells run.

Written from the published descriptions (monai-generative's
DiffusionModelUNet and VQVAE, PNDM's PLMS, DPM-Solver++(2M), LPIPS v0.1
with AlexNet, SSIM, DDPM's epsilon loss and Adam), in float32 and
channels-first layout, as functions of a state dict in monai-generative's
key names. It imports nothing of the measured package: the benchmark makes
the weights and inputs and hands the same to both sides.

``ops.Ops`` carries the convolution and matrix-product operand rounding: none
for the reference itself, float8 or int4 for the precision controls.
"""
