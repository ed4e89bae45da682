"""Pix2Pix-style PatchGAN discriminator (2D or 3D) for VQ-VAE training.

Port of ``ddpm_ood_tpu/models/discriminator.py``: ``layer_0`` is a
kernel-4, stride-2 convolution with bias and a LeakyReLU(0.2); layers 1 to
``num_layers_d - 1`` are bias-free kernel-4 convolutions (stride 2, the last
stride 1) with channels doubling up to 512, each followed by BatchNorm and
LeakyReLU; ``final_conv`` maps to ``out_channels`` logits. Padding is 1
everywhere. The call returns the list of feature maps with the logits last
(fp32), as the JAX package's does. Module names follow the JAX package's
(``layer_{i}``, ``norm_{i}``, ``final_conv``), so
``utils/convert.py:jax_discriminator_params_to_state_dict`` is a renaming.

BatchNorm is Flax's, not torch's: in train mode it normalises with the
batch mean and the biased batch variance E[x^2] - E[x]^2 (clipped at 0) in
fp32, and updates the running statistics as ``m * running + (1 - m) *
batch`` with m = 0.9 and the same biased variance (torch's ``BatchNorm``
keeps m = 0.1 for the new value and the unbiased variance); in eval mode it
normalises with the running statistics. Under torchrun the train-mode mean
and E[x^2] are taken over the global batch (a differentiable all-reduce over
the processes, whose batches are equal), as BatchNorm over the JAX
package's batch-sharded mesh takes them.

``init_like_flax_`` draws Flax's default initialisation from a torch
generator: lecun-normal kernels (truncated normal, std sqrt(1 / fan_in)),
zero biases, BatchNorm scales 1 and offsets 0.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import process_count

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}


def _global_means(mean: torch.Tensor, mean_sq: torch.Tensor):
    """The means over every process's equal batch, differentiably: the
    backward all-reduces the gradients, so each process's D gradient holds
    the paths through the other processes' losses."""
    from torch.distributed.nn.functional import all_reduce

    both = all_reduce(torch.stack([mean, mean_sq])) / process_count()
    return both[0], both[1]


class FlaxBatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum, epsilon, dtype=float32)`` on
    (B, C, *spatial): ``weight`` is Flax's ``scale``, ``bias`` its
    ``bias``, ``running_mean`` / ``running_var`` its batch_stats."""

    def __init__(self, channels: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            if self.training:
                dims = [0] + list(range(2, x.dim()))
                mean, mean_sq = xf.mean(dims), (xf * xf).mean(dims)
                if process_count() > 1:
                    mean, mean_sq = _global_means(mean, mean_sq)
                var = (mean_sq - mean * mean).clamp_min(0.0)
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
            else:
                mean, var = self.running_mean, self.running_var
            shape = (1, -1) + (1,) * (x.dim() - 2)
            mul = torch.rsqrt(var + self.epsilon) * self.weight
            return (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class PatchDiscriminator(nn.Module):
    def __init__(self, spatial_dims: int = 2, num_layers_d: int = 3, num_channels: int = 64,
                 in_channels: int = 1, out_channels: int = 1, kernel_size: int = 4,
                 negative_slope: float = 0.2):
        super().__init__()
        if spatial_dims not in (2, 3):
            raise ValueError(f"spatial_dims must be 2 or 3, got {spatial_dims}")
        conv = _CONV[spatial_dims]
        self.num_layers_d, self.negative_slope = num_layers_d, negative_slope
        ch = num_channels
        self.layer_0 = conv(in_channels, ch, kernel_size, stride=2, padding=1)
        for i in range(1, num_layers_d):
            out = min(ch * 2, 512)
            stride = 2 if i < num_layers_d - 1 else 1
            self.add_module(f"layer_{i}", conv(ch, out, kernel_size, stride=stride, padding=1,
                                               bias=False))
            self.add_module(f"norm_{i}", FlaxBatchNorm(out))
            ch = out
        self.final_conv = conv(ch, out_channels, kernel_size, stride=1, padding=1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, C, *spatial) -> [features of each layer..., logits (fp32)]."""
        h = F.leaky_relu(self.layer_0(x), self.negative_slope)
        feats = [h]
        for i in range(1, self.num_layers_d):
            h = getattr(self, f"norm_{i}")(getattr(self, f"layer_{i}")(h))
            h = F.leaky_relu(h, self.negative_slope)
            feats.append(h)
        logits = self.final_conv(h)
        feats.append(logits.to(torch.promote_types(logits.dtype, torch.float32)))
        return feats


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """Fill `t` with Flax's lecun_normal draw: a normal of std sqrt(1 /
    fan_in) truncated at two standard deviations and rescaled to that std,
    by the inverse CDF of uniforms from `generator`."""
    std_correction = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    std = math.sqrt(1.0 / fan_in) / std_correction
    u = lo + (hi - lo) * torch.rand(t.shape, generator=generator)
    return t.copy_(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0) * std)


@torch.no_grad()
def init_like_flax_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's default initialisation of every convolution (lecun-normal
    kernels with the fan-in of Flax's (*k, I, O) kernel, zero biases) and
    of every ``FlaxBatchNorm`` (scale 1, offset 0) in `model`, in module
    order. Transposed convolutions take the fan-in of the JAX package's
    ``ConvTransposeTorchLike`` kernel, (*k, in, out)."""
    for module in model.modules():
        if isinstance(module, nn.modules.conv._ConvNd):
            w = module.weight  # (O, I, *k); transposed: (I, O, *k)
            fan_in = math.prod(w.shape[2:]) * w.shape[0 if module.transposed else 1]
            lecun_normal_(w, fan_in, generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, FlaxBatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model
