"""VQ-VAE (2D or 3D) with an EMA codebook, with monai-generative
state_dict names.

Port of ``ddpm_ood_tpu/models/vqvae.py`` (``ConvTransposeTorchLike``,
``VQVAEResidualUnit``, ``Encoder``, ``Decoder``, ``EMAQuantizer``, ``VQVAE``):
the stage-2 API ``encode_stage_2_inputs`` / ``decode_stage_2_outputs`` and
``reconstruct`` that scoring and latent diffusion training use, and the
training forward of stage 1 (``train/vqvae.py``): the commitment loss, the
straight-through estimator and the EMA codebook update.

Module names follow monai-generative's ``VQVAE``, so a reference ``.pth``
loads with ``strict=True``: ``encoder.blocks.{b}`` and ``decoder.blocks.{b}``
are flat lists of convolutions (weights at ``.conv``) and residual units
(``.conv1.conv``, ``.conv2.conv``); the codebook and its EMA statistics are
``quantizer.quantizer.{embedding.weight, ema_cluster_size, ema_w}``.
``utils/convert.py:jax_vqvae_params_to_state_dict`` writes these keys from
the JAX package's params.

Training: the codebook is EMA state, not a parameter (the JAX package keeps
it in the non-gradient "ema" collection), so ``embedding.weight`` is a
buffer and no optimizer sees it. In train mode the quantizer gathers each
forward's code counts and sums, taken with the codebook it quantized
against; ``ema_update`` folds everything gathered since the last update
into the EMA once, so k microbatches of a batch update the codebook exactly
as the whole batch would. ``remat=True`` recomputes each residual unit in
the backward pass (``torch.utils.checkpoint``), as the JAX package wraps
``VQVAEResidualUnit`` in ``nn.remat``; it changes memory, never values.

Layout: (B, C, *spatial) tensors, best in ``models.unet.memory_format``
(channels-last). The decoder's transposed convolutions are
``nn.ConvTranspose{2,3}d``, whose output size is the one the JAX package's
``ConvTransposeTorchLike`` reproduces: (in - 1) * stride - 2 * padding +
dilation * (kernel - 1) + output_padding + 1.

Precision: on CUDA the caller runs the encoder and decoder under bf16
autocast, as the JAX package runs them in bf16 on its accelerator. The
quantizer always runs in fp32 with autocast off: its argmin over the
codebook decides which code a latent becomes, and one flipped index changes
a decoded region by a lot, not by rounding. The distances are
|x|^2 - 2 x.e + |e|^2 in the JAX package's order, and ties go to the lowest
index in both packages.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import all_reduce_sum_, process_count

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_T = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}


class _Conv(nn.Module):
    """A conv wrapped one level deep, for monai's ``.conv`` key segment."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class VQVAEResidualUnit(nn.Module):
    """relu(x + conv2(relu(conv1(x)))), 3x3(x3) convolutions, 'same' padding."""

    def __init__(self, dims: int, channels: int, res_channels: int):
        super().__init__()
        self.conv1 = _Conv(_CONV[dims](channels, res_channels, 3, padding=1))
        self.conv2 = _Conv(_CONV[dims](res_channels, channels, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x + self.conv2(F.relu(self.conv1(x))))


def _run_blocks(blocks: nn.ModuleList, relu_after: set, x: torch.Tensor,
                remat: bool) -> torch.Tensor:
    """The blocks in order, a ReLU after those in `relu_after`; with `remat`
    (and autograd recording) each residual unit is recomputed in the
    backward pass instead of keeping its activations."""
    remat = remat and torch.is_grad_enabled()
    for b, block in enumerate(blocks):
        if remat and isinstance(block, VQVAEResidualUnit):
            x = checkpoint(block, x, use_reentrant=False)
        else:
            x = block(x)
        if b in relu_after:
            x = F.relu(x)
    return x


class Encoder(nn.Module):
    """Per level: a strided conv (the level's (stride, kernel, dilation,
    padding)) and ReLU, then ``num_res_layers`` residual units; last, a 3x3
    conv to ``embedding_dim`` channels."""

    def __init__(self, dims: int, in_channels: int, out_channels: int,
                 num_channels: Sequence[int], num_res_channels: Sequence[int],
                 num_res_layers: int, downsample_parameters: Sequence[Tuple[int, ...]]):
        super().__init__()
        blocks = []
        ch = in_channels
        for i, out_ch in enumerate(num_channels):
            stride, kernel, dilation, pad = downsample_parameters[i]
            blocks.append(_Conv(_CONV[dims](ch, out_ch, kernel, stride=stride,
                                            dilation=dilation, padding=pad)))
            blocks += [VQVAEResidualUnit(dims, out_ch, num_res_channels[i])
                       for _ in range(num_res_layers)]
            ch = out_ch
        blocks.append(_Conv(_CONV[dims](ch, out_channels, 3, padding=1)))
        self.blocks = nn.ModuleList(blocks)
        self._relu_after = {i * (num_res_layers + 1) for i in range(len(num_channels))}
        self.remat = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _run_blocks(self.blocks, self._relu_after, x, self.remat)


class Decoder(nn.Module):
    """A 3x3 conv and ReLU from ``embedding_dim`` channels, then per level (in
    reverse): ``num_res_layers`` residual units and a transposed conv (the
    level's (stride, kernel, dilation, padding, output_padding)), with a ReLU
    after every transposed conv but the last."""

    def __init__(self, dims: int, in_channels: int, out_channels: int,
                 num_channels: Sequence[int], num_res_channels: Sequence[int],
                 num_res_layers: int, upsample_parameters: Sequence[Tuple[int, ...]]):
        super().__init__()
        rev_ch = list(reversed(num_channels))
        rev_res_ch = list(reversed(num_res_channels))
        rev_up = list(reversed(upsample_parameters))
        n = len(rev_ch)
        blocks = [_Conv(_CONV[dims](in_channels, rev_ch[0], 3, padding=1))]
        self._relu_after = {0}
        for i in range(n):
            blocks += [VQVAEResidualUnit(dims, rev_ch[i], rev_res_ch[i])
                       for _ in range(num_res_layers)]
            stride, kernel, dilation, pad, out_pad = rev_up[i]
            last = i == n - 1
            blocks.append(_Conv(_CONV_T[dims](
                rev_ch[i], out_channels if last else rev_ch[i + 1], kernel, stride=stride,
                padding=pad, output_padding=out_pad, dilation=dilation)))
            if not last:
                self._relu_after.add(len(blocks) - 1)
        self.blocks = nn.ModuleList(blocks)
        self.remat = False

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return _run_blocks(self.blocks, self._relu_after, z, self.remat)


class _Codebook(nn.Module):
    """The codebook as the buffer ``weight``: monai's ``embedding.weight``
    key, drawn as ``nn.Embedding`` draws it (a unit normal)."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.register_buffer("weight", torch.randn(num_embeddings, embedding_dim))


class EMAQuantizer(nn.Module):
    """The codebook (``embedding.weight``, (num_embeddings, embedding_dim))
    and its EMA statistics (``ema_cluster_size``, ``ema_w``: the JAX
    package's ``cluster_size`` and ``embed_avg``), all buffers."""

    def __init__(self, num_embeddings: int, embedding_dim: int, commitment_cost: float = 0.25,
                 decay: float = 0.99, epsilon: float = 1e-5):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.commitment_cost, self.decay, self.epsilon = commitment_cost, decay, epsilon
        self.embedding = _Codebook(num_embeddings, embedding_dim)
        self.register_buffer("ema_cluster_size", torch.zeros(num_embeddings))
        self.register_buffer("ema_w", self.embedding.weight.clone())
        # (counts, sums) gathered in train mode since the last ema_update
        self._stats = None

    def forward(self, z: torch.Tensor):
        """z (B, C, *spatial) -> (quantized (z's shape and dtype), commitment
        loss, indices (B, *spatial)), in fp32 (fp64 for fp64 z) with
        autocast off. The
        quantized tensor is z + detach(e[idx] - z), the JAX package's
        straight-through form: its values round as JAX's do, and its
        gradient is the identity to z. The loss is commitment_cost *
        mean((e[idx] - z)^2), whose gradient reaches z only."""
        with torch.autocast(z.device.type, enabled=False):
            zl = z.movedim(1, -1)  # (B, *spatial, C): a view for channels-last z
            flat = zl.reshape(-1, self.embedding_dim)
            flat = flat.to(torch.promote_types(flat.dtype, torch.float32))
            e = self.embedding.weight.to(flat.dtype)
            with torch.no_grad():
                dist = (torch.sum(flat ** 2, dim=1, keepdim=True) - 2.0 * (flat @ e.t())
                        + torch.sum(e ** 2, dim=1)[None, :])
                idx = torch.argmin(dist, dim=1)
                if self.training:
                    self._gather(flat, idx)
            quantized = e[idx].view(zl.shape)
            loss = self.commitment_cost * torch.mean((quantized - zl.to(flat.dtype)) ** 2)
            out = zl + (quantized.to(z.dtype) - zl).detach()
        return out.movedim(-1, 1), loss, idx.view(zl.shape[:-1])

    def _gather(self, flat: torch.Tensor, idx: torch.Tensor) -> None:
        counts = torch.bincount(idx, minlength=self.num_embeddings).to(flat.dtype)
        sums = torch.zeros_like(self.ema_w).index_add_(0, idx, flat)
        if self._stats is not None:
            counts, sums = counts + self._stats[0], sums + self._stats[1]
        self._stats = (counts, sums)

    @torch.no_grad()
    def ema_update(self) -> None:
        """Fold the gathered counts and sums into the EMA statistics and
        recompute the codebook from them with Laplace smoothing
        (``ddpm_ood_tpu/models/vqvae.py``'s train branch); a no-op when
        nothing was gathered. Under torchrun the counts and sums are summed
        over the processes first, so the statistics are the global batch's,
        as the JAX package computes them and as monai's ``ddp_sync`` does,
        and every process's codebook stays the same."""
        if self._stats is None:
            return
        counts, sums = self._stats
        self._stats = None
        if process_count() > 1:
            flat = all_reduce_sum_(torch.cat([counts[:, None], sums], dim=1))
            counts, sums = flat[:, 0], flat[:, 1:]
        d = self.decay
        cs = d * self.ema_cluster_size + (1.0 - d) * counts
        ea = d * self.ema_w + (1.0 - d) * sums
        total = torch.sum(cs)
        smoothed = (cs + self.epsilon) / (total + self.num_embeddings * self.epsilon) * total
        self.ema_cluster_size.copy_(cs)
        self.ema_w.copy_(ea)
        self.embedding.weight.copy_(ea / smoothed[:, None])


class _QuantizerWrapper(nn.Module):
    """monai-generative's ``VQVAE.quantizer`` level, for the key prefix."""

    def __init__(self, quantizer: EMAQuantizer):
        super().__init__()
        self.quantizer = quantizer

    def forward(self, z: torch.Tensor):
        return self.quantizer(z)


class VQVAE(nn.Module):
    """The stage-1 model of latent diffusion. Constructor arguments are the
    keys of the reference's ``vqvae_config.json`` (``dropout`` acts only in
    training, where ``train/vqvae.py`` refuses it, and ``ddp_sync`` is
    accepted for the file's sake: the codebook statistics are always summed
    over the processes, as in the JAX package), plus ``remat``, which is not
    part of the file."""

    def __init__(
        self,
        spatial_dims: int = 2,
        in_channels: int = 1,
        out_channels: int = 1,
        num_res_layers: int = 3,
        downsample_parameters: Sequence[Tuple[int, int, int, int]] = ((2, 4, 1, 1),) * 4,
        upsample_parameters: Sequence[Tuple[int, int, int, int, int]] = ((2, 4, 1, 1, 0),) * 4,
        num_channels: Sequence[int] = (128, 128, 128, 256),
        num_res_channels: Sequence[int] = (128, 128, 128, 256),
        num_embeddings: int = 256,
        embedding_dim: int = 256,
        decay: float = 0.99,
        commitment_cost: float = 0.25,
        epsilon: float = 1e-5,
        dropout: float = 0.0,
        ddp_sync: bool = True,
        remat: bool = False,
    ):
        super().__init__()
        if spatial_dims not in (2, 3):
            raise ValueError(f"spatial_dims must be 2 or 3, got {spatial_dims}")
        self.spatial_dims = spatial_dims
        self.encoder = Encoder(spatial_dims, in_channels, embedding_dim, num_channels,
                               num_res_channels, num_res_layers, downsample_parameters)
        self.decoder = Decoder(spatial_dims, embedding_dim, out_channels, num_channels,
                               num_res_channels, num_res_layers, upsample_parameters)
        self.encoder.remat = self.decoder.remat = remat
        self.quantizer = _QuantizerWrapper(
            EMAQuantizer(num_embeddings, embedding_dim, commitment_cost, decay, epsilon))

    def forward(self, images: torch.Tensor):
        """(reconstruction, commitment loss)."""
        quantized, loss, _ = self.quantizer(self.encoder(images))
        return self.decoder(quantized), loss

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        return self.encoder(images)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def encode_stage_2_inputs(self, images: torch.Tensor) -> torch.Tensor:
        return self.quantizer(self.encoder(images))[0]

    def decode_stage_2_outputs(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.quantizer(z)[0])

    def reconstruct(self, images: torch.Tensor) -> torch.Tensor:
        return self(images)[0]

