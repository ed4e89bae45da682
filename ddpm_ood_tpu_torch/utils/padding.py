"""torch.nn.functional.pad-style latent padding on channel-last tensors.

Port of ``ddpm_ood_tpu/utils/padding.py``. ``--latent_pad`` takes a torch
``pad`` tuple: (before, after) pairs starting from the LAST spatial axis of
a channel-first tensor. The same tuple applies here to (B, *spatial, C)
tensors: the pairs still run over the spatial axes from last to first.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def pad_pairs(pad: Sequence[int], spatial: int) -> List[Tuple[int, int]]:
    """(before, after) per spatial axis, in axis order, from a torch-style
    flat tuple (last axis first); axes the tuple does not reach get (0, 0)."""
    pairs = [(int(pad[2 * i]), int(pad[2 * i + 1])) for i in range(len(pad) // 2)]
    if len(pairs) > spatial:
        raise ValueError(f"pad tuple {tuple(pad)} longer than spatial rank {spatial}")
    return [(0, 0)] * (spatial - len(pairs)) + pairs[::-1]


def padded_shape(spatial: Sequence[int], pad: Sequence[int]) -> Tuple[int, ...]:
    """The spatial shape after ``pad_torch_style``."""
    return tuple(s + lo + hi for s, (lo, hi) in zip(spatial, pad_pairs(pad, len(spatial))))


def pad_torch_style(x: torch.Tensor, pad: Sequence[int]) -> torch.Tensor:
    """Zero-pad x (B, *spatial, C) by a torch-style tuple over its spatial axes."""
    flat: List[int] = [0, 0]  # F.pad runs from the last axis: C first
    for lo, hi in reversed(pad_pairs(pad, x.dim() - 2)):
        flat += [lo, hi]
    return F.pad(x, flat)


def unpad_torch_style(x: torch.Tensor, pad: Sequence[int],
                      spatial: Optional[int] = None) -> torch.Tensor:
    """The inverse of ``pad_torch_style`` on x (B, *spatial, C), as a view.
    With `spatial` given, x may carry more leading axes, (K, B, *spatial, C)
    lane stacks for example; the pad applies to the `spatial` axes before C."""
    spatial = x.dim() - 2 if spatial is None else spatial
    index = [slice(None)] * (x.dim() - spatial - 1)
    for axis, (lo, hi) in enumerate(pad_pairs(pad, spatial)):
        index.append(slice(lo, x.shape[len(index)] - hi))
    return x[tuple(index)]
