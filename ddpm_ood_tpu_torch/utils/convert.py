"""Convert the JAX package's UNet params into the port's state_dict.

A port of the flax -> torch direction of
``ddpm_ood_tpu/utils/convert_torch.py`` (``flax_to_torch_unet``,
``_module_spec``, ``_to_torch``), numpy only. It does not import
``ddpm_ood_tpu.utils``, whose package init needs JAX.

Input: the UNet params as a nested mapping of arrays (``{"conv_in":
{"kernel", "bias"}, "down_0_res_0": {"norm1": {"scale", "bias"}, ...}, ...}``),
for example an Orbax checkpoint's ``model_state_dict`` restored and turned
into numpy on a host with JAX. Output: a flat {key: fp32 tensor} dict with
monai-generative names, which ``DiffusionModelUNet.load_state_dict`` takes
with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

# leaf kind -> (flax leaf name -> torch leaf name)
_LEAF_NAMES = {
    "conv": {"kernel": "weight", "bias": "bias"},
    "linear": {"kernel": "weight", "bias": "bias"},
    "norm": {"scale": "weight", "bias": "bias"},
}
_RES = {
    "norm1": ("norm1", "norm"),
    "conv1": ("conv1.conv", "conv"),
    "time_emb_proj": ("time_emb_proj", "linear"),
    "norm2": ("norm2", "norm"),
    "conv2": ("conv2.conv", "conv"),
    "skip_connection": ("skip_connection.conv", "conv"),
}
_ATTN = {
    "norm": ("norm", "norm"),
    "to_q": ("to_q", "linear"),
    "to_k": ("to_k", "linear"),
    "to_v": ("to_v", "linear"),
    "proj_attn": ("proj_attn", "linear"),
}


def _module_spec(name: str) -> Tuple[str, Dict[str, Tuple[str, str]]]:
    """(torch prefix, {flax submodule: (torch sub-prefix, kind)}) for one
    top-level flax module of the UNet."""
    plain = {
        "time_embed_0": ("time_embed.0", "linear"),
        "time_embed_2": ("time_embed.2", "linear"),
        "conv_in": ("conv_in.conv", "conv"),
        "conv_out": ("out.2.conv", "conv"),
        "norm_out": ("out.0", "norm"),
    }
    if name in plain:
        prefix, kind = plain[name]
        return prefix, {"": ("", kind)}
    fixed = {"mid_res_0": ("middle_block.resnet_1", _RES),
             "mid_res_1": ("middle_block.resnet_2", _RES),
             "mid_attn": ("middle_block.attention", _ATTN)}
    if name in fixed:
        return fixed[name]
    parts = name.split("_")
    if len(parts) == 4 and parts[0] in ("down", "up"):
        side, level, kind, j = parts
        if kind == "res":
            return f"{side}_blocks.{level}.resnets.{j}", _RES
        if kind == "attn":
            return f"{side}_blocks.{level}.attentions.{j}", _ATTN
    if len(parts) == 3 and parts[0] == "down" and parts[2] == "downsample":
        return f"down_blocks.{parts[1]}", {"conv": ("downsampler.op.conv", "conv")}
    if len(parts) == 3 and parts[0] == "up" and parts[2] == "upsample":
        return f"up_blocks.{parts[1]}", {"conv": ("upsampler.conv.conv", "conv")}
    raise KeyError(f"No torch mapping for UNet module {name!r}")


def _to_torch(t: np.ndarray, kind: str) -> np.ndarray:
    t = np.asarray(t)
    if kind == "conv" and t.ndim > 1:
        return np.transpose(t, (t.ndim - 1, t.ndim - 2) + tuple(range(t.ndim - 2)))  # (*k, I, O) -> (O, I, *k)
    if kind == "linear" and t.ndim == 2:
        return t.T  # (I, O) -> (O, I)
    return t


def jax_unet_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax UNet params -> the port's fp32 state_dict (monai-generative keys)."""
    out: Dict[str, torch.Tensor] = {}
    for mod_name, leaves in params.items():
        prefix, submods = _module_spec(mod_name)
        first = next(iter(leaves.values()))
        if isinstance(first, Mapping):  # res / attn blocks: {submodule: {leaf: array}}
            items: List[Tuple[str, str, object]] = [
                (sub, leaf, v) for sub, sl in leaves.items() for leaf, v in sl.items()
            ]
        else:  # a plain conv / dense / norm module: {leaf: array}
            items = [("", leaf, v) for leaf, v in leaves.items()]
        for sub, leaf, value in items:
            torch_sub, kind = submods[sub]
            key = ".".join(p for p in (prefix, torch_sub, _LEAF_NAMES[kind][leaf]) if p)
            arr = np.ascontiguousarray(_to_torch(value, kind), dtype=np.float32)
            out[key] = torch.from_numpy(arr)
    return out
