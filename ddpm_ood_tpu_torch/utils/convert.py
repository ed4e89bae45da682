"""Convert the JAX package's UNet, VQ-VAE and LPIPS params into the port's
state_dicts.

A port of the flax -> torch direction of
``ddpm_ood_tpu/utils/convert_torch.py`` (``flax_to_torch_unet``,
``flax_to_torch_vqvae``, ``_module_spec``, ``_vqvae_plan``, ``_to_torch``),
numpy only. Conv kernels go from (*k, I, O) to (O, I, *k) in 2D and 3D
alike (HWIO -> OIHW, DHWIO -> OIDHW). It does not import
``ddpm_ood_tpu.utils``, whose package init needs JAX.

Input: the UNet params as a nested mapping of arrays (``{"conv_in":
{"kernel", "bias"}, "down_0_res_0": {"norm1": {"scale", "bias"}, ...}, ...}``),
for example an Orbax checkpoint's ``model_state_dict`` restored and turned
into numpy on a host with JAX. Output: a flat {key: fp32 tensor} dict with
monai-generative names, which ``DiffusionModelUNet.load_state_dict`` takes
with ``strict=True``. ``jax_lpips_params_to_state_dict`` does the same for
the LPIPS params that the JAX package's ``save_lpips_npz`` writes,
``jax_vqvae_params_to_state_dict`` for a VQ-VAE's params and EMA codebook,
and ``jax_discriminator_params_to_state_dict`` for a PatchGAN
discriminator's params and BatchNorm statistics.
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
    if kind == "convtranspose" and t.ndim > 1:
        # the JAX package's lhs-dilated conv kernel (*k, I, O) holds the taps
        # of torch's ConvTranspose (I, O, *k) spatially flipped
        t = t[(slice(None, None, -1),) * (t.ndim - 2)]
        return np.transpose(t, (t.ndim - 2, t.ndim - 1) + tuple(range(t.ndim - 2)))
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


def _vqvae_plan(params: Mapping) -> List[Tuple[str, str, str, str]]:
    """[(side, flax module path, torch key prefix, kind)] for every conv of
    the JAX VQ-VAE's params, in monai-generative's flat ``blocks`` layout.
    The encoder's levels each open with a strided conv (``Conv_{i}``) and
    its residual units follow; a last conv maps to the embedding. The
    decoder opens with a conv, then each level's residual units and its
    transposed conv."""
    def num(name: str) -> int:
        return int(name.rsplit("_", 1)[1])

    plan = []
    for side in ("encoder", "decoder"):
        mods = params[side]
        convs = sorted((n for n in mods if n.startswith("Conv_")), key=num)
        res = sorted((n for n in mods if "ResidualUnit" in n), key=num)
        trans = sorted((n for n in mods if "ConvTranspose" in n), key=num)
        n_levels = len(convs) - 1 if side == "encoder" else len(trans)
        r = len(res) // max(n_levels, 1)
        first_res = 1  # block index of a level's first residual unit, past its opening conv
        if side == "encoder":
            plan += [(side, c, f"{side}.blocks.{i * (r + 1)}.conv", "conv")
                     for i, c in enumerate(convs)]
        else:
            plan.append((side, convs[0], f"{side}.blocks.0.conv", "conv"))
            plan += [(side, t, f"{side}.blocks.{1 + i * (r + 1) + r}.conv", "convtranspose")
                     for i, t in enumerate(trans)]
        for k, unit in enumerate(res):
            level, j = divmod(k, max(r, 1))
            b = level * (r + 1) + first_res + j
            plan += [(side, f"{unit}/Conv_0", f"{side}.blocks.{b}.conv1.conv", "conv"),
                     (side, f"{unit}/Conv_1", f"{side}.blocks.{b}.conv2.conv", "conv")]
    return plan


# the JAX quantizer's "ema" leaves -> monai-generative's keys
_QUANTIZER_KEYS = {
    "embedding": "quantizer.quantizer.embedding.weight",
    "cluster_size": "quantizer.quantizer.ema_cluster_size",
    "embed_avg": "quantizer.quantizer.ema_w",
}


def jax_vqvae_params_to_state_dict(params: Mapping, ema: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX VQ-VAE's ``params`` and ``ema`` collections -> the port's fp32
    state_dict in monai-generative's keys, which ``models.vqvae.VQVAE``
    takes with ``strict=True`` (and so does a reference ``VQVAE``)."""
    out: Dict[str, np.ndarray] = {}
    for side, path, prefix, kind in _vqvae_plan(params):
        node = params[side]
        for part in path.split("/"):
            node = node[part]
        out[f"{prefix}.weight"] = _to_torch(node["kernel"], kind)
        out[f"{prefix}.bias"] = np.asarray(node["bias"])
    for leaf, key in _QUANTIZER_KEYS.items():
        out[key] = np.asarray(ema["quantizer"][leaf])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def jax_discriminator_params_to_state_dict(params: Mapping, batch_stats: Mapping
                                           ) -> Dict[str, torch.Tensor]:
    """The JAX ``PatchDiscriminator``'s ``params`` (``layer_{i}`` /
    ``final_conv`` kernels and biases, ``norm_{i}`` scales and biases) and
    ``batch_stats`` (``norm_{i}`` mean and var) -> the fp32 state_dict of
    the port's ``models.discriminator.PatchDiscriminator``."""
    out: Dict[str, np.ndarray] = {}
    for name, leaves in params.items():
        if name.startswith("norm_"):
            out[f"{name}.weight"] = np.asarray(leaves["scale"])
            out[f"{name}.bias"] = np.asarray(leaves["bias"])
            out[f"{name}.running_mean"] = np.asarray(batch_stats[name]["mean"])
            out[f"{name}.running_var"] = np.asarray(batch_stats[name]["var"])
        else:
            out[f"{name}.weight"] = _to_torch(leaves["kernel"], "conv")
            if "bias" in leaves:
                out[f"{name}.bias"] = np.asarray(leaves["bias"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def load_params_npz(path) -> dict:
    """A params tree saved flat in an npz, one array per "/"-joined path
    ("down_0_res_0/conv1/kernel" -> tree["down_0_res_0"]["conv1"]["kernel"]),
    as nested dicts of numpy arrays."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key])
    return out


_LPIPS_CONVS = ("conv0", "conv3", "conv6", "conv8", "conv10")


def jax_lpips_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPS params (``{"params": {"net": {"conv0": {"kernel",
    "bias"}, ...}, "lin0": (C, 1), ...}}``, or the inner ``"params"`` tree) ->
    the state_dict of the port's ``losses.lpips.LPIPS``: conv kernels HWIO ->
    OIHW, ``lin`` (C, 1) -> (1, C, 1, 1)."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for name in _LPIPS_CONVS:
        conv = p["net"][name]
        out[f"net.{name}.weight"] = _to_torch(conv["kernel"], "conv")
        out[f"net.{name}.bias"] = np.asarray(conv["bias"])
    for i in range(len(_LPIPS_CONVS)):
        w = np.asarray(p[f"lin{i}"])
        out[f"lin{i}.weight"] = w.reshape(1, w.shape[0], 1, 1)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}
