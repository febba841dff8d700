"""Parameter conversion and checkpoint loading for the backbone and the
trainable heads.

Counterpart of ``vit_colmap_tpu/models/convert.py``:

* :func:`jax_dinov2_to_torch` carries the flax ``DinoV2`` param tree (as
  numpy arrays; GELU or SwiGLU MLP, optional register tokens) into the
  port's ``state_dict``, whose keys are the public DINOv2 checkpoint keys;
* :func:`jax_feature_heads_to_torch` carries the flax ``FeatureHeads`` tree
  (norm "group" or "none") into the port's heads ``state_dict``;
* :func:`load_torch_feature_model` reads the reference's trained ``.pt``
  (torch ``ViTFeatureModel``, BatchNorm heads) natively and folds each
  eval-mode BatchNorm into its conv, for the norm-free ("none") heads.

Layouts: Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in); Conv
``kernel`` HWIO -> Conv2d ``weight`` OIHW; ConvTranspose ``kernel`` HWIO ->
ConvTranspose2d ``weight`` (in, out, kh, kw) spatially flipped; LayerNorm
and GroupNorm ``scale`` -> ``weight``; LayerScale ``gamma`` as is.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

_PREFIXES = ("model.", "_orig_mod.", "module.")


def _numpy_state_dict(sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


def jax_dinov2_to_torch(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax ``{"params": {...}}`` (or the inner dict) -> torch state dict."""
    p = params.get("params", params)
    sd: dict[str, Any] = {}

    def dense(prefix: str, d: Mapping[str, Any]) -> None:
        sd[f"{prefix}.weight"] = np.asarray(d["kernel"]).T
        sd[f"{prefix}.bias"] = d["bias"]

    def layernorm(prefix: str, d: Mapping[str, Any]) -> None:
        sd[f"{prefix}.weight"] = d["scale"]
        sd[f"{prefix}.bias"] = d["bias"]

    sd["patch_embed.proj.weight"] = np.asarray(p["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
    sd["patch_embed.proj.bias"] = p["patch_embed"]["bias"]
    sd["cls_token"] = p["cls_token"]
    sd["pos_embed"] = p["pos_embed"]
    if "register_tokens" in p:
        sd["register_tokens"] = p["register_tokens"]
    depth = sum(1 for k in p if k.startswith("blocks_"))
    for i in range(depth):
        blk = p[f"blocks_{i}"]
        b = f"blocks.{i}"
        layernorm(f"{b}.norm1", blk["norm1"])
        dense(f"{b}.attn.qkv", blk["attn"]["qkv"])
        dense(f"{b}.attn.proj", blk["attn"]["proj"])
        sd[f"{b}.ls1.gamma"] = blk["ls1"]["gamma"]
        layernorm(f"{b}.norm2", blk["norm2"])
        for name in ("w12", "w3") if "w12" in blk["mlp"] else ("fc1", "fc2"):
            dense(f"{b}.mlp.{name}", blk["mlp"][name])
        sd[f"{b}.ls2.gamma"] = blk["ls2"]["gamma"]
    layernorm("norm", p["norm"])
    return _numpy_state_dict(sd)


def jax_feature_heads_to_torch(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax ``FeatureHeads`` tree (``{"params": ...}``, the inner dict, or a
    whole ``ViTFeatureModel`` tree with ``heads``) -> the port's
    ``FeatureHeads`` state dict.  flax's ConvTranspose correlates with its
    kernel where torch's convolves, so the kernel is flipped spatially."""
    p = params.get("params", params)
    p = p.get("heads", p)
    sd: dict[str, Any] = {}

    def conv(prefix: str, d: Mapping[str, Any]) -> None:
        sd[f"{prefix}.weight"] = np.asarray(d["kernel"]).transpose(3, 2, 0, 1)
        sd[f"{prefix}.bias"] = d["bias"]

    for up in ("up1", "up2"):
        blk = p[up]
        deconv = np.asarray(blk["ConvTranspose_0"]["kernel"])[::-1, ::-1]
        sd[f"{up}.deconv.weight"] = deconv.transpose(2, 3, 0, 1)
        sd[f"{up}.deconv.bias"] = blk["ConvTranspose_0"]["bias"]
        conv(f"{up}.conv", blk["Conv_0"])
        if "GroupNorm_0" in blk:
            sd[f"{up}.norm.weight"] = blk["GroupNorm_0"]["scale"]
            sd[f"{up}.norm.bias"] = blk["GroupNorm_0"]["bias"]
    for name in ("trunk", "kp1", "kp2", "desc1", "desc2"):
        conv(name, p[name])
    return _numpy_state_dict(sd)


def fold_batchnorm(conv_w: torch.Tensor, conv_b: torch.Tensor, bn: Mapping[str, torch.Tensor],
                   eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """An eval-mode BatchNorm folded into the conv before it (OIHW weight):
    w' = w * s, b' = (b - mean) * s + beta, s = gamma / sqrt(var + eps)."""
    s = bn["weight"] / torch.sqrt(bn["running_var"] + eps)
    return conv_w * s[:, None, None, None], (conv_b - bn["running_mean"]) * s + bn["bias"]


def _strip_prefixes(key: str) -> str:
    for pre in _PREFIXES:
        if key.startswith(pre):
            key = key[len(pre):]
    return key


def torch_feature_heads_to_port(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The reference ``ViTFeatureModel``'s heads (``upsampler.{0,1}.{deconv,
    conv,bn}``, ``trunk.{0 conv,1 bn}``, ``keypoint_head.{0 conv,1 bn,3
    conv}``, ``descriptor_head.{0 conv,1 bn,3 conv}``) -> the port's
    norm-free heads, every BatchNorm folded into its conv."""
    sd = {k: v.detach().float().cpu() for k, v in state_dict.items()}

    def conv(prefix: str):
        return sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]

    def bn(prefix: str) -> dict[str, torch.Tensor]:
        return {k: sd[f"{prefix}.{k}"] for k in ("weight", "bias", "running_mean",
                                                 "running_var")}

    out: dict[str, torch.Tensor] = {}

    def put(name: str, wb) -> None:
        out[f"{name}.weight"], out[f"{name}.bias"] = (t.contiguous() for t in wb)

    for i, up in ((0, "up1"), (1, "up2")):
        put(f"{up}.deconv", conv(f"upsampler.{i}.deconv"))
        put(f"{up}.conv", fold_batchnorm(*conv(f"upsampler.{i}.conv"),
                                         bn(f"upsampler.{i}.bn")))
    put("trunk", fold_batchnorm(*conv("trunk.0"), bn("trunk.1")))
    for head, first, second in (("keypoint_head", "kp1", "kp2"),
                                ("descriptor_head", "desc1", "desc2")):
        put(first, fold_batchnorm(*conv(f"{head}.0"), bn(f"{head}.1")))
        put(second, conv(f"{head}.3"))
    return out


def load_torch_feature_model(
    path: str,
) -> tuple[dict[str, torch.Tensor], Optional[dict[str, torch.Tensor]]]:
    """A reference trained ``.pt`` in any of its three layouts
    (``{"model_state_dict": ...}``, ``{"state_dict": ...}`` or the raw state
    dict), the heads' keys with or without a ``model.`` / ``_orig_mod.`` /
    ``module.`` prefix -> (the port's norm-free heads state dict, the
    embedded DINOv2 ``backbone.*`` state dict with the prefix removed, or
    None).  As in the JAX package, ``backbone.*`` is split off before the
    prefixes are stripped: a prefixed backbone key is not restored."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        sd = ckpt["model_state_dict"]
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
    else:
        sd = ckpt
    backbone = {k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")}
    heads = torch_feature_heads_to_port(
        {_strip_prefixes(k): v for k, v in sd.items() if not k.startswith("backbone.")})
    return heads, backbone or None


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A ``.pt``/``.pth`` DINOv2 state dict (optionally wrapped in
    ``{"model": ...}`` or ``{"state_dict": ...}``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd
