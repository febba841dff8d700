"""Flax -> PyTorch parameter conversion for the DINOv2 backbone.

Counterpart (inverse direction) of ``vit_colmap_tpu/models/convert.py``:
carries the flax ``DinoV2`` param tree, as numpy arrays, into the port's
``state_dict``, whose keys are the public DINOv2 checkpoint keys.  Pure key
mapping and transposes:

* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
* Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW;
* LayerNorm ``scale`` -> ``weight``;
* LayerScale ``gamma`` as is.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def jax_dinov2_to_torch(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax ``{"params": {...}}`` (or the inner dict) -> torch state dict."""
    p = params.get("params", params)
    sd: dict[str, np.ndarray] = {}

    def put(key: str, value) -> None:
        sd[key] = np.ascontiguousarray(np.asarray(value, dtype=np.float32))

    def dense(prefix: str, d: Mapping[str, Any]) -> None:
        put(f"{prefix}.weight", np.asarray(d["kernel"]).T)
        put(f"{prefix}.bias", d["bias"])

    def layernorm(prefix: str, d: Mapping[str, Any]) -> None:
        put(f"{prefix}.weight", d["scale"])
        put(f"{prefix}.bias", d["bias"])

    put("patch_embed.proj.weight",
        np.asarray(p["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    put("patch_embed.proj.bias", p["patch_embed"]["bias"])
    put("cls_token", p["cls_token"])
    put("pos_embed", p["pos_embed"])
    if "register_tokens" in p:
        raise NotImplementedError("register tokens are not ported yet")
    depth = sum(1 for k in p if k.startswith("blocks_"))
    for i in range(depth):
        blk = p[f"blocks_{i}"]
        b = f"blocks.{i}"
        layernorm(f"{b}.norm1", blk["norm1"])
        dense(f"{b}.attn.qkv", blk["attn"]["qkv"])
        dense(f"{b}.attn.proj", blk["attn"]["proj"])
        put(f"{b}.ls1.gamma", blk["ls1"]["gamma"])
        layernorm(f"{b}.norm2", blk["norm2"])
        if "fc1" not in blk["mlp"]:
            raise NotImplementedError("SwiGLU MLP (vitg14) is not ported yet")
        dense(f"{b}.mlp.fc1", blk["mlp"]["fc1"])
        dense(f"{b}.mlp.fc2", blk["mlp"]["fc2"])
        put(f"{b}.ls2.gamma", blk["ls2"]["gamma"])
    layernorm("norm", p["norm"])
    return {k: torch.from_numpy(v.copy()) for k, v in sd.items()}


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A ``.pt``/``.pth`` DINOv2 state dict (optionally wrapped in
    ``{"model": ...}`` or ``{"state_dict": ...}``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd
