"""Plain DINOv2 ViT forward in float32 with either MLP form and register
tokens, from a state dict of the public checkpoints' keys.  Independent of
the program: plain torch operations, no kernel, no cache, no batching
beyond one image at a time, TF32 off, attention a few heads at a time.

It follows DINOv2's ``vision_transformer.py``: patch-14 conv embedding, cls
token, the position embedding added, then ``num_register_tokens`` register
tokens inserted between the cls token and the patches (they take no
position embedding), pre-norm blocks with LayerScale, a final LayerNorm,
and the output's patch tokens with the cls and register tokens dropped.
The configuration's ``mlp`` picks the MLP:

* ``gelu``: ``fc1``, GELU (the configuration's ``gelu``, as in
  ``reference/vit.py``), ``fc2``;
* ``swiglu``: DINOv2's ``SwiGLUFFNFused``: ``w12`` maps the width to twice
  the hidden width, the block takes ``silu`` of its first half times its
  second half, and ``w3`` maps the hidden width back.

Its one departure is the one the configurations name: ``pos_embed_resize``
"keys_bicubic", Keys' cubic a = -0.5 (``reference/vit.py``), where DINOv2
calls ``F.interpolate(mode="bicubic")`` (a = -0.75).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.vit import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    _lin,
    _ln,
    attention,
    full_f32,
    position_embedding,
)


def embed(image_u8: torch.Tensor, w: dict, cfg: dict) -> torch.Tensor:
    """One (H, W, 3) uint8 image -> the first block's input (1 + R + N, D):
    cls, registers, patches."""
    p = cfg["patch_size"]
    mean = torch.tensor(IMAGENET_MEAN, device=image_u8.device)
    std = torch.tensor(IMAGENET_STD, device=image_u8.device)
    x = (image_u8.float() / 255.0 - mean) / std
    h, wd = x.shape[0] // p, x.shape[1] // p
    t = F.conv2d(x.permute(2, 0, 1)[None], w["patch_embed.proj.weight"],
                 w["patch_embed.proj.bias"], stride=p)[0]
    t = torch.cat([w["cls_token"][0], t.flatten(1).T], dim=0)
    t = t + position_embedding(w["pos_embed"], h, wd, cfg["pos_embed_grid"])
    if cfg["num_register_tokens"]:
        t = torch.cat([t[:1], w["register_tokens"][0], t[1:]], dim=0)
    return t


def mlp(x: torch.Tensor, w: dict, p: str, cfg: dict) -> torch.Tensor:
    """The block's MLP at prefix ``p`` (``blocks.<i>.mlp``)."""
    if cfg["mlp"] == "swiglu":
        first, second = _lin(x, w, p + ".w12").chunk(2, dim=-1)
        return _lin(F.silu(first) * second, w, p + ".w3")
    approx = "tanh" if cfg["gelu"] == "tanh" else "none"
    return _lin(F.gelu(_lin(x, w, p + ".fc1"), approximate=approx), w, p + ".fc2")


def features(image_u8: torch.Tensor, w: dict, cfg: dict) -> torch.Tensor:
    """One (H, W, 3) uint8 image -> (gh, gw, D) final-norm patch tokens, f32."""
    p, heads, eps = cfg["patch_size"], cfg["num_heads"], cfg["layer_norm_eps"]
    gh, gw = image_u8.shape[0] // p, image_u8.shape[1] // p
    with full_f32():
        t = embed(image_u8, w, cfg)
        for i in range(cfg["num_hidden_layers"]):
            b = f"blocks.{i}"
            t = t + w[b + ".ls1.gamma"] * attention(_ln(t, w, b + ".norm1", eps), w,
                                                     b + ".attn", heads)
            t = t + w[b + ".ls2.gamma"] * mlp(_ln(t, w, b + ".norm2", eps), w, b + ".mlp", cfg)
        t = _ln(t, w, "norm", eps)
    return t[1 + cfg["num_register_tokens"]:].reshape(gh, gw, -1)
