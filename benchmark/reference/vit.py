"""Plain DINOv2 ViT forward in float32, from a state dict of the public
checkpoints' keys.  Independent of the program: plain torch operations, no
kernel, no cache, no batching beyond one image at a time, TF32 off.

It follows DINOv2's ``vision_transformer.py`` (patch-14 conv embedding, cls
token, pre-norm blocks with LayerScale, GELU MLP, final LayerNorm), with two
departures that the configuration names, because they are the arithmetic of
the system under test (and of the JAX package it was ported from):

* ``gelu``: "tanh" is the tanh approximation of GELU; "erf" is DINOv2's own.
* ``pos_embed_resize``: "keys_bicubic" resizes the 37 x 37 position grid
  with Keys' cubic (a = -0.5), half-pixel centres and, when shrinking, a
  kernel widened by the scale, each output's weights normalised to one;
  DINOv2 calls ``F.interpolate(mode="bicubic")`` (a = -0.75).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def full_f32():
    """TF32 off for matrix products and convolutions while inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def keys_cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) resize weights along one axis, in float64."""
    scale = n_out / n_in
    support = max(1.0 / scale, 1.0)
    centres = (np.arange(n_out) + 0.5) / scale - 0.5
    x = np.abs(centres[:, None] - np.arange(n_in)[None, :]) / support
    w = np.where(x < 1.0, (1.5 * x - 2.5) * x * x + 1.0,
                 np.where(x < 2.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, 0.0))
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (centres >= -0.5) & (centres <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0)


def position_embedding(pos_embed: torch.Tensor, gh: int, gw: int, grid: int) -> torch.Tensor:
    d = pos_embed.shape[-1]
    patch = pos_embed[0, 1:].reshape(grid, grid, d)
    if (gh, gw) != (grid, grid):
        wh = torch.from_numpy(keys_cubic_weights(grid, gh)).float().to(pos_embed.device)
        ww = torch.from_numpy(keys_cubic_weights(grid, gw)).float().to(pos_embed.device)
        patch = torch.einsum("hH,HWd,wW->hwd", wh, patch, ww)
    return torch.cat([pos_embed[0, :1], patch.reshape(gh * gw, d)], dim=0)


def _ln(x, w, p: str, eps: float):
    return F.layer_norm(x, (x.shape[-1],), w[p + ".weight"], w[p + ".bias"], eps)


def _lin(x, w, p: str):
    return x @ w[p + ".weight"].T + w[p + ".bias"]


def attention(x: torch.Tensor, w: dict, p: str, heads: int, heads_at_once: int = 4):
    """Softmax attention of one image's tokens (N, D), a few heads at a time
    so that the (heads, N, N) scores fit."""
    n, d = x.shape
    hd = d // heads
    qkv = _lin(x, w, p + ".qkv").reshape(n, 3, heads, hd).permute(1, 2, 0, 3)
    q, k, v = qkv[0], qkv[1], qkv[2]
    out = torch.empty(heads, n, hd, device=x.device, dtype=x.dtype)
    for h in range(0, heads, heads_at_once):
        s = (q[h:h + heads_at_once] * hd**-0.5) @ k[h:h + heads_at_once].transpose(-1, -2)
        out[h:h + heads_at_once] = torch.softmax(s, dim=-1) @ v[h:h + heads_at_once]
        del s
    return _lin(out.permute(1, 0, 2).reshape(n, d), w, p + ".proj")


def features(image_u8: torch.Tensor, w: dict, cfg: dict) -> torch.Tensor:
    """One (H, W, 3) uint8 image -> (gh, gw, D) final-norm patch tokens, f32."""
    p = cfg["patch_size"]
    heads, eps = cfg["num_heads"], cfg["layer_norm_eps"]
    mean = torch.tensor(IMAGENET_MEAN, device=image_u8.device)
    std = torch.tensor(IMAGENET_STD, device=image_u8.device)
    with full_f32():
        x = (image_u8.float() / 255.0 - mean) / std
        h, wd = x.shape[0] // p, x.shape[1] // p
        t = F.conv2d(x.permute(2, 0, 1)[None], w["patch_embed.proj.weight"],
                     w["patch_embed.proj.bias"], stride=p)[0]
        t = t.flatten(1).T
        t = torch.cat([w["cls_token"][0], t], dim=0)
        t = t + position_embedding(w["pos_embed"], h, wd, cfg["pos_embed_grid"])
        approx = "tanh" if cfg["gelu"] == "tanh" else "none"
        for i in range(cfg["num_hidden_layers"]):
            b = f"blocks.{i}"
            t = t + w[b + ".ls1.gamma"] * attention(_ln(t, w, b + ".norm1", eps), w,
                                                     b + ".attn", heads)
            m = F.gelu(_lin(_ln(t, w, b + ".norm2", eps), w, b + ".mlp.fc1"),
                       approximate=approx)
            t = t + w[b + ".ls2.gamma"] * _lin(m, w, b + ".mlp.fc2")
        t = _ln(t, w, "norm", eps)
    return t[1:].reshape(h, wd, -1)
