"""DINOv2 Vision Transformer backbone in PyTorch.

Counterpart of ``vit_colmap_tpu/models/dinov2.py``: patch-14 conv
embedding, cls token, pre-norm blocks with LayerScale, GELU MLP and a final
LayerNorm in f32.  Parameters live in f32 and the blocks compute in
``cfg.dtype`` (bf16 by default), as the flax model does.  The state-dict
keys are those of the public DINOv2 checkpoints (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,ls1,
norm2,mlp.fc1,mlp.fc2,ls2}``, ``norm``).

Input is (B, H, W, 3) normalized images, H and W multiples of 14, the JAX
package's layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vit_colmap_tpu_torch.kernels import attention as attention_kernel

PATCH_SIZE = 14

VIT_CONFIGS = {
    "vits14": dict(embed_dim=384, depth=12, num_heads=6, mlp_ratio=4.0, swiglu=False),
    "vitb14": dict(embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0, swiglu=False),
    "vitl14": dict(embed_dim=1024, depth=24, num_heads=16, mlp_ratio=4.0, swiglu=False),
    "vitg14": dict(
        embed_dim=1536, depth=40, num_heads=24, mlp_ratio=8 / 3, swiglu=True
    ),
}

# Smallest sequence that takes the attention kernel; shorter ones run eager,
# as in the reference's ``Attention``.
KERNEL_MIN_TOKENS = 1024


@dataclass(frozen=True)
class ViTConfig:
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    swiglu: bool = False
    patch_size: int = PATCH_SIZE
    num_register_tokens: int = 0
    layerscale_init: float = 1e-5
    ln_eps: float = 1e-6
    pretrain_grid: int = 37  # grid the pretrained pos-embed was trained at
    dtype: torch.dtype = torch.bfloat16
    quantize: str = "none"
    # "fixedmax_fused" (kernel 1 under the reference's gate) or "xla"
    # (eager softmax).  "fixedmax", "flash" and "auto" are not ported yet,
    # so the default is "fixedmax_fused" where the reference's is "auto".
    attn_impl: str = "fixedmax_fused"
    gelu: str = "tanh"  # "tanh" (approximate) | "erf" (exact, torch nn.GELU)

    @classmethod
    def named(cls, name: str, **overrides) -> "ViTConfig":
        if name not in VIT_CONFIGS:
            raise ValueError(f"Unknown backbone {name!r}; options: {list(VIT_CONFIGS)}")
        return cls(**{**VIT_CONFIGS[name], **overrides})


_NOT_PORTED = ("fixedmax", "flash", "auto")


def _check_supported(c: ViTConfig) -> None:
    if c.swiglu:
        raise NotImplementedError("SwiGLU (vitg14) is not ported yet; see ROADMAP.md")
    if c.num_register_tokens:
        raise NotImplementedError("register tokens are not ported yet; see ROADMAP.md")
    if c.quantize != "none":
        raise NotImplementedError("quantize='int8' is not ported yet; see ROADMAP.md")
    if c.attn_impl in _NOT_PORTED:
        raise NotImplementedError(
            f"attn_impl={c.attn_impl!r} is not ported yet (use 'fixedmax_fused' "
            "or 'xla'); see ROADMAP.md"
        )
    if c.attn_impl not in ("fixedmax_fused", "xla"):
        raise ValueError(f"unknown attn_impl {c.attn_impl!r}")
    if c.gelu not in ("tanh", "erf"):
        raise ValueError(f"unknown gelu {c.gelu!r}")


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    # Statistics in f32, result in ``dtype`` (flax LayerNorm with dtype=bf16).
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return y.to(dtype)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = nn.Linear(cfg.embed_dim, 3 * cfg.embed_dim)
        self.proj = nn.Linear(cfg.embed_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, N, D = x.shape
        head_dim = c.embed_dim // c.num_heads
        qkv = _linear(x, self.qkv, c.dtype)
        if (
            c.attn_impl == "fixedmax_fused"
            and head_dim == 64
            and c.num_heads % 2 == 0
            and N >= KERNEL_MIN_TOKENS
        ):
            out = attention_kernel.attention_qkv(
                qkv.contiguous(), c.num_heads, head_dim**-0.5
            )
            return _linear(out, self.proj, c.dtype)
        q, k, v = qkv.reshape(B, N, 3, c.num_heads, head_dim).permute(2, 0, 3, 1, 4)
        attn = (q * head_dim**-0.5) @ k.transpose(-1, -2)
        attn = torch.softmax(attn.float(), dim=-1).to(c.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, D)
        return _linear(out, self.proj, c.dtype)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.fc1 = nn.Linear(cfg.embed_dim, hidden)
        self.fc2 = nn.Linear(hidden, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        h = _linear(x, self.fc1, c.dtype)
        h = F.gelu(h, approximate="none" if c.gelu == "erf" else "tanh")
        return _linear(h, self.fc2, c.dtype)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.ls1 = LayerScale(cfg.embed_dim, cfg.layerscale_init)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.mlp = Mlp(cfg)
        self.ls2 = LayerScale(cfg.embed_dim, cfg.layerscale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = x + self.ls1(self.attn(_layer_norm(x, self.norm1, dt)))
        return x + self.ls2(self.mlp(_layer_norm(x, self.norm2, dt)))


def keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic convolution kernel with a = -0.5 on |x| (float32)."""
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1.0, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0), out)
    return np.where(x >= 2.0, f(0.0), out).astype(f)


def bicubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.resize(..., "bicubic")`` along
    one axis: half-pixel centres, Keys a = -0.5, the kernel stretched by
    n_in / n_out when downsampling (antialiasing), columns normalized to 1.
    Computed in float32 in the same order as JAX, so the weights agree to
    the last bit or so (``F.interpolate`` uses a = -0.75 and differs)."""
    f = np.float32
    inv = f(1.0 / (n_out / n_in))
    kernel_scale = max(inv, f(1.0))
    sample = (np.arange(n_out, dtype=f) + f(0.5)) * inv - f(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f)[:, None]) / kernel_scale
    w = keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f).eps,
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f(0.0)).T


def interpolate_pos_embed(
    pos_embed: torch.Tensor, grid_h: int, grid_w: int, pretrain_grid: int
) -> torch.Tensor:
    """Bicubic-resize the patch position embeddings to a (grid_h, grid_w)
    grid, with the reference's weights.  (1, 1 + g*g, D) -> (1, 1 + gh*gw, D)."""
    cls_pe = pos_embed[:, :1]
    d = pos_embed.shape[-1]
    patch = pos_embed[:, 1:].reshape(pretrain_grid, pretrain_grid, d).float()
    if (grid_h, grid_w) != (pretrain_grid, pretrain_grid):
        dev = pos_embed.device
        wh = torch.from_numpy(bicubic_weights(pretrain_grid, grid_h)).float().to(dev)
        ww = torch.from_numpy(bicubic_weights(pretrain_grid, grid_w)).float().to(dev)
        patch = torch.einsum("hH,HWd,wW->hwd", wh, patch, ww)
    patch = patch.reshape(1, grid_h * grid_w, d)
    return torch.cat([cls_pe.float(), patch], dim=1)


class DinoV2(nn.Module):
    """DINOv2 ViT.  Input: (B, H, W, 3) normalized images, H/W multiples of 14."""

    def __init__(self, cfg: ViTConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, d, cfg.patch_size, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pretrain_grid**2, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random init with the flax model's distributions (lecun-normal
        Dense/Conv kernels, zero biases, pos_embed N(0, 0.02), zero cls,
        LayerScale at ``layerscale_init``).  Not the same numbers as flax:
        parity tests carry parameters across with ``convert``."""
        def lecun(w: torch.Tensor, fan_in: int) -> None:
            w.normal_(0.0, fan_in**-0.5, generator=generator)

        p = self.cfg.patch_size
        lecun(self.patch_embed.proj.weight, 3 * p * p)
        self.patch_embed.proj.bias.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.cls_token.zero_()
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun(m.weight, m.in_features)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, LayerScale):
                m.gamma.fill_(self.cfg.layerscale_init)

    def forward(self, x: torch.Tensor) -> dict:
        c = self.cfg
        B, H, W, _ = x.shape
        gh, gw = H // c.patch_size, W // c.patch_size
        pe = self.patch_embed.proj
        t = F.conv2d(
            x.permute(0, 3, 1, 2).to(c.dtype), pe.weight.to(c.dtype),
            pe.bias.to(c.dtype), stride=c.patch_size,
        )
        t = t.flatten(2).transpose(1, 2)  # (B, gh*gw, D)
        pos = interpolate_pos_embed(self.pos_embed, gh, gw, c.pretrain_grid)
        cls = self.cls_token.to(c.dtype).expand(B, -1, -1)
        t = torch.cat([cls, t], dim=1) + pos.to(c.dtype)
        for blk in self.blocks:
            t = blk(t)
        t = F.layer_norm(t.float(), self.norm.normalized_shape, self.norm.weight,
                         self.norm.bias, self.norm.eps)
        return {
            "x_norm_clstoken": t[:, 0],
            "x_norm_patchtokens": t[:, 1:],
            "grid": (gh, gw),
        }


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess(images_uint8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB -> ImageNet-normalized float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=images_uint8.device)
    std = torch.tensor(IMAGENET_STD, device=images_uint8.device)
    return (images_uint8.float() / 255.0 - mean) / std


def patch_grid_size(h: int, w: int, patch: int = PATCH_SIZE) -> tuple[int, int]:
    """Largest patch-aligned size <= (h, w)."""
    return max(h // patch, 1) * patch, max(w // patch, 1) * patch


def make_backbone(
    name: str = "vitb14",
    dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "fixedmax_fused",
    quantize: str = "none",
    generator: Optional[torch.Generator] = None,
) -> tuple[DinoV2, ViTConfig]:
    cfg = ViTConfig.named(name, dtype=dtype, attn_impl=attn_impl, quantize=quantize)
    return DinoV2(cfg, generator=generator), cfg

