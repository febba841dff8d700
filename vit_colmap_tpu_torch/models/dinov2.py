"""DINOv2 Vision Transformer backbone in PyTorch.

Counterpart of ``vit_colmap_tpu/models/dinov2.py``: patch-14 conv
embedding, cls (+ optional register) tokens, pre-norm blocks with
LayerScale, GELU MLP (SwiGLU for vitg14 and vitg14_reg) and a final
LayerNorm in f32.
Parameters live in f32 and the blocks compute in ``cfg.dtype`` (bf16 by
default), as the flax model does; ``quantize="int8"`` runs the transformer
matmuls through :class:`QuantDense`.  The state-dict keys are those of the
public DINOv2 checkpoints (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``register_tokens``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,
ls1,norm2,mlp.fc1,mlp.fc2 | mlp.w12,mlp.w3,ls2}``, ``norm``).

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

from vit_colmap_tpu_torch.device import exact_f32_convolutions
from vit_colmap_tpu_torch.kernels import add_norm as add_norm_kernel
from vit_colmap_tpu_torch.kernels import attention as attention_kernel
from vit_colmap_tpu_torch.utils.profiling import span

PATCH_SIZE = 14

VIT_CONFIGS = {
    "vits14": dict(embed_dim=384, depth=12, num_heads=6, mlp_ratio=4.0, swiglu=False),
    "vitb14": dict(embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0, swiglu=False),
    "vitl14": dict(embed_dim=1024, depth=24, num_heads=16, mlp_ratio=4.0, swiglu=False),
    # The JAX package's ViT-g/14 (SwiGLU 2,736, 0.886 B parameters), kept for
    # parity with it; it is not the public model, which is vitg14_reg.
    "vitg14": dict(
        embed_dim=1536, depth=40, num_heads=24, mlp_ratio=8 / 3, swiglu=True
    ),
    # The public DINOv2 ViT-g/14 with registers (hub ``dinov2_vitg14_reg``,
    # ``vit_giant2`` with ``ffn_layer="swiglufused"``): SwiGLU 4,096 from
    # mlp_ratio 4 by ``swiglu_hidden``, 4 registers, 1,136,485,376 parameters.
    "vitg14_reg": dict(
        embed_dim=1536, depth=40, num_heads=24, mlp_ratio=4.0, swiglu=True,
        num_register_tokens=4,
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
    # "auto" (PyTorch's fused attention on the GPU for long sequences),
    # "xla" (eager softmax), "flash" (fused attention on the GPU), or the
    # inference-only fixed-max kernels: "fixedmax" (kernel 3, head-major)
    # and "fixedmax_fused" (kernel 1, packed qkv).  See ``Attention``.
    attn_impl: str = "auto"
    gelu: str = "tanh"  # "tanh" (approximate) | "erf" (exact, torch nn.GELU)

    @classmethod
    def named(cls, name: str, **overrides) -> "ViTConfig":
        if name not in VIT_CONFIGS:
            raise ValueError(f"Unknown backbone {name!r}; options: {list(VIT_CONFIGS)}")
        return cls(**{**VIT_CONFIGS[name], **overrides})


ATTN_IMPLS = ("auto", "xla", "flash", "fixedmax", "fixedmax_fused")


def _check_supported(c: ViTConfig) -> None:
    if c.quantize not in ("none", "int8"):
        raise ValueError(f"unknown quantize {c.quantize!r}; options: none, int8")
    if c.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {c.attn_impl!r}; options: {ATTN_IMPLS}")
    if c.gelu not in ("tanh", "erf"):
        raise ValueError(f"unknown gelu {c.gelu!r}")


class QuantDense(nn.Linear):
    """int8 dense layer: per-output-channel int8 weights, a dynamic
    per-tensor int8 activation scale, an int32 product
    (``torch._int_mm``) and f32 dequantization, as the reference's
    ``QuantDense``.  Its parameters are ``nn.Linear``'s, so every
    checkpoint path is untouched; the weights are quantized at each call.
    Inference only (rounding has no gradient).  On the card ``_int_mm``
    takes k and n multiples of 8."""

    def weight_int8(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(out, in) int8 weights and their (out,) f32 scales max|W|/127,
        rounded half to even."""
        w = self.weight.float()
        s_w = torch.clamp_min(w.abs().amax(dim=1), 1e-12) / 127.0
        return torch.round(w / s_w[:, None]).to(torch.int8), s_w

    def accumulate(self, x: torch.Tensor):
        """(..., in) -> the int32 products (M, out) of the int8 activations
        and weights, the activation scale (over the whole of ``x``, so it
        depends on the batch) and the weight scales."""
        w8, s_w = self.weight_int8()
        xf = x.float().reshape(-1, x.shape[-1])
        s_x = torch.clamp_min(xf.abs().amax(), 1e-12) / 127.0
        x8 = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
        m = x8.shape[0]
        if m <= 16:  # the card's int8 product takes more than 16 rows
            x8 = F.pad(x8, (0, 0, 0, 17 - m))
        return torch._int_mm(x8, w8.t())[:m], s_x, s_w

    def quantized(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        acc, s_x, s_w = self.accumulate(x)
        y = acc.float() * (s_x * s_w) + self.bias.float()
        return y.reshape(*x.shape[:-1], self.out_features).to(dtype)


def _dense(c: ViTConfig, in_features: int, out_features: int) -> nn.Linear:
    """nn.Linear, or QuantDense for ``quantize="int8"``."""
    return (QuantDense if c.quantize == "int8" else nn.Linear)(in_features, out_features)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(layer, QuantDense):
        return layer.quantized(x, dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class LayerScale(nn.Module):
    """The per-channel ``gamma`` a block's branch is scaled by before the
    residual add, which :func:`_add_norm` applies."""

    def __init__(self, dim: int, init: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))


def _add_norm(x: torch.Tensor, branch: Optional[torch.Tensor], ls: Optional[LayerScale],
              norm: nn.LayerNorm, out_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """One block boundary: the residual stream ``x + ls(branch)`` (``x``
    without a branch) and ``norm`` of it in ``out_dtype``, statistics in f32
    (flax LayerNorm with dtype=bf16), by the add-and-norm kernel where
    :func:`~vit_colmap_tpu_torch.kernels.add_norm.takes_kernel` says so (a
    bf16 stream on the card whose forward records no gradient), by its
    plain version otherwise."""
    gamma = None if ls is None else ls.gamma
    args = (x, branch, gamma, norm.weight, norm.bias, norm.eps, out_dtype)
    if add_norm_kernel.takes_kernel(*args[:5]):
        return add_norm_kernel.add_norm(*args)
    return add_norm_kernel.add_norm_plain(*args)


def _use_sdpa(impl: str, n_tokens: int, device: torch.device) -> bool:
    """Where the reference takes JAX's library flash kernel (on its
    accelerator only), the port takes PyTorch's fused attention (on CUDA
    only): always for "flash", from KERNEL_MIN_TOKENS tokens for the rest."""
    if impl == "xla" or device.type != "cuda":
        return False
    return impl == "flash" or n_tokens >= KERNEL_MIN_TOKENS


class Attention(nn.Module):
    """Multi-head self-attention.  ``attn_impl`` picks the softmax, with the
    reference's gates: "fixedmax_fused" takes kernel 1 and "fixedmax" kernel
    3 for the head layouts each kernel takes (``takes_attention_qkv``,
    ``takes_fixed_max_attention``) and N >= KERNEL_MIN_TOKENS; otherwise (and for
    "auto" and "flash") :func:`_use_sdpa` decides between PyTorch's fused
    attention and eager softmax."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.qkv = _dense(cfg, cfg.embed_dim, 3 * cfg.embed_dim)
        self.proj = _dense(cfg, cfg.embed_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, N, D = x.shape
        head_dim = c.embed_dim // c.num_heads
        qkv = _linear(x, self.qkv, c.dtype)
        if (
            c.attn_impl == "fixedmax_fused"
            and attention_kernel.takes_attention_qkv(c.embed_dim, c.num_heads)
            and N >= KERNEL_MIN_TOKENS
        ):
            out = attention_kernel.attention_qkv(
                qkv.contiguous(), c.num_heads, head_dim**-0.5
            )
            return _linear(out, self.proj, c.dtype)
        q, k, v = qkv.reshape(B, N, 3, c.num_heads, head_dim).permute(2, 0, 3, 1, 4)
        if (
            c.attn_impl == "fixedmax"
            and attention_kernel.takes_fixed_max_attention(head_dim)
            and N >= KERNEL_MIN_TOKENS
        ):
            out = attention_kernel.fixed_max_attention(q, k, v, head_dim**-0.5)
        elif _use_sdpa(c.attn_impl, N, x.device):
            out = F.scaled_dot_product_attention(q, k, v, scale=head_dim**-0.5)
        else:
            attn = (q * head_dim**-0.5) @ k.transpose(-1, -2)
            attn = torch.softmax(attn.float(), dim=-1).to(c.dtype)
            out = attn @ v
        return _linear(out.transpose(1, 2).reshape(B, N, D), self.proj, c.dtype)


def swiglu_hidden(cfg: ViTConfig) -> int:
    """The SwiGLU hidden width, by the JAX package's rule, which is
    DINOv2's ``SwiGLUFFNFused``: 2/3 of int(embed_dim * mlp_ratio), rounded
    up to a multiple of 8 (2736 for vitg14 at mlp_ratio 8/3; 4096 for
    vitg14_reg at mlp_ratio 4, the public ViT-g/14's width)."""
    return (int(int(cfg.embed_dim * cfg.mlp_ratio) * 2 / 3) + 7) // 8 * 8


class Mlp(nn.Module):
    """GELU MLP (fc1, fc2), or for ``swiglu`` the fused SwiGLU (w12, w3):
    silu of w12's first half times its second half."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        if cfg.swiglu:
            hidden = swiglu_hidden(cfg)
            self.w12 = _dense(cfg, d, 2 * hidden)
            self.w3 = _dense(cfg, hidden, d)
        else:
            hidden = int(d * cfg.mlp_ratio)
            self.fc1 = _dense(cfg, d, hidden)
            self.fc2 = _dense(cfg, hidden, d)

    @span("vc.backbone.mlp")
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        if c.swiglu:
            x1, x2 = _linear(x, self.w12, c.dtype).chunk(2, dim=-1)
            return _linear(F.silu(x1) * x2, self.w3, c.dtype)
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

    def forward(self, x: torch.Tensor, h: torch.Tensor, next_norm: nn.LayerNorm,
                out_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """The block on the residual stream ``x`` and ``h = norm1(x)``:
        returns the new stream and ``next_norm`` of it in ``out_dtype`` (the
        next block's ``norm1``, or the backbone's final ``norm``), each of
        its two boundaries one :func:`_add_norm`."""
        x, h = _add_norm(x, self.attn(h), self.ls1, self.norm2, self.cfg.dtype)
        return _add_norm(x, self.mlp(h), self.ls2, next_norm, out_dtype)


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
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random init with the flax model's distributions (lecun-normal
        Dense/Conv kernels, zero biases, pos_embed N(0, 0.02), zero cls and
        register tokens, LayerScale at ``layerscale_init``).  Not the same
        numbers as flax: parity tests carry parameters across with
        ``convert``."""
        def lecun(w: torch.Tensor, fan_in: int) -> None:
            w.normal_(0.0, fan_in**-0.5, generator=generator)

        p = self.cfg.patch_size
        lecun(self.patch_embed.proj.weight, 3 * p * p)
        self.patch_embed.proj.bias.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.cls_token.zero_()
        if self.cfg.num_register_tokens:
            self.register_tokens.zero_()
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
        with exact_f32_convolutions():  # no TF32 when c.dtype is f32
            t = F.conv2d(
                x.permute(0, 3, 1, 2).to(c.dtype), pe.weight.to(c.dtype),
                pe.bias.to(c.dtype), stride=c.patch_size,
            )
        t = t.flatten(2).transpose(1, 2)  # (B, gh*gw, D)
        pos = interpolate_pos_embed(self.pos_embed, gh, gw, c.pretrain_grid)
        cls = self.cls_token.to(c.dtype).expand(B, -1, -1)
        t = torch.cat([cls, t], dim=1) + pos.to(c.dtype)
        if c.num_register_tokens:  # between cls and the patches, after the pos-embed
            reg = self.register_tokens.to(c.dtype).expand(B, -1, -1)
            t = torch.cat([t[:, :1], reg, t[:, 1:]], dim=1)
        # 1 + 2 * depth boundaries: norm1 of the tokens, then two a block,
        # the last one into the final norm's f32.
        norms = [blk.norm1 for blk in self.blocks] + [self.norm]
        out_dtypes = [c.dtype] * c.depth + [torch.float32]
        x, t = _add_norm(t, None, None, norms[0], out_dtypes[0])
        for blk, norm, out_dtype in zip(self.blocks, norms[1:], out_dtypes[1:]):
            x, t = blk(x, t, norm, out_dtype)
        return {
            "x_norm_clstoken": t[:, 0],
            "x_norm_patchtokens": t[:, 1 + c.num_register_tokens:],
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
    num_register_tokens: Optional[int] = None,
    attn_impl: str = "auto",
    quantize: str = "none",
    generator: Optional[torch.Generator] = None,
) -> tuple[DinoV2, ViTConfig]:
    """The backbone ``name`` of ``VIT_CONFIGS``, with the table's register
    count unless ``num_register_tokens`` is given."""
    regs = {} if num_register_tokens is None else {"num_register_tokens": num_register_tokens}
    cfg = ViTConfig.named(name, dtype=dtype, attn_impl=attn_impl, quantize=quantize, **regs)
    return DinoV2(cfg, generator=generator), cfg

