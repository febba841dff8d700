"""Trainable keypoint/descriptor heads on the frozen DINOv2 backbone.

Counterpart of ``vit_colmap_tpu/models/feature_model.py``: backbone patch
features -> two upsampling blocks (C -> 512 -> 512) -> a bilinear resize to
exactly the quarter-resolution map (gh*14//4, gw*14//4) -> a shared trunk
(512 -> 256) -> the keypoint head (256 -> 64 -> 4: score logit, dx, dy,
orientation) and the descriptor head (256 -> 128 -> D, L2-normalized).

Normalization is GroupNorm(32) in f32 ("group", the native training
configuration) or none ("none": the reference's trained torch checkpoints,
whose eval-mode BatchNorms are folded into the convs by
``models/convert.load_torch_feature_model``).  Convolutions compute in
``cfg.dtype`` (bf16 by default) with f32 parameters; the two 1x1 output
convs and the normalization are f32.  The modules take NCHW inside and
return the flax model's NHWC maps.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Mapping, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from vit_colmap_tpu_torch.device import exact_f32_convolutions, exact_f32_matmuls
from vit_colmap_tpu_torch.models.dinov2 import DinoV2, ViTConfig


@dataclass(frozen=True)
class FeatureModelConfig:
    backbone: str = "vitb14"
    descriptor_dim: int = 128
    hidden: int = 512
    trunk_dim: int = 256
    dtype: torch.dtype = torch.bfloat16
    # "group": GroupNorm in the upsampling blocks; "none": no norm (the
    # reference's torch checkpoints, BatchNorms folded into the convs).
    norm: str = "group"


@functools.lru_cache(maxsize=32)
def bilinear_weights(n_in: int, n_out: int, device=torch.device("cpu")) -> torch.Tensor:
    """(n_out, n_in) f32 weights of ``F.interpolate(mode="bilinear",
    align_corners=False)`` along one axis, as PyTorch computes them: source
    index ``(n_in / n_out) * (i + 0.5) - 0.5`` clamped at 0, the right
    neighbour clamped at the last index.  Built on ``device`` and cached, so
    a backward pass copies nothing from the host (a blocking copy would
    stall it); the cached tensors are read only."""
    scale = torch.full((), n_in / n_out, dtype=torch.float32, device=device)
    src = torch.clamp_min(scale * (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
                          - 0.5, 0.0)
    i0 = src.long()
    lam = src - i0.float()
    i1 = torch.clamp_max(i0 + 1, n_in - 1)
    cols = torch.arange(n_in, device=device)
    return (torch.where(cols == i0[:, None], 1.0 - lam[:, None], 0.0)
            + torch.where(cols == i1[:, None], lam[:, None], 0.0))


class _BilinearResize(torch.autograd.Function):
    """``F.interpolate(mode="bilinear", align_corners=False, antialias=False)``
    of an f32 (B, C, H, W) map to ``size``, with the same forward and a
    backward that applies the transposed weights as two products.
    PyTorch's own backward adds with float atomics on the card, in no fixed
    order, so two runs of one training step would not be bit-equal."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
        ctx.in_hw = tuple(x.shape[-2:])
        ctx.size = tuple(size)
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                             antialias=False)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        wy = bilinear_weights(ctx.in_hw[0], ctx.size[0], grad.device)
        wx = bilinear_weights(ctx.in_hw[1], ctx.size[1], grad.device)
        with exact_f32_matmuls():
            return wy.T @ grad @ wx, None


resize_bilinear = _BilinearResize.apply


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    padding=conv.padding)


class UpsampleBlock(nn.Module):
    """ConvTranspose(k4, s2, p1) + Conv3x3 + GroupNorm (f32) or none + exact GELU."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype, norm: str):
        super().__init__()
        self.dtype = dtype
        self.deconv = nn.ConvTranspose2d(in_ch, out_ch, 4, stride=2, padding=1)
        self.conv = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.norm = nn.GroupNorm(32, out_ch, eps=1e-6) if norm == "group" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        d = self.deconv
        x = F.conv_transpose2d(x.to(dt), d.weight.to(dt), d.bias.to(dt), stride=2, padding=1)
        x = _conv(x, self.conv, dt)
        if self.norm is not None:
            x = self.norm(x.float())
        return F.gelu(x.to(dt))


class FeatureHeads(nn.Module):
    """The trainable part: upsampler + trunk + keypoint/descriptor heads.

    Input: backbone patch features (B, gh, gw, C).  Output dict:
    score_logits (B, H4, W4), offsets (B, H4, W4, 2) in [-0.5, 0.5],
    orientation (B, H4, W4) in [-pi, pi], descriptors (B, H4, W4, D)
    L2-normalized, where (H4, W4) = (gh*14//4, gw*14//4)."""

    def __init__(self, cfg: FeatureModelConfig, in_dim: int):
        super().__init__()
        if cfg.norm not in ("group", "none"):
            raise ValueError(f"unknown norm {cfg.norm!r}; options: group, none")
        self.cfg = cfg
        self.up1 = UpsampleBlock(in_dim, cfg.hidden, cfg.dtype, cfg.norm)
        self.up2 = UpsampleBlock(cfg.hidden, cfg.hidden, cfg.dtype, cfg.norm)
        self.trunk = nn.Conv2d(cfg.hidden, cfg.trunk_dim, 3, padding=1)
        self.kp1 = nn.Conv2d(cfg.trunk_dim, 64, 3, padding=1)
        self.kp2 = nn.Conv2d(64, 4, 1)
        self.desc1 = nn.Conv2d(cfg.trunk_dim, 128, 3, padding=1)
        self.desc2 = nn.Conv2d(128, cfg.descriptor_dim, 1)

    def forward(self, feats: torch.Tensor) -> dict[str, torch.Tensor]:
        c = self.cfg
        dt = c.dtype
        _, gh, gw, _ = feats.shape
        # NHWC -> NCHW as a view: cuDNN reads it channels-last.
        x = feats.permute(0, 3, 1, 2)
        with exact_f32_convolutions():  # no TF32 for the f32 convolutions
            x = self.up2(self.up1(x))
            # 4*gh -> gh*14//4 is a downscale; no antialiasing, as the
            # reference's F.interpolate (a deterministic backward).
            x = resize_bilinear(x.float(), (gh * 14 // 4, gw * 14 // 4))
            trunk = F.gelu(_conv(x, self.trunk, dt))
            kp = _conv(F.gelu(_conv(trunk, self.kp1, dt)), self.kp2, torch.float32)
            ds = _conv(F.gelu(_conv(trunk, self.desc1, dt)), self.desc2, torch.float32)
        kp = kp.permute(0, 2, 3, 1)
        ds = ds.permute(0, 2, 3, 1)
        return {
            "score_logits": kp[..., 0],
            "offsets": torch.tanh(kp[..., 1:3]) * 0.5,
            "orientation": torch.tanh(kp[..., 3]) * torch.pi,
            "descriptors": ds / torch.clamp_min(torch.linalg.vector_norm(
                ds, dim=-1, keepdim=True), 1e-8),
        }


class ViTFeatureModel(nn.Module):
    """Frozen backbone + trainable heads.  ``forward`` takes normalized
    images (B, H, W, 3); ``forward_from_backbone_features`` takes backbone
    patch features (B, gh, gw, C) computed earlier."""

    def __init__(self, cfg: FeatureModelConfig, backbone_cfg: ViTConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.backbone_cfg = backbone_cfg
        self.backbone = DinoV2(backbone_cfg, generator=generator)
        self.heads = FeatureHeads(cfg, backbone_cfg.embed_dim)
        reset_heads(self.heads, generator)

    def backbone_features(self, images: torch.Tensor) -> torch.Tensor:
        """Normalized images -> (B, gh, gw, C) patch tokens, detached (the
        backbone is frozen)."""
        out = self.backbone(images)
        gh, gw = out["grid"]
        return out["x_norm_patchtokens"].reshape(images.shape[0], gh, gw, -1).detach()

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        return self.heads(self.backbone_features(images))

    def forward_from_backbone_features(self, feats: torch.Tensor) -> dict[str, torch.Tensor]:
        return self.heads(feats)


@torch.no_grad()
def reset_heads(heads: FeatureHeads, generator: torch.Generator) -> None:
    """Random init with the flax heads' distributions (lecun-normal kernels,
    fan-in = input channels x window, zero biases; GroupNorm keeps unit
    weights and zero biases).  Not the same numbers as flax: parity tests
    carry parameters across with ``convert``."""
    for m in heads.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.normal_(0.0, fan_in**-0.5, generator=generator)
            m.bias.zero_()


def make_feature_model(
    backbone: str = "vitb14",
    descriptor_dim: int = 128,
    dtype: torch.dtype = torch.bfloat16,
    norm: str = "group",
    attn_impl: str = "fixedmax_fused",
    generator: Optional[torch.Generator] = None,
) -> tuple[ViTFeatureModel, FeatureModelConfig, ViTConfig]:
    """The model and its two configs.  The backbone is frozen (its output is
    detached), so the inference-only fixed-max attention kernel is its
    default, as in the reference."""
    bcfg = ViTConfig.named(backbone, dtype=dtype, attn_impl=attn_impl)
    cfg = FeatureModelConfig(backbone=backbone, descriptor_dim=descriptor_dim,
                             dtype=dtype, norm=norm)
    return ViTFeatureModel(cfg, bcfg, generator=generator), cfg, bcfg


def count_parameters(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Number of parameter values of a module or a state dict."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params.values()
    return sum(t.numel() for t in tensors)


def split_trainable(
    params: Union[nn.Module, Mapping[str, torch.Tensor]],
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """A ``ViTFeatureModel`` (or its state dict) -> (trainable heads,
    frozen backbone) as name -> tensor, names keeping their prefix."""
    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)
    heads = {k: v for k, v in named.items() if k.startswith("heads.")}
    return heads, {k: v for k, v in named.items() if not k.startswith("heads.")}
