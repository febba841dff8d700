"""Inputs made from the seed on the device, in a few large calls: the ViT's
weights, the descriptor PCA, the image pool and the matching scene.  The
benchmark keeps what it makes and hands the same tensors to the program and
to the plain reference."""

from __future__ import annotations

import math
import re

import torch


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one named stream of the seed's inputs
    (weights, images, scene), so each input stays the same whatever else is
    drawn."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2**63))
    return g


def _init(name: str, shape) -> tuple[float, float]:
    """(mean, std) of a ViT parameter.  Linear and conv weights are
    lecun-normal.  LayerScale and LayerNorm parameters are drawn away from
    their init, so that every block's branches and the final norm move the
    output."""
    if name.endswith(".weight") and len(shape) >= 2:
        fan_in = math.prod(shape[1:])
        return 0.0, 1.0 / math.sqrt(fan_in)
    if ".ls" in name:
        return 0.3, 0.08
    if name.startswith("norm."):
        return (1.0, 0.5) if name.endswith("weight") else (0.0, 0.1)
    if "norm" in name:
        return (1.0, 0.2) if name.endswith("weight") else (0.0, 0.1)
    if name == "pos_embed":
        return 0.0, 0.2
    if name == "cls_token":
        return 0.0, 0.5
    return 0.0, 0.02  # biases


# Outlier channels of the blocks' LayerNorm weights: trained ViTs (DINOv2
# among them) carry a few channels far larger than the rest in the inputs of
# their dense layers (Dettmers et al. 2022, LLM.int8(); Darcet et al. 2023,
# "Vision Transformers Need Registers").
OUTLIER_SHARE = 0.02
OUTLIER_GAIN = 8.0
BLOCK_NORM = re.compile(r"^blocks\.\d+\.norm[12]\.weight$")


def vit_weights(shapes: dict, dim: int, seed: int, device) -> dict:
    """Seeded f32 weights for every key of a DINOv2 state dict (``shapes``:
    key -> shape), drawn in one normal call on ``device``, and one uniform
    call that picks the outlier channels of the blocks' norms."""
    g = generator(seed, device, 1)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    norms = [n for n in shapes if BLOCK_NORM.match(n)]
    outlier = torch.rand(len(norms), dim, generator=g, device=device) < OUTLIER_SHARE
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        mean, std = _init(name, shape)
        w = flat[at:at + n].view(shape).mul_(std).add_(mean)
        if name in norms:
            w[outlier[norms.index(name)]] *= OUTLIER_GAIN
        out[name] = w
        at += n
    return out


def pca(dim: int, out_dim: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A seeded orthonormal (dim, out_dim) projection and a (dim,) mean."""
    g = generator(seed, device, 2)
    z = torch.randn(dim, out_dim + 1, generator=g, device=device, dtype=torch.float32)
    q, _ = torch.linalg.qr(z[:, :out_dim])
    return q.contiguous(), 0.1 * z[:, out_dim].contiguous()


# Octaves of the textures: (grid rows, grid columns, amplitude).
OCTAVES = ((5, 7, 1.0), (20, 27, 0.6), (80, 107, 0.35), (0, 0, 0.15))


def textures(n: int, height: int, width: int, seed: int, device) -> torch.Tensor:
    """(n, height, width, 3) uint8 images: sums of upsampled noise at four
    scales, a shared luminance and a weaker colour part per channel."""
    g = generator(seed, device, 3)
    acc = torch.zeros(n, 3, height, width, device=device)
    for gh, gw, amp in OCTAVES:
        gh, gw = (gh, gw) if gh else (height, width)
        z = torch.randn(n, 4, gh, gw, generator=g, device=device)
        z = z[:, :1] + 0.5 * z[:, 1:]  # luminance + colour
        if (gh, gw) != (height, width):
            z = torch.nn.functional.interpolate(z, size=(height, width), mode="bilinear",
                                                align_corners=False)
        acc += amp * z
    img = torch.sigmoid(1.2 * acc / acc.std()) * 255.0
    return img.round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def signed_u8(d: torch.Tensor) -> torch.Tensor:
    """Unit descriptors -> the ViT extractor's signed uint8 encoding."""
    return torch.clamp((d + 1.0) * 127.5, 0.0, 255.0).to(torch.uint8)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def arc_scene(views: int, keypoints: int, dim: int, scene_points: int, overlap_views: int,
              noise: tuple[float, float], seed: int, device) -> torch.Tensor:
    """(views, keypoints, dim) uint8 descriptors of views along an arc.

    World points lie on a line; view v sees ``scene_points`` consecutive
    ones starting at v * step, step = scene_points / overlap_views, so
    neighbours share most of their points and views ``overlap_views`` or
    more apart share none.  Each observation is the point's unit descriptor
    plus noise of a norm drawn from ``noise``; the remaining keypoints are
    distractors seen by one view only; every view's rows are shuffled."""
    g = generator(seed, device, 4)
    step = scene_points // overlap_views
    world = _unit(torch.randn((views - 1) * step + scene_points, dim, generator=g,
                              device=device))
    idx = (torch.arange(views, device=device)[:, None] * step
           + torch.arange(scene_points, device=device)[None])
    lo, hi = noise
    sigma = lo + (hi - lo) * torch.rand(views, scene_points, 1, generator=g, device=device)
    obs = world[idx] + sigma * _unit(torch.randn(views, scene_points, dim, generator=g,
                                                 device=device))
    extra = torch.randn(views, keypoints - scene_points, dim, generator=g, device=device)
    desc = _unit(torch.cat([obs, extra], dim=1))
    order = torch.argsort(torch.rand(views, keypoints, generator=g, device=device), dim=1)
    desc = torch.gather(desc, 1, order[..., None].expand_as(desc))
    return signed_u8(desc)
