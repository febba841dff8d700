"""Plain keypoints and descriptors from a dense feature map, in float32:
Harris and difference-of-Gaussians saliency on the channel mean, 3 x 3
max-pool NMS in soft mode (local maxima ranked first), binned top-k,
separable quadratic refinement, border-clamped bilinear descriptors, PCA,
L2 normalisation and the signed uint8 encoding.  Written from the method's
description; it shares no code with the program."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.vit import full_f32


def blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (H, W), edges replicated, radius
    round(3 sigma)."""
    r = max(1, int(3.0 * sigma + 0.5))
    t = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = k / k.sum()
    xp = F.pad(x[None, None], (0, 0, r, r), mode="replicate")
    x = F.conv2d(xp, k.view(1, 1, -1, 1))
    xp = F.pad(x, (r, r, 0, 0), mode="replicate")
    return F.conv2d(xp, k.view(1, 1, 1, -1))[0, 0]


def _unit_range(v: torch.Tensor) -> torch.Tensor:
    return (v - v.min()) / torch.clamp_min(v.max() - v.min(), 1e-8)


def saliency(fmap: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(H, W, C) -> (H, W): the mean of the Harris blend (0.7 corner, 0.3
    gradient magnitude, k = 0.04, structure tensor blurred at sigma 1) and
    the |DoG| (sigma 1 and 1.6), each scaled to [0, 1]."""
    if cfg["saliency"] != "combined":
        raise ValueError(f"saliency {cfg['saliency']!r} has no reference")
    with full_f32():
        m = fmap.mean(dim=-1)
        mp = F.pad(m[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
        gy = (mp[2:, 1:-1] - mp[:-2, 1:-1]) / 2.0
        gx = (mp[1:-1, 2:] - mp[1:-1, :-2]) / 2.0
        ixx, iyy, ixy = blur(gx * gx, 1.0), blur(gy * gy, 1.0), blur(gx * gy, 1.0)
        corner = ixx * iyy - ixy * ixy - 0.04 * (ixx + iyy) ** 2
        harris = 0.7 * _unit_range(corner) + 0.3 * _unit_range(torch.sqrt(gx * gx + gy * gy))
        dog = _unit_range(torch.abs(blur(m, 1.0) - blur(m, 1.6)))
    return 0.5 * harris + 0.5 * dog


def select(scores: torch.Tensor, cfg: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W) scores -> ((K, 2) x, y of the chosen cells, (K,) valid).

    Soft NMS: a cell at least as high as its 3 x 3 neighbourhood and above 0
    ranks by score + 1, the others by score.  Each bin_size x bin_size bin
    keeps its k_per_bin best (lower index first on ties), then the best
    max_keypoints overall are chosen, stable on ties."""
    H, W = scores.shape
    r, b, kpb = cfg["nms_radius"], cfg["bin_size"], cfg["k_per_bin"]
    if cfg["nms_mode"] != "soft":
        raise ValueError("only soft NMS has a reference")
    pooled = F.max_pool2d(scores[None, None], 2 * r + 1, stride=1, padding=r)[0, 0]
    peak = torch.where(scores >= pooled, scores, 0.0) > 0.0
    key = torch.where(peak, scores + 1.0, scores)
    key = torch.where(key > 0.0, key, 0.0)
    nh, nw = math.ceil(H / b), math.ceil(W / b)
    padded = torch.zeros(nh * b, nw * b, device=scores.device)
    padded[:H, :W] = key
    cells = padded.reshape(nh, b, nw, b).permute(0, 2, 1, 3).reshape(nh * nw, b * b)
    kpb = min(kpb, b * b)
    v, i = torch.sort(cells, dim=1, descending=True, stable=True)
    v, i = v[:, :kpb].reshape(-1), i[:, :kpb]
    bins = torch.arange(nh * nw, device=scores.device)[:, None]
    ys = ((bins // nw) * b + i // b).reshape(-1)
    xs = ((bins % nw) * b + i % b).reshape(-1)
    k = min(cfg["max_keypoints"], v.numel())
    top_v, top_i = torch.sort(v, descending=True, stable=True)
    top_v, top_i = top_v[:k], top_i[:k]
    x, y = xs[top_i], ys[top_i]
    valid = (top_v > 0.0) & (x < W) & (y < H)
    return torch.stack([x, y], dim=-1).float(), valid


def refine(scores: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sub-cell offsets in [-0.5, 0.5] from a parabola through each cell and
    its two neighbours along x and along y (edges clamped)."""
    H, W = scores.shape
    x, y = xy[:, 0].long(), xy[:, 1].long()

    def at(dy, dx):
        return scores[(y + dy).clamp(0, H - 1), (x + dx).clamp(0, W - 1)]

    c = at(0, 0)

    def vertex(m, p):
        den = m - 2.0 * c + p
        big = den.abs() > 1e-6
        return torch.where(big, 0.5 * (m - p) / torch.where(big, den, 1.0), 0.0).clamp(-0.5, 0.5)

    return torch.stack([vertex(at(0, -1), at(0, 1)), vertex(at(-1, 0), at(1, 0))], dim=-1)


def sample(fmap: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of (H, W, C) at (K, 2) continuous (x, y), clamped to
    the map."""
    H, W, _ = fmap.shape
    x = xy[:, 0].clamp(0.0, W - 1.0)
    y = xy[:, 1].clamp(0.0, H - 1.0)
    x0, y0 = x.floor().long(), y.floor().long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    top = fmap[y0, x0] * (1 - fx) + fmap[y0, x1] * fx
    bot = fmap[y1, x0] * (1 - fx) + fmap[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def describe(fmap: torch.Tensor, xy: torch.Tensor, comps: torch.Tensor,
             mean: torch.Tensor) -> torch.Tensor:
    """Descriptors at ``xy``: sample, project, L2-normalise, signed uint8."""
    with full_f32():
        d = (sample(fmap, xy) - mean) @ comps
    d = d / d.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    return torch.clamp((d + 1.0) * 127.5, 0.0, 255.0).to(torch.uint8)


def keypoints(fmap: torch.Tensor, cfg: dict) -> tuple[torch.Tensor, ...]:
    """(H, W, C) -> refined (K, 2) map coordinates, (K,) valid, and the (K, 2)
    map cells they were refined from."""
    scores = saliency(fmap, cfg)
    cells, valid = select(scores, cfg)
    xy = cells + refine(scores, cells) if cfg["refine"] else cells
    return xy, valid, cells
