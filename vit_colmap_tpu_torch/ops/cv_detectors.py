"""OpenCV's SIFT, FAST, GFTT and ORB keypoint detectors in PyTorch.

The hybrid extractor localizes keypoints with a classical detector; the
JAX package calls ``cv2.SIFT_create(nfeatures).detect``,
``cv2.FastFeatureDetector_create().detect``,
``cv2.GFTTDetector_create(maxCorners).detect`` and
``cv2.ORB_create(nfeatures).detect`` on the host.  Each function here
follows OpenCV's own stages, takes an (H, W) uint8 tensor on any device and
returns ``(pts (K, 2) float32 (x, y) pixels, response (K,) float32)``:

* :func:`detect_fast`: the 9-of-16 segment test, ``cornerScore``, a 3-pixel
  border and the strict 3x3 non-max rule; row-major order, exact in
  integers.
* :func:`detect_gftt`: ``cornerMinEigenVal`` with the rounding of OpenCV's
  3x3 Sobel on x86 with FMA (x: the centre row times 2s, then a fused
  multiply-add of the side rows' sum times s; y: the row smoothing as a
  chain of fused multiply-adds 32 columns at a time, separate products and
  sums in the remaining columns, then the row difference), the 3x3 products summed exactly (in
  float64, as OpenCV's box filter sums float in double) and rounded once,
  the eigenvalue formula in float32; the threshold at quality x max, the
  3x3 dilation, the sort by response with equal responses in descending
  address (row-major) order, and the minDistance grid.  Bit-exact.
* :func:`detect_orb`: the 8-level pyramid (``resize(INTER_LINEAR_EXACT)``
  in 8-bit fixed point, each level from the one before), FAST at threshold
  20 per level, the edge-31 border, the per-level budget, the 7x7 Harris
  score (k 0.04) in OpenCV's float order and ``retainBest`` (ties at the
  cut kept).  Points are scaled back to level 0.  OpenCV's order after
  ``retainBest`` is that of ``std::nth_element``; here it is level by
  level, best Harris response first, equal responses in row-major order.
* :func:`detect_sift`: the x2 upsampled base (bilinear, exact) and its
  1.6 blur, 3 layers an octave, DoG extrema over ``floor(0.5 * 0.04 / 3 *
  255)``, ``adjustLocalExtrema`` (5 steps, Cramer's rule in float32, edge
  ratio 10), the 36-bin orientation histogram (``fastAtan2``'s polynomial,
  the [1 4 6 4 1] smoothing) with one keypoint per peak at 0.8 of the
  largest or more, ``removeDuplicatedSorted``'s order and duplicate rule,
  ``retainBest(nfeatures)`` (ties kept) and the x0.5 of the upsampled
  octave.  Its blurs use OpenCV's Gaussian taps; they are not OpenCV's
  float summation order, so values agree to float rounding, not bits.

Every blur and every stencil is a fixed-order sum of shifted copies made
of elementwise operations (no convolution algorithm, no TF32, no
reduction whose order depends on the device), and every sequential step
of OpenCV's (the minDistance grid, ``retainBest``, duplicate removal) is a
sort or a masked selection on tensors.  FAST, GFTT and ORB give the same
bits on the card and on the CPU; SIFT's orientation histogram adds its
samples with ``scatter_add_``, whose order on the card is not fixed.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# ------------------------------------------------------------------ common
# OpenCV's FAST patterns: the Bresenham circle as (dx, dy) in its order, and
# the number of contiguous circle pixels that must all be brighter or darker.
FAST_PATTERNS = {
    "9_16": (((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
              (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3)), 9),
    "7_12": (((0, 2), (1, 2), (2, 1), (2, 0), (2, -1), (1, -2),
              (0, -2), (-1, -2), (-2, -1), (-2, 0), (-2, 1), (-1, 2)), 7),
}


def reflect101_index(n: int, pad: int) -> np.ndarray:
    """Indices of a line of ``n`` pixels padded by ``pad`` on each side with
    ``BORDER_REFLECT_101`` (OpenCV's ``borderInterpolate``, any pad)."""
    p = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(p)
    while True:
        low, high = p < 0, p >= n
        if not (low.any() or high.any()):
            return p
        p = np.where(low, -p, np.where(high, 2 * n - 2 - p, p))


def _pad101(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    idx = torch.from_numpy(reflect101_index(x.shape[dim], pad)).to(x.device)
    return x.index_select(dim, idx)


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (``sqrtf``), through
    float64: PyTorch's vectorized float32 sqrt on the CPU is not always
    correctly rounded."""
    return torch.sqrt(x.double()).to(torch.float32)


def _round_half_even_f32(x: np.ndarray) -> np.ndarray:
    """cvRound of a float (``lrintf``): nearest, ties to even."""
    return np.rint(np.float32(x)).astype(np.int64)


# -------------------------------------------------------------------- FAST
def fast_score_map(gray: torch.Tensor, threshold: int, pattern: str = "9_16") -> torch.Tensor:
    """(H, W) uint8 -> (H, W) int32: ``cornerScore`` at every corner of the
    segment test (``arc`` contiguous circle pixels all darker than v - t or
    all brighter than v + t, for the circle and arc of ``pattern``), 0
    elsewhere and within 3 pixels of the border.

    ``cornerScore`` is the largest t' for which the pixel stays a corner,
    less one: over the arcs, the largest of min(v - p) and of min(p - v),
    taken with the threshold, minus one."""
    circle, arc = FAST_PATTERNS[pattern]
    H, W = gray.shape
    n = len(circle)
    score = torch.zeros((H, W), dtype=torch.int32, device=gray.device)
    if H <= 6 or W <= 6:
        return score
    h, w = H - 6, W - 6
    g = gray.to(torch.int16)
    v = g[3 : 3 + h, 3 : 3 + w]
    ring = torch.stack([v - g[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w]
                        for dx, dy in circle])  # v - p
    ext = torch.cat([ring, ring[: arc - 1]])  # (n + arc - 1, h, w): circular arcs
    best = None
    for sign in (1, -1):
        e = ext * sign
        # Minimum over each window of ``arc`` consecutive entries.
        m = e[:n].clone()
        for k in range(1, arc):
            m = torch.minimum(m, e[k : k + n])
        arc_best = m.amax(dim=0)
        best = arc_best if best is None else torch.maximum(best, arc_best)
    corner = best > threshold
    score[3 : 3 + h, 3 : 3 + w] = torch.where(corner, best.to(torch.int32) - 1, 0)
    return score


def _nonmax3x3(score: torch.Tensor) -> torch.Tensor:
    """Pixels whose score is strictly above all 8 neighbours' (0 outside)."""
    p = F.pad(score, (1, 1, 1, 1))
    H, W = score.shape
    keep = score > 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                keep &= score > p[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
    return keep


def _fast(gray: torch.Tensor, threshold: int, nonmax: bool, pattern: str = "9_16"):
    """FAST keypoints as (ys, xs, responses) in row-major order."""
    threshold = min(max(int(threshold), 0), 255)
    score = fast_score_map(gray, threshold, pattern)
    if nonmax:
        keep = _nonmax3x3(score)
        ys, xs = torch.nonzero(keep, as_tuple=True)
        resp = score[ys, xs].to(torch.float32)
    else:  # OpenCV computes no score without non-max suppression
        ys, xs = torch.nonzero(score > 0, as_tuple=True)
        resp = torch.zeros(ys.shape, dtype=torch.float32, device=gray.device)
    return ys, xs, resp


def detect_fast(gray: torch.Tensor, threshold: int = 10, nonmax: bool = True,
                pattern: str = "9_16"):
    """``cv2.FastFeatureDetector_create(threshold, nonmax).detect`` (type
    9_16): (pts (K, 2), response (K,)) in row-major order.  ``pattern="7_12"``
    asks for 7 contiguous pixels of the radius-2 circle of 12 with the same
    score rule, which is not OpenCV's TYPE_7_12 (a known-wrong variant)."""
    ys, xs, resp = _fast(gray, threshold, nonmax, pattern)
    return torch.stack([xs, ys], 1).to(torch.float32), resp


# -------------------------------------------------------------------- GFTT
def _sobel_minmax_scale(block_size: int, gradient_size: int) -> float:
    scale = float(1 << ((gradient_size if gradient_size > 0 else 3) - 1)) * block_size
    if gradient_size < 0:
        scale *= 2.0
    return 1.0 / (scale * 255.0)


# Columns an iteration of OpenCV's 8u -> 32f row filter computes (4 AVX2
# vectors of 8 floats).
ROW_FILTER_VECTOR = 32


def _box_sum_f32(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Unnormalized ``boxFilter`` of a float32 map with REFLECT_101 borders:
    OpenCV sums float input in double; the sum of ``block_size``^2 float32
    values of this map's range is exact in float64, so it is rounded once."""
    r = block_size // 2
    p = _pad101(_pad101(x.double(), r, 0), r, 1)
    H, W = x.shape
    rows = p[:, 0:W].clone()
    for k in range(1, block_size):
        rows = rows + p[:, k : k + W]
    out = rows[0:H].clone()
    for k in range(1, block_size):
        out = out + rows[k : k + H]
    return out.to(torch.float32)


def corner_min_eigen_val(gray: torch.Tensor, block_size: int = 3,
                         gradient_size: int = 3, harris_k: Optional[float] = None
                         ) -> torch.Tensor:
    """``cv2.cornerMinEigenVal(gray, block_size, 3)`` (REFLECT_101), bit for
    bit; with ``harris_k`` set, the Harris score det - k tr^2 of the same
    covariance instead (``cv2.cornerHarris`` to float rounding)."""
    if gradient_size != 3:
        raise NotImplementedError("only the 3x3 Sobel aperture is ported")
    scale = np.float32(_sobel_minmax_scale(block_size, gradient_size))
    f1 = float(scale)
    f0 = float(np.float32(2.0) * scale)
    g = _pad101(_pad101(gray.to(torch.int32), 1, 0), 1, 1)
    H, W = gray.shape
    # x: the row derivative is an integer; the column pass rounds the centre
    # product, then adds the sides' product in one fused multiply-add
    # (exact in float64 here, and rounded once to float32).
    rowd = g[:, 2:] - g[:, :-2]  # (H + 2, W)
    centre = (rowd[1 : H + 1].to(torch.float32) * f0).double()
    sides = (rowd[0:H] + rowd[2 : H + 2]).double()
    dx = (sides * f1 + centre).to(torch.float32)
    # y: the row smoothing, then the row difference.  OpenCV's row filter
    # runs 32 columns at a time as a chain of fused multiply-adds (each
    # exact in float64 here and rounded once); the columns past the last
    # full 32 take its scalar loop's separate products and sums.
    left, mid, right = (g[:, k : k + W].double() for k in range(3))
    fused = (left * f1).to(torch.float32)
    fused = (mid * f0 + fused.double()).to(torch.float32)
    fused = (right * f1 + fused.double()).to(torch.float32)
    plain = (left.float() * f1 + mid.float() * f0) + right.float() * f1
    vec = torch.arange(W, device=gray.device) < ROW_FILTER_VECTOR * (W // ROW_FILTER_VECTOR)
    sm = torch.where(vec[None], fused, plain)
    dy = sm[2 : H + 2] - sm[0:H]
    a = _box_sum_f32(dx * dx, block_size)
    b = _box_sum_f32(dx * dy, block_size)
    c = _box_sum_f32(dy * dy, block_size)
    if harris_k is not None:
        k = float(np.float32(harris_k))
        return a * c - b * b - (k * (a + c)) * (a + c)
    a = a * 0.5
    c = c * 0.5
    t = a - c
    return (a + c) - _sqrt_f32(t * t + b * b)


def _greedy_min_distance(ys: torch.Tensor, xs: torch.Tensor, H: int, W: int,
                         min_distance: float) -> torch.Tensor:
    """OpenCV's minDistance grid on candidates in rank order: a candidate is
    kept unless a kept candidate of better rank lies closer than
    ``min_distance``.  The cell grid of side round(min_distance) checks
    exactly the points within that distance, so this decides the same set
    by rounds over all candidates at once: each round keeps the undecided
    candidates whose better-ranked neighbours are all dropped and drops
    those with a kept one."""
    K = ys.numel()
    dev = ys.device
    md2 = float(np.float32(min_distance) * np.float32(min_distance))
    reach = int(math.floor(min_distance))
    offsets = [(dy, dx) for dy in range(-reach, reach + 1) for dx in range(-reach, reach + 1)
               if (dy or dx) and float(np.float32(dx * dx + dy * dy)) < md2]
    if not offsets or K == 0:
        return torch.ones(K, dtype=torch.bool, device=dev)
    rank = torch.full((H + 2 * reach, W + 2 * reach), K, dtype=torch.int64, device=dev)
    rank[ys + reach, xs + reach] = torch.arange(K, device=dev)
    nb = torch.stack([rank[ys + reach + dy, xs + reach + dx] for dy, dx in offsets], 1)
    me = torch.arange(K, device=dev)[:, None]
    better = nb < me  # better-ranked neighbours within the distance
    nb = torch.where(better, nb, 0)
    state = torch.zeros(K, dtype=torch.int8, device=dev)  # 0 open, 1 kept, 2 dropped
    while True:
        open_ = state == 0
        if not bool(open_.any()):
            return state == 1
        ns = state[nb]
        has_kept = (better & (ns == 1)).any(1)
        all_dropped = (~better | (ns == 2)).all(1)
        state = torch.where(open_ & has_kept, 2, state).to(torch.int8)
        state = torch.where(open_ & ~has_kept & all_dropped, 1, state).to(torch.int8)


def detect_gftt(gray: torch.Tensor, max_corners: int = 1000, quality: float = 0.01,
                min_distance: float = 1.0, block_size: int = 3, gradient_size: int = 3,
                use_harris: bool = False, harris_k: float = 0.04):
    """``cv2.GFTTDetector_create(max_corners, quality, min_distance,
    block_size, gradient_size, use_harris, harris_k).detect``: (pts (K, 2),
    response (K,)) best response first, equal responses in descending
    row-major order (OpenCV's ``greaterThanPtr`` compares addresses)."""
    H, W = gray.shape
    eig = corner_min_eigen_val(gray, block_size, gradient_size,
                               harris_k if use_harris else None)
    max_val = float(eig.max())
    thresh = float(np.float32(max_val * quality))
    eig = torch.where(eig > thresh, eig, torch.zeros((), dtype=eig.dtype, device=eig.device))
    dil = F.max_pool2d(eig[None, None], 3, stride=1, padding=1)[0, 0]
    cand = (eig != 0) & (eig == dil)
    cand[0, :] = False
    cand[-1, :] = False
    cand[:, 0] = False
    cand[:, -1] = False
    ys, xs = torch.nonzero(cand, as_tuple=True)  # ascending address
    ys, xs = ys.flip(0), xs.flip(0)  # descending address
    val = eig[ys, xs]
    order = torch.sort(val, descending=True, stable=True).indices
    ys, xs, val = ys[order], xs[order], val[order]
    if min_distance >= 1 and ys.numel():
        keep = _greedy_min_distance(ys, xs, H, W, min_distance)
        ys, xs, val = ys[keep], xs[keep], val[keep]
    if max_corners > 0:
        ys, xs, val = ys[:max_corners], xs[:max_corners], val[:max_corners]
    return torch.stack([xs, ys], 1).to(torch.float32), val


# ---------------------------------------------------------------- resizing
def _linear_exact_axis(n_src: int, n_dst: int):
    """One axis of ``resize(INTER_LINEAR_EXACT)``: source offsets, 8-bit
    fixed-point weights and the [lo, hi) range of destination indices that
    interpolate; below lo the first source pixel is replicated, from hi on
    the last."""
    inv_scale = n_dst / n_src
    scale = 1.0 / inv_scale
    d = np.arange(n_dst, dtype=np.float64)
    fval = scale * (d + 0.5) - 0.5
    ival = np.floor(fval).astype(np.int64)
    if n_src <= 1:  # OpenCV replicates a single source pixel
        lo = hi = n_dst
    else:
        lo = int(np.count_nonzero(ival < 0))
        past = np.nonzero(ival >= n_src - 1)[0]
        hi = int(past[0]) if past.size else n_dst
    inside = (ival >= 0) & (ival < n_src - 1)
    c1 = np.where(inside, np.rint((fval - ival) * 256.0), 0).astype(np.int64)
    ofs = np.clip(ival, 0, max(n_src - 2, 0))
    return ofs, 256 - c1, c1, lo, hi


def resize_linear_exact(gray: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(H, W) uint8 -> (height, width) uint8, as ``cv2.resize(gray, (width,
    height), interpolation=cv2.INTER_LINEAR_EXACT)``: rows in 8.8 fixed
    point, then columns in 16.16 rounded half up."""
    H, W = gray.shape
    dev = gray.device
    src = gray.to(torch.int64)
    xo, xc0, xc1, xlo, xhi = _linear_exact_axis(W, width)
    yo, yc0, yc1, ylo, yhi = _linear_exact_axis(H, height)
    t = lambda a: torch.from_numpy(a).to(dev)
    xo_t = t(xo)
    xo1 = t(np.minimum(xo + 1, W - 1))
    rows = src[:, xo_t] * t(xc0)[None] + src[:, xo1] * t(xc1)[None]  # 8.8
    xs = np.arange(width)
    rows[:, t(np.nonzero(xs < xlo)[0])] = src[:, :1] * 256
    rows[:, t(np.nonzero(xs >= xhi)[0])] = src[:, W - 1 : W] * 256
    yo_t = t(yo)
    yo1 = t(np.minimum(yo + 1, H - 1))
    out = (rows[yo_t] * t(yc0)[:, None] + rows[yo1] * t(yc1)[:, None] + (1 << 15)) >> 16
    ys = np.arange(height)
    out[t(np.nonzero(ys < ylo)[0])] = (rows[:1] + 128) >> 8
    out[t(np.nonzero(ys >= yhi)[0])] = (rows[H - 1 : H] + 128) >> 8
    return out.clamp(0, 255).to(torch.uint8)


# --------------------------------------------------------------------- ORB
# cv2.ORB_create's defaults: 8 levels at scale 1.2, FAST threshold 20, edge
# threshold 31, the Harris score on a 7 x 7 block with k 0.04.
ORB_LEVELS = 8
ORB_SCALE = 1.2
ORB_FAST_THRESHOLD = 20
ORB_EDGE = 31
ORB_HARRIS_BLOCK = 7


def orb_level_sizes(H: int, W: int, n_levels: int, scale_factor: float):
    """Each pyramid level's scale (float32 pow, as ``getScale``) and size
    (cvRound of the float32 product, as ``ORB_Impl``)."""
    out = []
    for level in range(n_levels):
        scale = np.float32(math.pow(float(np.float32(scale_factor)), float(level)))
        inv = np.float32(1.0) / scale
        w = int(_round_half_even_f32(np.float32(W) * inv))
        h = int(_round_half_even_f32(np.float32(H) * inv))
        out.append((float(scale), h, w))
    return out


def orb_features_per_level(n_features: int, n_levels: int, scale_factor: float):
    factor = np.float32(1.0 / float(np.float32(scale_factor)))
    desired = np.float32(np.float32(n_features) * (np.float32(1) - factor)
                         / (np.float32(1) - np.float32(math.pow(float(factor), float(n_levels)))))
    per_level, total = [], 0
    for _ in range(n_levels - 1):
        n = int(_round_half_even_f32(desired))
        per_level.append(n)
        total += n
        desired = np.float32(desired * factor)
    per_level.append(max(n_features - total, 0))
    return per_level


def _retain_best_mask(resp: torch.Tensor, n: int) -> torch.Tensor:
    """``KeyPointsFilter::retainBest``'s set: every response at or above the
    n-th largest (ties at the cut kept)."""
    if n < 0 or resp.numel() <= n:
        return torch.ones(resp.shape, dtype=torch.bool, device=resp.device)
    if n == 0:
        return torch.zeros(resp.shape, dtype=torch.bool, device=resp.device)
    cut = torch.sort(resp, descending=True).values[n - 1]
    return resp >= cut


def _harris_int_sums(level: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                     block: int):
    """ORB's ``HarrisResponses`` sums at integer points: a, b, c = the sums
    of Ix^2, Iy^2 and Ix Iy over the block (Ix, Iy: the unscaled 3x3 Sobel)."""
    p = level.to(torch.int32)
    # Ix, Iy on the interior (the block never reaches the image's border).
    c = p[1:-1, 1:-1]
    ix = (p[1:-1, 2:] - p[1:-1, :-2]) * 2 + (p[:-2, 2:] - p[:-2, :-2]) + (p[2:, 2:] - p[2:, :-2])
    iy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 2 + (p[2:, :-2] - p[:-2, :-2]) + (p[2:, 2:] - p[:-2, 2:])
    del c
    r = block // 2
    di = torch.arange(block, device=level.device)
    yy = (ys[:, None, None] - r + di[None, :, None] - 1).expand(-1, block, block)
    xx = (xs[:, None, None] - r + di[None, None, :] - 1).expand(-1, block, block)
    gx = ix[yy, xx].to(torch.int64)
    gy = iy[yy, xx].to(torch.int64)
    a = (gx * gx).sum((1, 2))
    b = (gy * gy).sum((1, 2))
    cc = (gx * gy).sum((1, 2))
    return a, b, cc


def orb_harris_response(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        block: int = ORB_HARRIS_BLOCK, k: float = 0.04) -> torch.Tensor:
    """``((float)a * b - (float)c * c - k * ((float)a + b) * ((float)a + b))
    * scale^4`` in float32, operation by operation."""
    scale = np.float32(1.0) / (np.float32((1 << 2) * block) * np.float32(255.0))
    s4 = float(np.float32(np.float32(np.float32(scale * scale) * scale) * scale))
    fa, fb, fc = a.to(torch.float32), b.to(torch.float32), c.to(torch.float32)
    s = fa + fb
    kk = float(np.float32(k))
    return ((fa * fb - fc * fc) - (s * kk) * s) * s4


def detect_orb(gray: torch.Tensor, n_features: int = 500, pyramid: bool = True):
    """``cv2.ORB_create(n_features).detect``: (pts (K, 2) at level 0, Harris
    response (K,)).  ``pyramid=False`` runs every level on the full image (a
    known-wrong variant)."""
    H, W = gray.shape
    edge = ORB_EDGE
    levels = orb_level_sizes(H, W, ORB_LEVELS, ORB_SCALE)
    budget = orb_features_per_level(n_features, ORB_LEVELS, ORB_SCALE)
    pts, resps = [], []
    img = gray
    for level, (scale, h, w) in enumerate(levels):
        if level > 0 and pyramid:
            img = resize_linear_exact(img, w, h)
        h, w = img.shape
        ys, xs, resp = _fast(img, ORB_FAST_THRESHOLD, True)
        if h <= 2 * edge or w <= 2 * edge:
            continue
        inb = (xs >= edge) & (xs < w - edge) & (ys >= edge) & (ys < h - edge)
        ys, xs, resp = ys[inb], xs[inb], resp[inb]
        # FAST's best 2 x budget, then Harris's best budget (ties kept)
        keep = _retain_best_mask(resp, 2 * budget[level])
        ys, xs, resp = ys[keep], xs[keep], resp[keep]
        if ys.numel():
            resp = orb_harris_response(*_harris_int_sums(img, ys, xs, ORB_HARRIS_BLOCK))
            keep = _retain_best_mask(resp, budget[level])
            ys, xs, resp = ys[keep], xs[keep], resp[keep]
        order = torch.sort(resp, descending=True, stable=True).indices
        ys, xs, resp = ys[order], xs[order], resp[order]
        sc = scale if pyramid else 1.0
        pts.append(torch.stack([xs, ys], 1).to(torch.float32) * sc)
        resps.append(resp)
    if not pts:
        return (torch.zeros((0, 2), dtype=torch.float32, device=gray.device),
                torch.zeros((0,), dtype=torch.float32, device=gray.device))
    return torch.cat(pts), torch.cat(resps)


# -------------------------------------------------------------------- SIFT
# cv2.SIFT_create's defaults, and its constants.
SIFT_OCTAVE_LAYERS = 3
SIFT_CONTRAST_THRESHOLD = 0.04
SIFT_EDGE_THRESHOLD = 10.0
SIFT_SIGMA = 1.6
SIFT_INIT_SIGMA = 0.5
SIFT_IMG_BORDER = 5
SIFT_MAX_INTERP_STEPS = 5
SIFT_ORI_HIST_BINS = 36
SIFT_ORI_SIG_FCTR = 1.5
SIFT_ORI_RADIUS = 3 * SIFT_ORI_SIG_FCTR
SIFT_ORI_PEAK_RATIO = 0.8
_F32 = np.float32
# fastAtan2's polynomial, in degrees.
_ATAN_P = [float(_F32(c) * _F32(180.0 / math.pi)) for c in
           (0.9997878412794807, -0.3258083974640975, 0.1555786518463281, -0.04432655554792128)]


def gaussian_taps(n: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(n, sigma, CV_32F)`` (its bit-exact double
    path, rounded to float32)."""
    if sigma <= 0:
        raise ValueError("sigma must be positive")
    scale2x = -0.125 / (sigma * sigma)
    n2 = (n - 1) // 2
    values = [math.exp(float(x * x) * scale2x) for x in range(1 - n, 1 - n + 2 * n2, 2)]
    total = 0.0
    for v in values:
        total += v
    total *= 2.0
    total += 1.0
    if n % 2 == 0:
        total += 1.0
    mul = 1.0 / total
    out = np.zeros(n, np.float64)
    for i, v in enumerate(values):
        out[i] = out[n - 1 - i] = v * mul
    out[n2] = mul
    if n % 2 == 0:
        out[n2 + 1] = out[n2]
    return out.astype(np.float32)


def gaussian_ksize(sigma: float) -> int:
    """GaussianBlur's kernel size for a float image: cvRound(8 sigma + 1) | 1."""
    return int(np.rint(sigma * 4 * 2 + 1)) | 1


def gaussian_blur_f32(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(x, (0, 0), sigma)`` of an (H, W) float32 image
    (REFLECT_101): rows, then columns, each a tap-by-tap sum of shifted
    copies in a fixed order."""
    taps = gaussian_taps(gaussian_ksize(sigma), sigma).tolist()
    r = len(taps) // 2
    H, W = x.shape
    p = _pad101(x, r, 1)
    acc = p[:, 0:W] * taps[0]
    for k in range(1, len(taps)):
        acc = acc + p[:, k : k + W] * taps[k]
    p = _pad101(acc, r, 0)
    out = p[0:H] * taps[0]
    for k in range(1, len(taps)):
        out = out + p[k : k + H] * taps[k]
    return out


def upsample2x_linear(x: torch.Tensor) -> torch.Tensor:
    """``resize(x, 2x, INTER_LINEAR)`` of an (H, W) float32 image of
    integers: each output is 3/4 of its nearest and 1/4 of its next-nearest
    source pixel (the edge rows and columns copied), exact in float32."""
    def axis(t: torch.Tensor, dim: int) -> torch.Tensor:
        n = t.shape[dim]
        prev = torch.cat([t.narrow(dim, 0, 1), t.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([t.narrow(dim, 1, n - 1), t.narrow(dim, n - 1, 1)], dim)
        even = prev * 0.25 + t * 0.75
        odd = t * 0.75 + nxt * 0.25
        # the first even and the last odd sample replicate the edge pixel
        even.narrow(dim, 0, 1).copy_(t.narrow(dim, 0, 1))
        odd.narrow(dim, n - 1, 1).copy_(t.narrow(dim, n - 1, 1))
        return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)

    return axis(axis(x, 0), 1)


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``cv::fastAtan2`` in degrees [0, 360), its polynomial in float32."""
    ax, ay = x.abs(), y.abs()
    eps = float(_F32(np.finfo(np.float64).eps))
    wide = ax >= ay
    c = torch.where(wide, ay / (ax + eps), ax / (ay + eps))
    c2 = c * c
    p1, p3, p5, p7 = _ATAN_P
    a = (((c2 * p7 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(wide, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def _sift_octaves(base: torch.Tensor, n_octaves: int, n_layers: int, sigma: float):
    """The Gaussian pyramid of ``buildGaussianPyramid``: per octave
    n_layers + 3 images; octave o + 1 starts from octave o's layer
    n_layers, halved by nearest neighbour."""
    sig = [sigma]
    k = 2.0 ** (1.0 / n_layers)
    for i in range(1, n_layers + 3):
        prev = k ** (i - 1) * sigma
        total = prev * k
        sig.append(math.sqrt(total * total - prev * prev))
    octaves = []
    img = base
    for o in range(n_octaves):
        if o > 0:
            src = octaves[-1][n_layers]
            img = src[: 2 * (src.shape[0] // 2) : 2, : 2 * (src.shape[1] // 2) : 2]
        layers = [img]
        for i in range(1, n_layers + 3):
            layers.append(gaussian_blur_f32(layers[-1], sig[i]))
        octaves.append(layers)
        if min(img.shape) // 2 <= 2 * SIFT_IMG_BORDER:
            break  # later octaves hold no pixel inside the border
    return octaves


def _sift_refine(dog: torch.Tensor, layer, r, c, n_layers: int, contrast: float,
                 edge: float):
    """``adjustLocalExtrema`` for a batch of extrema of one octave's DoG
    stack (n_layers + 2, rows, cols): returns (ok, layer, r, c, xi, xr, xc,
    contr), each step in float32 as OpenCV writes it."""
    L, rows, cols = dog.shape
    img_scale = float(_F32(1.0) / _F32(255.0))
    deriv = float(_F32(img_scale) * _F32(0.5))
    cross = float(_F32(img_scale) * _F32(0.25))
    N = layer.numel()
    dev = dog.device
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    failed = torch.zeros(N, dtype=torch.bool, device=dev)
    xi = torch.zeros(N, dtype=torch.float32, device=dev)
    xr = torch.zeros_like(xi)
    xc = torch.zeros_like(xi)

    def at(dl, dr, dc):
        return dog[layer + dl, r + dr, c + dc]

    def derivatives():
        v = at(0, 0, 0)
        dD = ((at(0, 0, 1) - at(0, 0, -1)) * deriv, (at(0, 1, 0) - at(0, -1, 0)) * deriv,
              (at(1, 0, 0) - at(-1, 0, 0)) * deriv)
        v2 = v * 2
        dxx = (at(0, 0, 1) + at(0, 0, -1) - v2) * img_scale
        dyy = (at(0, 1, 0) + at(0, -1, 0) - v2) * img_scale
        dss = (at(1, 0, 0) + at(-1, 0, 0) - v2) * img_scale
        dxy = (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1)) * cross
        dxs = (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1)) * cross
        dys = (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0)) * cross
        return v, dD, (dxx, dyy, dss, dxy, dxs, dys)

    for _ in range(SIFT_MAX_INTERP_STEPS):
        _, (b0, b1, b2), (dxx, dyy, dss, dxy, dxs, dys) = derivatives()
        # Matx33f::solve(DECOMP_LU) of a 3x3: Cramer's rule.
        a00, a01, a02 = dxx, dxy, dxs
        a10, a11, a12 = dxy, dyy, dys
        a20, a21, a22 = dxs, dys, dss
        det = (a00 * (a11 * a22 - a21 * a12) - a01 * (a10 * a22 - a20 * a12)
               + a02 * (a10 * a21 - a20 * a11))
        singular = det == 0
        d = 1.0 / torch.where(singular, torch.ones_like(det), det)
        x0 = d * (b0 * (a11 * a22 - a12 * a21) - a01 * (b1 * a22 - a12 * b2)
                  + a02 * (b1 * a21 - a11 * b2))
        x1 = d * (a00 * (b1 * a22 - a12 * b2) - b0 * (a10 * a22 - a12 * a20)
                  + a02 * (a10 * b2 - b1 * a20))
        x2 = d * (a00 * (a11 * b2 - b1 * a21) - a01 * (a10 * b2 - b1 * a20)
                  + b0 * (a10 * a21 - a11 * a20))
        zero = torch.zeros_like(x0)
        nxi = -torch.where(singular, zero, x2)
        nxr = -torch.where(singular, zero, x1)
        nxc = -torch.where(singular, zero, x0)
        active = ~done & ~failed
        conv = active & (nxi.abs() < 0.5) & (nxr.abs() < 0.5) & (nxc.abs() < 0.5)
        xi = torch.where(active, nxi, xi)
        xr = torch.where(active, nxr, xr)
        xc = torch.where(active, nxc, xc)
        done = done | conv
        moving = active & ~conv
        big = float(_F32(2147483647 // 3))
        failed = failed | (moving & ((nxi.abs() > big) | (nxr.abs() > big) | (nxc.abs() > big)))
        moving = moving & ~failed
        step = lambda t: torch.round(torch.nan_to_num(t, nan=0.0).clamp(-1e6, 1e6)).to(torch.int64)
        c = torch.where(moving, c + step(nxc), c)
        r = torch.where(moving, r + step(nxr), r)
        layer = torch.where(moving, layer + step(nxi), layer)
        out = moving & ((layer < 1) | (layer > n_layers) | (c < SIFT_IMG_BORDER)
                        | (c >= cols - SIFT_IMG_BORDER) | (r < SIFT_IMG_BORDER)
                        | (r >= rows - SIFT_IMG_BORDER))
        failed = failed | out
        # keep failed points' indices inside the stack for the next gather
        layer = torch.where(failed, 1, layer)
        r = torch.where(failed, SIFT_IMG_BORDER, r)
        c = torch.where(failed, SIFT_IMG_BORDER, c)
    ok = done & ~failed
    v, (b0, b1, b2), (dxx, dyy, _dss, dxy, _dxs, _dys) = derivatives()
    t = b0 * xc + b1 * xr + b2 * xi
    contr = v * img_scale + t * 0.5
    ok = ok & ~(contr.abs() * float(n_layers) < float(_F32(contrast)))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    e = float(_F32(edge))
    ok = ok & ~((det <= 0) | (tr * tr * e >= ((e + 1) * (e + 1)) * det))
    return ok, layer, r, c, xi, xr, xc, contr


def _sift_orientations(gauss: torch.Tensor, layer, r, c, scl_octv, n_bins: int):
    """``calcOrientationHist`` for a batch of keypoints of one octave
    (``gauss``: the octave's (n_layers + 3, rows, cols) stack): the
    smoothed (K, n_bins) histograms."""
    _, rows, cols = gauss.shape
    dev = gauss.device
    radius = torch.round(scl_octv * float(_F32(SIFT_ORI_RADIUS))).to(torch.int64)
    sigma = scl_octv * float(_F32(SIFT_ORI_SIG_FCTR))
    expf_scale = -1.0 / ((sigma * sigma) * 2.0)
    R = int(radius.max()) if radius.numel() else 0
    off = torch.arange(-R, R + 1, device=dev)
    oi = off[None, :, None]
    oj = off[None, None, :]
    y = r[:, None, None] + oi
    x = c[:, None, None] + oj
    rad = radius[:, None, None]
    valid = ((oi.abs() <= rad) & (oj.abs() <= rad) & (y > 0) & (y < rows - 1)
             & (x > 0) & (x < cols - 1))
    yc = y.clamp(1, rows - 2)
    xc = x.clamp(1, cols - 2)
    lay = layer[:, None, None].expand_as(yc)
    dx = gauss[lay, yc, xc + 1] - gauss[lay, yc, xc - 1]
    dy = gauss[lay, yc - 1, xc] - gauss[lay, yc + 1, xc]
    w = torch.exp((oi * oi + oj * oj).to(torch.float32) * expf_scale[:, None, None])
    ori = fast_atan2_deg(dy, dx)
    mag = _sqrt_f32(dx * dx + dy * dy)
    bins = torch.round(ori * float(_F32(n_bins) / _F32(360.0))).to(torch.int64)
    bins = torch.where(bins >= n_bins, bins - n_bins, bins)
    bins = torch.where(bins < 0, bins + n_bins, bins)
    contrib = torch.where(valid, w * mag, torch.zeros((), device=dev))
    K = r.numel()
    temp = torch.zeros((K, n_bins), dtype=torch.float32, device=dev)
    temp.scatter_add_(1, bins.reshape(K, -1), contrib.reshape(K, -1))
    m2 = torch.roll(temp, 2, 1)
    m1 = torch.roll(temp, 1, 1)
    p1 = torch.roll(temp, -1, 1)
    p2 = torch.roll(temp, -2, 1)
    return ((m2 + p2) * float(_F32(1.0 / 16.0)) + (m1 + p1) * float(_F32(4.0 / 16.0))
            + temp * float(_F32(6.0 / 16.0)))


def _lexsort_rows(keys: list[torch.Tensor]) -> torch.Tensor:
    """The permutation sorting by keys[0], then keys[1], ... (ascending)."""
    order = torch.arange(keys[0].numel(), device=keys[0].device)
    for key in reversed(keys):
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def detect_sift(gray: torch.Tensor, n_features: int = 0, upsample: bool = True):
    """``cv2.SIFT_create(n_features).detect``: (pts (K, 2), response (K,)) in
    ``removeDuplicatedSorted``'s order (x, then y, then larger size, then
    angle).  ``upsample=False`` skips the x2 base (a known-wrong variant:
    OpenCV's first octave is -1)."""
    dev = gray.device
    n_layers = SIFT_OCTAVE_LAYERS
    contrast_threshold, edge_threshold = SIFT_CONTRAST_THRESHOLD, SIFT_EDGE_THRESHOLD
    sig_f = _F32(SIFT_SIGMA)
    img = gray.to(torch.float32)
    if upsample:
        sig_diff = float(np.sqrt(max(sig_f * sig_f - _F32(SIFT_INIT_SIGMA * SIFT_INIT_SIGMA * 4),
                                     _F32(0.01))))
        base = gaussian_blur_f32(upsample2x_linear(img), sig_diff)
        first_octave = -1
    else:
        sig_diff = float(np.sqrt(max(sig_f * sig_f - _F32(SIFT_INIT_SIGMA * SIFT_INIT_SIGMA),
                                     _F32(0.01))))
        base = gaussian_blur_f32(img, sig_diff)
        first_octave = 0
    n_octaves = int(np.rint(math.log(min(base.shape)) / math.log(2.0) - 2)) - first_octave
    octaves = _sift_octaves(base, n_octaves, n_layers, float(sig_f))
    threshold = math.floor(0.5 * contrast_threshold / n_layers * 255)
    xs_all, ys_all, size_all, angle_all, resp_all = [], [], [], [], []
    n_bins = SIFT_ORI_HIST_BINS
    for o, layers in enumerate(octaves):
        gauss = torch.stack(layers)
        dog = gauss[1:] - gauss[:-1]  # (n_layers + 2, rows, cols)
        _, rows, cols = dog.shape
        if rows <= 2 * SIFT_IMG_BORDER or cols <= 2 * SIFT_IMG_BORDER:
            continue
        vmax = F.max_pool3d(dog[None, None], 3, stride=1, padding=1)[0, 0]
        vmin = -F.max_pool3d(-dog[None, None], 3, stride=1, padding=1)[0, 0]
        ext = (dog.abs() > threshold) & (((dog > 0) & (dog >= vmax)) | ((dog <= 0) & (dog <= vmin)))
        mask = torch.zeros_like(ext)
        b = SIFT_IMG_BORDER
        mask[1 : n_layers + 1, b : rows - b, b : cols - b] = True
        layer, r, c = torch.nonzero(ext & mask, as_tuple=True)
        if layer.numel() == 0:
            continue
        ok, layer, r, c, xi, xr, xc, contr = _sift_refine(
            dog, layer, r, c, n_layers, contrast_threshold, edge_threshold)
        layer, r, c, xi, xr, xc, contr = (t[ok] for t in (layer, r, c, xi, xr, xc, contr))
        if layer.numel() == 0:
            continue
        octave_px = float(1 << o)
        px = (c.to(torch.float32) + xc) * octave_px
        py = (r.to(torch.float32) + xr) * octave_px
        size = torch.pow(torch.full_like(xi, 2.0),
                         (layer.to(torch.float32) + xi) / float(n_layers))
        size = size * float(sig_f) * octave_px * 2.0
        scl_octv = size * 0.5 / octave_px
        hist = _sift_orientations(gauss, layer, r, c, scl_octv, n_bins)
        omax = hist.amax(1)
        mag_thr = (omax.double() * SIFT_ORI_PEAK_RATIO).to(torch.float32)
        left = torch.roll(hist, 1, 1)
        right = torch.roll(hist, -1, 1)
        peak = (hist > left) & (hist > right) & (hist >= mag_thr[:, None])
        k, j = torch.nonzero(peak, as_tuple=True)
        hl, hj, hr = left[k, j], hist[k, j], right[k, j]
        bin_ = j.to(torch.float32) + 0.5 * (hl - hr) / (hl - 2 * hj + hr)
        bin_ = torch.where(bin_ < 0, n_bins + bin_, torch.where(bin_ >= n_bins, bin_ - n_bins, bin_))
        angle = 360.0 - bin_ * float(_F32(360.0) / _F32(n_bins))
        angle = torch.where((angle - 360.0).abs() < float(np.finfo(np.float32).eps),
                            torch.zeros_like(angle), angle)
        xs_all.append(px[k])
        ys_all.append(py[k])
        size_all.append(size[k])
        angle_all.append(angle)
        resp_all.append(contr[k].abs())
    if not xs_all:
        empty = torch.zeros((0,), dtype=torch.float32, device=dev)
        pts = torch.zeros((0, 2), dtype=torch.float32, device=dev)
        return pts, empty
    x, y, size, angle, resp = (torch.cat(t) for t in (xs_all, ys_all, size_all, angle_all,
                                                      resp_all))
    # removeDuplicatedSorted: sort by x, y, -size, angle, -response, then
    # drop a point equal to its predecessor in (x, y, size, angle).
    order = _lexsort_rows([x, y, -size, angle, -resp])
    x, y, size, angle, resp = (t[order] for t in (x, y, size, angle, resp))
    same = torch.zeros_like(x, dtype=torch.bool)
    same[1:] = (x[1:] == x[:-1]) & (y[1:] == y[:-1]) & (size[1:] == size[:-1]) & \
               (angle[1:] == angle[:-1])
    keep = ~same
    if n_features > 0:
        keep_idx = torch.nonzero(keep).squeeze(1)
        best = _retain_best_mask(resp[keep_idx], n_features)
        keep = torch.zeros_like(keep)
        keep[keep_idx[best]] = True
    x, y, size, angle, resp = (t[keep] for t in (x, y, size, angle, resp))
    if first_octave < 0:
        f = float(_F32(1.0) / _F32(1 << -first_octave))
        x, y, size = x * f, y * f, size * f
    pts = torch.stack([x, y], 1)
    return pts, resp


# ------------------------------------------------------------- agreement
def point_agreement(ref_pts: torch.Tensor, pts: torch.Tensor, tol: float = 0.05) -> dict:
    """How two keypoint sets (K, 2) agree: ``count_rel`` (the relative
    difference of their sizes), and over each side's distinct points the
    share with a point of the other side within ``tol`` pixels
    (``share_ref``: of ``ref_pts``'s, ``share_out``: of ``pts``'s)."""
    def nearest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if len(b) == 0:
            return torch.full((len(a),), float("inf"), dtype=torch.float64)
        return torch.cat([torch.cdist(a[i : i + 4096], b).min(1).values
                          for i in range(0, len(a), 4096)]) if len(a) else a[:, 0]

    ref = torch.unique(ref_pts.detach().cpu().double(), dim=0)
    out = torch.unique(pts.detach().cpu().double(), dim=0)
    n_ref = len(ref_pts)
    return {
        "count_ref": n_ref,
        "count": len(pts),
        "count_rel": abs(len(pts) - n_ref) / max(n_ref, 1),
        "share_ref": float((nearest(ref, out) <= tol).double().mean()) if len(ref) else 1.0,
        "share_out": float((nearest(out, ref) <= tol).double().mean()) if len(out) else 1.0,
    }
