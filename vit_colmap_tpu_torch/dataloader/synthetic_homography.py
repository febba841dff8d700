"""Synthetic homography augmentation on the host, in numpy.

Counterpart of ``vit_colmap_tpu/dataloader/synthetic_homography.py``:
random in-plane rotation, scale, perspective and translation composed about
the image centre (the same draws from the numpy ``Generator`` in the same
order, so a seed gives the JAX package's H bit for bit); presets
conservative / moderate / aggressive; a photometric jitter; resize and
composition helpers.  Warping is ``dataloader.synthetic_benchmark.
warp_perspective``, the port's ``cv2.warpPerspective`` (bilinear,
constant-0 border).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import warp_perspective


@dataclass
class SyntheticHomographyConfig:
    max_rotation_deg: float = 30.0
    min_scale: float = 0.8
    max_scale: float = 1.2
    max_perspective: float = 2e-4
    max_translation: float = 0.1  # fraction of image size

    @classmethod
    def conservative(cls) -> "SyntheticHomographyConfig":
        return cls(15.0, 0.9, 1.1, 1e-4, 0.05)

    @classmethod
    def moderate(cls) -> "SyntheticHomographyConfig":
        return cls()

    @classmethod
    def aggressive(cls) -> "SyntheticHomographyConfig":
        return cls(45.0, 0.7, 1.4, 5e-4, 0.2)

    @classmethod
    def preset(cls, name: str) -> "SyntheticHomographyConfig":
        return {
            "conservative": cls.conservative,
            "moderate": cls.moderate,
            "aggressive": cls.aggressive,
        }[name]()


def generate_random_homography(
    width: int,
    height: int,
    config: SyntheticHomographyConfig | None = None,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Random H = T C P S R C^-1 about the image centre, normalized to
    H[2, 2] = 1 (float64)."""
    config = config or SyntheticHomographyConfig()
    rng = rng or np.random.default_rng()

    angle = np.radians(rng.uniform(-config.max_rotation_deg, config.max_rotation_deg))
    scale = rng.uniform(config.min_scale, config.max_scale)
    px = rng.uniform(-config.max_perspective, config.max_perspective)
    py = rng.uniform(-config.max_perspective, config.max_perspective)
    tx = rng.uniform(-config.max_translation, config.max_translation) * width
    ty = rng.uniform(-config.max_translation, config.max_translation) * height

    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    S = np.diag([scale, scale, 1.0])
    P = np.array([[1, 0, 0], [0, 1, 0], [px, py, 1.0]])
    T = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1.0]])

    cx, cy = width / 2.0, height / 2.0
    C = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1.0]])
    Cinv = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    H = T @ C @ P @ S @ R @ Cinv
    return H / H[2, 2]


def create_synthetic_pair(
    image: np.ndarray,
    config: SyntheticHomographyConfig | None = None,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """uint8 image -> (image warped by a random H, H)."""
    h, w = image.shape[:2]
    H = generate_random_homography(w, h, config, rng)
    return warp_perspective(image, H, (w, h)), H


def photometric_jitter(
    image: np.ndarray,
    rng: np.random.Generator | None = None,
    strength: float = 1.0,
) -> np.ndarray:
    """Random contrast, brightness, gamma and Gaussian noise (uint8 in and
    out); ``strength=0`` is the identity."""
    rng = rng or np.random.default_rng()
    img = image.astype(np.float32)
    contrast = 1.0 + rng.uniform(-0.3, 0.3) * strength
    brightness = rng.uniform(-0.2, 0.2) * strength * 255.0
    mean = img.mean()
    img = (img - mean) * contrast + mean + brightness
    gamma = float(np.exp(rng.uniform(-0.4, 0.4) * strength))
    img = np.clip(img, 0.0, 255.0)
    img = 255.0 * (img / 255.0) ** gamma
    sigma = rng.uniform(0.0, 8.0) * strength
    if sigma > 0:
        img = img + rng.normal(0.0, sigma, img.shape)
    return np.clip(img, 0.0, 255.0).astype(np.uint8)


def adjust_homography_for_resize(
    H: np.ndarray,
    orig_size1: tuple[int, int],
    new_size1: tuple[int, int],
    orig_size2: tuple[int, int],
    new_size2: tuple[int, int],
) -> np.ndarray:
    """H for both endpoint images resized: S2 H S1^-1, sizes as (w, h)."""
    sx1 = new_size1[0] / orig_size1[0]
    sy1 = new_size1[1] / orig_size1[1]
    sx2 = new_size2[0] / orig_size2[0]
    sy2 = new_size2[1] / orig_size2[1]
    S1inv = np.diag([1.0 / sx1, 1.0 / sy1, 1.0])
    S2 = np.diag([sx2, sy2, 1.0])
    out = S2 @ H @ S1inv
    return out / out[2, 2]


def compose_homographies(H_1i: np.ndarray, H_1j: np.ndarray) -> np.ndarray:
    """H_i_j = H_1_j @ H_1_i^-1, normalized."""
    out = H_1j @ np.linalg.inv(H_1i)
    return out / out[2, 2]
