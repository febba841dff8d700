"""Write the JPEG fixtures of ``tests/data/jpeg/``: small JPEGs encoded by
libjpeg.so.62, each beside the bytes libjpeg's decode gives (the reference
route of ``vit_colmap_tpu_torch/utils/native_io.py``).

Machines without libjpeg (the card's, where nvJPEG decodes) cannot make
these bytes, so they are committed; ``tests/test_torch_native_io.py``
checks that the libjpeg route still gives them, and
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold the nvJPEG route to
them.  Each ``<name>.npz`` holds:

* ``ycc``: (H, W, 3) full-resolution YCbCr (libjpeg's fancy upsampling);
* ``i420``: the packed I420 the extractor's native route ships, at the
  patch-aligned size (``models/dinov2.patch_grid_size``);
* ``rgb``: (H, W, 3) libjpeg's RGB (what ``cv2.imread`` gives);
* ``size``: the I420 target (width, height).

Run with the repo on ``sys.path`` where ``libjpeg.so.62`` exists:
``python3 scripts/torch_jpeg_fixtures.py [--out tests/data/jpeg]``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

# name -> (height, width, chroma sampling; 0 = gray)
FIXTURES = {
    "c420_45x67": (45, 67, 420),
    "c422_45x67": (45, 67, 422),
    "c440_45x67": (45, 67, 440),
    "c444_45x67": (45, 67, 444),
    "gray_45x67": (45, 67, 0),
    "c420_161x243": (161, 243, 420),
}
QUALITY = 90


def texture(rng, h: int, w: int) -> np.ndarray:
    """Blocks of random colour with smooth colour waves and sharp edges:
    chroma that changes at every scale the upsampling filters."""
    base = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, 3)).astype(np.float32)
    img = np.kron(base, np.ones((4, 4, 1), np.float32))[:h, :w]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img[..., 0] += 60 * np.sin(xx / 7.0)
    img[..., 2] += 50 * np.cos(yy / 5.0)
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "tests" / "data" / "jpeg")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from vit_colmap_tpu_torch.kernels import host_build
    from vit_colmap_tpu_torch.models.dinov2 import patch_grid_size
    from vit_colmap_tpu_torch.utils import native_io

    if host_build.jpeg_codec() != "libjpeg":
        print("torch_jpeg_fixtures: needs libjpeg.so.62 (the reference codec)",
              file=sys.stderr)
        return 2
    args.out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    for name, (h, w, chroma) in FIXTURES.items():
        img = texture(rng, h, w)
        path = args.out / f"{name}.jpg"
        if chroma:
            native_io.encode_jpeg(path, img, QUALITY, chroma)
        else:
            native_io.encode_jpeg(path, img[..., 0], QUALITY)
        th, tw = patch_grid_size(h, w)
        i420, ok = native_io.decode_batch_i420([path], tw, th)
        assert ok.all(), path
        np.savez_compressed(args.out / f"{name}.npz", ycc=native_io.decode_jpeg_ycc(path),
                            i420=i420[0], rgb=native_io.decode_jpeg_rgb(path),
                            size=np.array([tw, th]))
        print(f"{name}: {path.stat().st_size} bytes, I420 {tw}x{th}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
