"""The JPEG route of this machine's codec against libjpeg's bytes of the
committed fixtures (``tests/data/jpeg/``, written by
``scripts/torch_jpeg_fixtures.py``): per plane, the largest and the mean
absolute difference of

* ``ycc``: full-resolution YCbCr (``native_io.decode_jpeg_ycc``);
* ``i420``: the extractor's I420 at the patch-aligned size, Y, U and V
  (``native_io.decode_batch_i420``, on card 0 where nvJPEG decodes);
* ``rgb``: R, G and B (``native_io.decode_jpeg_rgb``);
* ``i420_stored``: the I420 the route gave before libjpeg's upsampling was
  added to it: the stored chroma planes resampled straight to the I420
  grid by the decoder's half-pixel bilinear (re-done here in numpy f32).

On the card's machine the codec is nvJPEG, so what is left is its IDCT's
rounding; on a machine with libjpeg every difference but
``i420_stored``'s is 0.  Prints one JSON line (with the card's name and
power limit where ``nvidia-smi`` runs).  Run: ``python3
scripts/torch_nvjpeg_planes.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "data" / "jpeg"


def resample_plane(src: np.ndarray, tw: int, th: int) -> np.ndarray:
    """``csrc/host/image_io.cc``'s ``resample_plane`` in f32 numpy."""
    sh, sw = src.shape
    if (sw, sh) == (tw, th):
        return src.copy()
    sx, sy = np.float32(sw / tw), np.float32(sh / th)

    def axis(n_out, scale, n_in):
        c = np.maximum((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * scale
                       - np.float32(0.5), np.float32(0))
        i = np.clip(c.astype(np.int32), 0, max(n_in - 2, 0))
        return i, np.minimum(i + 1, n_in - 1) if n_in > 1 else i, (c - i).astype(np.float32)

    x0, x1, fx = axis(tw, sx, sw)
    y0, y1, fy = axis(th, sy, sh)
    s = src.astype(np.float32)
    r0, r1 = s[y0], s[y1]
    a = r0[:, x0] + (r0[:, x1] - r0[:, x0]) * fx
    b = r1[:, x0] + (r1[:, x1] - r1[:, x0]) * fx
    v = a + (b - a) * fy[:, None]
    return (v + np.float32(0.5)).astype(np.uint8)


def stored_route_i420(planes, tw: int, th: int) -> np.ndarray:
    y, cb, cr = planes
    if cb.size == 0:
        cb = cr = np.full_like(y, 128)
    return np.concatenate([resample_plane(y, tw, th).ravel(),
                           resample_plane(cb, tw // 2, th // 2).ravel(),
                           resample_plane(cr, tw // 2, th // 2).ravel()])


def i420_planes(flat: np.ndarray, tw: int, th: int) -> dict:
    n, nc = tw * th, (tw // 2) * (th // 2)
    flat = flat.ravel()
    return {"Y": flat[:n], "U": flat[n:n + nc], "V": flat[n + nc:]}


def diff(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return {"max": int(d.max()), "mean": float(d.mean())}


def measure() -> dict:
    """fixture -> route -> plane -> {max, mean}."""
    from vit_colmap_tpu_torch.utils import native_io

    out = {}
    for jpg in sorted(FIXTURES.glob("*.jpg")):
        ref = np.load(jpg.with_suffix(".npz"))
        tw, th = (int(v) for v in ref["size"])
        i420, ok = native_io.decode_batch_i420([jpg], tw, th, device=0)
        if not ok.all():
            raise RuntimeError(f"{jpg.name}: decode failed")
        ycc = native_io.decode_jpeg_ycc(jpg)
        rgb = native_io.decode_jpeg_rgb(jpg)
        stored = stored_route_i420(native_io.decode_jpeg_planes(jpg), tw, th)
        want = i420_planes(ref["i420"], tw, th)
        out[jpg.stem] = {
            "ycc": {p: diff(ycc[..., c], ref["ycc"][..., c]) for c, p in enumerate("YUV")},
            "i420": {p: diff(v, want[p]) for p, v in i420_planes(i420[0], tw, th).items()},
            "rgb": {p: diff(rgb[..., c], ref["rgb"][..., c]) for c, p in enumerate("RGB")},
            "i420_stored": {p: diff(v, want[p])
                            for p, v in i420_planes(stored, tw, th).items()},
        }
    return out


def worst(per_fixture: dict) -> dict:
    """route -> plane -> the largest max and mean over the fixtures."""
    routes = {}
    for res in per_fixture.values():
        for route, planes in res.items():
            for p, d in planes.items():
                w = routes.setdefault(route, {}).setdefault(p, {"max": 0, "mean": 0.0})
                w["max"] = max(w["max"], d["max"])
                w["mean"] = max(w["mean"], d["mean"])
    return routes


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from vit_colmap_tpu_torch.kernels import host_build

    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except OSError:
        card = "none"
    per = measure()
    print(json.dumps({"codec": host_build.jpeg_codec(), "card": card, "worst": worst(per),
                      "fixtures": per}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
