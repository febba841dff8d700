#!/usr/bin/env python
"""Write OpenCV's SIFT rows of the fidelity table's cases as a fixture.

``scripts/torch_sift_fidelity_table.py`` holds the port's SIFT to cv2's on
the card's machine, which has no OpenCV.  This script, run where OpenCV
exists, renders each case's pair exactly as the table does (the port's
numpy renderer), the pinned zoom rows included, and writes cv2's row for it to
``tests/data/sift_fidelity/cv2_rows.json``: keypoints (mean of the two
images), mutual-NN matches, MMA@3 against the homography, and the sha1 of
both images, which the table checks before it uses the row.

    python3 scripts/torch_sift_fidelity_fixtures.py [--output PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import cv2
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from scripts.torch_sift_fidelity_table import (  # noqa: E402
    CASES,
    FIXTURE,
    PINNED_CASES,
    mma,
    mutual_nn,
    sha1,
    warp_pair,
)


def cv2_features(img, n=1024):
    """cv2's SIFT of one RGB image: (keypoints (N, 2), descriptors)."""
    sift = cv2.SIFT_create(nfeatures=n)
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    kps, desc = sift.detectAndCompute(gray, None)
    kp = np.array([k.pt for k in kps], np.float32).reshape(-1, 2)
    return kp, (desc if desc is not None else np.zeros((0, 128), np.float32))


def opencv_row(img1, img2, H, n: int) -> dict:
    t0 = time.perf_counter()
    k1, d1 = cv2_features(img1, n)
    k2, d2 = cv2_features(img2, n)
    dt = time.perf_counter() - t0
    m = mutual_nn(d1, d2)
    return {"cv2_kpts": int((len(k1) + len(k2)) / 2), "cv2_matches": int(len(m)),
            "cv2_mma3": round(mma(k1, k2, m, H, t=3.0), 4), "cv2_wall_s": round(dt, 2)}


def fixture_rows(cases=(*CASES, *PINNED_CASES)) -> list[dict]:
    rows = []
    for label, size, seed, scale, n in cases:
        img1, img2, H = warp_pair(seed=seed, size=size, scale=scale)
        row = {"case": label, "sha1_1": sha1(img1), "sha1_2": sha1(img2)}
        row.update({k: v for k, v in opencv_row(img1, img2, H, n).items() if k != "cv2_wall_s"})
        rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--output", type=Path, default=FIXTURE)
    args = ap.parse_args(argv)
    out = {"cv2_version": cv2.__version__, "numpy_version": np.__version__,
           "rows": fixture_rows()}
    args.output.parent.mkdir(parents=True, exist_ok=True)
    args.output.write_text(json.dumps(out, indent=1) + "\n")
    print(f"Wrote {args.output} ({len(out['rows'])} cases, cv2 {cv2.__version__})")


if __name__ == "__main__":
    main()
