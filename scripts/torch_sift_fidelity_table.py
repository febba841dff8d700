#!/usr/bin/env python
"""The port's SIFT against OpenCV's SIFT, across textures, sizes and scales.

Counterpart of ``scripts/sift_fidelity_table.py``, with its 8 cases (up to a
DTU-like 1200 x 1600 frame), its protocol (a structured synthetic image and
its warp by a known homography, mutual nearest neighbours, MMA at 3 px
against the homography), its markdown table and its JSON line.  The keys
keep the JAX script's names: the ``jax_*`` fields and the "jax" columns are
the port's SIFT (``ops/sift.extract_sift``), run on the card unless
``--device cpu``; ``cv2_wall_s`` is null where cv2's row comes from the
fixture.

The card's machine has no OpenCV, so cv2's rows are committed:
``scripts/torch_sift_fidelity_fixtures.py``, run where OpenCV exists, writes
``tests/data/sift_fidelity/cv2_rows.json`` (cv2's keypoints, matches and
MMA@3 on each case's pair, with the sha1 of both images).  The pair here is
rendered with the port's numpy renderer (``make_structured_image``,
``warp_perspective``, ``generate_random_homography``), so the script first
checks that each image's sha1 equals the fixture's.  Where OpenCV exists it
also recomputes cv2's rows and fails if they differ from the fixture.

The reference's pair maker sets ``cfg.scale_range`` for its two zoom cases,
an attribute its homography generator never reads, so those cases draw
their scale as the others do.  The 8 cases here draw the same homographies
(their labels kept), and the means that the bars judge are over them.  Two
more rows, ``PINNED_CASES``, pin the zoom (``min_scale = max_scale``) as the
labels meant; they are printed below the table and in the JSON line's
``pinned_rows``, outside the means.

It fails (exit status 1, after printing the table and the JSON line) where
the means over the cases miss the reference's bars
(``tests/test_sift_fidelity.py``): MMA@3 ratio >= 0.9 and match-volume
ratio >= 0.8 of cv2's.

    python3 scripts/torch_sift_fidelity_table.py            # the card
    python3 scripts/torch_sift_fidelity_table.py --device cpu --cases 3

Without CUDA and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FIXTURE = Path(__file__).resolve().parents[1] / "tests" / "data" / "sift_fidelity" / \
    "cv2_rows.json"
MMA_BAR = 0.9  # the port's MMA@3 over cv2's, mean over the cases
VOLUME_BAR = 0.8  # the port's mutual-NN matches over cv2's, mean over the cases

# (label, (h, w), seed, pinned scale or None, max keypoints): the
# reference's cases and draws (its zoom cases' scale is never applied).
CASES = [
    ("240x320/t0", (240, 320), 0, None, 1024),
    ("240x320/t1", (240, 320), 1, None, 1024),
    ("240x320/t2", (240, 320), 2, None, 1024),
    ("480x640/t3", (480, 640), 3, None, 2048),
    ("480x640/zoom0.7", (480, 640), 4, None, 2048),
    ("480x640/zoom1.4", (480, 640), 5, None, 2048),
    ("768x1024/t6", (768, 1024), 6, None, 4096),
    ("1200x1600/DTU-like", (1200, 1600), 7, None, 4096),
]
# The zoom cases with the scale pinned: reported, outside the means.
PINNED_CASES = [
    ("480x640/zoom0.7 pinned", (480, 640), 4, 0.7, 2048),
    ("480x640/zoom1.4 pinned", (480, 640), 5, 1.4, 2048),
]


def warp_pair(seed=0, size=(240, 320), scale=None):
    """(img1, img2, H): a structured image and its warp by a random
    moderate homography (the zoom pinned where ``scale`` is given)."""
    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import (
        make_structured_image,
        warp_perspective,
    )
    from vit_colmap_tpu_torch.dataloader.synthetic_homography import (
        SyntheticHomographyConfig,
        generate_random_homography,
    )

    rng = np.random.default_rng(seed)
    h, w = size
    img1 = make_structured_image(rng, h, w)
    cfg = SyntheticHomographyConfig.moderate()
    if scale is not None:
        cfg.min_scale = cfg.max_scale = scale
    H = generate_random_homography(w, h, cfg, rng)
    return img1, warp_perspective(img1, H, (w, h)), H


def mutual_nn(d1, d2):
    """Mutual nearest-neighbor matches on L2-normalized rows."""
    d1 = d1.astype(np.float32)
    d2 = d2.astype(np.float32)
    d1 /= np.maximum(np.linalg.norm(d1, axis=1, keepdims=True), 1e-8)
    d2 /= np.maximum(np.linalg.norm(d2, axis=1, keepdims=True), 1e-8)
    sim = d1 @ d2.T
    nn12 = sim.argmax(1)
    nn21 = sim.argmax(0)
    idx1 = np.arange(len(d1))
    mutual = nn21[nn12] == idx1
    return np.stack([idx1[mutual], nn12[mutual]], axis=1)


def mma(kp1, kp2, matches, H, t=3.0):
    if len(matches) == 0:
        return 0.0
    x1 = kp1[matches[:, 0], :2]
    x2 = kp2[matches[:, 1], :2]
    x1h = np.concatenate([x1, np.ones((len(x1), 1))], axis=1)
    proj = (H @ x1h.T).T
    proj = proj[:, :2] / proj[:, 2:]
    err = np.linalg.norm(proj - x2, axis=1)
    return float((err <= t).mean())


def sha1(img: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(img).tobytes()).hexdigest()


def score(name: str, features, img1, img2, H, n: int) -> dict:
    """One extractor's fields of a row: keypoints (mean of the two images),
    mutual-NN matches, MMA@3 and wall seconds."""
    t0 = time.perf_counter()
    k1, d1 = features(img1, n)
    k2, d2 = features(img2, n)
    dt = time.perf_counter() - t0
    m = mutual_nn(d1, d2)
    return {f"{name}_kpts": int((len(k1) + len(k2)) / 2), f"{name}_matches": int(len(m)),
            f"{name}_mma3": round(mma(k1, k2, m, H, t=3.0), 4),
            f"{name}_wall_s": round(dt, 2)}


def port_features(device):
    """The port's SIFT of one RGB image: (keypoints (N, 2), descriptors)."""
    from vit_colmap_tpu_torch.ops.sift import extract_sift
    from vit_colmap_tpu_torch.utils.image_io import rgb_to_gray

    def features(img, n):
        gray = rgb_to_gray(img).astype(np.float32) / 255.0
        kp, dc = extract_sift(gray[None], max_keypoints=n, device=device)
        return kp[0][:, :2], dc[0]

    return features


def load_fixture(path: Path = FIXTURE) -> dict:
    return json.loads(path.read_text())


def check_images(fixture_row: dict, img1, img2) -> None:
    got = (sha1(img1), sha1(img2))
    want = (fixture_row["sha1_1"], fixture_row["sha1_2"])
    if got != want:
        raise SystemExit(f"{fixture_row['case']}: the rendered pair's sha1 {got} is not the "
                         f"fixture's {want}: cv2's committed row is not of these images")


def live_opencv_row():
    """cv2's rows computed here, or None where OpenCV is not installed."""
    try:
        from scripts.torch_sift_fidelity_fixtures import opencv_row
    except ImportError:
        return None
    return opencv_row


CV2_FIELDS = ("cv2_kpts", "cv2_matches", "cv2_mma3")


def run(cases=CASES, device=None, fixture: dict | None = None, pinned=PINNED_CASES) -> dict:
    """Every case's row, and the JSON line's fields; the ``pinned`` cases'
    rows in ``pinned_rows``, outside the means."""
    fixture = fixture or load_fixture()
    by_case = {r["case"]: r for r in fixture["rows"]}
    features = port_features(device)
    opencv_row = live_opencv_row()
    live_mismatch = []

    def case_row(label, size, seed, scale, n):
        img1, img2, H = warp_pair(seed=seed, size=size, scale=scale)
        ref = by_case[label]
        check_images(ref, img1, img2)
        row = {"case": label, "h": size[0], "w": size[1], "n_feats": n}
        row.update({k: ref[k] for k in CV2_FIELDS}, cv2_wall_s=None)
        if opencv_row is not None:
            live = opencv_row(img1, img2, H, n)
            if any(live[k] != ref[k] for k in CV2_FIELDS):
                live_mismatch.append((label, {k: live[k] for k in CV2_FIELDS}))
            row["cv2_wall_s"] = live["cv2_wall_s"]
        row.update(score("jax", features, img1, img2, H, n))
        row["match_ratio"] = round(row["jax_matches"] / max(row["cv2_matches"], 1), 3)
        row["mma_ratio"] = round(row["jax_mma3"] / max(row["cv2_mma3"], 1e-9), 3)
        return row

    rows = [case_row(*case) for case in cases]
    pinned_rows = [case_row(*case) for case in pinned]
    vol = float(np.mean([r["match_ratio"] for r in rows]))
    mma_mean = float(np.mean([r["mma_ratio"] for r in rows]))
    return {
        "metric": "sift_fidelity_match_volume_ratio",
        "value": round(vol, 4),
        "unit": "jax/cv2 mutual-NN matches (mean over cases)",
        "vs_baseline": round(mma_mean, 4),
        "mma_ratio_mean": round(mma_mean, 4),
        "rows": rows,
        "cv2_version": fixture["cv2_version"],
        "pinned_rows": pinned_rows,
        "live_cv2_mismatch": live_mismatch,
    }


def table(rows, pinned_rows=()) -> str:
    """The markdown table; ``pinned_rows`` below it, outside the means."""
    lines = ["| case | cv2 kpts | jax kpts | cv2 matches | jax matches | "
             "vol ratio | cv2 MMA@3 | jax MMA@3 | MMA ratio |", "|" + "---|" * 9]
    for r in [*rows, *pinned_rows]:
        lines.append(
            f"| {r['case']} | {r['cv2_kpts']} | {r['jax_kpts']} | "
            f"{r['cv2_matches']} | {r['jax_matches']} | {r['match_ratio']} | "
            f"{r['cv2_mma3']:.3f} | {r['jax_mma3']:.3f} | {r['mma_ratio']} |")
    if pinned_rows:
        lines.insert(2 + len(rows), "| *pinned zoom, outside the means* |" + " |" * 8)
    return "\n".join(lines)


def missed(out: dict) -> list[str]:
    """What fails the run: a bar missed, or live cv2 rows off the fixture."""
    why = []
    if out["mma_ratio_mean"] < MMA_BAR:
        why.append(f"mean MMA@3 ratio {out['mma_ratio_mean']} < {MMA_BAR}")
    if out["value"] < VOLUME_BAR:
        why.append(f"mean match-volume ratio {out['value']} < {VOLUME_BAR}")
    if out["live_cv2_mismatch"]:
        why.append(f"live cv2 rows differ from the fixture: {out['live_cv2_mismatch']}")
    return why


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", type=int, default=len(CASES),
                    help="run the first N cases (default: all)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from vit_colmap_tpu_torch.device import resolve_device

    resolve_device(args.device)  # raises without CUDA unless --device cpu
    out = run(CASES[:args.cases], args.device)
    print(table(out["rows"], out["pinned_rows"]))
    print(json.dumps(out))
    why = missed(out)
    if why:
        raise SystemExit("sift fidelity: " + "; ".join(why))
    return out


if __name__ == "__main__":
    main()
