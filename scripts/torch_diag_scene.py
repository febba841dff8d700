#!/usr/bin/env python
"""Root-cause a reconstruction that registers nothing, on the PyTorch/CUDA
port.

Counterpart of ``scripts/diag_scene.py``, with its flags and printed lines:
replays the mapper's initialization decision (``sfm/incremental.py``:
``_MapperState``, ``IncrementalMapper._bootstrap_candidates``,
``_triangulation_angles``, ``_reproj_errors``, and ``sfm/geometry``) on an
existing matched and verified database and prints, for each of the
``--top`` best candidate init pairs, which gate kills it:

  few_matches    raw verified inliers < max(min_num_matches, 30)
  tri_angle      triangulated points fail min_triangulation_angle_deg
  reproj         triangulated points fail filter_max_reproj_error_px
  ok             the pair initializes (n_good points)

The port's mapper fits each init pair at its own size, so nothing is padded
(the JAX package pads to a power-of-two bucket to bound its compiles).  The
init geometry runs on the host in both packages; ``--device`` is the
mapper's (PnP and bundle adjustment), as ``incremental_mapping`` takes it.

    python3 scripts/torch_diag_scene.py --db OUT/db.db [--top 20]
    python3 scripts/torch_diag_scene.py --db OUT/db.db --device cpu

Without CUDA and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--db", type=Path, required=True)
    ap.add_argument("--top", type=int, default=16,
                    help="diagnose the N best candidate pairs")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import vit_colmap_tpu_torch.sfm.geometry as geom
    from vit_colmap_tpu_torch.database import ColmapDatabase
    from vit_colmap_tpu_torch.sfm.incremental import (
        IncrementalMapper,
        _f32,
        _MapperState,
        _reproj_errors,
        _triangulation_angles,
    )
    from vit_colmap_tpu_torch.utils.config import ReconstructionConfig

    cfg = ReconstructionConfig()
    db = ColmapDatabase(args.db)
    cameras = db.read_cameras()
    images = db.read_images()
    keypoints = {}
    for iid in images:
        k = db.read_keypoints(iid)
        k = k[:, :2] if k is not None and len(k) else np.zeros((0, 2), np.float32)
        keypoints[iid] = geom.undistort_points(k, cameras[images[iid]["camera_id"]])
    geometries = db.read_all_two_view_geometries()
    db.close()

    all_pairs = {ids: g["inlier_matches"].astype(np.int64) for ids, g in geometries.items()}
    pair_matches = {ids: m for ids, m in all_pairs.items() if len(m) >= cfg.min_num_matches}
    print(json.dumps({
        "images": len(images),
        "two_view_geometries": len(all_pairs),
        "verified_pairs(min_num_matches)": len(pair_matches),
        "inlier_counts": sorted((len(m) for m in all_pairs.values()), reverse=True)[:30],
        "min_num_matches": cfg.min_num_matches,
        "init_floor": max(cfg.min_num_matches, 30),
        "good_floor": max(cfg.min_num_matches, 20),
        "min_tri_angle_deg": cfg.min_triangulation_angle_deg,
        "max_reproj_px": cfg.filter_max_reproj_error_px,
    }, indent=2))

    state = _MapperState(cameras, images, keypoints)
    mapper = IncrementalMapper(state, pair_matches, cfg, device=args.device)

    candidates = sorted(pair_matches.items(), key=lambda kv: -len(kv[1]))
    rows = []
    for (i1, i2), m in candidates[: args.top]:
        row = {"pair": (i1, i2), "matches": len(m)}
        if len(m) < max(cfg.min_num_matches, 30):
            row["verdict"] = "few_matches"
            rows.append(row)
            print(json.dumps(row), flush=True)
            continue
        k1, k2 = state.K(i1), state.K(i2)
        x1 = state.keypoints[i1][m[:, 0]].astype(np.float64)
        x2 = state.keypoints[i2][m[:, 1]].astype(np.float64)
        thr = cfg.filter_max_reproj_error_px
        P1 = k1 @ np.eye(3, 4)
        best = None
        for ci, (R, t) in enumerate(mapper._bootstrap_candidates(x1, x2, k1, k2)):
            P2 = k2 @ np.concatenate([R, t[:, None]], axis=1)
            X = geom.triangulate(_f32(P1)[None], _f32(P2)[None], _f32(x1)[None],
                                 _f32(x2)[None])[0].double().numpy()
            with np.errstate(all="ignore"):
                angles = _triangulation_angles(X, np.zeros(3), -R.T @ t)
                e1 = _reproj_errors(np.eye(3), np.zeros(3), k1, X, x1)
                e2 = _reproj_errors(R, t, k2, X, x2)
            ang_ok = angles > cfg.min_triangulation_angle_deg
            rep_ok = (e1 < thr) & (e2 < thr)
            good = ang_ok & rep_ok
            cand = {
                "cand": ci,
                "n_good": int(good.sum()),
                "n_angle_ok": int(ang_ok.sum()),
                "n_reproj_ok": int(rep_ok.sum()),
                "median_angle_deg": round(float(np.nanmedian(angles)), 3),
                "median_reproj_px": round(float(np.nanmedian(np.maximum(e1, e2))), 3),
            }
            if best is None or cand["n_good"] > best["n_good"]:
                best = cand
        row["best_candidate"] = best
        floor = max(cfg.min_num_matches, 20)
        if best["n_good"] >= floor:
            row["verdict"] = "ok"
        elif best["n_angle_ok"] < floor:
            row["verdict"] = "tri_angle"
        elif best["n_reproj_ok"] < floor:
            row["verdict"] = "reproj"
        else:
            row["verdict"] = "angle+reproj_disjoint"
        rows.append(row)
        print(json.dumps(row), flush=True)

    verdicts = {}
    for r in rows:
        verdicts[r["verdict"]] = verdicts.get(r["verdict"], 0) + 1
    out = {
        "metric": "diag_init_pairs_ok",
        "value": verdicts.get("ok", 0),
        "unit": "pairs",
        "verdicts": verdicts,
        "db": str(args.db),
    }
    print(json.dumps(out))
    return {**out, "rows": rows}


if __name__ == "__main__":
    main()
