"""Ground-truth pose oracle: similarity alignment + pose-error metrics.

The port's copy of ``vit_colmap_tpu/sfm/align.py`` (numpy only).  A
reconstruction is only defined up to a 3D similarity (gauge freedom), so
estimated camera centers are aligned to the ground-truth centers with the
closed-form Umeyama solver, and rotation / camera-center errors are
reported in the ground-truth frame.  ``chip_smoke.py``'s mapper phase holds
the port's mapper to these errors on a scene with known poses.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform mapping ``src`` -> ``dst``.

    Returns (s, R, t) such that ``dst ≈ s * R @ src + t`` (Umeyama 1991,
    closed form).  ``src``/``dst`` are (N, 3) with N >= 3 non-degenerate
    points.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if src.shape != dst.shape or src.shape[0] < 3:
        raise ValueError(f"need matched (N>=3, 3) point sets, got {src.shape}")
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-18))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def rotation_angle_deg(R: np.ndarray) -> float:
    """Geodesic angle of a rotation matrix, in degrees."""
    c = (np.trace(R) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def save_gt_poses(path: Path | str, cams: Sequence[tuple], names: list[str]) -> None:
    """Persist ground-truth world->camera poses [(R, t), ...] keyed by image
    file name, so cached benchmark scenes keep their oracle across runs."""
    payload = {
        name: {"R": np.asarray(R).tolist(), "t": np.asarray(t).tolist()}
        for name, (R, t) in zip(names, cams)
    }
    Path(path).write_text(json.dumps(payload))


def load_gt_poses(path: Path | str) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    data = json.loads(Path(path).read_text())
    return {
        name: (np.asarray(p["R"], np.float64), np.asarray(p["t"], np.float64))
        for name, p in data.items()
    }


def gt_poses_for_rendered_scene(image_dir: Path | str) -> Optional[dict]:
    """Load the oracle for a scene rendered by ``render_multiview_scene``:
    reads ``gt_poses.json`` next to the image dir; falls back to None."""
    image_dir = Path(image_dir)
    for cand in (image_dir / "gt_poses.json", image_dir.parent / "gt_poses.json"):
        if cand.exists():
            return load_gt_poses(cand)
    return None


_VIEW_RE = re.compile(r"view_(\d+)")


def pose_errors_vs_gt(
    rec,
    gt: dict[str, tuple[np.ndarray, np.ndarray]],
) -> Optional[dict]:
    """Align a :class:`~vit_colmap_tpu_torch.sfm.reconstruction.Reconstruction` to
    ground-truth world->camera poses and report pose errors.

    The gauge similarity is estimated pose-based (rotation from orientation
    pairs, scale/translation from centers — see inline note on the
    collinear-centers degeneracy of center-only Umeyama); :func:`umeyama`
    remains the point-set alignment primitive.  Returns None when fewer
    than 3 registered images have GT (alignment undefined).  Errors:
    rotation in degrees (geodesic), camera-center distance both absolute
    (GT units) and relative to the GT scene scale (camera-center
    bounding-box diagonal) — the "<0.5 deg / <1% scene scale" regression
    contract lives on these fields.
    """
    pairs = []  # (name, R_est, C_est, R_gt, C_gt)
    for im in rec.images.values():
        if im.name not in gt:
            continue
        R_gt, t_gt = gt[im.name]
        C_gt = -R_gt.T @ t_gt
        pairs.append((im.name, im.R(), im.projection_center(), R_gt, C_gt))
    if len(pairs) < 3:
        return None

    C_est = np.stack([p[2] for p in pairs])
    C_gt = np.stack([p[4] for p in pairs])
    # Gauge rotation from the camera ORIENTATIONS, not the centers: center-
    # only Umeyama leaves the rotation about the trajectory axis free when
    # camera centers are nearly collinear (an arc of cameras — exactly this
    # benchmark's geometry), which shows up as a uniform phantom rotation
    # error on every camera.  Each orientation pair fully constrains the
    # gauge: R_gt,i ≈ R_est,i @ R_a^T  =>  R_a ≈ (R_est,i^T R_gt,i)^T;
    # average over cameras by projecting the sum onto SO(3).
    M = sum(R_gt.T @ R_est for _, R_est, _, R_gt, _ in pairs)
    U, _, Vt = np.linalg.svd(M)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R_a = U @ S @ Vt
    # Scale + translation: least squares on centers given R_a.
    mu_e, mu_g = C_est.mean(axis=0), C_gt.mean(axis=0)
    d_e = (C_est - mu_e) @ R_a.T
    d_g = C_gt - mu_g
    denom = float((d_e**2).sum())
    s = float((d_e * d_g).sum() / denom) if denom > 1e-18 else 1.0
    t_a = mu_g - s * R_a @ mu_e

    all_gt_centers = np.stack([-R.T @ t for R, t in gt.values()])
    span = all_gt_centers.max(axis=0) - all_gt_centers.min(axis=0)
    scene_scale = float(np.linalg.norm(span))

    rot_errs, center_errs = [], []
    per_image = {}
    for name, R_est, C_e, R_gt, C_g in pairs:
        # World-frame alignment X_gt = s R_a X_est + t_a transforms a
        # world->camera rotation as R_est -> R_est @ R_a^T.
        R_hat = R_est @ R_a.T
        e_rot = rotation_angle_deg(R_hat @ R_gt.T)
        e_ctr = float(np.linalg.norm(s * R_a @ C_e + t_a - C_g))
        rot_errs.append(e_rot)
        center_errs.append(e_ctr)
        per_image[name] = {"rot_deg": e_rot, "center": e_ctr}

    rot_errs = np.array(rot_errs)
    center_errs = np.array(center_errs)
    rel = center_errs / max(scene_scale, 1e-12)
    return {
        "aligned_cameras": len(pairs),
        "scale": s,
        "scene_scale": scene_scale,
        "pose_rot_err_deg_mean": float(rot_errs.mean()),
        "pose_rot_err_deg_max": float(rot_errs.max()),
        "pose_center_err_mean": float(center_errs.mean()),
        "pose_center_err_max": float(center_errs.max()),
        "pose_center_err_rel_mean": float(rel.mean()),
        "pose_center_err_rel_max": float(rel.max()),
        "per_image": per_image,
    }


def best_pose_errors(reconstructions, gt) -> Optional[dict]:
    """Pose errors for the largest model of a pipeline run (mirrors how the
    reference reports stats on pycolmap's main model)."""
    if not reconstructions or gt is None:
        return None
    biggest = max(reconstructions.values(), key=lambda r: len(r.images))
    return pose_errors_vs_gt(biggest, gt)
