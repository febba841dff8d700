"""Incremental structure-from-motion mapper.

The port's copy of ``vit_colmap_tpu/sfm/incremental.py``.  Host code
orchestrates the model-building loop and keeps the model's state in numpy
float64; the iterative programs run on the mapper's device (``cuda`` unless
the caller asks for the CPU):

* registration: vectorized PnP RANSAC (:mod:`vit_colmap_tpu_torch.sfm.pnp`),
  its sample uniforms drawn on a CPU generator, so that the card and the
  CPU register with the same samples,
* refinement: Levenberg-Marquardt bundle adjustment
  (:mod:`vit_colmap_tpu_torch.sfm.bundle`), local after every registration
  and global as the model grows.

The one-shot glue geometry (the init pair's E / H bootstrap and
triangulation, the new points' triangulation, axis-angle conversions) is a
few hundred microseconds of math per call and runs on CPU tensors, as the
reference runs it on its host CPU backend: on the card each of its many
small operations would be one launch.  The reference pads every problem to
a shape bucket so that XLA programs are reused; padded rows carry zero
weight, so the port does not pad (``ba_coarse_buckets`` is accepted and has
no effect; ``ba_unified_iters`` still sets the LM budget).

Supports multiple models (``ReconstructionConfig.multiple_models``) and
writes COLMAP-format sparse models to ``output_path/<idx>/``.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.device import resolve_device
from vit_colmap_tpu_torch.pipeline.match import camera_matrix
from vit_colmap_tpu_torch.sfm import geometry as geom
from vit_colmap_tpu_torch.sfm.bundle import (
    axis_angle_to_matrix,
    bundle_adjust_packed,
    matrix_to_axis_angle,
    pack_ba_problem,
    unpack_ba_result,
)
from vit_colmap_tpu_torch.sfm.pnp import pnp_ransac_packed
from vit_colmap_tpu_torch.sfm.reconstruction import Camera, Image, Point3D, Reconstruction
from vit_colmap_tpu_torch.utils.config import ReconstructionConfig

logger = logging.getLogger(__name__)

PNP_ITERS = 512

# A function that draws one registration attempt's PnP uniforms, (iters, 6)
# float32 in [0, 1) on the CPU; a mapper draws from its own.
PnPSampler = Callable[[int], torch.Tensor]


def default_pnp_sampler() -> PnPSampler:
    """The mapper's sampler: one CPU generator, seeded 0 for each model."""
    gen = torch.Generator().manual_seed(0)
    return lambda iters: torch.rand((iters, 6), generator=gen)


def _f32(a) -> torch.Tensor:
    """A host array as a CPU float32 tensor (a copy), for the glue
    geometry."""
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _qvec_from_R(R: np.ndarray) -> np.ndarray:
    return geom.rotmat_to_qvec(_f32(R)).numpy()


class _MapperState:
    """Mutable state of one model being built.

    ``feat_pid`` keeps a per-image int64 array mapping keypoint index ->
    point id (-1 = none), so correspondence counting and triangulation
    candidacy are vectorized gathers, not dict lookups."""

    def __init__(self, cameras, images, keypoints, keypoints_raw=None):
        self.cameras = cameras  # camera_id -> db dict
        self.images = images  # image_id -> db dict
        self.keypoints = keypoints  # image_id -> (N, 2) float32, undistorted
        # Raw (distorted) pixel observations for BA with in-model radial
        # distortion (COLMAP convention).  Same arrays when no distortion.
        self.keypoints_raw = keypoints_raw if keypoints_raw is not None else keypoints
        self.poses: dict[int, tuple[np.ndarray, np.ndarray]] = {}  # id -> (R, t)
        self.points: dict[int, np.ndarray] = {}  # point_id -> xyz
        self.tracks: dict[int, list[tuple[int, int]]] = {}
        self.feat_pid: dict[int, np.ndarray] = {
            iid: np.full(len(k), -1, np.int64) for iid, k in keypoints.items()
        }
        self.next_point_id = 1

    def K(self, image_id: int) -> np.ndarray:
        return camera_matrix(self.cameras[self.images[image_id]["camera_id"]])

    def add_point(self, xyz, obs: list[tuple[int, int]]) -> int:
        pid = self.next_point_id
        self.next_point_id += 1
        self.points[pid] = np.asarray(xyz, np.float64)
        self.tracks[pid] = list(obs)
        for iid, f in obs:
            self.feat_pid[iid][f] = pid
        return pid

    def add_observation(self, pid: int, image_id: int, feat: int) -> None:
        if self.feat_pid[image_id][feat] < 0:
            self.feat_pid[image_id][feat] = pid
            self.tracks[pid].append((image_id, feat))

    def remove_point(self, pid: int) -> None:
        for iid, f in self.tracks.pop(pid, []):
            if self.feat_pid[iid][f] == pid:
                self.feat_pid[iid][f] = -1
        self.points.pop(pid, None)


def _triangulation_angles(X, C1, C2):
    r1 = X - C1
    r2 = X - C2
    cos = np.sum(r1 * r2, axis=-1) / np.maximum(
        np.linalg.norm(r1, axis=-1) * np.linalg.norm(r2, axis=-1), 1e-12
    )
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def _reproj_errors(R, t, K, X, xy):
    Xc = X @ R.T + t
    z = np.where(np.abs(Xc[:, 2:]) > 1e-9, Xc[:, 2:], 1e-9)
    uv = (Xc[:, :2] / z) * np.array([K[0, 0], K[1, 1]]) + np.array([K[0, 2], K[1, 2]])
    err = np.linalg.norm(uv - xy, axis=-1)
    return np.where(Xc[:, 2] > 1e-6, err, np.inf)


class IncrementalMapper:
    def __init__(self, state: _MapperState, pair_matches, config: ReconstructionConfig,
                 device=None, pnp_sampler: Optional[PnPSampler] = None):
        self.s = state
        self.pair_matches = pair_matches  # (id1, id2) -> (M, 2) inlier matches
        self.cfg = config
        self.device = resolve_device(device)
        self._pnp_uniforms = pnp_sampler or default_pnp_sampler()
        # Per-phase wall-clock inside bundle_adjust, and its LM iterations
        # and device-to-host syncs.
        self.ba_phases = {"asm": 0.0, "solve": 0.0, "readback": 0.0, "calls": 0,
                          "lm_iters": 0, "syncs": 0}

    # ------------------------------------------------------ initialization
    def initialize(self) -> bool:
        """Pick the best verified pair and bootstrap the model."""
        t0 = time.perf_counter()
        candidates = sorted(self.pair_matches.items(), key=lambda kv: -len(kv[1]))
        for (i1, i2), m in candidates:
            if len(m) < max(self.cfg.min_num_matches, 30):
                continue
            if self._try_init_pair(i1, i2, m):
                logger.info("Initialization took %.1fs", time.perf_counter() - t0)
                return True
        return False

    def _bootstrap_candidates(self, x1, x2, k1, k2):
        """Candidate relative poses for an init pair: the essential-matrix
        pose plus the homography decompositions (planar / low-parallax
        scenes make E degenerate; COLMAP falls back to H there too)."""
        x1n = (x1 - k1[:2, 2]) / np.diag(k1)[:2]
        x2n = (x2 - k2[:2, 2]) / np.diag(k2)[:2]
        cands = []
        E = geom.fit_essential(_f32(x1n)[None], _f32(x2n)[None])
        R, t = geom.recover_pose_from_E(E, _f32(x1n)[None], _f32(x2n)[None],
                                        torch.ones((1, len(x1)), dtype=torch.bool))
        cands.append((R[0].double().numpy(), t[0].double().numpy()))
        H = geom.fit_homography(_f32(x1)[None], _f32(x2)[None])[0].double().numpy()
        if np.isfinite(H).all():
            with np.errstate(all="ignore"):
                Rs, ts, _ = geom.decompose_homography(H, k1)
            for Rk, tk in zip(Rs, ts):
                norm = np.linalg.norm(tk)
                if norm > 1e-8:
                    cands.append((Rk, tk / norm))
        return cands

    def _try_init_pair(self, i1, i2, m) -> bool:
        s = self.s
        k1, k2 = s.K(i1), s.K(i2)
        x1 = s.keypoints[i1][m[:, 0]].astype(np.float64)
        x2 = s.keypoints[i2][m[:, 1]].astype(np.float64)
        thr = self.cfg.filter_max_reproj_error_px

        best = None  # (n_good, good mask, R, t, X)
        P1 = k1 @ np.eye(3, 4)
        for R, t in self._bootstrap_candidates(x1, x2, k1, k2):
            P2 = k2 @ np.concatenate([R, t[:, None]], axis=1)
            X = geom.triangulate(_f32(P1)[None], _f32(P2)[None], _f32(x1)[None],
                                 _f32(x2)[None])[0].double().numpy()
            with np.errstate(all="ignore"):
                angles = _triangulation_angles(X, np.zeros(3), -R.T @ t)
                e1 = _reproj_errors(np.eye(3), np.zeros(3), k1, X, x1)
                e2 = _reproj_errors(R, t, k2, X, x2)
            good = (
                (angles > self.cfg.min_triangulation_angle_deg)
                & (e1 < thr)  # NaN compares False
                & (e2 < thr)
            )
            if best is None or good.sum() > best[0]:
                best = (int(good.sum()), good, R, t, X)

        n_good, good, R, t, X = best
        if n_good < max(self.cfg.min_num_matches, 20):
            return False

        s.poses[i1] = (np.eye(3), np.zeros(3))
        s.poses[i2] = (R, t)
        for idx in np.nonzero(good)[0]:
            s.add_point(X[idx], [(i1, int(m[idx, 0])), (i2, int(m[idx, 1]))])
        logger.info("Initialized model with pair (%d, %d): %d points", i1, i2, n_good)
        return True

    # --------------------------------------------------------- registration
    def _pairs_with(self, iid):
        """Yield (other_id, feats_self, feats_other) for registered partners."""
        s = self.s
        for (a, b), m in self.pair_matches.items():
            if a == iid and b in s.poses:
                yield b, m[:, 0], m[:, 1]
            elif b == iid and a in s.poses:
                yield a, m[:, 1], m[:, 0]

    def find_next_image(self):
        """Unregistered image with most visible 3D points (vectorized count)."""
        s = self.s
        best, best_count = None, 0
        for iid in s.images:
            if iid in s.poses:
                continue
            count = 0
            for other, fs, fo in self._pairs_with(iid):
                count += int((s.feat_pid[other][fo] >= 0).sum())
            if count > best_count:
                best, best_count = iid, count
        if best is None or best_count < 6:
            return None, None
        return best, self._collect_2d3d(best)

    def _collect_2d3d(self, iid):
        """[(feat_idx, point_id)] correspondences of an unregistered image."""
        s = self.s
        out = {}
        for other, fs, fo in self._pairs_with(iid):
            pids = s.feat_pid[other][fo]
            sel = pids >= 0
            for f_self, pid in zip(fs[sel], pids[sel]):
                if int(f_self) not in out:
                    out[int(f_self)] = int(pid)
        return list(out.items())

    def register_image(self, iid, corrs) -> bool:
        s = self.s
        xy = s.keypoints[iid][[f for f, _ in corrs]].astype(np.float32)
        X = np.stack([s.points[p] for _, p in corrs]).astype(np.float32)
        n = len(corrs)
        # One buffer up, one result vector down.
        fbuf = np.concatenate([xy.ravel(), X.ravel(),
                               np.asarray(s.K(iid), np.float32).ravel()])
        u = self._pnp_uniforms(PNP_ITERS).to(torch.float32)
        out = pnp_ransac_packed(
            torch.from_numpy(fbuf).to(self.device),
            torch.ones(n, dtype=torch.bool, device=self.device),
            u.to(self.device), n=n,
            max_error_px=self.cfg.filter_max_reproj_error_px * 2,
        ).cpu().numpy()
        n_inl = int(out[12])
        floor = max(6, self.cfg.min_num_matches // 2)
        if n_inl < floor:
            logger.info("Image %d not registered: %d/%d inliers, fewer than %d",
                        iid, n_inl, n, floor)
            return False
        R = out[:9].reshape(3, 3).astype(np.float64)
        t = out[9:12].astype(np.float64)
        s.poses[iid] = (R, t)
        inl = out[13: 13 + n] > 0.5
        for (f, pid), ok in zip(corrs, inl):
            if ok and pid in s.points:
                s.add_observation(pid, iid, f)
        logger.info("Registered image %d with %d/%d inliers", iid, n_inl, n)
        return True

    # --------------------------------------------------------------- merging
    def _merge_candidate(self, pa: int, pb: int):
        """Structural checks of COLMAP's MergeTracks: the weighted merged
        position when ``pa``/``pb`` are distinct live points whose combined
        track observes no image twice, else None."""
        s = self.s
        if pa == pb or pa not in s.points or pb not in s.points:
            return None
        ta, tb = s.tracks[pa], s.tracks[pb]
        imgs_a = {i for i, _ in ta}
        if any(i in imgs_a for i, _ in tb):
            return None
        wa, wb = len(ta), len(tb)
        return (wa * s.points[pa] + wb * s.points[pb]) / (wa + wb)

    def _merge_apply(self, pa: int, pb: int, xyz: np.ndarray) -> None:
        """Absorb pb into pa at the merged position."""
        s = self.s
        s.points[pa] = xyz
        for iid, f in s.tracks[pb]:
            s.feat_pid[iid][f] = pa
            s.tracks[pa].append((iid, f))
        s.points.pop(pb)
        s.tracks.pop(pb)

    @staticmethod
    def _track_consistent(Rs, ts, Ks, xyz_rows, uv, thr):
        """Per observation: in front of its camera and reprojecting within
        ``thr`` pixels."""
        Xc = np.einsum("nij,nj->ni", Rs, xyz_rows) + ts
        z = Xc[:, 2]
        zs = np.where(np.abs(z) > 1e-9, z, 1e-9)
        u = Xc[:, 0] / zs * Ks[:, 0, 0] + Ks[:, 0, 2]
        v = Xc[:, 1] / zs * Ks[:, 1, 1] + Ks[:, 1, 2]
        err = np.hypot(u - uv[:, 0], v - uv[:, 1])
        return (z > 1e-6) & np.isfinite(err) & (err <= thr)

    def try_merge(self, pa: int, pb: int) -> bool:
        """Merge two 3D points into one track (COLMAP's MergeTracks) when the
        combined track is geometrically consistent."""
        s = self.s
        xyz = self._merge_candidate(pa, pb)
        if xyz is None:
            return False
        obs = [(i, f) for i, f in s.tracks[pa] + s.tracks[pb] if i in s.poses]
        if obs:
            Rs = np.stack([s.poses[i][0] for i, _ in obs])
            ts = np.stack([s.poses[i][1] for i, _ in obs])
            Ks = np.stack([s.K(i) for i, _ in obs])
            uv = np.stack([s.keypoints[i][f] for i, f in obs]).astype(np.float64)
            xyz_rows = np.broadcast_to(xyz, (len(obs), 3))
            if not self._track_consistent(Rs, ts, Ks, xyz_rows, uv,
                                          self.cfg.filter_max_reproj_error_px).all():
                return False
        self._merge_apply(pa, pb, xyz)
        return True

    def try_merge_batch(self, pairs) -> int:
        """Batched MergeTracks over candidate (pa, pb) pairs: the consistency
        reprojections of all candidates with mutually disjoint pids run as
        one flat numpy computation; a candidate sharing a pid with an
        earlier one chains through :meth:`try_merge` afterwards, preserving
        the sequential semantics."""
        s = self.s
        img_ids = sorted(s.poses.keys())
        if not img_ids:
            return sum(bool(self.try_merge(int(a), int(b))) for a, b in pairs)
        idx = {iid: k for k, iid in enumerate(img_ids)}
        Rs = np.stack([s.poses[i][0] for i in img_ids])
        ts = np.stack([s.poses[i][1] for i in img_ids])
        Ks = np.stack([s.K(i) for i in img_ids])

        cands: list[tuple[int, int, np.ndarray]] = []
        obs_img: list[int] = []
        obs_uv: list[np.ndarray] = []
        obs_cand: list[int] = []
        touched: set[int] = set()
        chained: list[tuple[int, int]] = []
        merged = 0
        for pa, pb in pairs:
            pa, pb = int(pa), int(pb)
            if pa in touched or pb in touched:
                chained.append((pa, pb))
                continue
            touched.add(pa)
            touched.add(pb)
            xyz = self._merge_candidate(pa, pb)
            if xyz is None:
                continue
            k = len(cands)
            cands.append((pa, pb, xyz))
            for iid, f in s.tracks[pa] + s.tracks[pb]:
                ik = idx.get(iid)
                if ik is not None:
                    obs_img.append(ik)
                    obs_uv.append(s.keypoints[iid][f])
                    obs_cand.append(k)
        if cands:
            X = np.stack([c[2] for c in cands])
            oc = np.asarray(obs_cand, np.int64)
            cand_bad = np.zeros(len(cands), bool)
            if len(oc):
                oi = np.asarray(obs_img)
                ok = self._track_consistent(Rs[oi], ts[oi], Ks[oi], X[oc],
                                            np.asarray(obs_uv, np.float64),
                                            self.cfg.filter_max_reproj_error_px)
                cand_bad = np.bincount(oc[~ok], minlength=len(cands)) > 0
            for k, (pa, pb, xyz) in enumerate(cands):
                if not cand_bad[k]:
                    self._merge_apply(pa, pb, xyz)
                    merged += 1
        for pa, pb in chained:
            merged += bool(self.try_merge(pa, pb))
        return merged

    # -------------------------------------------------------- triangulation
    def triangulate_new(self, iid) -> int:
        """Merge, extend and create tracks from the matches of image ``iid``
        with its registered partners; new points in one batched
        triangulation on CPU tensors."""
        s = self.s
        R2, t2 = s.poses[iid]
        K2 = s.K(iid)
        P2 = K2 @ np.concatenate([R2, t2[:, None]], axis=1)
        C2 = -R2.T @ t2
        created = 0
        thr = self.cfg.filter_max_reproj_error_px
        cand_P1: list[np.ndarray] = []
        cand_C1: list[np.ndarray] = []
        cand_x1: list[np.ndarray] = []
        cand_x2: list[np.ndarray] = []
        cand_obs: list[tuple[int, int]] = []
        cand_fs: list[int] = []
        for other, f_self, f_other in self._pairs_with(iid):
            R1, t1 = s.poses[other]
            K1 = s.K(other)
            P1 = K1 @ np.concatenate([R1, t1[:, None]], axis=1)
            C1 = -R1.T @ t1

            # Track merging: both features already have different 3D points
            # -> merge when the combined track is consistent.
            pid_s = s.feat_pid[iid][f_self]
            pid_o = s.feat_pid[other][f_other]
            both = (pid_s >= 0) & (pid_o >= 0) & (pid_s != pid_o)
            if both.any():
                self.try_merge_batch(zip(pid_o[both], pid_s[both]))

            # Track extension: the partner's feature has a 3D point and ours
            # is free -> join the track when the point reprojects here.
            ext_mask = (s.feat_pid[other][f_other] >= 0) & (s.feat_pid[iid][f_self] < 0)
            if ext_mask.any():
                fs_e = f_self[ext_mask]
                pids_e = s.feat_pid[other][f_other[ext_mask]]
                keep = np.array([p in s.points for p in pids_e])
                if keep.any():
                    fs_e, pids_e = fs_e[keep], pids_e[keep]
                    Xe = np.stack([s.points[int(p)] for p in pids_e])
                    uv_e = s.keypoints[iid][fs_e].astype(np.float64)
                    errs = _reproj_errors(R2, t2, K2, Xe, uv_e)
                    for fs_k, pid_k, ok in zip(fs_e, pids_e, errs < thr):
                        if ok:
                            s.add_observation(int(pid_k), iid, int(fs_k))

            new_mask = (s.feat_pid[iid][f_self] < 0) & (s.feat_pid[other][f_other] < 0)
            if not new_mask.any():
                continue
            fs = f_self[new_mask]
            fo = f_other[new_mask]
            cand_P1.append(np.broadcast_to(P1, (len(fs), 3, 4)))
            cand_C1.append(np.broadcast_to(C1, (len(fs), 3)))
            cand_x1.append(s.keypoints[other][fo].astype(np.float64))
            cand_x2.append(s.keypoints[iid][fs].astype(np.float64))
            cand_obs.extend((other, int(f)) for f in fo)
            cand_fs.extend(int(f) for f in fs)

        if not cand_fs:
            return 0
        P1s = np.concatenate(cand_P1)
        C1s = np.concatenate(cand_C1)
        x1 = np.concatenate(cand_x1)
        x2 = np.concatenate(cand_x2)
        n = len(cand_fs)
        X = geom.triangulate(
            _f32(P1s), _f32(np.broadcast_to(P2, (n, 3, 4))), _f32(x1[:, None]),
            _f32(x2[:, None]))[:, 0].double().numpy()

        def _perrs(P, Xw, uv):  # reprojection through the P matrices
            uvw = np.einsum("nij,nj->ni", P[:, :, :3], Xw) + P[:, :, 3]
            w = uvw[:, 2]
            safe = np.where(np.abs(w) > 1e-9, w, 1e-9)
            e = np.linalg.norm(uvw[:, :2] / safe[:, None] - uv, axis=-1)
            return np.where(w > 1e-6, e, np.inf)

        e1 = _perrs(P1s, X, x1)
        e2 = _perrs(np.broadcast_to(P2, (n, 3, 4)), X, x2)
        angles = _triangulation_angles(X, C1s, np.broadcast_to(C2, (n, 3)))
        good = (angles > self.cfg.min_triangulation_angle_deg) & (e1 < thr) & (e2 < thr)
        for k in np.nonzero(good)[0]:
            oid, fo_k = cand_obs[k]
            # Several partners may propose the same new-image feature: the
            # first accepted wins.
            if s.feat_pid[iid][cand_fs[k]] >= 0 or s.feat_pid[oid][fo_k] >= 0:
                continue
            s.add_point(X[k], [(oid, fo_k), (iid, cand_fs[k])])
            created += 1
        return created

    # ------------------------------------------------------------------ BA
    def local_bundle_adjust(self, iid: int, iters: Optional[int] = None) -> float:
        """Local BA around a newly registered image (COLMAP's
        AdjustLocalBundle): the new image and its most-connected registered
        neighbors are variable, every other image observing their points is
        a fixed anchor."""
        s = self.s
        shared: dict[int, int] = {}
        pids_i = s.feat_pid[iid]
        for pid in pids_i[pids_i >= 0]:
            pid = int(pid)
            if pid not in s.tracks:
                continue
            for oid, _f in s.tracks[pid]:
                if oid != iid and oid in s.poses:
                    shared[oid] = shared.get(oid, 0) + 1
        neighbors = sorted(shared, key=lambda o: -shared[o])
        variable = [iid] + neighbors[: self.cfg.local_ba_num_images - 1]
        return self.bundle_adjust(
            iters=iters or self.cfg.ba_local_inner_iters or self.cfg.ba_local_iters,
            variable_imgs=variable,
            refine_focal=False,
            cg_iters=self.cfg.ba_local_cg_iters,
        )

    def bundle_adjust(self, iters: int = 15, variable_imgs: Optional[list[int]] = None,
                      refine_focal: Optional[bool] = None,
                      cg_iters: Optional[int] = None) -> float:
        t0 = time.perf_counter()
        if cg_iters is None:
            cg_iters = self.cfg.ba_global_cg_iters
        solver = self.cfg.ba_solver
        # One LM budget for every BA call (the LM loop exits early on
        # convergence, so a single maximum costs nothing extra).
        if self.cfg.ba_unified_iters:
            iters = self.cfg.ba_unified_iters
        s = self.s
        if variable_imgs is None:
            img_ids = sorted(s.poses.keys())
            var_set = set(img_ids)
            pt_ids = sorted(s.points.keys())
        else:
            var_set = {i for i in variable_imgs if i in s.poses}
            pt_set: set[int] = set()
            for vid in var_set:
                pids = s.feat_pid[vid]
                for pid in pids[pids >= 0]:
                    if int(pid) in s.points:
                        pt_set.add(int(pid))
            pt_ids = sorted(pt_set)
            # Fixed anchors: every other registered image observing them.
            img_set = set(var_set)
            for pid in pt_ids:
                for oid, _f in s.tracks[pid]:
                    if oid in s.poses:
                        img_set.add(oid)
            img_ids = sorted(img_set)
        if len(pt_ids) == 0:
            return 0.0
        img_index = {iid: k for k, iid in enumerate(img_ids)}
        pt_index = {pid: k for k, pid in enumerate(pt_ids)}
        n_img, n_pts = len(img_ids), len(pt_ids)

        # Raw (distorted) observations: BA models radial distortion in the
        # projection.
        obs_cam, obs_pt, obs_xy = [], [], []
        for pid in pt_ids:
            for iid2, f in s.tracks[pid]:
                if iid2 in img_index:
                    obs_cam.append(img_index[iid2])
                    obs_pt.append(pt_index[pid])
                    obs_xy.append(s.keypoints_raw[iid2][f])
        n_obs = len(obs_cam)

        cam = np.zeros((n_img, 6), np.float32)  # axis-angle + t
        Ks = np.zeros((n_img, 3, 3), np.float32)
        cam_ids_used = sorted({s.images[iid]["camera_id"] for iid in img_ids})
        cam_index = {cid: k for k, cid in enumerate(cam_ids_used)}
        cam_of_img = np.zeros(n_img, np.int32)
        Rs = np.stack([s.poses[iid2][0] for iid2 in img_ids])
        cam[:, :3] = matrix_to_axis_angle(_f32(Rs)).numpy()
        for iid2, k in img_index.items():
            cam[k, 3:6] = s.poses[iid2][1]
            Ks[k] = s.K(iid2)
            cam_of_img[k] = cam_index[s.images[iid2]["camera_id"]]
        pts = np.stack([s.points[p] for p in pt_ids]).astype(np.float32)

        # Gauge: fix the first camera; local BA also fixes every anchor
        # outside the variable set.
        fixed = np.array([iid2 not in var_set for iid2 in img_ids])
        fixed[0] = True

        # Refine focal only for cameras without a prior focal length.
        do_refine = self.cfg.ba_refine_focal if refine_focal is None else refine_focal
        refine_focal_mask = np.zeros(len(cam_ids_used), bool)
        if do_refine:
            for cid, k in cam_index.items():
                refine_focal_mask[k] = not s.cameras[cid].get("prior_focal_length", False)
        # Radial distortion: k1 (SIMPLE_RADIAL) / k1, k2 (RADIAL), refined
        # under the same no-prior gate as focal (COLMAP refine_extra_params).
        dist = np.zeros((len(cam_ids_used), 2), np.float32)
        refine_dist = np.zeros((len(cam_ids_used), 2), bool)
        for cid, k in cam_index.items():
            model = s.cameras[cid]["model"]
            params = np.asarray(s.cameras[cid]["params"], np.float64)
            if model == "SIMPLE_RADIAL":
                dist[k, 0] = params[3] if len(params) > 3 else 0.0
                refine_dist[k] = (True, False)
            elif model == "RADIAL":
                dist[k, 0] = params[3] if len(params) > 3 else 0.0
                dist[k, 1] = params[4] if len(params) > 4 else 0.0
                refine_dist[k] = (True, True)
        if not (do_refine and self.cfg.ba_refine_extra_params):
            refine_dist[:] = False
        else:
            refine_dist &= refine_focal_mask[:, None]
        n_cam_used = len(cam_ids_used)
        fbuf, ibuf, bbuf = pack_ba_problem(
            cam, np.zeros(n_cam_used, np.float32), dist, pts,
            np.asarray(obs_cam), np.asarray(obs_pt), np.asarray(obs_xy),
            np.ones(n_obs, bool), Ks, cam_of_img, fixed, refine_focal_mask, refine_dist,
        )
        t_asm = time.perf_counter()
        lm = {}
        out = bundle_adjust_packed(
            torch.from_numpy(fbuf).to(self.device), torch.from_numpy(ibuf).to(self.device),
            torch.from_numpy(bbuf).to(self.device),
            n_img=n_img, n_cam=n_cam_used, n_pts=n_pts, n_obs=n_obs,
            iters=iters, cg_iters=cg_iters, solver=solver, stats=lm,
        )
        t_solve = time.perf_counter()
        cam_out, focal_out, dist_out, pts_out, msr = unpack_ba_result(
            out, n_img, n_cam_used, n_pts)
        t_read = time.perf_counter()
        ph = self.ba_phases
        ph["asm"] += t_asm - t0
        ph["solve"] += t_solve - t_asm
        ph["readback"] += t_read - t_solve
        ph["calls"] += 1
        ph["lm_iters"] += lm["lm_iters"]
        ph["syncs"] += lm["syncs"] + 1  # and the readback

        var_k = [k for iid2, k in img_index.items() if iid2 in var_set]
        R_out = axis_angle_to_matrix(_f32(cam_out[var_k, :3])).numpy()
        for j, k in enumerate(var_k):
            s.poses[img_ids[k]] = (R_out[j], cam_out[k, 3:6])
        for pid, k in pt_index.items():
            s.points[pid] = pts_out[k]
        # Per-camera focal write-back (the shared-intrinsics parameter).
        for cid, k in cam_index.items():
            scale = float(np.exp(focal_out[k]))
            if abs(scale - 1.0) > 1e-8:
                params = np.asarray(s.cameras[cid]["params"], np.float64).copy()
                n_f = 2 if s.cameras[cid]["model"] == "PINHOLE" else 1
                params[:n_f] *= scale
                s.cameras[cid]["params"] = params
            # Distortion write-back, and the refresh of the mapper's cached
            # undistorted observations (PnP, triangulation and the filters
            # read them).
            if refine_dist[k].any():
                params = np.asarray(s.cameras[cid]["params"], np.float64).copy()
                changed = False
                if len(params) > 3 and abs(dist_out[k, 0] - params[3]) > 1e-12:
                    params[3] = dist_out[k, 0]
                    changed = True
                if (s.cameras[cid]["model"] == "RADIAL" and len(params) > 4
                        and abs(dist_out[k, 1] - params[4]) > 1e-12):
                    params[4] = dist_out[k, 1]
                    changed = True
                if changed:
                    s.cameras[cid]["params"] = params
                    for iid2 in s.images:
                        if s.images[iid2]["camera_id"] == cid and iid2 in s.keypoints_raw:
                            s.keypoints[iid2] = geom.undistort_points(
                                s.keypoints_raw[iid2], s.cameras[cid])
        return float(msr)

    def filter_points(self) -> int:
        """Drop points with high mean reprojection error, too-short tracks,
        or any behind-camera observation (all observations in one flat
        batch)."""
        s = self.s
        pids = list(s.points.keys())
        if not pids:
            return 0
        thr = self.cfg.filter_max_reproj_error_px

        img_ids = sorted(s.poses.keys())
        img_index = {iid: k for k, iid in enumerate(img_ids)}
        Rs = np.stack([s.poses[i][0] for i in img_ids])
        ts = np.stack([s.poses[i][1] for i in img_ids])
        Ks = np.stack([s.K(i) for i in img_ids])

        obs_pid, obs_img, obs_xy = [], [], []
        pt_index = {p: k for k, p in enumerate(pids)}
        for pid in pids:
            for iid, f in s.tracks[pid]:
                obs_pid.append(pt_index[pid])
                obs_img.append(img_index[iid])
                obs_xy.append(s.keypoints[iid][f])
        obs_pid = np.array(obs_pid)
        obs_img = np.array(obs_img)
        obs_xy = np.asarray(obs_xy, np.float64)
        X = np.stack([s.points[p] for p in pids])[obs_pid]

        R, t, Kk = Rs[obs_img], ts[obs_img], Ks[obs_img]
        Xc = np.einsum("nij,nj->ni", R, X) + t
        z = np.where(np.abs(Xc[:, 2:]) > 1e-9, Xc[:, 2:], 1e-9)
        f = np.stack([Kk[:, 0, 0], Kk[:, 1, 1]], axis=1)
        c = np.stack([Kk[:, 0, 2], Kk[:, 1, 2]], axis=1)
        uv = (Xc[:, :2] / z) * f + c
        err = np.linalg.norm(uv - obs_xy, axis=-1)
        behind = Xc[:, 2] <= 1e-6

        n_pts = len(pids)
        err_sum = np.bincount(obs_pid, weights=err, minlength=n_pts)
        cnt = np.bincount(obs_pid, minlength=n_pts)
        bad_behind = np.bincount(obs_pid, weights=behind, minlength=n_pts) > 0
        mean_err = err_sum / np.maximum(cnt, 1)
        drop = (cnt < 2) | bad_behind | (mean_err > thr)
        for k in np.nonzero(drop)[0]:
            s.remove_point(pids[k])
        return int(drop.sum())

    # ------------------------------------------------------------- finalize
    def to_reconstruction(self) -> Reconstruction:
        s = self.s
        rec = Reconstruction()
        for cid, cam in s.cameras.items():
            rec.cameras[cid] = Camera(
                camera_id=cid,
                model=cam["model"],
                width=cam["width"],
                height=cam["height"],
                params=np.asarray(cam["params"], np.float64),
            )
        for iid in s.poses:
            R, t = s.poses[iid]
            rec.images[iid] = Image(
                image_id=iid,
                name=s.images[iid]["name"],
                camera_id=s.images[iid]["camera_id"],
                qvec=_qvec_from_R(R),
                tvec=np.asarray(t, np.float64),
                xys=s.keypoints[iid].astype(np.float64),
                point3D_ids=s.feat_pid[iid].copy(),
            )
        for pid, xyz in s.points.items():
            errs = []
            for iid, f in s.tracks[pid]:
                if iid in s.poses:
                    R, t = s.poses[iid]
                    e = _reproj_errors(R, t, s.K(iid), xyz[None],
                                       s.keypoints[iid][f][None])[0]
                    if np.isfinite(e):
                        errs.append(e)
            rec.points3D[pid] = Point3D(
                point3D_id=pid,
                xyz=np.asarray(xyz, np.float64),
                error=float(np.mean(errs)) if errs else 0.0,
                track=list(s.tracks[pid]),
            )
        return rec


# The reference's substeps, and "init": the init pair, its BA and filter.
SUBSTEPS = ("init", "find", "register", "tri", "lba", "gba", "refine_tri", "refine_gba")


def incremental_mapping(
    db_path: Path | str,
    image_dir: Path | str,
    output_path: Path | str,
    config: Optional[ReconstructionConfig] = None,
    device=None,
    pnp_sampler_factory: Optional[Callable[[], PnPSampler]] = None,
    log: Optional[dict] = None,
) -> dict[int, Reconstruction]:
    """Build one or more sparse models from a matched and verified database,
    with PnP and BA on ``device`` (default ``cuda``; ``"cpu"`` runs them on
    the host).  ``pnp_sampler_factory`` is called once per model and returns
    the function that draws each registration attempt's PnP uniforms
    (default: :func:`default_pnp_sampler`).  ``log``, where given, gains per model
    the substep seconds and the BA phases (``log[model_idx]``)."""
    config = config or ReconstructionConfig()
    output_path = Path(output_path)
    device = resolve_device(device)
    pnp_sampler_factory = pnp_sampler_factory or default_pnp_sampler

    db = ColmapDatabase(db_path)
    cameras = db.read_cameras()
    images = db.read_images()
    keypoints = {}
    keypoints_raw = {}
    for iid in images:
        k = db.read_keypoints(iid)
        k = k[:, :2] if k is not None and len(k) else np.zeros((0, 2), np.float32)
        # Mapper geometry uses an undistorted pinhole model; radial models'
        # observations are undistorted once here.  BA consumes the raw
        # coordinates and models distortion in the projection.
        keypoints_raw[iid] = k
        keypoints[iid] = geom.undistort_points(k, cameras[images[iid]["camera_id"]])
    geometries = db.read_all_two_view_geometries()
    db.close()

    pair_matches = {
        ids: g["inlier_matches"].astype(np.int64)
        for ids, g in geometries.items()
        if len(g["inlier_matches"]) >= config.min_num_matches
    }
    logger.info("Mapper input: %d images, %d verified pairs", len(images), len(pair_matches))

    reconstructions: dict[int, Reconstruction] = {}
    remaining = set(images.keys())
    model_idx = 0
    while len(remaining) >= 2 and model_idx < config.max_models:
        sub_pairs = {(a, b): m for (a, b), m in pair_matches.items()
                     if a in remaining and b in remaining}
        if not sub_pairs:
            break
        state = _MapperState(
            cameras,
            {i: images[i] for i in remaining},
            {i: keypoints[i] for i in remaining},
            {i: keypoints_raw[i] for i in remaining},
        )
        mapper = IncrementalMapper(state, sub_pairs, config, device=device,
                                   pnp_sampler=pnp_sampler_factory())
        t_sub = dict.fromkeys(SUBSTEPS, 0.0)
        t0 = time.perf_counter()
        if not mapper.initialize():
            break
        mapper.bundle_adjust(iters=config.ba_local_iters)
        mapper.filter_points()
        t_sub["init"] = time.perf_counter() - t0

        stalled = 0
        last_global_size = 2

        def _timed(key, fn, *a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            t_sub[key] += time.perf_counter() - t0
            return out

        while True:
            iid, corrs = _timed("find", mapper.find_next_image)
            if iid is None:
                break
            if not _timed("register", mapper.register_image, iid, corrs):
                stalled += 1
                if stalled > 2:
                    break
                continue
            stalled = 0
            _timed("tri", mapper.triangulate_new, iid)
            # Local BA after every registration; global BA when the model
            # grew enough (COLMAP's schedule).
            _timed("lba", mapper.local_bundle_adjust, iid)
            if len(state.poses) >= config.global_ba_growth * last_global_size:
                _timed("gba", mapper.bundle_adjust, iters=config.ba_local_iters)
                _timed("gba", mapper.filter_points)
                last_global_size = len(state.poses)
        # Final refinement: retriangulate features that gained geometry
        # during the build, then global BA + filter.
        for _ in range(2):
            created = _timed("refine_tri",
                             lambda: sum(mapper.triangulate_new(i) for i in list(state.poses)))
            _timed("refine_gba", mapper.bundle_adjust, iters=config.ba_global_iters)
            removed = _timed("refine_gba", mapper.filter_points)
            logger.info("Refinement round: +%d points, -%d filtered", created, removed)
            if created <= removed:
                break
        ph = mapper.ba_phases
        logger.info("Mapper substep seconds: %s", {k: round(v, 2) for k, v in t_sub.items()})
        logger.info(
            "BA phase seconds: %s; %d LM iterations and %d host syncs over %d calls "
            "(%.1f and %.1f per call)",
            {k: round(ph[k], 2) for k in ("asm", "solve", "readback")},
            ph["lm_iters"], ph["syncs"], ph["calls"],
            ph["lm_iters"] / max(ph["calls"], 1), ph["syncs"] / max(ph["calls"], 1),
        )
        if log is not None:
            log[model_idx] = {"substeps": dict(t_sub), "ba": dict(ph)}
        rec = mapper.to_reconstruction()
        if len(rec.images) >= 2 and len(rec.points3D) >= 10:
            rec.write(output_path / str(model_idx))
            reconstructions[model_idx] = rec
            logger.info(
                "Model %d: %d images, %d points, mean reproj %.3f px",
                model_idx, len(rec.images), len(rec.points3D),
                rec.mean_reprojection_error(),
            )
            model_idx += 1
        remaining -= set(state.poses.keys())
        if not config.multiple_models:
            break
    return reconstructions
