"""Exhaustive matching and geometric verification.

Counterpart of ``vit_colmap_tpu/pipeline/match.py``:

1. read every image's keypoints (undistorted) and descriptors once (or take
   the extractor's device-resident descriptors), pad ragged counts to one
   power-of-two width >= 128 with validity masks;
2. decode (signed encoding) and L2-normalize on the device;
3. match pair batches with the pair matcher (the matching kernel on CUDA);
4. compact matches on the device, read back counts and a prefix, and write
   the ``matches`` table;
5. verify pairs with at least 8 matches in batches through the batched
   RANSAC (``ops.ransac.estimate_two_view_batched``) and write
   ``two_view_geometries`` (config enum, F/E/H and relative pose) for the
   pairs that reach ``min_num_inliers`` and are not DEGENERATE.

The reference sends a verification batch's correspondences flat and
scatters them on the TPU (a wire-transfer device); here the padded
``(pairs, k_max)`` buffers are built on the host and copied once.
"""

from __future__ import annotations

import logging
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from vit_colmap_tpu_torch.database import TWO_VIEW_CONFIG, ColmapDatabase
from vit_colmap_tpu_torch.device import resolve_device
from vit_colmap_tpu_torch.ops.matching import (
    compact_matches_device,
    get_pair_matcher,
    normalize_descriptors,
    unpack_matches,
)
from vit_colmap_tpu_torch.ops.ransac import draw_uniforms, estimate_two_view_batched
from vit_colmap_tpu_torch.sfm.geometry import undistort_points
from vit_colmap_tpu_torch.utils.config import MatchingConfig

logger = logging.getLogger(__name__)


def _decode_normalize_u8(desc_u8: torch.Tensor, valid: torch.Tensor, signed: bool):
    """uint8 decode (+ signed mapping), masking and L2 normalization."""
    d = desc_u8.float()
    if signed:
        d = d / 127.5 - 1.0
    d = torch.where(valid[..., None], d, 0.0)
    return normalize_descriptors(d)


def _next_pow2(n: int, minimum: int = 128) -> int:
    m = minimum
    while m < n:
        m *= 2
    return m


def camera_matrix(cam: dict) -> np.ndarray:
    """COLMAP camera dict -> 3x3 K (distortion ignored for verification)."""
    p = cam["params"]
    model = cam["model"]
    if model == "PINHOLE":
        fx, fy, cx, cy = p[:4]
    elif model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    else:
        fx = fy = p[0]
        cx, cy = cam["width"] / 2.0, cam["height"] / 2.0
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)


def batch_generator(seed: int, start: int) -> torch.Generator:
    """The CPU generator of the verification batch that starts at pair
    ``start``: seeded from ``seed`` and ``start`` together, as the
    reference folds the batch start into its key."""
    state = np.random.SeedSequence([seed, start]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


@dataclass
class MatchStats:
    num_pairs: int = 0
    matched_pairs: int = 0
    verified_pairs: int = 0
    total_matches: int = 0
    total_inliers: int = 0
    match_seconds: float = 0.0
    verify_seconds: float = 0.0
    # RANSAC chunks run, summed over the verification batches, per loop:
    # "f", "h", "e" (8-point E) and "e5" (5-point E).
    verify_chunks: Counter = field(default_factory=Counter)


def match_exhaustive(
    db_path,
    config: Optional[MatchingConfig] = None,
    seed: int = 0,
    device_descriptors: Optional[dict] = None,
    device=None,
) -> MatchStats:
    """Match every image pair in the database and write ``matches``, then
    (``config.do_verification``) verify them and write
    ``two_view_geometries``.

    ``device_descriptors``: ``{image_name: (desc (K, D) uint8 tensor,
    count)}`` from an extractor's ``device_cache``; when it covers every
    image, descriptors are taken from the device instead of the database.
    ``seed`` seeds verification's sampling (see :func:`batch_generator`).
    """
    config = config or MatchingConfig()
    if config.shard_descriptors:
        raise NotImplementedError("shard_descriptors (multi-GPU) is not ported yet")
    dev = resolve_device(device)
    stats = MatchStats()

    db = ColmapDatabase(db_path)
    try:
        images = db.read_images()
        cameras = db.read_cameras()
        image_ids = sorted(images)
        n_img = len(image_ids)
        if n_img < 2:
            logger.warning("Fewer than 2 images; nothing to match")
            return stats
        names = [images[iid]["name"] for iid in image_ids]
        use_dev = device_descriptors is not None and all(
            n in device_descriptors for n in names
        )
        if use_dev:
            use_dev = len({device_descriptors[n][0].shape[-1] for n in names}) == 1
        # counts: keypoints per image (sets the padded width); n_valid:
        # descriptor rows that take part in matching.
        desc_list, counts, n_valid, kpts = [], [], [], []
        for iid, name in zip(image_ids, names):
            k = db.read_keypoints(iid)
            n_k = 0 if k is None else len(k)
            counts.append(n_k)
            cam = cameras[images[iid]["camera_id"]]
            k = np.zeros((0, 2), np.float32) if k is None else k[:, :2].astype(np.float32)
            kpts.append(undistort_points(k, cam))
            if use_dev:
                d, cnt = device_descriptors[name]
                desc_list.append(d)
                n_valid.append(min(cnt, n_k))
            else:
                d = db.read_descriptors(iid)
                if d is None or n_k == 0:
                    d = np.zeros((0, 128), np.uint8)
                desc_list.append(torch.from_numpy(d))
                n_valid.append(len(d))
    finally:
        db.close()

    t0 = time.perf_counter()
    n_max = _next_pow2(max(counts))
    dim = max(d.shape[1] for d in desc_list)
    desc = torch.zeros(n_img, n_max, dim, dtype=torch.uint8, device=dev)
    valid = torch.zeros(n_img, n_max, dtype=torch.bool, device=dev)
    for i, (d, c) in enumerate(zip(desc_list, n_valid)):
        rows = min(d.shape[0], n_max)
        desc[i, :rows, : d.shape[1]] = d[:rows].to(dev)
        valid[i, :c] = True
    desc = _decode_normalize_u8(
        desc, valid, signed=config.descriptor_encoding == "signed"
    )

    pairs = [(i, j) for i in range(n_img) for j in range(i + 1, n_img)]
    stats.num_pairs = len(pairs)
    matcher = get_pair_matcher(config.use_pallas)
    all_matches: dict[tuple[int, int], np.ndarray] = {}
    pending = []
    for start in range(0, len(pairs), config.pair_batch):
        chunk = pairs[start : start + config.pair_batch]
        i1 = torch.tensor([c[0] for c in chunk], device=dev)
        i2 = torch.tensor([c[1] for c in chunk], device=dev)
        out = matcher(
            desc[i1], desc[i2], valid[i1], valid[i2],
            config.max_ratio, config.max_distance, config.cross_check,
        )
        pending.append((chunk, compact_matches_device(out)))
    for chunk, (m_counts, packed) in pending:
        m_counts = m_counts.cpu().numpy()
        k_max = int(m_counts.max(initial=0))
        if k_max == 0:
            continue
        prefix = packed[:, : min(_next_pow2(k_max), packed.shape[-1])].cpu().numpy()
        for b, (i, j) in enumerate(chunk):
            m = unpack_matches(prefix[b], int(m_counts[b]))
            if len(m) > config.max_num_matches:
                m = m[: config.max_num_matches]
            if len(m) > 0:
                all_matches[(i, j)] = m

    writer = ColmapDatabase(db_path)
    try:
        for (i, j), m in all_matches.items():
            writer.add_matches(image_ids[i], image_ids[j], m)
            stats.total_matches += len(m)
        writer.commit()
        stats.matched_pairs = len(all_matches)
        stats.match_seconds = time.perf_counter() - t0
        logger.info(
            "Matched %d/%d pairs (%d matches) in %.2fs",
            stats.matched_pairs, stats.num_pairs, stats.total_matches,
            stats.match_seconds,
        )
        if config.do_verification and all_matches:
            cams = [cameras[images[iid]["camera_id"]] for iid in image_ids]
            _verify(all_matches, kpts, cams, image_ids, config, seed, dev, writer, stats)
    finally:
        writer.close()
    return stats


def _verify(all_matches, kpts, cams, image_ids, config, seed, dev, writer,
            stats: MatchStats) -> None:
    """Verify the pairs with at least 8 matches and write their two-view
    geometries."""
    t1 = time.perf_counter()
    # Sorted by match count, a proxy of difficulty: a batch runs until its
    # slowest lane converges, so hard pairs are best batched together.
    verif_pairs = sorted((p for p, m in all_matches.items() if len(m) >= 8),
                         key=lambda p: len(all_matches[p]))
    if not verif_pairs:
        return
    k_max = _next_pow2(max(len(all_matches[p]) for p in verif_pairs))
    VB = config.verify_pair_batch or config.pair_batch
    five_point = config.essential_solver == "5pt"
    kw = dict(iters=config.ransac_iters, five_point=five_point,
              five_point_chunk=config.five_point_chunk)
    pending = []
    t_dispatch0 = time.perf_counter()
    for start in range(0, len(verif_pairs), VB):
        chunk = verif_pairs[start : start + VB]
        n = len(chunk)
        pts1 = np.zeros((n, k_max, 2), np.float32)
        pts2 = np.zeros((n, k_max, 2), np.float32)
        mask = np.zeros((n, k_max), bool)
        K1 = np.zeros((n, 3, 3), np.float32)
        K2 = np.zeros((n, 3, 3), np.float32)
        calibrated = np.zeros(n, bool)
        for b, (i, j) in enumerate(chunk):
            m = all_matches[(i, j)]
            pts1[b, : len(m)] = kpts[i][m[:, 0]]
            pts2[b, : len(m)] = kpts[j][m[:, 1]]
            mask[b, : len(m)] = True
            K1[b], K2[b] = camera_matrix(cams[i]), camera_matrix(cams[j])
            # COLMAP: a pair is calibrated only when both cameras carry a
            # prior focal length; otherwise it verifies through F.
            calibrated[b] = cams[i]["prior_focal_length"] and cams[j]["prior_focal_length"]
        uniforms = draw_uniforms(n, batch_generator(seed, start), device=dev, **kw)
        res = estimate_two_view_batched(
            *(torch.from_numpy(a).to(dev) for a in (pts1, pts2, mask, K1, K2, calibrated)),
            uniforms,
            max_error_px=config.ransac_max_error_px,
            min_num_inliers=config.min_num_inliers,
            confidence=config.ransac_confidence,
            chunks=stats.verify_chunks,
            **kw,
        )
        pending.append((chunk, res))
    t_dispatch = time.perf_counter() - t_dispatch0
    t_read = 0.0
    t_db0 = time.perf_counter()
    for chunk, res in pending:
        tr0 = time.perf_counter()
        configs, inl_masks, n_inl = (r.cpu().numpy() for r in res[:3])
        Fs, Es, Hs, qs, ts = (r.cpu().double().numpy() for r in res[3:])
        t_read += time.perf_counter() - tr0
        for b, (i, j) in enumerate(chunk):
            if n_inl[b] < config.min_num_inliers:
                continue
            if configs[b] == TWO_VIEW_CONFIG["DEGENERATE"]:
                continue
            m = all_matches[(i, j)]
            inliers = m[inl_masks[b, : len(m)]]
            writer.add_two_view_geometry(
                image_ids[i], image_ids[j], inliers, config=int(configs[b]),
                F=Fs[b], E=Es[b], H=Hs[b], qvec=qs[b], tvec=ts[b],
            )
            stats.verified_pairs += 1
            stats.total_inliers += len(inliers)
    writer.commit()
    stats.verify_seconds = time.perf_counter() - t1
    logger.info(
        "Verified %d pairs (%d inliers) in %.2fs",
        stats.verified_pairs, stats.total_inliers, stats.verify_seconds,
    )
    # dispatch: host assembly, copies and the RANSAC loops (each chunk ends
    # in a host check); readback: copies of the results; db: inlier
    # packing and writes.
    logger.info(
        "Verify phases: dispatch %.2fs, readback %.2fs, db %.2fs; chunks %s",
        t_dispatch, t_read, time.perf_counter() - t_db0 - t_read,
        dict(stats.verify_chunks),
    )
