"""Exhaustive matching driver.

Counterpart of ``vit_colmap_tpu/pipeline/match.py`` without geometric
verification, which is not ported yet:

1. read every image's keypoints and descriptors once (or take the
   extractor's device-resident descriptors), pad ragged counts to one
   power-of-two width >= 128 with validity masks;
2. decode (signed encoding) and L2-normalize on the device;
3. match pair batches with the pair matcher (the matching kernel on CUDA);
4. compact matches on the device, read back counts and a prefix, and write
   the ``matches`` table.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.device import resolve_device
from vit_colmap_tpu_torch.ops.matching import (
    compact_matches_device,
    get_pair_matcher,
    normalize_descriptors,
    unpack_matches,
)
from vit_colmap_tpu_torch.utils.config import MatchingConfig

logger = logging.getLogger(__name__)

VERIFICATION_NOT_PORTED = (
    "geometric verification is not ported yet (see ROADMAP.md, Queue 1): "
    "set MatchingConfig.do_verification=False / pass --skip-verification"
)


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


@dataclass
class MatchStats:
    num_pairs: int = 0
    matched_pairs: int = 0
    verified_pairs: int = 0
    total_matches: int = 0
    total_inliers: int = 0
    match_seconds: float = 0.0
    verify_seconds: float = 0.0


def match_exhaustive(
    db_path,
    config: Optional[MatchingConfig] = None,
    seed: int = 0,
    device_descriptors: Optional[dict] = None,
    device=None,
) -> MatchStats:
    """Match every image pair in the database and write ``matches``.

    ``device_descriptors``: ``{image_name: (desc (K, D) uint8 tensor,
    count)}`` from an extractor's ``device_cache``; when it covers every
    image, descriptors are taken from the device instead of the database.
    ``seed`` seeds verification's sampling in the reference; it is kept for
    the same signature and unused until verification is ported.
    """
    config = config or MatchingConfig()
    if config.do_verification:
        raise NotImplementedError(VERIFICATION_NOT_PORTED)
    if config.shard_descriptors:
        raise NotImplementedError("shard_descriptors (multi-GPU) is not ported yet")
    dev = resolve_device(device)
    stats = MatchStats()

    db = ColmapDatabase(db_path)
    try:
        images = db.read_images()
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
        desc_list, counts, n_valid = [], [], []
        for iid, name in zip(image_ids, names):
            k = db.read_keypoints(iid)
            n_k = 0 if k is None else len(k)
            counts.append(n_k)
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
    finally:
        writer.close()
    stats.matched_pairs = len(all_matches)
    stats.match_seconds = time.perf_counter() - t0
    logger.info(
        "Matched %d/%d pairs (%d matches) in %.2fs",
        stats.matched_pairs, stats.num_pairs, stats.total_matches,
        stats.match_seconds,
    )
    return stats
