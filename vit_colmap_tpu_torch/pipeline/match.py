"""Exhaustive matching and geometric verification.

Counterpart of ``vit_colmap_tpu/pipeline/match.py``:

1. read every image's keypoints (undistorted) and descriptors once (or take
   the extractor's device-resident descriptors), pad ragged counts to one
   power-of-two width >= 128 with validity masks;
2. decode (signed encoding) and L2-normalize on the device;
3. match pair batches with the pair matcher (the matching kernel on CUDA),
   their image indices sliced from one index vector built on the device
   once a job, so that queuing a batch never waits for the device;
4. compact matches on the device and queue each batch's counts and packed
   rows back into one pinned host buffer behind it (on the CPU the outputs
   are read where they are), then take the batches in order, waiting on a
   batch's event only where it has not completed, while later batches
   run; write the ``matches`` table through the batched C++ writer
   (``database/native.py``; ``ColmapDatabase`` where it is unavailable);
5. verify pairs with at least 8 matches in batches through the batched
   RANSAC (``ops.ransac.estimate_two_view_batched``) and write
   ``two_view_geometries`` (config enum, F/E/H and relative pose) for the
   pairs that reach ``min_num_inliers`` and are not DEGENERATE.

Several devices (``parallel/mesh.py``; every visible card when there is
more than one and the device names no index, or a ``mesh=`` of slots): the
pair batch rounds up to a multiple of the data slots, each slot matches its
contiguous slice of each batch's pairs on its own thread, and the outputs
are concatenated in pair order on the first slot's device.  Descriptors are
replicated on every slot, or with ``MatchingConfig.shard_descriptors`` (the
scale-out memory mode) padded to a multiple of the slots over images and
sharded, each slot holding only its share and gathering the full set for
each batch.  Verification runs on the first slot.

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
from vit_colmap_tpu_torch.database.native import open_bulk_writer
from vit_colmap_tpu_torch.device import resolve_device
from vit_colmap_tpu_torch.ops.interpolate import decode_descriptors
from vit_colmap_tpu_torch.ops.matching import (
    compact_matches_device,
    get_pair_matcher,
    unpack_matches,
)
from vit_colmap_tpu_torch.ops.ransac import draw_uniforms, estimate_two_view_batched
from vit_colmap_tpu_torch.parallel.mesh import (
    Mesh,
    gather,
    pad_to_multiple,
    replicate,
    resolve_mesh,
    run_slots,
    shard_batch,
)
from vit_colmap_tpu_torch.sfm.geometry import undistort_points
from vit_colmap_tpu_torch.utils.config import MatchingConfig
from vit_colmap_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


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


def _build_sharded_pallas_matcher(mesh: Mesh, cross_check: bool, use_pallas=True):
    """The pair matcher over the mesh with replicated descriptors:
    ``(desc, valid, idx1, idx2, max_ratio, max_distance) -> (P, N)`` on the
    first slot's device.  ``desc`` / ``valid`` are (images, N, D) / (images,
    N) tensors or lists of one replica a slot (:func:`parallel.mesh.
    replicate`); each slot gathers its pair slice from its replica and runs
    the matcher (kernel 2 for widths that are multiples of 128)."""
    matcher = get_pair_matcher(use_pallas)
    devices = mesh.data_devices

    def run(desc, valid, idx1, idx2, max_ratio=0.8, max_distance=0.7):
        if isinstance(desc, torch.Tensor):
            desc, valid = replicate(desc, mesh), replicate(valid, mesh)

        def body(i, i1, i2):
            return matcher(desc[i][i1], desc[i][i2], valid[i][i1], valid[i][i2],
                           max_ratio, max_distance, cross_check)

        outs = run_slots(body, devices, shard_batch(idx1, mesh), shard_batch(idx2, mesh))
        return gather(outs, devices[0])

    return run


def _build_desc_sharded_matcher(mesh: Mesh, cross_check: bool, use_pallas=True):
    """The pair matcher for descriptors sharded over images (the scale-out
    memory mode, ``MatchingConfig.shard_descriptors``): ``desc`` / ``valid``
    are tensors whose image count divides over the slots, or lists of one
    contiguous image shard a slot (:func:`parallel.mesh.shard_batch`).  For
    each batch every slot gathers the full set from the others' shards (a
    transient copy between devices), takes its pair slice and matches it;
    outputs in pair order on the first slot's device."""
    matcher = get_pair_matcher(use_pallas)
    devices = mesh.data_devices

    def run(desc, valid, idx1, idx2, max_ratio=0.8, max_distance=0.7):
        if isinstance(desc, torch.Tensor):
            desc, valid = shard_batch(desc, mesh), shard_batch(valid, mesh)

        def body(i, i1, i2):
            d, v = gather(desc, devices[i]), gather(valid, devices[i])
            return matcher(d[i1], d[i2], v[i1], v[i2], max_ratio, max_distance, cross_check)

        outs = run_slots(body, devices, shard_batch(idx1, mesh), shard_batch(idx2, mesh))
        return gather(outs, devices[0])

    return run


def _own_shards(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """:func:`shard_batch` with each share a tensor of its own: over several
    slots a share left on ``x``'s device is copied out of it, so that no
    slot keeps the whole of ``x`` alive once the caller drops it."""
    shards = shard_batch(x, mesh)
    if len(shards) == 1:
        return shards
    return [s.clone() if s.device == x.device else s for s in shards]


@dataclass
class MatchStats:
    num_pairs: int = 0
    matched_pairs: int = 0
    verified_pairs: int = 0
    total_matches: int = 0
    total_inliers: int = 0
    match_seconds: float = 0.0
    verify_seconds: float = 0.0
    # Pair batches launched, and those whose results the host had to wait
    # for when it came to unpack them (one event wait each on CUDA).
    chunks: int = 0
    readback_waits: int = 0
    # RANSAC chunks run, summed over the verification batches, per loop:
    # "f", "h", "e" (8-point E) and "e5" (5-point E).
    verify_chunks: Counter = field(default_factory=Counter)


@span("vc.match.job")
def match_exhaustive(
    db_path,
    config: Optional[MatchingConfig] = None,
    seed: int = 0,
    device_descriptors: Optional[dict] = None,
    device=None,
    mesh: Optional[Mesh] = None,
) -> MatchStats:
    """Match every image pair in the database and write ``matches``, then
    (``config.do_verification``) verify them and write
    ``two_view_geometries``.

    ``device_descriptors``: ``{image_name: (desc (K, D) uint8 tensor,
    count)}`` from an extractor's ``device_cache``; when it covers every
    image, descriptors are taken from the device instead of the database.
    ``seed`` seeds verification's sampling (see :func:`batch_generator`).
    ``mesh``: the data slots pair batches are split over (default: every
    visible card when there are several and ``device`` names no index, else
    one slot on ``device``).
    """
    config = config or MatchingConfig()
    if mesh is None:
        mesh = resolve_mesh(resolve_device(device))
    dev = mesh.data_devices[0]
    ndev = mesh.shape["data"]
    logger.info("Matching over %d data slots on %s%s", ndev,
                [str(d) for d in mesh.data_devices],
                " (descriptors sharded)" if config.shard_descriptors else "")
    stats = MatchStats()

    with span("vc.match.read"):
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
    with span("vc.match.assemble"):
        n_max = _next_pow2(max(counts))
        dim = max(d.shape[1] for d in desc_list)
        desc = torch.zeros(n_img, n_max, dim, dtype=torch.uint8, device=dev)
        valid = torch.zeros(n_img, n_max, dtype=torch.bool, device=dev)
        for i, (d, c) in enumerate(zip(desc_list, n_valid)):
            rows = min(d.shape[0], n_max)
            desc[i, :rows, : d.shape[1]] = d[:rows].to(dev)
            valid[i, :c] = True
        desc = decode_descriptors(
            desc, valid, signed=config.descriptor_encoding == "signed"
        )

        pairs = [(i, j) for i in range(n_img) for j in range(i + 1, n_img)]
        stats.num_pairs = len(pairs)
        P = pad_to_multiple(config.pair_batch, ndev)  # every slot gets pairs
        # Both index vectors of every pair, in the same row-major order, on
        # the device; the last batch padded to a multiple of the slots with
        # pair (0, 0), whose rows are dropped.
        n_pad = pad_to_multiple(len(pairs), ndev)
        idx1, idx2 = torch.nn.functional.pad(
            torch.triu_indices(n_img, n_img, 1, device=dev), (0, n_pad - len(pairs)))
        if config.shard_descriptors:
            pad_img = (-n_img) % ndev  # zero images, never indexed
            desc = torch.cat([desc, desc.new_zeros((pad_img, *desc.shape[1:]))])
            valid = torch.cat([valid, valid.new_zeros((pad_img, valid.shape[1]))])
            matcher = _build_desc_sharded_matcher(mesh, config.cross_check, config.use_pallas)
            desc, valid = _own_shards(desc, mesh), _own_shards(valid, mesh)
        else:
            matcher = _build_sharded_pallas_matcher(mesh, config.cross_check, config.use_pallas)
            desc, valid = replicate(desc, mesh), replicate(valid, mesh)
    with span("vc.match.launch"):
        # Nothing here waits for the device: on CUDA each batch's counts
        # and whole packed rows are copied asynchronously into one pinned
        # buffer a job, behind the batch, and an event marks their arrival.
        on_card = dev.type == "cuda"
        pinned = None
        pending = []  # (first pair, counts, packed, event) a batch
        for start in range(0, n_pad, P):
            stop = min(start + P, n_pad)
            out = matcher(desc, valid, idx1[start:stop], idx2[start:stop],
                          config.max_ratio, config.max_distance)[: min(stop, len(pairs)) - start]
            m_counts, packed = compact_matches_device(out)
            event = None
            if on_card:
                if pinned is None:
                    pinned = [torch.empty((n_pad, *t.shape[1:]), dtype=t.dtype, pin_memory=True)
                            for t in (m_counts, packed)]
                rows = slice(start, start + len(out))
                m_counts = pinned[0][rows].copy_(m_counts, non_blocking=True)
                packed = pinned[1][rows].copy_(packed, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
            pending.append((start, m_counts, packed, event))
        stats.chunks = len(pending)
    with span("vc.match.unpack"):
        # In batch order; while the host unpacks one, later ones still run.
        all_matches: dict[tuple[int, int], np.ndarray] = {}
        for start, m_counts, packed, event in pending:
            if event is not None and not event.query():
                event.synchronize()
                stats.readback_waits += 1
            m_counts, packed = m_counts.numpy(), packed.numpy()
            for b in np.flatnonzero(m_counts):
                m = unpack_matches(packed[b], int(m_counts[b]))
                if len(m) > config.max_num_matches:
                    m = m[: config.max_num_matches]
                if len(m) > 0:
                    all_matches[pairs[start + b]] = m

    # Bulk writes go through the C++ writer (one transaction) where it
    # builds; ColmapDatabase is the fallback, as in the JAX package.  With
    # verification the writer stays open for its geometries: its close is
    # a second ``vc.match.write`` span after ``vc.match.verify``.
    verify = bool(config.do_verification and all_matches)
    with span("vc.match.write"):
        writer = open_bulk_writer(db_path)
        try:
            for (i, j), m in all_matches.items():
                writer.add_matches(image_ids[i], image_ids[j], m)
                stats.total_matches += len(m)
            writer.commit()
        except BaseException:
            writer.close()
            raise
        stats.matched_pairs = len(all_matches)
        stats.match_seconds = time.perf_counter() - t0
        if not verify:
            writer.close()
    logger.info(
        "Matched %d/%d pairs (%d matches) in %.2fs; %d pair batches, %d readback waits",
        stats.matched_pairs, stats.num_pairs, stats.total_matches,
        stats.match_seconds, stats.chunks, stats.readback_waits,
    )
    if verify:
        try:
            with span("vc.match.verify"):
                cams = [cameras[images[iid]["camera_id"]] for iid in image_ids]
                _verify(all_matches, kpts, cams, image_ids, config, seed, dev, writer, stats)
        finally:
            with span("vc.match.write"):
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
