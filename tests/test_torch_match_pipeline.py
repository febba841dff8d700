"""The matching stage's chunk loop (``pipeline/match.py``
``match_exhaustive``): pair indices built on the device once a job, each
pair batch's results read back behind it and taken in order.

* On the CPU: a 7-view scene with ``pair_batch=4`` (21 pairs, a ragged last
  batch of one) writes, pair for pair and row for row, what the plain
  reference (``match_pairs_batched`` + ``compact_matches``, one pair at a
  time) gives: pairs with no match are not written, pairs over
  ``max_num_matches`` are cut, also with ``shard_descriptors`` on the
  one-slot mesh.
* On the card (marked ``gpu``, skipped without one): an 8-view job of
  4,096 128-wide descriptors under ``torch.profiler`` makes no
  synchronizing runtime call while it launches its batches and at most
  one a batch in the whole job (the rule of
  ``benchmark/harness/program_spans.is_sync``), and writes the table the
  CPU's plain path writes.  This file imports neither JAX nor the JAX
  package:

    python -m pytest --noconftest tests/test_torch_match_pipeline.py -m gpu
"""

import sqlite3

import numpy as np
import pytest
import torch

from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.ops.interpolate import l2_normalize
from vit_colmap_tpu_torch.ops.matching import compact_matches, match_pairs_batched
from vit_colmap_tpu_torch.parallel.mesh import get_mesh
from vit_colmap_tpu_torch.pipeline.match import match_exhaustive
from vit_colmap_tpu_torch.utils.config import MatchingConfig

DIM = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def arc_descriptors(views, shared, step, own, seed):
    """Signed uint8 descriptors of ``views`` views along a line of world
    points: view v sees points [v * step, v * step + shared), each with
    integer noise of at most 6 steps, plus ``own[v]`` points of its own, in
    a shuffled order.  Views ``shared / step`` or more apart share none."""
    rng = np.random.default_rng(seed)
    world = rng.integers(0, 256, (step * (views - 1) + shared, DIM))
    out = []
    for v in range(views):
        seen = world[v * step : v * step + shared] + rng.integers(-6, 7, (shared, DIM))
        d = np.concatenate([seen, rng.integers(0, 256, (own[v], DIM))])
        out.append(np.clip(d, 0, 255).astype(np.uint8)[rng.permutation(len(d))])
    return out


def scene_db(path, descs, with_descriptors=True):
    """A database of one camera and an image a descriptor set, with random
    keypoints (and the descriptors, unless they come from the device)."""
    rng = np.random.default_rng(len(descs))
    db = ColmapDatabase(path)
    try:
        cam = db.add_camera("SIMPLE_PINHOLE", 640, 480, [500.0, 320.0, 240.0])
        for v, d in enumerate(descs):
            iid = db.add_image(f"view_{v}.png", cam)
            db.add_keypoints(iid, rng.uniform((0, 0), (640, 480), (len(d), 2)).astype(np.float32))
            if with_descriptors:
                db.add_descriptors(iid, d)
        db.commit()
    finally:
        db.close()
    return path


def match_table(path):
    """{(view1, view2): (R, 2) uint32} of the ``matches`` table."""
    db = ColmapDatabase(path)
    try:
        ids = {iid: int(im["name"][5:-4]) for iid, im in db.read_images().items()}
        return {(ids[a], ids[b]): m for (a, b), m in db.read_all_matches().items()}
    finally:
        db.close()


def reference_table(descs, cfg: MatchingConfig):
    """Each pair on its own through the plain matcher and
    ``compact_matches``, cut to ``max_num_matches``; pairs with no match
    left out."""
    dec = [l2_normalize(torch.from_numpy(d).float() / 127.5 - 1.0) for d in descs]
    out = {}
    for i in range(len(descs)):
        for j in range(i + 1, len(descs)):
            v1 = torch.ones(1, len(dec[i]), dtype=torch.bool)
            v2 = torch.ones(1, len(dec[j]), dtype=torch.bool)
            idx = match_pairs_batched(dec[i][None], dec[j][None], v1, v2, cfg.max_ratio,
                                      cfg.max_distance, cfg.cross_check)
            m = compact_matches(idx[0].numpy(), len(dec[i]))[: cfg.max_num_matches]
            if len(m):
                out[(i, j)] = m
    return out


def assert_same_tables(got, want):
    assert sorted(got) == sorted(want)
    for p in want:
        assert got[p].dtype == np.uint32 and np.array_equal(got[p], want[p]), p


# Neighbours share 40 points, views two apart 20, three or more apart none;
# ragged counts (110-180 rows, padded to 256).
SCENE = dict(views=7, shared=60, step=20, own=[50, 65, 80, 95, 110, 120, 60], seed=11)
MAX_MATCHES = 30  # between the two overlaps: neighbours are cut, the rest are not


@pytest.mark.parametrize("shard_descriptors", [False, True])
def test_chunk_loop_writes_the_plain_reference(tmp_path, shard_descriptors):
    descs = arc_descriptors(**SCENE)
    cfg = MatchingConfig(do_verification=False, descriptor_encoding="signed", pair_batch=4,
                         max_num_matches=MAX_MATCHES, shard_descriptors=shard_descriptors)
    want = reference_table(descs, cfg)
    full = reference_table(descs, MatchingConfig(descriptor_encoding="signed"))
    # The scene's premises: some pairs match nothing, some are cut, some not.
    assert 0 < len(want) < 21
    assert any(len(m) > MAX_MATCHES for m in full.values())
    assert any(0 < len(m) < MAX_MATCHES for m in full.values())

    db = scene_db(tmp_path / "scene.db", descs)
    stats = match_exhaustive(db, cfg, mesh=get_mesh(["cpu"]))
    assert_same_tables(match_table(db), want)
    assert stats.num_pairs == 21 and stats.matched_pairs == len(want)
    assert stats.total_matches == sum(len(m) for m in want.values())
    assert stats.chunks == 6 and 0 <= stats.readback_waits <= 6


@pytest.mark.parametrize("pair_batch,chunks", [(1, 21), (7, 3), (32, 1)])
def test_chunk_loop_batch_sizes_write_the_same_table(tmp_path, pair_batch, chunks):
    """Batches of one pair, batches that divide the pairs, one batch wider
    than the job: the same rows, device descriptors taken as given."""
    descs = arc_descriptors(**SCENE)
    cfg = MatchingConfig(do_verification=False, descriptor_encoding="signed",
                         pair_batch=pair_batch, max_num_matches=MAX_MATCHES)
    db = scene_db(tmp_path / "scene.db", descs, with_descriptors=False)
    cache = {f"view_{v}.png": (torch.from_numpy(d), len(d)) for v, d in enumerate(descs)}
    stats = match_exhaustive(db, cfg, device_descriptors=cache, device="cpu")
    assert_same_tables(match_table(db), reference_table(descs, cfg))
    assert stats.chunks == chunks and stats.readback_waits == 0


@pytest.mark.gpu
def test_chunk_loop_makes_no_sync_while_launching_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; run with `pytest -m gpu` on the GPU machine")
    from benchmark.harness import program_spans as ps
    from benchmark.harness.trace import Trace, profiled, span

    descs = arc_descriptors(views=8, shared=3072, step=384, own=[1024] * 8, seed=3)
    cfg = MatchingConfig(do_verification=False, descriptor_encoding="signed")
    names = [f"view_{v}.png" for v in range(8)]
    on_card = {n: (torch.from_numpy(d).cuda(), len(d)) for n, d in zip(names, descs)}
    card_db = scene_db(tmp_path / "card.db", descs, with_descriptors=False)
    match_exhaustive(card_db, cfg, device_descriptors=on_card, device="cuda")  # builds, warms
    con = sqlite3.connect(card_db)
    con.execute("DELETE FROM matches")
    con.commit()
    con.close()
    torch.cuda.synchronize()
    with profiled(True) as held:
        with span("bench.window", True):
            stats = match_exhaustive(card_db, cfg, device_descriptors=on_card, device="cuda")
    trace = Trace(held.events)
    assert stats.num_pairs == 28 and stats.chunks == 2
    assert ps.syncs(trace, "vc.match.launch") == 0
    assert ps.syncs(trace, "vc.match.job") <= stats.chunks + 1
    assert stats.readback_waits <= stats.chunks

    plain = MatchingConfig(do_verification=False, descriptor_encoding="signed", use_pallas=False)
    cpu_db = scene_db(tmp_path / "cpu.db", descs, with_descriptors=False)
    on_cpu = {n: (torch.from_numpy(d), len(d)) for n, d in zip(names, descs)}
    match_exhaustive(cpu_db, plain, device_descriptors=on_cpu, device="cpu")
    assert_same_tables(match_table(card_db), match_table(cpu_db))
    assert stats.matched_pairs == 28
