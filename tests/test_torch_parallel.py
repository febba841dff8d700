"""The port's device mesh and multi-process seam (``parallel/``) and its
call sites, against the JAX package on its 8-virtual-device CPU mesh
(``tests/conftest.py``).

* Mesh shapes and axes (8 CPU slots, 4 x 2), shard and replicate,
  ``pad_to_multiple``: the same shapes and numbers as the JAX helpers.
* Matching under a mesh: the plain matcher over 8 slots against JAX's
  ``match_pairs_batched``; the pair-sliced matcher against JAX's
  ``_build_sharded_pallas_matcher`` and the descriptor-sharded matcher
  (with a fully invalid image) against JAX's ``_build_desc_sharded_matcher``,
  bit for bit; ``match_exhaustive(shard_descriptors=True)`` on 3 slots with
  5 images (image padding) against the replicated rows.
* Extraction on 4 CPU slots (vits14 at 70x84, one image a slot) against
  each image extracted alone on one device, bit for bit.
* The process seam: a two-process gloo world from the
  ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID`` contract (the
  worker is this file, run as a script), and the single-process helpers.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":  # the two-process worker: the port only
    sys.path.insert(0, str(ROOT))

from vit_colmap_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from vit_colmap_tpu_torch.parallel import multihost  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Slots run on threads of their own: one intra-op thread each keeps
    the test workers from oversubscribing the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU8 = ["cpu"] * 8


def test_mesh_shape_and_axes():
    from vit_colmap_tpu.parallel.mesh import get_mesh as jget_mesh

    mesh = tmesh.get_mesh(CPU8)
    assert mesh.size == 8 and mesh.axis_names == ("data", "model")
    assert mesh.shape == dict(jget_mesh().shape) == {"data": 8, "model": 1}
    mesh2 = tmesh.get_mesh(CPU8, data=4, model=2)
    assert mesh2.shape == dict(jget_mesh(data=4, model=2).shape) == {"data": 4, "model": 2}
    assert len(mesh2.data_devices) == 4
    with pytest.raises(ValueError):
        tmesh.get_mesh(CPU8, data=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.get_mesh()
    assert tmesh.resolve_mesh(torch.device("cpu")).data_devices == [torch.device("cpu")]


def test_shard_and_replicate_placement():
    mesh = tmesh.get_mesh(CPU8)
    x = torch.arange(16.0).reshape(16, 1)
    xs = tmesh.shard_batch(x, mesh)
    assert [p.shape[0] for p in xs] == [2] * 8
    torch.testing.assert_close(torch.cat(xs), x, rtol=0, atol=0)
    torch.testing.assert_close(tmesh.gather(xs, "cpu"), x, rtol=0, atol=0)
    xr = tmesh.replicate(x, mesh)
    assert len(xr) == 8 and all(torch.equal(r, x) for r in xr)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_batch(torch.zeros(12, 1), mesh)


def test_pad_to_multiple():
    from vit_colmap_tpu.parallel.mesh import pad_to_multiple as jpad

    for n in range(1, 20):
        for m in (1, 2, 3, 8):
            assert tmesh.pad_to_multiple(n, m) == jpad(n, m)
    assert tmesh.pad_to_multiple(5, 8) == 8 and tmesh.pad_to_multiple(9, 8) == 16


def test_run_slots_keeps_slot_order_and_raises():
    out = tmesh.run_slots(lambda i, x: (i, x * 2), [torch.device("cpu")] * 3, [1, 2, 3])
    assert out == [(0, 2), (1, 4), (2, 6)]

    def fail(i):
        if i == 1:
            raise KeyError("slot 1")
        return i

    with pytest.raises(KeyError, match="slot 1"):
        tmesh.run_slots(fail, [torch.device("cpu")] * 2)


def test_tf32_blocks_overlapping_on_two_threads():
    """A slot leaving its exact-f32 block while another is inside keeps the
    flag off; the caller's setting comes back when the last one leaves."""
    import threading

    from vit_colmap_tpu_torch.device import exact_f32_convolutions

    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    a_in, b_in, a_left, seen = threading.Event(), threading.Event(), threading.Event(), []

    def slot_a():  # enters first, leaves while b is inside
        with exact_f32_convolutions():
            a_in.set()
            b_in.wait()
        a_left.set()

    def slot_b():
        a_in.wait()
        with exact_f32_convolutions():
            b_in.set()
            a_left.wait()
            seen.append(torch.backends.cudnn.allow_tf32)

    try:
        threads = [threading.Thread(target=f) for f in (slot_a, slot_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert seen == [False] and torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _descriptors(seed, n_img, N, D):
    from vit_colmap_tpu.ops.matching import normalize_descriptors

    rng = np.random.default_rng(seed)
    return np.array(normalize_descriptors(
        rng.standard_normal((n_img, N, D)).astype(np.float32)))


def _pair_indices(n_img, multiple=8):
    pairs = [(i, j) for i in range(n_img) for j in range(i + 1, n_img)]
    pad = (-len(pairs)) % multiple
    return (np.array([p[0] for p in pairs] + [0] * pad, np.int32),
            np.array([p[1] for p in pairs] + [0] * pad, np.int32))


def test_sharded_matching_equals_jax_single_device():
    """The plain matcher over 8 slots (pair batch split) gives JAX's
    ``match_pairs_batched`` rows."""
    from vit_colmap_tpu.ops.matching import match_pairs_batched
    from vit_colmap_tpu_torch.pipeline.match import _build_sharded_pallas_matcher

    d = _descriptors(0, 4, 64, 32)
    v = np.ones((4, 64), bool)
    i1, i2 = _pair_indices(4)
    ref = np.asarray(match_pairs_batched(d[i1], d[i2], v[i1], v[i2]))
    run = _build_sharded_pallas_matcher(tmesh.get_mesh(CPU8), True, use_pallas=False)
    out = run(torch.from_numpy(d), torch.from_numpy(v), torch.from_numpy(i1).long(),
              torch.from_numpy(i2).long())
    np.testing.assert_array_equal(out.numpy(), ref)


def test_sharded_pallas_matcher_equals_jax():
    """Replicated descriptors, each slot matching its pair slice with the
    matching kernel's wrapper, against JAX's shard_map-wrapped Pallas
    matcher."""
    import jax.numpy as jnp

    from vit_colmap_tpu.parallel.mesh import get_mesh as jget_mesh
    from vit_colmap_tpu.pipeline.match import _build_sharded_pallas_matcher as jbuild
    from vit_colmap_tpu_torch.pipeline.match import _build_sharded_pallas_matcher

    n_img, N = 6, 128
    desc = _descriptors(1, n_img, N, 128)
    valid = np.ones((n_img, N), bool)
    valid[2, 100:] = False
    i1, i2 = _pair_indices(n_img)
    ref = np.asarray(jbuild(jget_mesh(), cross_check=True)(
        jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(i1), jnp.asarray(i2), 0.8, 0.7))
    out = _build_sharded_pallas_matcher(tmesh.get_mesh(CPU8), True)(
        torch.from_numpy(desc), torch.from_numpy(valid), torch.from_numpy(i1).long(),
        torch.from_numpy(i2).long(), 0.8, 0.7)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref >= 0).sum() > 0


def test_desc_sharded_matcher_equals_jax():
    """Descriptors sharded over images, gathered by every slot for the
    batch, against JAX's all_gather matcher, with a fully invalid image."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vit_colmap_tpu.parallel.mesh import get_mesh as jget_mesh
    from vit_colmap_tpu.pipeline.match import _build_desc_sharded_matcher as jbuild
    from vit_colmap_tpu_torch.pipeline.match import _build_desc_sharded_matcher

    n_img, N = 8, 128
    desc = _descriptors(5, n_img, N, 128)
    valid = np.ones((n_img, N), bool)
    valid[1, 90:] = False
    valid[7, :] = False  # a fully padded image slot
    i1, i2 = _pair_indices(n_img)
    jmesh = jget_mesh()
    sh = NamedSharding(jmesh, P("data"))
    ref = np.asarray(jbuild(jmesh, cross_check=True, use_pallas=True)(
        jax.device_put(jnp.asarray(desc), sh), jax.device_put(jnp.asarray(valid), sh),
        jax.device_put(jnp.asarray(i1), sh), jax.device_put(jnp.asarray(i2), sh), 0.8, 0.7))
    mesh = tmesh.get_mesh(CPU8)
    run = _build_desc_sharded_matcher(mesh, True)
    shards = tmesh.shard_batch(torch.from_numpy(desc), mesh)
    vshards = tmesh.shard_batch(torch.from_numpy(valid), mesh)
    assert [s.shape[0] for s in shards] == [1] * 8
    out = run(shards, vshards, torch.from_numpy(i1).long(), torch.from_numpy(i2).long(),
              0.8, 0.7)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref[i1 == 7] == -1).all() and (ref >= 0).sum() > 0


def _checkerboards(image_dir, n, w=320, h=240, square=24):
    from vit_colmap_tpu_torch.utils.image_io import write_png

    image_dir.mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        board = (((xx + i * 8) // square + yy // square) % 2 * 255).astype(np.uint8)
        write_png(image_dir / f"img_{i}.png", np.stack([board] * 3, axis=-1))


def _match_rows(db_path):
    from vit_colmap_tpu_torch.database import ColmapDatabase

    with ColmapDatabase.open_database(db_path) as db:
        return sorted(db.conn.execute("SELECT pair_id, rows, data FROM matches").fetchall())


@pytest.mark.parametrize("shard_descriptors", [False, True])
def test_match_exhaustive_over_three_slots_equals_one_device(tmp_path, shard_descriptors):
    """5 images over 3 slots: the pair batch rounds up to a multiple of 3,
    and sharded descriptors are padded to 6 images; the rows equal one
    device's replicated rows."""
    from vit_colmap_tpu_torch.features.dummy_extractor import DummyExtractor
    from vit_colmap_tpu_torch.pipeline.match import match_exhaustive
    from vit_colmap_tpu_torch.utils.config import MatchingConfig

    _checkerboards(tmp_path / "images", 5)
    for name in ("one.db", "mesh.db"):
        DummyExtractor(device="cpu").extract(tmp_path / "images", tmp_path / name, "PINHOLE")
    one = MatchingConfig(do_verification=False, pair_batch=4)
    on_mesh = MatchingConfig(do_verification=False, pair_batch=4,
                             shard_descriptors=shard_descriptors)
    match_exhaustive(tmp_path / "one.db", one, device="cpu")
    stats = match_exhaustive(tmp_path / "mesh.db", on_mesh, mesh=tmesh.get_mesh(["cpu"] * 3))
    assert stats.num_pairs == 10 and stats.matched_pairs == 10
    assert _match_rows(tmp_path / "mesh.db") == _match_rows(tmp_path / "one.db")


def test_extraction_over_four_slots_equals_single_images():
    """vits14 at 70x84 over 4 CPU slots, one image a slot (and 3 images,
    padded with a zero image), against each image extracted alone by a
    one-device extractor with the same weights and PCA."""
    from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor
    from vit_colmap_tpu_torch.ops.interpolate import fit_pca

    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 255, (4, 70, 84, 3), dtype=np.uint8)
    kw = dict(backbone="vits14", max_keypoints=32, image_batch=4, seed=0)
    ex = ViTExtractor(mesh=tmesh.get_mesh(["cpu"] * 4), **kw)
    alone = ViTExtractor(device="cpu", **kw)
    assert ex._ndev == 4 and alone._ndev == 1 and ex.batch_size == 4
    pca = fit_pca(torch.from_numpy(rng.standard_normal((512, 384)).astype(np.float32)),
                  ex.descriptor_dim)
    ex.set_pca(*pca)
    alone.set_pca(*pca)

    batch = ex.extract_batch(imgs)
    three = ex.extract_batch(imgs[:3])
    for b in range(4):
        single = alone.extract_batch(imgs[b:b + 1])
        for got, want in zip(batch, single):
            np.testing.assert_array_equal(got[b], want[0])
    for got, want in zip(three, batch):
        np.testing.assert_array_equal(got, want[:3])
    assert batch[2].any()  # valid keypoints


def test_multihost_helpers_single_process():
    from vit_colmap_tpu_torch.parallel import (
        initialize_multihost,
        is_primary,
        local_image_slice,
    )

    assert initialize_multihost() is False  # no multi-process env configured
    assert initialize_multihost() is False  # and safe to call again
    assert is_primary()
    paths = [f"img_{i}.png" for i in range(10)]
    assert local_image_slice(paths) == paths


@pytest.mark.parametrize("n_proc", [2, 3, 4])
def test_local_image_slice_is_a_contiguous_ceil_split(monkeypatch, n_proc):
    paths = [f"img_{i:02d}.png" for i in range(10)]
    per = -(-10 // n_proc)
    monkeypatch.setattr(multihost, "process_count", lambda: n_proc)
    shares = []
    for pid in range(n_proc):
        monkeypatch.setattr(multihost, "process_index", lambda pid=pid: pid)
        shares.append(multihost.local_image_slice(paths))
    assert sum(shares, []) == paths
    assert all(s == paths[i * per:(i + 1) * per] for i, s in enumerate(shares))


def _worker() -> None:
    """One process of the two-process world: initialize from the
    environment, check rank and world, the per-process plan, and one
    all_gather over gloo."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    assert multihost.initialize() is True, "expected multi-process initialization"
    assert multihost.initialize() is True  # a second call is a no-op
    pid = dist.get_rank()
    assert pid == int(os.environ["PROCESS_ID"]) and dist.get_world_size() == 2
    assert dist.get_backend() == "gloo"
    assert multihost.is_primary() == (pid == 0)
    paths = [f"img_{i:02d}.png" for i in range(10)]
    mine = multihost.local_image_slice(paths)
    assert mine == (paths[:5] if pid == 0 else paths[5:]), (pid, mine)
    got = [torch.zeros(1, dtype=torch.int64) for _ in range(2)]
    dist.all_gather(got, torch.tensor([pid + 1]))
    assert sorted(int(g) for g in got) == [1, 2], got
    dist.destroy_process_group()
    print(f"MULTIHOST_OK pid={pid}", flush=True)


def test_multihost_two_process_gloo():
    with socket.socket() as s:  # a free port for the rendezvous
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES="2",
                   PROCESS_ID=str(pid), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, __file__], env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MULTIHOST_OK pid={pid}" in out, out


if __name__ == "__main__":
    _worker()
