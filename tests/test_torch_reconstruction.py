"""The port's reconstruction model and COLMAP writers
(``sfm/reconstruction.py``) and pose oracle (``sfm/align.py``) against the
JAX package's.

The same model, built from numpy with a seed, goes through both packages'
writers: the text and binary files must be equal byte for byte, and the
port's ``read_text`` must read back what it wrote (the text keeps 12
significant digits of poses and points, 6 of keypoints and errors).  The
oracle runs ``tests/test_align.py``'s cases through both packages: the
results must be equal to 1e-12 (the same float64 numpy operations).
"""

import numpy as np
import pytest

from tests.test_align import _make_rec_and_gt
from vit_colmap_tpu.sfm import align as jalign
from vit_colmap_tpu.sfm import reconstruction as jrec
from vit_colmap_tpu_torch.sfm import align
from vit_colmap_tpu_torch.sfm import reconstruction as trec


def _model(mod, seed=0):
    """One model with two cameras of different models, three images and 40
    points with tracks, in package ``mod``'s classes."""
    rng = np.random.default_rng(seed)
    rec = mod.Reconstruction()
    rec.cameras[1] = mod.Camera(1, "PINHOLE", 640, 480, np.array([500.5, 501.25, 320.0, 240.0]))
    rec.cameras[2] = mod.Camera(2, "SIMPLE_RADIAL", 800, 600,
                                np.array([612.3456789, 400.0, 300.0, -0.0123456789]))
    for iid in (1, 2, 3):
        q = rng.standard_normal(4)
        n_kp = 30 + iid
        pids = np.full(n_kp, -1, np.int64)
        pids[: 20] = rng.permutation(40)[:20] + 1
        rec.images[iid] = mod.Image(
            image_id=iid, name=f"view_{iid:03d}.png", camera_id=1 + (iid == 3),
            qvec=(q / np.linalg.norm(q)).astype(np.float32 if iid == 2 else np.float64),
            tvec=rng.standard_normal(3), xys=rng.uniform(0, 640, (n_kp, 2)),
            point3D_ids=pids)
    for pid in range(1, 41):
        rec.points3D[pid] = mod.Point3D(
            point3D_id=pid, xyz=rng.standard_normal(3) * 3,
            rgb=rng.integers(0, 256, 3).astype(np.uint8), error=float(rng.uniform(0, 2)),
            track=[(int(i), int(rng.integers(0, 30))) for i in rng.permutation(3)[:2] + 1])
    return rec


@pytest.mark.parametrize("seed", [0, 1])
def test_writers_match_jax_byte_for_byte(tmp_path, seed):
    _model(jrec, seed).write(tmp_path / "jax")
    _model(trec, seed).write(tmp_path / "torch")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert len(names) == 6
    for name in names:
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_read_text_round_trip(tmp_path):
    rec = _model(trec)
    rec.write_text(tmp_path)
    back = trec.read_text(tmp_path)
    assert list(back.cameras) == list(rec.cameras)
    for cid, cam in rec.cameras.items():
        assert back.cameras[cid].model == cam.model
        np.testing.assert_allclose(back.cameras[cid].params, cam.params, rtol=1e-11)
    for iid, im in rec.images.items():
        b = back.images[iid]
        assert (b.name, b.camera_id) == (im.name, im.camera_id)
        np.testing.assert_allclose(b.qvec, im.qvec, rtol=1e-11, atol=1e-12)
        np.testing.assert_allclose(b.tvec, im.tvec, rtol=1e-11, atol=1e-12)
        np.testing.assert_allclose(b.xys, im.xys, rtol=1e-5)
        np.testing.assert_array_equal(b.point3D_ids, im.point3D_ids)
    for pid, pt in rec.points3D.items():
        b = back.points3D[pid]
        np.testing.assert_allclose(b.xyz, pt.xyz, rtol=1e-11, atol=1e-12)
        np.testing.assert_array_equal(b.rgb, pt.rgb)
        assert b.track == pt.track and abs(b.error - pt.error) < 1e-5 * max(1.0, pt.error)
    assert back.mean_track_length() == rec.mean_track_length() == 2.0


def _as_torch(rec):
    out = trec.Reconstruction()
    for iid, im in rec.images.items():
        out.images[iid] = trec.Image(image_id=iid, name=im.name, camera_id=im.camera_id,
                                     qvec=im.qvec, tvec=im.tvec)
    return out


@pytest.mark.parametrize("case", [dict(), dict(noise_rot_deg=2.0),
                                  dict(noise_rot_deg=0.5, noise_ctr=0.01), dict(n=2)])
def test_pose_errors_match_jax(case):
    rec, gt = _make_rec_and_gt(np.random.default_rng(3), **case)
    ref = jalign.pose_errors_vs_gt(rec, gt)
    ours = align.pose_errors_vs_gt(_as_torch(rec), gt)
    if case.get("n") == 2:
        assert ours is None and ref is None
        return
    for k, v in ref.items():
        if k != "per_image":
            assert abs(ours[k] - v) <= 1e-12 * max(1.0, abs(v)), k
    if not case:  # a pure gauge transform aligns with no error
        assert ours["pose_rot_err_deg_max"] < 1e-5 and abs(ours["scale"] - 0.4) < 1e-6


def test_umeyama_and_angle_match_jax():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((20, 3))
    dst = 2.7 * src @ np.linalg.qr(rng.standard_normal((3, 3)))[0].T + [1.0, -2.0, 0.5]
    for with_scale in (True, False):
        s1, R1, t1 = align.umeyama(src, dst, with_scale)
        s2, R2, t2 = jalign.umeyama(src, dst, with_scale)
        assert s1 == s2 and np.array_equal(R1, R2) and np.array_equal(t1, t2)
    assert np.linalg.det(align.umeyama(src, src * [1.0, 1.0, -1.0])[1]) > 0.99
    assert abs(align.rotation_angle_deg(R1) - jalign.rotation_angle_deg(R1)) == 0.0


def test_gt_poses_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    cams = [(np.linalg.qr(rng.standard_normal((3, 3)))[0], rng.standard_normal(3))
            for _ in range(3)]
    names = [f"view_{i:03d}.png" for i in range(3)]
    align.save_gt_poses(tmp_path / "gt_poses.json", cams, names)
    loaded = align.gt_poses_for_rendered_scene(tmp_path / "images")
    assert list(loaded) == names
    assert all(np.array_equal(loaded[n][0], c[0]) for n, c in zip(names, cams))
    assert align.gt_poses_for_rendered_scene(tmp_path / "nowhere" / "images") is None
