"""The port's SIFT fidelity table (``scripts/torch_sift_fidelity_table.py``)
and its cv2 fixture (``tests/data/sift_fidelity/cv2_rows.json``, written by
``scripts/torch_sift_fidelity_fixtures.py``) on the CPU.

* The committed cv2 rows equal OpenCV's rows computed live on the three
  240 x 320 cases (keypoints, matches, MMA@3, both images' sha1).
* The port's SIFT meets the reference's bars there (``tests/
  test_sift_fidelity.py``: mean MMA@3 ratio >= 0.9, mean match-volume ratio
  >= 0.8 of cv2's), and the live cv2 check finds no difference.
* The table's copies of the protocol equal the JAX test's helpers: the
  homography of an unpinned case, the mutual nearest neighbours and MMA on
  the same inputs; its 8 cases are the JAX script's, with its homographies.
* The pinned zoom rows are reported outside the means.
* A rendered pair whose sha1 is not the fixture's, and means below a bar,
  fail the run.
"""

import copy

import numpy as np
import pytest
import torch

import scripts.torch_sift_fidelity_fixtures as fixtures
import scripts.torch_sift_fidelity_table as table
from tests import test_sift_fidelity as jfid


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


SMALL = table.CASES[:3]


def test_fixture_covers_every_case():
    fx = table.load_fixture()
    assert [r["case"] for r in fx["rows"]] == [c[0] for c in table.CASES + table.PINNED_CASES]
    assert fx["cv2_version"]


def test_committed_cv2_rows_equal_live_cv2_on_small_cases():
    assert fixtures.fixture_rows(SMALL) == table.load_fixture()["rows"][:3]


def test_port_meets_the_bars_on_small_cases():
    out = table.run(SMALL, device="cpu", pinned=())
    assert len(out["rows"]) == 3 and out["live_cv2_mismatch"] == []
    assert table.missed(out) == []
    assert out["mma_ratio_mean"] >= table.MMA_BAR and out["value"] >= table.VOLUME_BAR
    assert all(r["cv2_wall_s"] is not None for r in out["rows"])  # cv2 ran live here
    assert "| 240x320/t0 |" in table.table(out["rows"])


def test_protocol_copies_equal_the_jax_helpers():
    _, _, H_jax = jfid._warp_pair(seed=1)
    img1, _, H = table.warp_pair(seed=1)
    np.testing.assert_array_equal(H, H_jax)
    assert img1.shape == (240, 320, 3)
    rng = np.random.default_rng(0)
    d1, d2 = rng.random((50, 128)), rng.random((40, 128))
    d2[:20] = d1[:20] + 0.01
    m = table.mutual_nn(d1.copy(), d2.copy())
    np.testing.assert_array_equal(m, jfid._mutual_nn(d1.copy(), d2.copy()))
    k1, k2 = rng.random((50, 2)) * 300, rng.random((40, 2)) * 300
    assert table.mma(k1, k2, m, H) == jfid._mma(k1, k2, m, H)


def test_cases_draw_the_jax_scripts_homographies():
    from scripts import sift_fidelity_table as jtable

    assert [(c[0], c[1], c[2], c[4]) for c in table.CASES] == \
        [(c[0], c[1], c[2], c[4]) for c in jtable.CASES]
    for (label, size, seed, scale, _), ref in zip(table.CASES, jtable.CASES):
        _, _, H_jax = jfid._warp_pair(seed=seed, size=size, scale=ref[3])
        np.testing.assert_array_equal(table.warp_pair(seed=seed, size=size, scale=scale)[2],
                                      H_jax, err_msg=label)


def test_zoom_cases_pin_the_scale():
    for label, (h, w), seed, scale, _ in table.PINNED_CASES:
        _, _, H = table.warp_pair(seed=seed, size=(h, w), scale=scale)
        # At the image centre the warp is the pinned scale times a rotation.
        p = H @ [w / 2, h / 2, 1.0]
        jac = (H[:2, :2] * p[2] - np.outer(p[:2], H[2, :2])) / p[2] ** 2
        assert abs(np.sqrt(np.linalg.det(jac)) - scale) < 1e-9, (label, H)


def test_pinned_rows_are_outside_the_means():
    out = table.run(SMALL[:1], device="cpu", pinned=table.PINNED_CASES[:1])
    (row,), (pinned,) = out["rows"], out["pinned_rows"]
    assert pinned["case"] == "480x640/zoom0.7 pinned" and out["live_cv2_mismatch"] == []
    assert out["value"] == row["match_ratio"] and out["mma_ratio_mean"] == row["mma_ratio"]
    lines = table.table(out["rows"], out["pinned_rows"]).splitlines()
    assert lines[2].startswith("| 240x320/t0 |") and "outside the means" in lines[3]
    assert lines[4].startswith("| 480x640/zoom0.7 pinned |")


def test_a_pair_off_the_fixture_fails():
    fx = copy.deepcopy(table.load_fixture())
    fx["rows"][0]["sha1_2"] = "0" * 40
    with pytest.raises(SystemExit, match="sha1"):
        table.run(SMALL[:1], device="cpu", fixture=fx, pinned=())


def test_means_below_a_bar_fail():
    out = {"mma_ratio_mean": 0.95, "value": 0.79, "live_cv2_mismatch": []}
    assert table.missed(out) == ["mean match-volume ratio 0.79 < 0.8"]
    out.update(mma_ratio_mean=0.89, value=0.8)
    assert table.missed(out) == ["mean MMA@3 ratio 0.89 < 0.9"]
