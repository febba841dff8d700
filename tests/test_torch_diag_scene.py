"""The port's mapper diagnostic (``scripts/torch_diag_scene.py``) against the
JAX script (``scripts/diag_scene.py``) on one verified database, on the CPU.

The database: a 6-view rendered scene (126 x 168) through the port's
``Pipeline.run`` with SIFT, verification on.  Both scripts read it; they
must list the same candidate pairs with the same inlier counts and give each
the same verdict (``few_matches``, ``tri_angle``, ``reproj``, ``ok``), and
the same summary line.  At the default gates every pair initializes; with
stricter gates (a 20 degree triangulation angle and a 0.3 px reprojection
bound, set in both packages' ``ReconstructionConfig``) the narrow-baseline
pairs fail on the angle and the wide ones on reprojection.  The best
candidate's counts may differ by the two packages' f32 rounding in the pose
fits, so they are held only through the verdict.
"""

import dataclasses
import json
import sys

import pytest
import torch

import scripts.diag_scene as jdiag
import scripts.torch_diag_scene as tdiag
from vit_colmap_tpu.utils import config as jconfig
from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import render_multiview_scene
from vit_colmap_tpu_torch.pipeline import Pipeline
from vit_colmap_tpu_torch.utils import config as tconfig
from vit_colmap_tpu_torch.utils.config import Config


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def json_lines(text: str) -> list:
    """The JSON objects printed one a line (and the first, indented)."""
    head, _, rest = text.partition("\n}\n")
    return [json.loads(head + "\n}")] + [json.loads(l) for l in rest.splitlines() if l]


@pytest.fixture(scope="module")
def verified_db(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("diag")
    _, K = render_multiview_scene(tmp_path / "images", n_cams=6, size=(126, 168),
                                  focal=158.0, seed=7)
    config = Config()
    config.extractor.extractor_type = "sift"
    config.extractor.max_keypoints = 256
    config.camera.model = "PINHOLE"
    config.camera.params = [float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])]
    config.do_reconstruction = False
    db = tmp_path / "db.db"
    Pipeline(config, device="cpu").run(tmp_path / "images", tmp_path / "out", db)
    return db


STRICT = {"min_triangulation_angle_deg": 20.0, "filter_max_reproj_error_px": 0.3}


@pytest.mark.parametrize("gates", [{}, STRICT], ids=["default", "strict"])
def test_verdicts_equal_the_jax_script(verified_db, gates, capsys, monkeypatch):
    for mod in (jconfig, tconfig):
        cls = mod.ReconstructionConfig
        monkeypatch.setattr(mod, "ReconstructionConfig",
                            lambda cls=cls: dataclasses.replace(cls(), **gates))
    db = verified_db
    capsys.readouterr()
    out = tdiag.main(["--db", str(db), "--top", "16", "--device", "cpu"])
    port = json_lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["diag_scene.py", "--db", str(db), "--top", "16"])
    jdiag.main()
    jax = json_lines(capsys.readouterr().out)

    assert port[0] == jax[0]  # the database summary
    assert len(port) == len(jax) == 17  # the summary, 15 pairs, the metric
    for p, j in zip(port[1:-1], jax[1:-1]):
        assert (p["pair"], p["matches"], p["verdict"]) == (j["pair"], j["matches"],
                                                          j["verdict"])
    assert port[-1] == {**jax[-1], "db": str(db)}
    assert out["verdicts"] == jax[-1]["verdicts"]
    if gates:
        assert {"tri_angle", "reproj"} <= set(out["verdicts"]), out["verdicts"]
    else:
        assert out["verdicts"] == {"ok": 15}
