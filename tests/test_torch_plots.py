"""The port's plotters (``utils/plot_metrics.py``, ``utils/plot_training.py``)
against the JAX package's, the counterpart of
``tests/test_metrics_export.py:66-100``: the same files, and the same
plotted numbers (every axis's title, bar heights, line values and
annotations, read from the figure just before it is saved), on metrics
exported from one database by each package's exporter and on one
``scalars.jsonl``; and the ``ImportError`` where matplotlib is missing."""

import builtins
import json

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
from matplotlib.figure import Figure  # noqa: E402

from tests.test_torch_metrics import populated_db  # noqa: E402,F401
from vit_colmap_tpu.utils import plot_metrics as jpm  # noqa: E402
from vit_colmap_tpu.utils import plot_training as jpt  # noqa: E402
from vit_colmap_tpu.utils.export import export_metrics as jexport  # noqa: E402
from vit_colmap_tpu.utils.metrics import MetricsExtractor as JExtractor  # noqa: E402
from vit_colmap_tpu.utils.metrics import ReconstructionMetrics as JRecon  # noqa: E402
from vit_colmap_tpu_torch.utils import plot_metrics as tpm  # noqa: E402
from vit_colmap_tpu_torch.utils import plot_training as tpt  # noqa: E402
from vit_colmap_tpu_torch.utils.export import export_metrics as texport  # noqa: E402
from vit_colmap_tpu_torch.utils.metrics import MetricsExtractor as TExtractor  # noqa: E402
from vit_colmap_tpu_torch.utils.metrics import ReconstructionMetrics as TRecon  # noqa: E402

RECON = dict(num_reconstructions=1, registered_images=3, registration_rate=0.75,
             total_3d_points=420, avg_track_length=3.2, avg_reprojection_error=0.61)


@pytest.fixture
def drawn(monkeypatch):
    """Every figure's plotted numbers, recorded as it is saved."""
    figures = []
    save = Figure.savefig

    def record(fig, *args, **kwargs):
        figures.append([
            (ax.get_title(), [round(float(p.get_height()), 9) for p in ax.patches],
             [np.asarray(line.get_ydata(), float).round(9).tolist() for line in ax.lines],
             [t.get_text() for t in ax.texts])
            for ax in fig.axes])
        return save(fig, *args, **kwargs)

    monkeypatch.setattr(Figure, "savefig", record)
    return figures


def _export(db, tmp_path, extractor_cls, export, recon_cls, out):
    ex = extractor_cls(db, tmp_path)
    for etype in ("colmap_sift", "vit"):
        result = ex.extract_all_metrics("DS", "s1", etype)
        if etype == "vit":
            result.reconstruction = recon_cls(**RECON)
        export(result, out)
    result = ex.extract_all_metrics("DS", "s2", "vit")
    export(result, out)


def test_metrics_plotter_matches_jax(populated_db, tmp_path, drawn):  # noqa: F811
    _export(populated_db, tmp_path, JExtractor, jexport, JRecon, tmp_path / "jax")
    _export(populated_db, tmp_path, TExtractor, texport, TRecon, tmp_path / "torch")
    files = {}
    for name, module in (("jax", jpm), ("torch", tpm)):
        p = module.MetricsPlotter(tmp_path / name)
        files[name] = [p.plot_comparison("DS", "s1", ["colmap_sift", "vit"]),
                       p.plot_single_scan("DS", "s1", "vit"),
                       p.plot_single_scan("DS", "s2", "vit"),
                       p.plot_summary(),
                       p.plot_comparison("DS", "s2")]  # no baseline: None
    assert files["torch"][-1] is None and files["jax"][-1] is None
    assert [f.relative_to(tmp_path / "torch") for f in files["torch"][:-1]] == \
        [f.relative_to(tmp_path / "jax") for f in files["jax"][:-1]]
    assert all(f.exists() and f.stat().st_size > 0 for f in files["torch"][:-1])
    assert len(drawn) == 8 and drawn[:4] == drawn[4:]
    assert any(h for _, h, _, _ in drawn[4][0:1])  # bars were drawn


def test_training_plotter_matches_jax(tmp_path, drawn):
    path = tmp_path / "scalars.jsonl"
    with open(path, "w") as f:
        for e in range(3):
            for s in range(4):
                f.write(json.dumps({
                    "event": "train", "epoch": e, "step": e * 4 + s,
                    "total_loss": 3.0 - e - 0.1 * s, "detector_loss": 1.0 + 0.01 * s,
                    "descriptor_loss": 0.5, "nce_loss": 0.25}) + "\n")
            f.write(json.dumps({"event": "val", "epoch": e, "total_loss": 3.1 - e}) + "\n")
        f.write("not json\n")
    log = tmp_path / "train.log"
    log.write_text("epoch 0 step 3 loss 0.5123 (det 0.2 desc 0.3)\n"
                   "epoch 1 step 9 loss 0.25\nnoise\n")
    outs = {}
    for name, module in (("jax", jpt), ("torch", tpt)):
        p = module.TrainingLossPlotter(path)
        ep, tr = p.epoch_means("total_loss")
        assert list(ep) == [0, 1, 2] and tr[0] > tr[2]
        outs[name] = (p.epoch_means("detector_loss"), p.epoch_means("total_loss", p.val_events),
                      p.plot_total_loss(tmp_path / name / "t.png"),
                      p.plot_components(tmp_path / name / "c.png"),
                      module.TrainingLossPlotter(log).train_events,
                      module.TrainingLossPlotter(tmp_path).epoch_means())
    for (a, b) in zip(outs["jax"], outs["torch"]):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif hasattr(a, "exists"):
            assert b.exists() and b.name == a.name
        else:
            assert a == b
    assert len(drawn) == 4 and drawn[:2] == drawn[2:]


def test_plot_without_matplotlib_raises_import_error(monkeypatch):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="plotting needs matplotlib"):
        tpm.pyplot()
