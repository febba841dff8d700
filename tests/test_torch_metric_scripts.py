"""The port's report scripts against the JAX package's, on the CPU:
``scripts/torch_compare_metrics.py``, ``scripts/torch_aggregate_results.py``
(no pandas), ``scripts/torch_visualize_matches.py`` and
``scripts/torch_plot_training_losses.py``.

Metrics: ``MetricsResult`` JSONs written here for 2 datasets, 2 scenes each
and 3 extractors (one extractor missing from one scene, so that a
single-scene standard deviation is NaN; one result without a
reconstruction; equal values, so that winners tie).  Compare: the printed
tables and the markdown equal line for line.  Aggregate: the rows equal the
JAX script's DataFrame, each scene's pivot, the relative sections, the
summary statistics (mean, sample std) and the winner counts equal cell by
cell; the report's lines outside the tables equal; ``--csv`` equals
``DataFrame.to_csv``.  Viewer: ``classify_matches``, ``--list-images`` and
``--list-matches`` equal the JAX script's on a database written here, and a
drawn pair is a PNG.  The loss plotter writes both figures.
"""

import io
import json
import math
import re
import sys

import numpy as np
import pytest

import scripts.aggregate_results as jagg
import scripts.compare_metrics as jcmp
import scripts.plot_training_losses as jplot
import scripts.torch_aggregate_results as tagg
import scripts.torch_compare_metrics as tcmp
import scripts.torch_plot_training_losses as tplot
import scripts.torch_visualize_matches as tviz
import scripts.visualize_matches as jviz
from vit_colmap_tpu.database import ColmapDatabase as JaxDatabase
from vit_colmap_tpu.utils.export import MetricsExporter as JaxExporter
from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.utils.export import MetricsExporter
from vit_colmap_tpu_torch.utils.image_io import write_png
from vit_colmap_tpu_torch.utils.metrics import (
    FeatureMetrics,
    MatchingMetrics,
    MetricsResult,
    ReconstructionMetrics,
)

EXTRACTORS = ["sift", "vit", "trainable_vit"]


def _result(rng, dataset, scene, extractor, recon=True, tie=None):
    n = int(rng.integers(5, 30))
    feats = FeatureMetrics(n, int(rng.integers(1000, 90000)), float(rng.uniform(100, 4000)),
                           int(rng.integers(0, 100)), int(rng.integers(4000, 9000)),
                           float(rng.uniform(100, 4000)))
    match = MatchingMetrics(
        n * (n - 1) // 2, int(rng.integers(1, 40)), int(rng.integers(1, 40)),
        float(rng.uniform(0, 100)), int(rng.integers(100, 90000)), float(rng.uniform(1, 900)),
        int(rng.integers(0, 50)), int(rng.integers(900, 2000)), float(rng.uniform(1, 900)),
        int(rng.integers(0, 9000)), float(rng.uniform(1, 900)), 0, 900, 100.0,
        float(rng.uniform(0, 1)), float(rng.uniform(0, 100)), int(rng.integers(0, 30)),
        {"CALIBRATED": 3})
    rec = ReconstructionMetrics(int(rng.integers(1, 3)), int(rng.integers(0, n)),
                                float(rng.uniform(0, 100)), int(rng.integers(0, 9000)),
                                float(rng.uniform(2, 6)), float(rng.uniform(0.1, 2)),
                                [{"id": 0}]) if recon else None
    if tie is not None:  # values shared with another extractor of the scene
        match.matched_pairs, rec.registered_images = tie
    return MetricsResult(dataset, scene, extractor, f"2026-01-0{len(scene)}T00:00:00",
                         feats, match, rec, {"extractor": extractor})


@pytest.fixture(scope="module")
def results_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("metrics")
    rng = np.random.default_rng(0)
    exp = MetricsExporter(root)
    for dataset in ("DTU", "HPatches"):
        for scene in ("scan1", "scan24"):
            for k, ex in enumerate(EXTRACTORS):
                if (dataset, scene, ex) == ("HPatches", "scan24", "trainable_vit"):
                    continue
                tie = (7, 3) if ex in ("sift", "vit") and scene == "scan1" else None
                exp.export(_result(rng, dataset, scene, ex,
                                   recon=(dataset, scene, ex) != ("DTU", "scan24", "vit"),
                                   tie=tie))
    return root


# --------------------------------------------------------------- compare
@pytest.mark.parametrize("scene", ["scan1", "all"])
def test_compare_equals_jax(results_dir, tmp_path, capsys, scene):
    argv = ["--results-dir", str(results_dir), "--dataset", "DTU", "--scene", scene,
            "--extractors", *EXTRACTORS]
    ref_md, out_md = tmp_path / "jax.md", tmp_path / "port.md"
    sys_argv = sys.argv
    try:
        sys.argv = ["compare_metrics.py", *argv, "--output", str(ref_md)]
        jcmp.main()
    finally:
        sys.argv = sys_argv
    ref_out = capsys.readouterr().out
    tcmp.main([*argv, "--output", str(out_md)])
    out = capsys.readouterr().out
    assert out.replace(str(out_md), "X") == ref_out.replace(str(ref_md), "X")
    assert out_md.read_text().splitlines() == ref_md.read_text().splitlines()
    for ex in EXTRACTORS:
        assert f"| {ex} |" in out_md.read_text() or f" {ex} " in out_md.read_text()


def test_compare_reports_missing_extractor(results_dir, capsys):
    wins = tcmp.compare_scene(MetricsExporter(results_dir), "HPatches", "scan24",
                              EXTRACTORS)
    ref = jcmp.compare_scene(JaxExporter(results_dir), "HPatches", "scan24", EXTRACTORS)
    assert wins == ref and set(wins) == {"sift", "vit"}
    assert "missing metrics for: ['trainable_vit']" in capsys.readouterr().out


# ------------------------------------------------------------- aggregate
@pytest.fixture(scope="module")
def frames(results_dir):
    ref = jagg.build_dataframe(JaxExporter(results_dir).load_all_metrics())
    rows = tagg.build_rows(MetricsExporter(results_dir).load_all_metrics())
    return ref, rows


def _same(a, b) -> bool:
    a, b = float(a), float(b)
    return (math.isnan(a) and math.isnan(b)) or a == b


def test_rows_equal_the_dataframe(frames):
    ref, rows = frames
    assert list(rows[0]) == list(ref.columns)
    assert len(rows) == len(ref) == 11
    for got, want in zip(rows, ref.to_dict("records")):
        for k, v in want.items():
            assert got[k] == v, (k, got[k], v)
            assert type(got[k]) in (int, float, str)


def test_pivots_equal_pandas(frames):
    ref, rows = frames
    for (dataset, scene), g in ref.groupby(["dataset", "scene"]):
        want = g.pivot_table(index="extractor",
                             values=[m for m in jagg.PIVOT_METRICS if m in g],
                             aggfunc="first")
        cols, body = tagg.pivot([r for r in rows
                                 if (r["dataset"], r["scene"]) == (dataset, scene)])
        assert cols == list(want.columns)
        assert [ex for ex, _ in body] == list(want.index)
        for ex, values in body:
            assert all(_same(v, want.loc[ex, c]) for c, v in zip(cols, values))


def test_summary_statistics_equal_pandas(frames):
    ref, rows = frames
    for dataset, g in ref.groupby("dataset"):
        want = g.groupby("extractor").agg({m: ["mean", "std"] for m in tagg.SUMMARY_METRICS})
        cols, body = tagg.summary([r for r in rows if r["dataset"] == dataset])
        assert cols == list(want.columns)
        assert [ex for ex, _ in body] == list(want.index)
        for ex, values in body:
            for c, v in zip(cols, values):
                assert v == pytest.approx(want.loc[ex, c], rel=1e-12, nan_ok=True), (ex, c)
    single = [r for r in rows if r["extractor"] == "trainable_vit" and r["dataset"] == "HPatches"]
    assert math.isnan(tagg.summary(single)[1][0][1][1])


def test_winner_counts_equal_jax(frames):
    ref, rows = frames
    assert tagg.winner_counts(rows) == jagg.winner_counts(ref)
    # Ties (matched pairs and registered images of sift and vit in scan1)
    # go to the first extractor of the scene, as idxmax gives them.
    scan1 = [r for r in rows if r["scene"] == "scan1" and r["dataset"] == "DTU"]
    metric = [("matched_pairs", "", True)]
    assert tagg.winner_counts(scan1, metric) == jagg.winner_counts(
        ref[(ref.scene == "scan1") & (ref.dataset == "DTU")], metric)


def _code_blocks(text: str):
    """(the text with each ``` block replaced by a marker, the blocks)."""
    blocks = re.findall(r"```\n(.*?)\n```", text, flags=re.S)
    return re.sub(r"```\n.*?\n```", "```TABLE```", text, flags=re.S), blocks


def _cells(block: str) -> dict:
    """{(row label, column index): cell text} of a table block."""
    lines = [ln.strip() for ln in block.splitlines()]
    body = lines[lines.index("extractor") + 1:]
    return {(ln.split()[0], i): v for ln in body for i, v in enumerate(ln.split()[1:])}


@pytest.mark.parametrize("baseline", ["colmap_sift", "vit"])
def test_report_equals_jax(results_dir, frames, tmp_path, baseline):
    ref_df, rows = frames
    # The CLI's fallback: colmap_sift is absent, so sift.
    base = baseline if baseline in set(ref_df["extractor"]) else "sift"
    jagg.generate_report(ref_df, tmp_path / "jax.md", base)
    tagg.generate_report(rows, tmp_path / "port.md", base)
    ref_text, ref_blocks = _code_blocks((tmp_path / "jax.md").read_text())
    text, blocks = _code_blocks((tmp_path / "port.md").read_text())
    assert text == ref_text
    assert f"### Relative performance vs `{base}`" in text
    # Each table's cells: pandas' to_string against this script's layout.
    assert len(blocks) == len(ref_blocks) == 6
    for block, ref_block in zip(blocks, ref_blocks):
        assert _cells(block) == _cells(ref_block), (block, ref_block)


def test_cli_report_and_csv(results_dir, frames, tmp_path, capsys):
    ref_df, rows = frames
    out, table = tmp_path / "r.md", tmp_path / "all.csv"
    tagg.main(["--results-dir", str(results_dir), "--output", str(out), "--csv", str(table)])
    printed = capsys.readouterr().out
    assert f"Wrote {out}" in printed and f"Wrote {table}" in printed
    for ex in EXTRACTORS:
        assert f"**{ex}**" in out.read_text()
    buf = io.StringIO()
    ref_df.to_csv(buf, index=False)
    assert table.read_text().splitlines() == buf.getvalue().splitlines()
    tagg.main(["--results-dir", str(results_dir), "--dataset", "nope"])
    assert "No metrics found" in capsys.readouterr().out


# ---------------------------------------------------------------- viewer
@pytest.fixture(scope="module")
def database(tmp_path_factory):
    """The same rows through both packages' writers: 3 images, matches on
    every pair, a two-view geometry on two of them."""
    root = tmp_path_factory.mktemp("viz")
    rng = np.random.default_rng(1)
    kpts = [rng.uniform(0, 60, (40, 6)).astype(np.float32) for _ in range(3)]
    images = root / "images"
    images.mkdir()
    for i in range(3):
        write_png(images / f"im{i}.png", rng.integers(0, 256, (64, 80, 3), dtype=np.uint8))
    paths = {}
    for name, cls in (("jax", JaxDatabase), ("port", ColmapDatabase)):
        db = cls(root / f"{name}.db")
        cam = db.add_pinhole_camera(80, 64, 70, 70, 40, 32)
        ids = [db.add_image(f"im{i}.png", cam) for i in (2, 0, 1)]
        for iid, k in zip(ids, kpts):
            db.add_keypoints(iid, k)
        for a in range(3):
            for b in range(a + 1, 3):
                m = np.stack([rng.permutation(40)[:25], rng.permutation(40)[:25]], 1)
                db.add_matches(ids[a], ids[b], m.astype(np.uint32))
                if b != 2:
                    db.add_two_view_geometry(ids[a], ids[b], m[::2].astype(np.uint32),
                                             config=2)
        db.commit()
        db.close()
        paths[name] = root / f"{name}.db"
    return paths, images


def test_classify_matches_equals_jax(database):
    paths, _ = database
    jdb, tdb = JaxDatabase(paths["jax"]), ColmapDatabase(paths["port"])
    try:
        pairs = sorted(tdb.read_all_matches())
        assert pairs == sorted(jdb.read_all_matches()) and len(pairs) == 3
        for i, j in pairs:
            m = tdb.read_matches(i, j)
            g, jg = tdb.read_two_view_geometry(i, j), jdb.read_two_view_geometry(i, j)
            flags = tviz.classify_matches(m, g)
            np.testing.assert_array_equal(flags, jviz.classify_matches(jdb.read_matches(i, j),
                                                                       jg))
            assert flags.dtype == bool and len(flags) == len(m)
        assert tviz.classify_matches(np.zeros((4, 2), np.uint32), None).tolist() == [False] * 4
    finally:
        jdb.close()
        tdb.close()


@pytest.mark.parametrize("flag", ["--list-images", "--list-matches"])
def test_listings_equal_jax(database, capsys, flag):
    paths, _ = database
    sys_argv = sys.argv
    try:
        sys.argv = ["visualize_matches.py", "--database", str(paths["jax"]), flag]
        jviz.main()
    finally:
        sys.argv = sys_argv
    ref = capsys.readouterr().out
    tviz.main(["--database", str(paths["port"]), flag])
    assert capsys.readouterr().out == ref
    assert "im0.png" in ref


def test_draws_a_pair_and_raises_without_matplotlib(database, tmp_path, monkeypatch):
    paths, images = database
    out = tmp_path / "pair.png"
    tviz.main(["--database", str(paths["port"]), "--image-dir", str(images), "--image1",
               "im0.png", "--image2", "1", "--output", str(out), "--show-all-keypoints",
               "--show-scores", "--show-orientation", "--max-matches", "10"])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tviz.main(["--database", str(paths["port"]), "--image-dir", str(images),
                   "--image1", "0", "--image2", "1", "--output", str(tmp_path / "x.png")])
    tviz.main(["--database", str(paths["port"]), "--list-matches"])  # no matplotlib needed


# ----------------------------------------------------------- loss plots
def test_plot_training_losses_writes_both_figures(tmp_path, capsys):
    lines = [{"step": s, "epoch": s // 3, "total_loss": 2.0 - 0.1 * s,
              "detector_loss": 1.0 - 0.05 * s, "descriptor_loss": 0.5} for s in range(9)]
    lines.append({"val": True, "epoch": 1, "total_loss": 1.5})
    src = tmp_path / "scalars.jsonl"
    src.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    tplot.main([str(src), "--output-dir", str(tmp_path / "port")])
    printed = capsys.readouterr().out
    sys_argv = sys.argv
    try:
        sys.argv = ["plot_training_losses.py", str(src), "--output-dir", str(tmp_path / "jax")]
        jplot.main()
    finally:
        sys.argv = sys_argv
    for name in ("total_loss.png", "loss_components.png"):
        assert (tmp_path / "port" / name).exists() and (tmp_path / "jax" / name).exists()
        assert f"Wrote {tmp_path / 'port' / name}" in printed
