"""The port's program spans (``utils/profiling.span``): free when no
profiler records, and, under ``torch.profiler``, one ``vc.*`` span a phase
inside the extractor's batch (with one ``vc.backbone.mlp`` a block inside
its forward), the matcher's job and the stage timer's stages, nested and
in program order."""

import numpy as np
import pytest
import torch

from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor
from vit_colmap_tpu_torch.models import dinov2
from vit_colmap_tpu_torch.pipeline.match import match_exhaustive
from vit_colmap_tpu_torch.utils import profiling
from vit_colmap_tpu_torch.utils.config import MatchingConfig

EXTRACT_PHASES = ["vc.extract.wire", "vc.extract.h2d", "vc.extract.forward",
                  "vc.extract.detect", "vc.extract.readback"]
TINY = dict(embed_dim=128, depth=2, num_heads=2, mlp_ratio=4.0, swiglu=False)
MLP_SPAN = "vc.backbone.mlp"
MATCH_PHASES = ["vc.match.read", "vc.match.assemble", "vc.match.launch",
                "vc.match.unpack", "vc.match.write"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _recorded(fn):
    """``fn()`` under ``torch.profiler``; its ``vc.*`` spans as (name,
    start_us, end_us) in start order."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith("vc.")]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def _inside(spans, parent):
    """The names of the spans that lie inside the one span named
    ``parent``, in start order."""
    (_, a, b), = [s for s in spans if s[0] == parent]
    return [n for n, s, e in spans if n != parent and a <= s and e <= b]


def _in_order(spans, names):
    """Each of ``names`` once, each ending before the next starts."""
    got = [s for s in spans if s[0] in names]
    assert [s[0] for s in got] == names
    assert all(x[2] <= y[1] for x, y in zip(got, got[1:]))


def test_span_without_profiler_never_annotates(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_annotation", refuse)
    assert not torch._C._autograd._profiler_enabled()
    with profiling.span("vc.test"):
        x = torch.ones(3).sum()
    t = profiling.StageTimer()
    with t.stage("extract"):
        pass
    assert float(x) == 3.0 and t.counts["extract"] == 1


def test_span_records_under_profiler_and_passes_errors():
    def body():
        with profiling.span("vc.outer"):
            with pytest.raises(ValueError):
                with profiling.span("vc.inner"):
                    raise ValueError("inside a span")
            torch.ones(8).sum()

    spans = _recorded(body)
    assert [s[0] for s in spans] == ["vc.outer", "vc.inner"]
    assert _inside(spans, "vc.outer") == ["vc.inner"]
    with profiling.span("vc.after"):  # the profiler is off again: nothing held
        pass


@pytest.fixture(scope="module")
def extractor():
    """A depth-2, 128-wide backbone on the CPU with a PCA installed, so a
    batch takes the fused path the benchmark times."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(dinov2.VIT_CONFIGS, "tiny", TINY)
        ex = ViTExtractor(backbone="tiny", max_keypoints=64, image_batch=2,
                          dtype=torch.float32, attn_impl="xla", device="cpu")
    g = torch.Generator().manual_seed(0)
    ex.set_pca(torch.linalg.qr(torch.randn(128, 128, generator=g))[0].numpy(),
               np.zeros(128, np.float32))
    return ex


def test_extract_batch_spans_each_phase_once_in_order(extractor):
    imgs = np.random.default_rng(2).integers(0, 256, (2, 70, 98, 3), dtype=np.uint8)
    out = []
    spans = _recorded(lambda: out.append(extractor.extract_batch(imgs)))
    assert [s[0] for s in spans].count("vc.extract.batch") == 1
    inner = _inside(spans, "vc.extract.batch")
    assert [n for n in inner if n != MLP_SPAN] == EXTRACT_PHASES
    assert _inside(spans, "vc.extract.forward") == [MLP_SPAN] * TINY["depth"]
    _in_order(spans, EXTRACT_PHASES)
    xy, _sc, valid, desc = out[0][:4]
    assert len(xy) == len(desc) == 2 and desc.dtype == np.uint8 and valid.any()


def test_extract_batch_async_spans_have_no_readback(extractor):
    imgs = np.random.default_rng(3).integers(0, 256, (2, 70, 98, 3), dtype=np.uint8)
    spans = _recorded(lambda: extractor.extract_batch_async(imgs))
    inner = _inside(spans, "vc.extract.batch")
    assert [n for n in inner if n != MLP_SPAN] == EXTRACT_PHASES[:-1]
    assert inner.count(MLP_SPAN) == TINY["depth"]


def _scene_db(path, views=3, k=160, shared=120):
    """``views`` images whose first ``shared`` descriptors are one set, so
    every pair matches, the rest drawn anew a view."""
    rng = np.random.default_rng(5)
    common = rng.integers(0, 256, (shared, 128), dtype=np.uint8)
    db = ColmapDatabase(path)
    try:
        cam = db.add_camera("SIMPLE_PINHOLE", 640, 480, [500.0, 320.0, 240.0])
        for v in range(views):
            iid = db.add_image(f"view_{v}.png", cam)
            xy = rng.uniform((0, 0), (640, 480), size=(k, 2)).astype(np.float32)
            db.add_keypoints(iid, xy)
            own = rng.integers(0, 256, (k - shared, 128), dtype=np.uint8)
            db.add_descriptors(iid, np.concatenate([common, own]))
        db.commit()
    finally:
        db.close()
    return path


def test_match_job_spans_each_phase_once_in_order(tmp_path):
    db = _scene_db(tmp_path / "scene.db")
    cfg = MatchingConfig(do_verification=False, descriptor_encoding="signed", pair_batch=2)
    stats = []
    spans = _recorded(lambda: stats.append(match_exhaustive(db, cfg, device="cpu")))
    assert [s[0] for s in spans].count("vc.match.job") == 1
    assert _inside(spans, "vc.match.job") == MATCH_PHASES
    _in_order(spans, MATCH_PHASES)
    assert stats[0].num_pairs == 3 and stats[0].matched_pairs == 3


def test_match_job_with_verification_writes_around_verify(tmp_path):
    db = _scene_db(tmp_path / "scene.db")
    cfg = MatchingConfig(do_verification=True, descriptor_encoding="signed", pair_batch=2,
                         ransac_iters=64)
    spans = _recorded(lambda: match_exhaustive(db, cfg, device="cpu"))
    order = [*MATCH_PHASES, "vc.match.verify", "vc.match.write"]
    assert _inside(spans, "vc.match.job") == order
    phases = [s for s in spans if s[0] in set(order)]
    assert all(x[2] <= y[1] for x, y in zip(phases, phases[1:]))


def test_stage_timer_stage_is_a_span_with_its_totals_unchanged():
    t = profiling.StageTimer()

    def body():
        with t.stage("extract"):
            torch.ones(4).sum()
        with t.stage("match+verify"):
            pass

    spans = _recorded(body)
    assert [s[0] for s in spans] == ["vc.stage.extract", "vc.stage.match+verify"]
    assert dict(t.counts) == {"extract": 1, "match+verify": 1}
    assert all(t.totals[n] >= 0.0 for n in t.counts)
    assert t.to_dict().keys() == {"extract", "match+verify"}
    with t.stage("extract"):  # no profiler: timed all the same
        pass
    assert t.counts["extract"] == 2
