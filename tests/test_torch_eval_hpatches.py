"""The port's HPatches evaluation (``scripts/torch_eval_hpatches.py``) and the
pieces it adds to the package (``ops/matching.match_pair``,
``utils/image_io.resize_linear``) against the JAX package's and OpenCV's, on
the CPU.

* ``match_pair``: index for index equal to the JAX package's, on
  ``tests/test_matching.py``'s cases, with ties, ``max_ratio``,
  ``max_distance`` and ``cross_check=False``.
* ``resize_linear``: byte for byte equal to ``cv2.resize`` (``INTER_LINEAR``)
  on shrinks, grows, odd widths, one and four channels, 480 x 640 ->
  476 x 630 and 300 random shapes.
* ``mutual_match`` and ``evaluate_dataset``: against ``scripts/
  eval_hpatches.py``'s on a 126 x 168 synthetic tree (one illumination and
  one viewpoint sequence of 3 images, 4 pairs).  Both evaluations take the
  homography's corner error from the port's RANSAC on the JAX package's
  uniforms: that it equals the JAX package's RANSAC on those uniforms (within
  1e-3 px) is held in ``tests/test_torch_training_homography_eval.py``, and
  the JAX RANSAC costs 7 s of compilation a shape and 1 s a pair here, over
  a test's 10 s.  sift and dummy: the same keypoints (sift within 2e-3 px,
  its descriptor bytes within 16, as ``tests/test_torch_sift.py`` bounds
  them; the dummy descriptors come from another hash of the grid position,
  by design), the same matches on every pair, and MMA, homography accuracy
  and average matches equal.  vit
  (ViT-S/14 from one random ``.pth`` with visible LayerNorms, bf16 on both
  sides, the PCA fitted on the first image by each package): average matches
  within 10% and MMA@3 within 0.1 (bf16 rounds differently in the two
  packages, which moves a few keypoints by a grid cell).  trainable_vit (a
  tiny backbone, depth 2 and width 128, since the JAX package's flax init of
  ViT-S/14 and its heads takes 18 s here; its random weights, perturbed,
  carried over by the port's converter into a checkpoint directory, f32):
  the same keypoint counts, and MMA@3 and average matches as for vit.
  Each extractor's first test (on the first image an evaluation extracts)
  pays the JAX package's compilation.
"""

import functools
import json
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scripts.eval_hpatches as jeval
import scripts.torch_eval_hpatches as teval
from vit_colmap_tpu.dataloader.hpatches_dataset import HPatchesDataset as JaxDataset
from vit_colmap_tpu.features import trainable_vit_extractor as jtve
from vit_colmap_tpu.models import dinov2 as jdino
from vit_colmap_tpu.ops import matching as jmatch
from vit_colmap_tpu.utils import homography_eval as jhe
from vit_colmap_tpu_torch.dataloader.hpatches_dataset import HPatchesDataset
from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import generate_synthetic_hpatches
from vit_colmap_tpu_torch.features import trainable_vit_extractor as ttve
from vit_colmap_tpu_torch.models.convert import jax_dinov2_to_torch, jax_feature_heads_to_torch
from vit_colmap_tpu_torch.models import dinov2 as tdino
from vit_colmap_tpu_torch.models.dinov2 import make_backbone
from vit_colmap_tpu_torch.models.feature_model import make_feature_model
from vit_colmap_tpu_torch.ops.interpolate import l2_normalize
from vit_colmap_tpu_torch.ops.matching import match_pair
from vit_colmap_tpu_torch.training.checkpoint import save_checkpoint
from vit_colmap_tpu_torch.utils import homography_eval as the
from vit_colmap_tpu_torch.utils.image_io import resize_linear

SIZE = (126, 168)
VIT_MATCHES_REL = 0.1
VIT_MMA_TOL = 0.1


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ match_pair
def _norm(x):
    return np.array(jmatch.normalize_descriptors(np.asarray(x, np.float32)))


def _case_identical(rng):
    d = _norm(rng.standard_normal((20, 128)))
    return d, d, np.ones(20, bool), np.ones(20, bool), {}


def _case_permuted_padded(rng):
    d1 = _norm(rng.standard_normal((16, 128)))
    d2 = np.concatenate([d1[rng.permutation(16)], _norm(rng.standard_normal((16, 128)))])
    return d1, d2, np.ones(16, bool), np.arange(32) < 16, {}


def _case_ratio(rng):
    base = rng.standard_normal(128)
    d2 = _norm(np.stack([base + 0.3 * rng.standard_normal(128) for _ in range(2)]))
    return _norm(base[None]), d2, np.ones(1, bool), np.ones(2, bool), {"max_ratio": 0.8}


def _case_far(rng):
    return (_norm(rng.standard_normal((8, 128))), _norm(rng.standard_normal((8, 128))),
            np.ones(8, bool), np.ones(8, bool), {"max_distance": 0.05})


def _case_cross_check(rng):
    d1 = np.eye(4, 128, dtype=np.float32)
    d1[1] = 0.9 * d1[0] + 0.1 * np.eye(4, 128)[1]
    d2 = np.eye(4, 128, dtype=np.float32)
    return (_norm(d1), _norm(d2), np.ones(4, bool), np.ones(4, bool),
            {"max_ratio": 1.0, "max_distance": 3.2})


def _case_ties(rng):
    """Small integer descriptors: many equal similarities in rows and
    columns; the first maximum wins on both sides."""
    d1 = _norm(rng.integers(0, 3, (40, 128)))
    d2 = _norm(np.concatenate([d1[::2], rng.integers(0, 3, (20, 128))]))
    d2[5] = d2[4]
    return d1, d2, np.arange(40) < 37, np.arange(40) != 7, {"max_ratio": 1.0,
                                                            "max_distance": 3.2}


def _case_no_cross_check(rng):
    d1, d2, v1, v2, _ = _case_ties(rng)
    return d1, d2, v1, v2, {"cross_check": False, "max_ratio": 0.95}


def _case_ragged(rng):
    """N != M, random validity, the default filters."""
    d1 = _norm(rng.standard_normal((30, 128)))
    d2 = _norm(np.concatenate([d1[:12] + 0.02 * rng.standard_normal((12, 128)),
                               rng.standard_normal((21, 128))]))
    return d1, d2, rng.random(30) < 0.8, rng.random(33) < 0.9, {}


MATCH_CASES = {f.__name__[6:]: f for f in (
    _case_identical, _case_permuted_padded, _case_ratio, _case_far, _case_cross_check,
    _case_ties, _case_no_cross_check, _case_ragged)}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_match_pair_equals_jax(case):
    d1, d2, v1, v2, kw = MATCH_CASES[case](np.random.default_rng(len(case)))
    ref = np.asarray(jmatch.match_pair(d1, d2, v1, v2, **kw))
    out = match_pair(torch.from_numpy(d1), torch.from_numpy(d2), torch.from_numpy(v1),
                     torch.from_numpy(v2), **kw)
    assert out.dtype == torch.int32 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    if case in ("identical", "ragged", "ties"):
        assert (ref >= 0).any()


def test_match_pair_is_one_batch_row():
    from vit_colmap_tpu_torch.ops.matching import match_pairs_batched

    rng = np.random.default_rng(4)
    d1 = l2_normalize(torch.from_numpy(rng.standard_normal((3, 12, 64)).astype(np.float32)))
    d2 = l2_normalize(torch.from_numpy(rng.standard_normal((3, 12, 64)).astype(np.float32)))
    valid = torch.ones(3, 12, dtype=torch.bool)
    batched = match_pairs_batched(d1, d2, valid, valid)
    for p in range(3):
        assert torch.equal(match_pair(d1[p], d2[p], valid[p], valid[p]), batched[p])


# ---------------------------------------------------------- resize_linear
RESIZES = {
    "eval_480x640_to_476x630": ((480, 640, 3), (630, 476)),
    "shrink_odd": ((101, 133, 3), (77, 61)),
    "grow_odd": ((51, 61, 3), (143, 99)),
    "grow_rows_only": ((40, 40, 3), (40, 100)),
    "halve": ((96, 128, 3), (64, 48)),
    "gray": ((57, 62), (190, 151)),
    "one_channel_axis": ((37, 41, 1), (17, 80)),
    "rgba_mixed": ((90, 33, 4), (70, 120)),
    "same_size": ((30, 45, 3), (45, 30)),
    "single_row": ((1, 67, 3), (94, 150)),
}


@pytest.mark.parametrize("case", sorted(RESIZES))
def test_resize_linear_equals_cv2(case):
    shape, (w, h) = RESIZES[case]
    img = np.random.default_rng(len(case)).integers(0, 256, shape, dtype=np.uint8)
    ref = cv2.resize(img, (w, h))
    out = resize_linear(img, w, h)
    assert out.shape == ref.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)


def test_resize_linear_equals_cv2_on_random_shapes():
    """300 random shrinks and grows of 1 to 150 rows and columns, to 1 to
    250, with 1, 3 or 4 channels or none."""
    rng = np.random.default_rng(11)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(1, 151, 2))
        oh, ow = (int(v) for v in rng.integers(1, 251, 2))
        c = int(rng.choice([0, 1, 3, 4]))
        img = rng.integers(0, 256, (h, w, c) if c else (h, w), dtype=np.uint8)
        ref = cv2.resize(img, (ow, oh))
        out = resize_linear(img, ow, oh)
        assert out.shape == ref.shape, (img.shape, oh, ow)
        assert np.array_equal(out, ref), (img.shape, oh, ow)


def test_resize_linear_is_not_linear_exact():
    """A case where INTER_LINEAR and INTER_LINEAR_EXACT differ: the port's
    follows the former."""
    img = np.random.default_rng(0).integers(0, 256, (101, 133, 3), dtype=np.uint8)
    exact = cv2.resize(img, (77, 61), interpolation=cv2.INTER_LINEAR_EXACT)
    out = resize_linear(img, 77, 61)
    assert not np.array_equal(out, exact)
    np.testing.assert_array_equal(out, cv2.resize(img, (77, 61)))


# ------------------------------------------------------- the evaluation
TINY = dict(embed_dim=128, depth=2, num_heads=2, mlp_ratio=4.0, swiglu=False)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("hp") / "hpatches"
    generate_synthetic_hpatches(root, n_illum=1, n_view=1, n_img=3, size=SIZE, seed=0)
    kw = dict(split="all", pair_mode="reference_only", target_height=SIZE[0],
              target_width=SIZE[1])
    return types.SimpleNamespace(root=root, jds=JaxDataset(root, **kw),
                                 tds=HPatchesDataset(root, **kw))


@pytest.fixture
def shared_ransac(monkeypatch):
    """Both evaluations' corner errors from the port's RANSAC on the JAX
    package's uniforms (``fold_in(key(0), hypotheses done)`` per chunk)."""
    n, chunk = the.ransac_chunks(512)
    key = jax.random.key(0)
    uniforms = torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(jax.random.fold_in(key, s * chunk), (chunk, 4)))
        for s in range(n)]))
    port = the.estimate_homography_corner_error

    def corner_error(k1, k2, m, H, wh, **kw):
        return port(k1, k2, m, H, wh, uniforms=uniforms, device="cpu")

    monkeypatch.setattr(jhe, "estimate_homography_corner_error", corner_error)
    monkeypatch.setattr(the, "estimate_homography_corner_error", corner_error)


def _random_vits14(path):
    """A random ViT-S/14 ``.pth`` with LayerScale 0.1 and visible LayerNorm
    weights and biases (with flax's init the saliency is rounding noise)."""
    g = torch.Generator().manual_seed(3)
    model, _ = make_backbone("vits14", generator=g)
    with torch.no_grad():
        for key, value in model.state_dict().items():
            if key.endswith(".gamma"):
                value.fill_(0.1)
            elif "norm" in key and key.endswith(".weight"):
                value.add_(0.1 * torch.randn(value.shape, generator=g))
            elif "norm" in key and key.endswith(".bias"):
                value.copy_(0.1 * torch.randn(value.shape, generator=g))
    torch.save(model.state_dict(), path)
    return str(path)


def _trainable_fns(tmp_path):
    """The JAX trainable extractor (tiny backbone, f32) with visible random
    weights as in ``tests/test_torch_trainable_extractor.py``, and the
    port's loading them from a trainer checkpoint directory written through
    the port's converter."""
    rng = np.random.default_rng(1)
    made = {}

    class Perturbed(jtve.TrainableViTExtractor):
        def __init__(self, **kw):
            super().__init__(dtype=jnp.float32, **kw)

            def noise(path, a):
                a = np.asarray(a)
                n = rng.standard_normal(a.shape).astype(np.float32)
                if path[1].key == "backbone":
                    return a + 0.1 * n
                return a * (1 + 0.1 * n) if path[-1].key == "kernel" else a + 0.05 * n

            p = jax.tree_util.tree_map_with_path(noise, self.params)
            p["params"]["heads"]["kp2"]["kernel"][..., 0] *= 20.0
            self.params = jax.tree_util.tree_map(jnp.asarray, p)
            made["params"] = p

    class JittedInit:
        """The flax model with its ``init`` compiled: eager, it takes 17 s
        here."""

        def __init__(self, model):
            self.model, self.init = model, jax.jit(model.init)

        def __getattr__(self, name):
            return getattr(self.model, name)

    make = jtve.make_feature_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtve, "TrainableViTExtractor", Perturbed)
        mp.setattr(jtve, "make_feature_model",
                   lambda *a, **kw: (lambda m, c, b: (JittedInit(m), c, b))(*make(*a, **kw)))
        jax_fn = jeval.make_extract_fn("trainable_vit", "tiny", None, max_kp=128)
    model, _, _ = make_feature_model("tiny", dtype=torch.float32, norm="group")
    model.backbone.load_state_dict(jax_dinov2_to_torch(made["params"]["params"]["backbone"]))
    model.heads.load_state_dict(jax_feature_heads_to_torch(made["params"]))
    ckpt = tmp_path / "heads"
    save_checkpoint(ckpt, model.heads, model.backbone)
    with pytest.MonkeyPatch.context() as mp:  # f32 on the port's side too
        mp.setattr(ttve, "TrainableViTExtractor",
                   functools.partial(ttve.TrainableViTExtractor, dtype=torch.float32))
        port_fn = teval.make_extract_fn("trainable_vit", "tiny", str(ckpt), max_kp=128,
                                        device="cpu")
    return jax_fn, port_fn


class _Extractors(dict):
    """Each extractor's pair of feature functions (JAX package, port), built
    at first use and kept for the module: the JAX package builds and
    compiles its programs at their first call, which the first test of each
    extractor pays."""

    def __init__(self, tmp):
        super().__init__()
        self.tmp = tmp

    def __missing__(self, name):
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(jdino.VIT_CONFIGS, "tiny", TINY)
            mp.setitem(tdino.VIT_CONFIGS, "tiny", TINY)
            if name == "trainable_vit":
                fns = _trainable_fns(self.tmp)
            else:
                weights = _random_vits14(self.tmp / "vits14.pth") if name == "vit" else None
                backbone = "vits14" if name == "vit" else "vitb14"
                fns = (jeval.make_extract_fn(name, backbone, weights, max_kp=256),
                       teval.make_extract_fn(name, backbone, weights, max_kp=256,
                                             device="cpu"))
        self[name] = fns
        return fns


@pytest.fixture(scope="module")
def extract_fns(tmp_path_factory):
    return _Extractors(tmp_path_factory.mktemp("weights"))


def _recorded(fn, store):
    def wrapped(img):
        out = fn(img)
        store.append(out)
        return out

    return wrapped


def _evaluate_both(tree, fns):
    jfeat, tfeat = [], []
    ref, _ = jeval.evaluate_dataset(tree.jds, _recorded(fns[0], jfeat))
    out, pps = teval.evaluate_dataset(tree.tds, _recorded(fns[1], tfeat), device="cpu")
    assert pps > 0 and len(out.pairs) == len(ref.pairs) == 4
    # One extraction per unique image (3 a sequence), in the same order.
    assert len(jfeat) == len(tfeat) == 6
    return ref, out, jfeat, tfeat


def _assert_features_close(extractor, jf, tf):
    (jk, jd, jenc), (tk, td, tenc) = jf, tf
    assert jenc == tenc and td.dtype == np.uint8
    if extractor in ("vit", "trainable_vit"):
        assert len(jk) == len(tk) > 0
        return
    assert jk.shape == tk.shape and jd.shape == td.shape
    np.testing.assert_allclose(tk, jk, atol=0 if extractor == "dummy" else 2e-3)
    if extractor == "sift":  # dummy bytes come from another hash by design
        assert np.abs(td.astype(int) - jd.astype(int)).max(initial=0) <= 16


@pytest.mark.parametrize("extractor", ["dummy", "sift", "vit", "trainable_vit"])
def test_first_image_features_close_to_jax(tree, extract_fns, extractor):
    """The first image an evaluation extracts (the vit rows fit their PCA
    on it, as a fresh evaluation does; the JAX package compiles here)."""
    img = tree.jds[0]["image1"]
    np.testing.assert_array_equal(img, tree.tds[0]["image1"])
    jax_fn, port_fn = extract_fns[extractor]
    jf = tuple(np.asarray(a) if i < 2 else a for i, a in enumerate(jax_fn(img)))
    _assert_features_close(extractor, jf, port_fn(img))


@pytest.mark.parametrize("extractor", ["dummy", "sift"])
def test_evaluate_dataset_equals_jax(tree, extract_fns, shared_ransac, extractor):
    ref, out, jfeat, tfeat = _evaluate_both(tree, extract_fns[extractor])
    for jf, tf in zip(jfeat, tfeat):
        _assert_features_close(extractor, jf, tf)
    assert [p.num_matches for p in out.pairs] == [p.num_matches for p in ref.pairs]
    assert out.avg_matches == ref.avg_matches > 0
    assert out.mma == pytest.approx(ref.mma, abs=1e-12)
    assert out.homography_accuracy == ref.homography_accuracy


@pytest.mark.parametrize("extractor", ["vit", "trainable_vit"])
def test_evaluate_dataset_within_tolerance(tree, extract_fns, shared_ransac, extractor):
    ref, out, jfeat, tfeat = _evaluate_both(tree, extract_fns[extractor])
    for jf, tf in zip(jfeat, tfeat):
        _assert_features_close(extractor, jf, tf)
    assert ref.avg_matches > 4
    assert abs(out.avg_matches - ref.avg_matches) <= VIT_MATCHES_REL * ref.avg_matches
    assert abs(out.mma[3.0] - ref.mma[3.0]) <= VIT_MMA_TOL
    assert set(out.mma) == set(ref.mma) == {1.0, 3.0, 5.0}


@pytest.mark.parametrize("extractor", ["dummy", "sift"])
def test_mutual_match_equals_jax(tree, extract_fns, extractor):
    """The JAX package's features of each pair through both matchers."""
    fn = extract_fns[extractor][0]
    for i in range(len(tree.jds)):
        item = tree.jds[i]
        f1, f2 = fn(item["image1"]), fn(item["image2"])
        f1 = (np.asarray(f1[0]), np.asarray(f1[1]), f1[2])
        f2 = (np.asarray(f2[0]), np.asarray(f2[1]), f2[2])
        ref = jeval.mutual_match(f1, f2)
        out = teval.mutual_match(f1, f2, device="cpu")
        assert out.dtype == np.int64
        np.testing.assert_array_equal(out, ref)


def test_mutual_match_signed_uneven_sides():
    """Signed (ViT) encoding, N1 != N2, one side empty."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (50, 128), dtype=np.uint8)
    d2 = np.clip(base[rng.permutation(50)[:37]].astype(int)
                 + rng.integers(-3, 4, (37, 128)), 0, 255).astype(np.uint8)
    f1 = (np.zeros((50, 2), np.float32), base, "signed")
    f2 = (np.zeros((37, 2), np.float32), d2, "signed")
    for a, b in ((f1, f2), (f2, f1)):
        ref = jeval.mutual_match(a, b)
        np.testing.assert_array_equal(teval.mutual_match(a, b, device="cpu"), ref)
        assert len(ref) > 20
    empty = (np.zeros((0, 2), np.float32), np.zeros((0, 128), np.uint8), "signed")
    assert teval.mutual_match(f1, empty, device="cpu").shape == (0, 2)


# -------------------------------------------------------------------- CLI
def test_cli_writes_the_json_keys(tree, tmp_path):
    out = tmp_path / "eval.json"
    teval.main(["--data-dir", str(tree.root), "--extractor", "sift", "--target-height",
                str(SIZE[0]), "--target-width", str(SIZE[1]), "--max-keypoints", "256",
                "--max-pairs", "2", "--output", str(out), "--device", "cpu"])
    res = json.loads(out.read_text())
    assert set(res) == {"extractor", "pairs", "avg_matches", "mma", "homography_accuracy",
                        "pairs_per_sec", "device"}
    assert res["pairs"] == 2 and res["device"] == "cpu"
    assert set(res["mma"]) == {"1.0", "3.0", "5.0"}


def test_cli_raises_without_cuda(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teval.main(["--data-dir", str(tree.root), "--extractor", "sift"])
