"""``TrainableViTExtractor`` of the port against the JAX package's.

Both extractors run a tiny backbone (depth 2, embed 128, 2 heads) and the
full-width heads (512 / 256 / 128) in f32 on the CPU, with one set of
weights: flax's, carried across by ``models/convert.py``, or a
reference-layout ``.pt`` (a torch ``ViTFeatureModel``'s heads with
BatchNorms and an embedded DINOv2) that each package loads itself.

Bounds: the same valid masks and keypoint cells; positions within 1e-3 px,
orientations within 1e-4, scores within 1e-5; descriptor bytes within 1
level (the truncation to uint8 at a level's edge); head and backbone outputs
from the ``.pt`` within atol 2e-4.
"""

import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_colmap_tpu.database import ColmapDatabase as JaxDatabase
from vit_colmap_tpu.features import trainable_vit_extractor as jtve
from vit_colmap_tpu.models import dinov2 as jdino
from vit_colmap_tpu.models.dinov2 import preprocess as jax_preprocess
from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.features.trainable_vit_extractor import TrainableViTExtractor
from vit_colmap_tpu_torch.models import dinov2 as tdino
from vit_colmap_tpu_torch.models.convert import (
    jax_dinov2_to_torch,
    jax_feature_heads_to_torch,
)
from vit_colmap_tpu_torch.models.dinov2 import preprocess
from vit_colmap_tpu_torch.utils.image_io import write_png

TINY = dict(embed_dim=128, depth=2, num_heads=2, mlp_ratio=4.0, swiglu=False)
KW = dict(backbone="tiny", num_keypoints=64, detection_threshold=0.5, min_keypoints=8,
          image_batch=2)


@pytest.fixture(autouse=True)
def tiny_backbone(monkeypatch):
    monkeypatch.setitem(jdino.VIT_CONFIGS, "tiny", TINY)
    monkeypatch.setitem(tdino.VIT_CONFIGS, "tiny", TINY)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rows(db_path, table):
    con = sqlite3.connect(db_path)
    try:
        return con.execute(f"SELECT * FROM {table} ORDER BY 1").fetchall()
    finally:
        con.close()


def _images(seed=0, n=2, hw=(56, 84)):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _extractors(**kw):
    """The JAX extractor with visible random weights (flax's init leaves
    LayerScale at 1e-5, zero biases and unit norms: the backbone gets 0.1
    N(0, 1) on every parameter, the heads' kernels 10% of theirs and their
    biases and norms 0.05 N(0, 1)) and the port's with the same weights;
    the score logits scaled so that they spread (std about 3)."""
    jex = jtve.TrainableViTExtractor(dtype=jnp.float32, **KW, **kw)
    rng = np.random.default_rng(1)

    def noise(path, a):
        a = np.asarray(a)
        n = rng.standard_normal(a.shape).astype(np.float32)
        if path[1].key == "backbone":
            return a + 0.1 * n
        return a * (1 + 0.1 * n) if path[-1].key == "kernel" else a + 0.05 * n

    p = jax.tree_util.tree_map_with_path(noise, jex.params)
    p["params"]["heads"]["kp2"]["kernel"][..., 0] *= 20.0
    jex.params = jax.tree_util.tree_map(jnp.asarray, p)
    tex = TrainableViTExtractor(dtype=torch.float32, device="cpu", **KW, **kw)
    tex.model.backbone.load_state_dict(jax_dinov2_to_torch(p["params"]["backbone"]))
    tex.model.heads.load_state_dict(jax_feature_heads_to_torch(p))
    return jex, tex


def _assert_keypoints_close(ours, ref):
    x, y, orient, score, valid, desc = ours
    rx, ry, rorient, rscore, rvalid, rdesc = ref
    np.testing.assert_array_equal(valid, rvalid)
    assert 0 < valid.sum() < valid.size
    np.testing.assert_allclose(x, rx, atol=1e-3)
    np.testing.assert_allclose(y, ry, atol=1e-3)
    np.testing.assert_allclose(orient, rorient, atol=1e-4)
    np.testing.assert_allclose(score, rscore, atol=1e-5)
    assert np.abs(desc.astype(int) - rdesc.astype(int)).max() <= 1


@pytest.mark.parametrize("subpixel", ["head", "quad", "none"])
def test_extract_batch_matches_jax(subpixel):
    jex, tex = _extractors(subpixel=subpixel)
    imgs = _images()
    ref = jex.extract_batch(imgs)
    ours = tex.extract_batch(imgs)
    assert ours[0].shape == ref[0].shape == (2, 64)
    assert ours[5].shape == ref[5].shape == (2, 64, 128)
    _assert_keypoints_close(ours, ref)
    if subpixel == "none":  # cell centres: the same cells exactly
        np.testing.assert_array_equal(ours[0], np.asarray(ref[0]))
        np.testing.assert_array_equal(ours[1], np.asarray(ref[1]))


def test_min_keypoints_floor():
    """Port of tests/test_extractors.py::test_trainable_min_keypoints_floor:
    a head whose sigmoid never clears the threshold still emits its best
    peaks; with min_keypoints=0 the bare threshold returns."""
    img = np.random.default_rng(0).integers(0, 255, (1, 56, 56, 3), dtype=np.uint8)
    ex = TrainableViTExtractor(backbone="vits14", num_keypoints=64, min_keypoints=16,
                               image_batch=1, detection_threshold=0.99, device="cpu")
    x, y, orient, score, valid, desc = ex.extract_batch(img)
    assert 0 < valid[0].sum() <= 64
    assert valid[0].sum() >= min(16, int((score[0] > 1e-6).sum()))
    ex0 = TrainableViTExtractor(backbone="vits14", num_keypoints=64, min_keypoints=0,
                                image_batch=1, detection_threshold=0.99, device="cpu")
    assert ex0.extract_batch(img)[4][0].sum() == 0


def test_extract_writes_the_database_contract(tmp_path):
    """extract() of both packages on the same PNGs (one needs the INTER_AREA
    resize): the same cameras and images, 6-column keypoints (x, y, 1,
    orientation, score, 0) within 1e-3 px, descriptors within 1 level."""
    jex, tex = _extractors()
    d = tmp_path / "images"
    d.mkdir()
    for i, img in enumerate(_images(n=3, hw=(60, 90))):
        write_png(d / f"view_{i}.png", img)
    write_png(d / "other.png", _images(seed=5, n=1, hw=(56, 70))[0])
    jdb, tdb = tmp_path / "jax.db", tmp_path / "torch.db"
    jex.extract(d, jdb, "SIMPLE_RADIAL")
    tex.extract(d, tdb, "SIMPLE_RADIAL")
    for table in ("cameras", "images"):
        assert _rows(jdb, table) == _rows(tdb, table)
    assert len(_rows(tdb, "cameras")) == 2
    with JaxDatabase.open_database(jdb) as a, ColmapDatabase.open_database(tdb) as b:
        for i in a.read_images():
            ka, kb = a.read_keypoints(i), b.read_keypoints(i)
            assert kb.shape == ka.shape and kb.shape[1] == 6 and len(kb) > 0
            np.testing.assert_allclose(kb, ka, atol=1e-3)
            assert (kb[:, 2] == 1).all() and (kb[:, 5] == 0).all()
            assert (kb[:, 4] > 0).all() and (kb[:, 4] <= 1).all()
            da, db_ = a.read_descriptors(i), b.read_descriptors(i)
            assert db_.shape == (len(kb), 128)
            assert np.abs(da.astype(int) - db_.astype(int)).max() <= 1


class _RefFeatureModel(torch.nn.Module):
    """The reference ``ViTFeatureModel``'s state-dict layout: heads with
    BatchNorms, and the frozen DINOv2 under ``backbone``."""

    def __init__(self, backbone: torch.nn.Module, cin=128, hidden=512, trunk=256, desc=128):
        super().__init__()

        class Up(torch.nn.Module):
            def __init__(self, i, o):
                super().__init__()
                self.deconv = torch.nn.ConvTranspose2d(i, o, 4, 2, 1)
                self.conv = torch.nn.Conv2d(o, o, 3, padding=1)
                self.bn = torch.nn.BatchNorm2d(o)

        def head(out):
            return torch.nn.Sequential(
                torch.nn.Conv2d(trunk, 64 if out == 4 else 128, 3, padding=1),
                torch.nn.BatchNorm2d(64 if out == 4 else 128), torch.nn.GELU(),
                torch.nn.Conv2d(64 if out == 4 else 128, out, 1))

        self.backbone = backbone
        self.upsampler = torch.nn.Sequential(Up(cin, hidden), Up(hidden, hidden))
        self.trunk = torch.nn.Sequential(torch.nn.Conv2d(hidden, trunk, 3, padding=1),
                                         torch.nn.BatchNorm2d(trunk), torch.nn.GELU())
        self.keypoint_head = head(4)
        self.descriptor_head = head(desc)


def _reference_checkpoint(path, layout, prefix, seed=0):
    g = torch.Generator().manual_seed(seed)
    backbone = tdino.DinoV2(tdino.ViTConfig(**TINY, dtype=torch.float32), generator=g)
    # The heads' default init draws from the global generator: seed it, so
    # that the weights do not depend on the tests run before.
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        model = _RefFeatureModel(backbone)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.startswith("backbone.") and t.dtype.is_floating_point:
                t.add_(0.1 * torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
        for m in model.modules():  # BatchNorms with running stats to fold
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.standard_normal(n) * 0.3))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, n)))
                m.weight.copy_(torch.from_numpy(rng.uniform(0.7, 1.3, n)))
                m.bias.copy_(torch.from_numpy(rng.standard_normal(n) * 0.1))
    sd = model.state_dict()
    # A torch.compile / DDP prefix on the heads' keys; the backbone keys
    # stay bare, which is where the reference package looks for them.
    sd = {(k if k.startswith("backbone.") else prefix + k): v for k, v in sd.items()}
    torch.save(sd if layout == "raw" else {layout: sd, "epoch": 3}, path)
    return model


@pytest.mark.parametrize("prefix", ["", "model.", "_orig_mod.", "module."])
@pytest.mark.parametrize("layout", ["model_state_dict", "state_dict", "raw"])
def test_reference_checkpoint_loads_like_jax(tmp_path, layout, prefix):
    """Both packages load the same reference ``.pt`` (BatchNorms folded into
    norm-free heads, the embedded backbone restored): the same backbone
    tokens and head outputs."""
    path = tmp_path / "heads.pt"
    model = _reference_checkpoint(path, layout, prefix)
    jex = jtve.TrainableViTExtractor(weights_path=str(path), dtype=jnp.float32, **KW)
    tex = TrainableViTExtractor(weights_path=str(path), dtype=torch.float32, device="cpu",
                                **KW)
    assert tex.cfg.norm == jex.cfg.norm == "none"
    for k, v in model.backbone.state_dict().items():
        torch.testing.assert_close(tex.model.backbone.state_dict()[k], v, rtol=0, atol=0)
    x = _images(seed=3)
    jout = jex.model.apply(jex.params, jax_preprocess(jnp.asarray(x)))
    jtok = jex.model.apply(jex.params, jax_preprocess(jnp.asarray(x)),
                           method=lambda m, im: m.backbone(im)["x_norm_patchtokens"])
    with torch.no_grad():
        tin = preprocess(torch.from_numpy(x))
        tout = tex.model(tin)
        ttok = tex.model.backbone(tin)["x_norm_patchtokens"]
    np.testing.assert_allclose(ttok.numpy(), np.asarray(jtok), atol=2e-4)
    for key in jout:
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=2e-4,
                                   err_msg=key)


def test_prefixed_backbone_keys_load(tmp_path):
    """A compiled model's checkpoint, every key prefixed: as the JAX package
    does, the port splits off ``backbone.*`` before it strips the prefixes,
    so both load the same heads and neither restores the backbone."""
    from vit_colmap_tpu.models.convert import load_torch_feature_model as jax_load
    from vit_colmap_tpu_torch.models.convert import load_torch_feature_model

    path = tmp_path / "compiled.pt"
    model = _reference_checkpoint(path, "raw", "", seed=1)
    sd = torch.load(path, weights_only=True)
    torch.save({"_orig_mod." + k: v for k, v in sd.items()}, path)
    jheads, jbackbone = jax_load(str(path), jdino.ViTConfig(**TINY))
    theads, tbackbone = load_torch_feature_model(str(path))
    assert jbackbone is None and tbackbone is None
    expect = jax_feature_heads_to_torch(jheads)
    assert theads.keys() == expect.keys()
    for k, v in theads.items():
        np.testing.assert_allclose(v.numpy(), expect[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    tex = TrainableViTExtractor(weights_path=str(path), dtype=torch.float32, device="cpu",
                                **KW)
    loaded = tex.model.backbone.state_dict()
    assert not torch.equal(loaded["pos_embed"], model.backbone.state_dict()["pos_embed"])


def test_unsupported_weights_raise(tmp_path):
    # A directory loads only as a checkpoint of the port's trainer.
    with pytest.raises(FileNotFoundError, match="not a checkpoint of the trainer"):
        TrainableViTExtractor(weights_path=str(tmp_path), device="cpu", **KW)
    with pytest.raises(ValueError, match="expected a .pt"):
        TrainableViTExtractor(weights_path=str(tmp_path / "w.npz"), device="cpu", **KW)
    with pytest.raises(ValueError, match="unknown subpixel"):
        TrainableViTExtractor(subpixel="bicubic", device="cpu", **KW)
