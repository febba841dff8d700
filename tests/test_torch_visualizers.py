"""The port's three token visualisers (``scripts/torch_visualize_
invariant_points.py``, ``torch_visualize_hpatches_warping.py``,
``torch_visualize_training_sampling.py``) against the JAX scripts'
computations on the CPU.

One random ViT-S/14 ``.pth`` (LayerScale 0.1, visible LayerNorms) loaded by
both packages in f32, a 112 x 140 rendered image and its warp by a
conservative homography.  Each compute function against the JAX package's
functions called as the JAX script calls them (``select_invariant_points``,
``warp_patch_tokens``, ``feature_similarity_map``, ``sample_features_at``,
``hard_negative_coords``): the tokens within 1e-4 (the backbones' f32
rounding), the invariant cells' coordinates and ``valid`` exactly,
similarities and warped tokens within 1e-4, the hard negatives'
coordinates exactly where their similarities leave no tie (no two within
1e-5), the points drawn and numpy's draws of the negatives exactly.  Each
script's ``main`` also draws its figure to a temporary PNG.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scripts.torch_visualize_hpatches_warping as twarp
import scripts.torch_visualize_invariant_points as tinv
import scripts.torch_visualize_training_sampling as tsamp
from vit_colmap_tpu.dataloader import homography_utils as jhu
from vit_colmap_tpu.dataloader import training_sampler as js
from vit_colmap_tpu.models import dinov2 as jdino
from vit_colmap_tpu.models.convert import load_torch_checkpoint as jax_load
from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import (
    make_structured_image,
    warp_perspective,
)
from vit_colmap_tpu_torch.dataloader.synthetic_homography import (
    SyntheticHomographyConfig,
    generate_random_homography,
)
from vit_colmap_tpu_torch.models.dinov2 import make_backbone
from vit_colmap_tpu_torch.utils.image_io import write_png


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


HW = (112, 140)  # an 8 x 10 token grid
TOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The .pth, the pair, H, and both packages' f32 token functions."""
    tmp = tmp_path_factory.mktemp("viz")
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
    pth = tmp / "vits14.pth"
    torch.save(model.state_dict(), pth)

    rng = np.random.default_rng(5)
    img1 = make_structured_image(rng, *HW)
    H = generate_random_homography(HW[1], HW[0], SyntheticHomographyConfig.conservative(),
                                   rng)
    img2 = warp_perspective(img1, H, (HW[1], HW[0]))

    jmodel, jcfg = jdino.make_backbone("vits14", dtype=jnp.float32)
    params = jax_load(str(pth), jcfg)

    def jfeats(img):
        out = jmodel.apply(params, jdino.preprocess(jnp.asarray(img[None])))
        gh, gw = out["grid"]
        return out["x_norm_patchtokens"].reshape(1, gh, gw, -1).astype(jnp.float32)

    tfeats = tinv.feature_fn("vits14", pth, "cpu", dtype=torch.float32)
    return {"tmp": tmp, "pth": pth, "img1": img1, "img2": img2, "H": H,
            "jf": (jfeats(img1), jfeats(img2)), "tfeats": tfeats}


def test_tokens_match_jax(setup):
    for img, jf in zip((setup["img1"], setup["img2"]), setup["jf"]):
        t = setup["tfeats"](img).numpy()
        assert t.shape == (1, 8, 10, 384)
        np.testing.assert_allclose(t, np.asarray(jf), atol=TOL)


def jax_invariant(setup, top_k):
    f1, f2 = setup["jf"]
    return js.select_invariant_points(f1, f2, jnp.asarray(setup["H"], jnp.float32)[None],
                                      top_k=top_k)


def test_invariant_points_match_jax(setup):
    res = tinv.compute(setup["img1"], setup["img2"], setup["H"], setup["tfeats"], top_k=64,
                       min_similarity=0.0, max_points=40)
    inv = jax_invariant(setup, 64)
    valid = np.asarray(inv.valid)[0]
    np.testing.assert_array_equal(res["valid"], valid)
    assert valid.sum() > 20
    np.testing.assert_array_equal(res["coords2_grid"], np.asarray(inv.coords2_grid)[0])
    np.testing.assert_allclose(res["coords1_grid"], np.asarray(inv.coords1_grid)[0],
                               atol=1e-5)
    np.testing.assert_allclose(res["similarity"], np.asarray(inv.similarity)[0], atol=TOL)
    # The JAX script's filter and sort on its own similarities.
    c2 = (np.asarray(inv.coords2_grid)[0][valid] + 0.5) * 14
    sim = np.asarray(inv.similarity)[0][valid]
    keep = sim >= 0.0
    order = np.argsort(-sim[keep])[:40]
    np.testing.assert_array_equal(res["c2"], c2[keep][order])
    np.testing.assert_allclose(res["sim"], sim[keep][order], atol=TOL)


def test_hpatches_warping_matches_jax(setup):
    res = twarp.compute(setup["img1"], setup["img2"], setup["H"], setup["tfeats"])
    f1, f2 = setup["jf"]
    Hj = jnp.asarray(setup["H"], jnp.float32)[None]
    warped, valid = jhu.warp_patch_tokens(f1, Hj)
    sim, _ = jhu.feature_similarity_map(f1, f2, Hj)
    np.testing.assert_array_equal(res["valid"], np.asarray(valid)[0])
    np.testing.assert_allclose(res["warped"], np.asarray(warped)[0], atol=TOL)
    np.testing.assert_allclose(res["sim"], np.asarray(sim)[0], atol=TOL)
    want = float(np.asarray(sim)[0][np.asarray(valid)[0]].mean())
    assert abs(res["mean_similarity"] - want) <= TOL
    for k in ("rgb1", "rgbw", "rgb2", "blend"):
        assert res[k].shape == (8, 10, 3) and 0 <= res[k].min() and res[k].max() <= 1


def test_training_sampling_matches_jax(setup):
    top_k, n_hard, seed = 32, 4, 2
    res = tsamp.compute(setup["img1"], setup["img2"], setup["H"], setup["tfeats"],
                        top_k=top_k, num_hard_neg=n_hard, seed=seed)
    f1, f2 = setup["jf"]
    inv = jax_invariant(setup, top_k)

    def norm(x):
        return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-8)

    f2n = norm(f2)
    anchor = norm(js.sample_features_at(f2n, inv.coords2_grid))
    hard_xy, hard_sim = js.hard_negative_coords(f2n, inv.coords2_grid, anchor, top_n=n_hard)
    np.testing.assert_array_equal(res["valid"], np.asarray(inv.valid)[0])
    np.testing.assert_array_equal(res["coords2_grid"], np.asarray(inv.coords2_grid)[0])
    np.testing.assert_allclose(res["hard_sim"], np.asarray(hard_sim)[0], atol=TOL)
    hs = np.sort(np.asarray(hard_sim)[0], axis=-1)
    untied = (np.diff(hs, axis=-1) > 1e-5).all(axis=-1)  # rows with no near-tie
    assert untied.mean() > 0.5
    np.testing.assert_array_equal(res["hard_xy"][untied], np.asarray(hard_xy)[0][untied])

    # numpy's draws, in the JAX script's order.
    rng = np.random.default_rng(seed)
    v = np.asarray(inv.valid)[0]
    n_valid = int(v.sum())
    sel = rng.choice(n_valid, min(5, n_valid), replace=False)
    np.testing.assert_array_equal(res["sel"], sel)
    for k, npx in zip(sel, res["in_image"]):
        negs = np.stack([rng.uniform(0, 9, 6), rng.uniform(0, 7, 6)], axis=1)
        keep = np.linalg.norm(negs - np.asarray(inv.coords2_grid)[0][v][k], axis=1) >= 16 / 14
        np.testing.assert_array_equal(npx, (negs[keep] + 0.5) * 14)
    xn, yn = rng.uniform(0, 9, 200), rng.uniform(0, 7, 200)
    np.testing.assert_array_equal(res["cross_px"], np.stack([(xn + 0.5) * 14,
                                                              (yn + 0.5) * 14], axis=1))


def test_each_script_draws_its_figure(setup, capsys):
    tmp = setup["tmp"]
    write_png(tmp / "a.png", setup["img1"])
    write_png(tmp / "b.png", setup["img2"])
    np.savetxt(tmp / "H.txt", setup["H"])
    common = ["--weights", str(setup["pth"]), "--device", "cpu"]
    tinv.main(["--image1", str(tmp / "a.png"), "--image2", str(tmp / "b.png"),
               "--homography", str(tmp / "H.txt"), "--top-k", "32", "--output",
               str(tmp / "inv.png"), *common])
    twarp.main(["--image1", str(tmp / "a.png"), "--output", str(tmp / "warp.png"), *common])
    tsamp.main(["--image", str(tmp / "a.png"), "--output", str(tmp / "samp.png"), *common])
    printed = capsys.readouterr().out
    for name in ("inv.png", "warp.png", "samp.png"):
        assert (tmp / name).stat().st_size > 1000 and f"Wrote {tmp / name}" in printed
    assert "mean in-overlap similarity" in printed
