"""The port's host image decoder (``csrc/host/image_io.cc`` through
``utils/native_io.py``) against the JAX package's native decoder and cv2.

The port's library is built with g++ (``kernels/host_build.py``); the JAX
decoder is the untouched ``native/image_io.cc``, built into a temporary
directory with ``native/build.sh``'s flags, and the JAX binding is pointed
at it.  Both skip where g++ or a runtime library (or, for the JAX build, a
header) is absent.

Bounds: ``probe_size`` equal; ``decode_batch_i420`` bit for bit equal to
the JAX decoder (colour and gray JPEG, RGB, gray, RGBA, 16-bit and palette
PNG, odd and even sizes, padding, failed slots); ``imread_rgb`` /
``imread_gray`` on JPEG equal to ``cv2.imread`` for every EXIF orientation;
the libjpeg declarations of ``csrc/host/jpeg62.h`` equal to the system
``jpeglib.h`` in every size and offset; the ViT extractor's native route
against the JAX package's on a mixed JPEG/PNG directory within the slice
tests' yuv bounds (keypoints 5e-3 px, descriptors +-1), and the
first-build rule (a warm ``extract()``, ``serve``'s second job, a run
after ``extract_batch``) in both packages.
"""

import re
import shutil
import sqlite3
import struct
import subprocess
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import vit_colmap_tpu.utils.native_io as jax_native_io  # noqa: E402
from vit_colmap_tpu.database import ColmapDatabase as JaxDatabase  # noqa: E402
from vit_colmap_tpu.features.vit_extractor import ViTExtractor as JaxViTExtractor  # noqa: E402
from vit_colmap_tpu.models import dinov2 as jdino  # noqa: E402
from vit_colmap_tpu_torch.database import ColmapDatabase  # noqa: E402
from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor  # noqa: E402
from vit_colmap_tpu_torch.kernels import host_build  # noqa: E402
from vit_colmap_tpu_torch.models import dinov2 as tdino  # noqa: E402
from vit_colmap_tpu_torch.models.convert import jax_dinov2_to_torch  # noqa: E402
from vit_colmap_tpu_torch.utils import image_io, native_io  # noqa: E402

torch.set_num_threads(2)

TINY = dict(embed_dim=128, depth=2, num_heads=2, mlp_ratio=4.0, swiglu=False)
KP_TOL = 5e-3  # px, the slice tests' yuv420c4 bound
JAX_DECODER = Path(__file__).resolve().parents[1] / "native" / "image_io.cc"


@pytest.fixture(scope="module")
def port_lib():
    if native_io.load_native() is None:
        pytest.skip("the port's host image library is unavailable (g++ or a runtime library)")
    return native_io


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory, port_lib):
    """The JAX package's decoder, built from native/image_io.cc with
    native/build.sh's flags, its binding pointed at it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    out = tmp_path_factory.mktemp("jax_native") / "libvc_image_io.so"
    build = subprocess.run(
        [gxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(out), str(JAX_DECODER),
         "-l:libjpeg.so.62", "-l:libpng16.so.16", "-L/lib/x86_64-linux-gnu", "-pthread"],
        capture_output=True, text=True)
    if build.returncode != 0:
        pytest.skip(f"the JAX decoder does not build here: {build.stderr[-300:]}")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_io, "_LIB_PATH", out)
        mp.setattr(jax_native_io, "_lib", None)
        mp.setattr(jax_native_io, "_lib_failed", False)
        assert jax_native_io.load_native() is not None
        yield jax_native_io


def _smooth(rng, h, w, c=3):
    small = rng.integers(0, 256, (max(2, h // 8), max(2, w // 8), c), dtype=np.uint8)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC).reshape(h, w, c)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def _write_palette_png(path, index: np.ndarray, palette: np.ndarray, depth: int):
    """An indexed PNG (color type 3) at ``depth`` bits, filter 0."""
    h, w = index.shape
    per = 8 // depth
    rows = []
    for r in range(h):
        vals = np.zeros(-(-w // per) * per, np.uint8)
        vals[:w] = index[r]
        packed = np.zeros(len(vals) // per, np.uint8)
        for k in range(per):
            packed |= vals[k::per] << (8 - depth * (k + 1))
        rows.append(b"\0" + packed.tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 3, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                     + _png_chunk(b"PLTE", palette.astype(np.uint8).tobytes())
                     + _png_chunk(b"IDAT", zlib.compress(b"".join(rows)))
                     + _png_chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """Every decoder input kind at an odd size (193 x 257) and an even one."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    files = []
    for h, w in ((193, 257), (96, 128)):
        rgb = _smooth(rng, h, w)
        tag = f"{h}x{w}"
        cv2.imwrite(str(d / f"color_{tag}.jpg"), rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])
        cv2.imwrite(str(d / f"gray_{tag}.jpg"), rgb[..., 0])
        cv2.imwrite(str(d / f"rgb_{tag}.png"), rgb[..., ::-1])
        cv2.imwrite(str(d / f"gray_{tag}.png"), rgb[..., 1])
        cv2.imwrite(str(d / f"rgba_{tag}.png"),
                    np.concatenate([rgb[..., ::-1], rgb[..., :1]], axis=-1))
        cv2.imwrite(str(d / f"deep_{tag}.png"),
                    rgb.astype(np.uint16) * 257 + rng.integers(0, 256, rgb.shape, dtype=np.uint16))
        _write_palette_png(d / f"pal4_{tag}.png", rng.integers(0, 16, (h, w)),
                           rng.integers(0, 256, (16, 3)), 4)
        _write_palette_png(d / f"pal8_{tag}.png", rng.integers(0, 256, (h, w)),
                           rng.integers(0, 256, (200, 3)), 8)  # indices past the palette
        image_io.write_jpeg(d / f"ours_{tag}.jpg", rgb, quality=80)
        image_io.write_jpeg(d / f"ours_gray_{tag}.jpg", rgb[..., 2], quality=80)
    files = sorted(d.iterdir())
    return d, files


def test_probe_size(port_lib, jax_lib, image_files, tmp_path):
    d, files = image_files
    for f in files:
        size = (193, 257) if "193x257" in f.name else (96, 128)
        assert port_lib.probe_size(f) == jax_lib.probe_size(f) == size[::-1]
    # A wrong extension falls back to the other format.
    png_as_jpg = tmp_path / "png.jpg"
    png_as_jpg.write_bytes((d / "rgb_96x128.png").read_bytes())
    jpg_as_png = tmp_path / "jpg.png"
    jpg_as_png.write_bytes((d / "color_96x128.jpg").read_bytes())
    for f in (png_as_jpg, jpg_as_png):
        assert port_lib.probe_size(f) == jax_lib.probe_size(f) == (128, 96)
    junk = tmp_path / "junk.jpg"
    junk.write_bytes(b"not an image")
    for f in (tmp_path / "missing.jpg", tmp_path / "missing.png", junk):
        assert port_lib.probe_size(f) is None and jax_lib.probe_size(f) is None


@pytest.mark.parametrize("target", [(256, 192), (252, 182), (258, 194), (128, 96), (96, 72)])
def test_decode_batch_i420_equals_jax(port_lib, jax_lib, image_files, tmp_path, target):
    _, files = image_files
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8 truncated")
    damaged = tmp_path / "damaged.png"  # IDAT's CRC broken
    data = bytearray((image_files[0] / "rgb_96x128.png").read_bytes())
    data[data.index(b"IDAT") + 10] ^= 0xFF
    damaged.write_bytes(bytes(data))
    paths = [*files, bad, damaged, tmp_path / "missing.png"]
    tw, th = target
    port_lib.decodes.clear()
    ours, ok = port_lib.decode_batch_i420(paths, tw, th, pad_to=len(paths) + 2)
    ref, ref_ok = jax_lib.decode_batch_i420(paths, tw, th, pad_to=len(paths) + 2)
    assert ours.shape == ref.shape == (len(paths) + 2, th * 3 // 2, tw)
    assert ok.tolist() == ref_ok.tolist() == [True] * len(files) + [False] * 5
    for f, a, b in zip(paths, ours, ref):
        assert np.array_equal(a, b), f.name
    assert not ours[len(files):].any()  # failed and padded slots stay zero
    assert port_lib.decodes["i420"] == len(files)


def test_decode_threads_and_empty_batch(port_lib, image_files):
    _, files = image_files
    one, _ = port_lib.decode_batch_i420(files, 64, 48, n_threads=1)
    many, _ = port_lib.decode_batch_i420(files, 64, 48, n_threads=8)
    on_card, _ = port_lib.decode_batch_i420(files, 64, 48, device=0)  # libjpeg ignores it
    assert np.array_equal(one, many) and np.array_equal(one, on_card)
    out, ok = port_lib.decode_batch_i420([], 64, 48, pad_to=3)
    assert out.shape == (3, 72, 64) and not out.any() and not ok.any()
    with pytest.raises(ValueError, match="pad_to"):
        port_lib.decode_batch_i420(files[:3], 64, 48, pad_to=2)


def _with_exif(src, dst, orientation: int, endian: str):
    """``src`` with an Exif APP1 segment holding the orientation tag."""
    bo = b"II" if endian == "<" else b"MM"
    tiff = (bo + struct.pack(endian + "HI", 42, 8) + struct.pack(endian + "H", 1)
            + struct.pack(endian + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(endian + "I", 0))
    seg = b"Exif\0\0" + tiff
    data = src.read_bytes()
    dst.write_bytes(data[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg + data[2:])


@pytest.mark.parametrize("orientation", range(0, 10))
def test_imread_jpeg_equals_cv2(port_lib, image_files, tmp_path, orientation):
    d, _ = image_files
    for name in ("color_193x257.jpg", "gray_96x128.jpg", "ours_193x257.jpg"):
        f = tmp_path / name
        _with_exif(d / name, f, orientation, "<" if orientation % 2 else ">")
        rgb = image_io.imread_rgb(f)
        assert np.array_equal(rgb, cv2.imread(str(f))[..., ::-1]), name
        gray = image_io.imread_gray(f)
        assert np.array_equal(gray, cv2.imread(str(f), cv2.IMREAD_GRAYSCALE)), name
    assert image_io.exif_orientation((d / "color_193x257.jpg").read_bytes()) == 1


def test_write_jpeg_reads_back_in_cv2(port_lib, image_files):
    d, _ = image_files
    src = cv2.imread(str(d / "rgb_193x257.png"))[..., ::-1].astype(int)
    back = cv2.imread(str(d / "ours_193x257.jpg"))[..., ::-1].astype(int)
    assert np.abs(back - src).mean() < 8  # the JAX test's decode bound
    assert np.array_equal(image_io.imread_rgb(d / "ours_193x257.jpg"), back)
    assert cv2.imread(str(d / "ours_gray_193x257.jpg"), cv2.IMREAD_UNCHANGED).ndim == 2


def test_imread_without_the_library_raises(image_files, monkeypatch):
    d, _ = image_files
    monkeypatch.setattr(native_io, "load_native", lambda: None)
    with pytest.raises(NotImplementedError, match="native image decoder"):
        image_io.imread_rgb(d / "color_96x128.jpg")
    with pytest.raises(NotImplementedError, match="native image"):
        image_io.write_jpeg(d / "x.jpg", np.zeros((8, 8, 3), np.uint8))


# ------------------------------------------------------------------ the ABI
COMMON = ["err", "mem", "progress", "client_data", "is_decompressor", "global_state"]
STRUCTS = ("jpeg_error_mgr", "jpeg_component_info", "jpeg_compress_struct",
           "jpeg_decompress_struct")


def _declared_fields(header: str, name: str) -> list[str]:
    body = re.search(r"struct %s \{(.*?)\n\};" % name, header, re.S).group(1)
    body = re.sub(r"union \{.*?\} (\w+);", r"union_t \1;", body, flags=re.S)
    fields = []
    for stmt in filter(None, (s.strip() for s in body.split(";"))):
        if stmt == "VC_JPEG_COMMON_FIELDS":
            fields += COMMON
        elif m := re.search(r"\(\*(\w+)\)", stmt):
            fields.append(m.group(1))
        else:
            fields += [re.sub(r"\[.*\]", "", part).split()[-1].lstrip("*")
                       for part in stmt.split(",")]
    return fields


def test_jpeg62_declarations_match_jpeglib_h(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    header = host_build.HOST_DIR / "jpeg62.h"
    text = header.read_text()
    lines = []
    for s in STRUCTS:
        # No "struct" keyword: jpeglib.h declares jpeg_component_info as a
        # typedef of an unnamed struct, and C++ names both kinds alike.
        lines.append(f'std::printf("{s} %zu\\n", sizeof({s}));')
        for f in _declared_fields(text, s):
            lines.append(f'std::printf("{s}.{f} %zu %zu\\n", offsetof({s}, {f}), '
                         f"sizeof((({s}*)0)->{f}));")
    main = "int main() {\n" + "\n".join(lines) + "\nreturn 0;\n}\n"
    layouts = []
    for include in ("#include <jpeglib.h>", f'#include "{header}"'):
        src = tmp_path / f"abi{len(layouts)}.cc"
        src.write_text("#include <cstddef>\n#include <cstdio>\n" + include + "\n" + main)
        exe = src.with_suffix("")
        build = subprocess.run([gxx, "-std=c++17", "-o", str(exe), str(src)],
                               capture_output=True, text=True)
        if build.returncode != 0 and "jpeglib.h" in include:
            pytest.skip("no jpeglib.h here")
        assert build.returncode == 0, build.stderr
        layouts.append(subprocess.run([str(exe)], capture_output=True, text=True,
                                      check=True).stdout)
    assert layouts[0].count("\n") > 150
    assert layouts[0] == layouts[1]


# ------------------------------------------------------------ the extractor
@pytest.fixture
def tiny_backbone(monkeypatch):
    monkeypatch.setitem(jdino.VIT_CONFIGS, "tiny", TINY)
    monkeypatch.setitem(tdino.VIT_CONFIGS, "tiny", TINY)


def _scene(d, seed=0, bad=False):
    """A mixed JPEG/PNG directory: four 112 x 140 views of one scene
    shifted by whole patches and one 118 x 147 view (resized to the patch
    grid); ``bad`` adds a PNG whose header probes but whose data fails."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
    for i in range(4):
        view = np.kron(np.roll(base, i, axis=1)[:8, :10], np.ones((14, 14, 1), np.uint8))
        if i % 2:
            cv2.imwrite(str(d / f"v{i}.png"), view[..., ::-1])
        else:
            cv2.imwrite(str(d / f"v{i}.jpg"), view[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])
    cv2.imwrite(str(d / "w.jpg"), _smooth(rng, 118, 147)[..., ::-1])
    if bad:
        data = bytearray((d / "v1.png").read_bytes())
        data[data.index(b"IDAT") + 10] ^= 0xFF
        (d / "v2b.png").write_bytes(bytes(data))
    return d


def _extractors(tmp_path, transfer_format="yuv420", **extra):
    kw = dict(backbone="tiny", max_keypoints=64, image_batch=2, attn_impl="xla",
              pca_path=str(tmp_path / "pca.npz"), transfer_format=transfer_format, **extra)
    jex = JaxViTExtractor(dtype=jnp.float32, **kw)
    rng = np.random.default_rng(1)
    jex.params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.3 * rng.standard_normal(p.shape).astype(np.float32)),
        jex.params)
    tex = ViTExtractor(dtype=torch.float32, device="cpu", **kw)
    tex.model.load_state_dict(jax_dinov2_to_torch(jex.params))
    return jex, tex


def _assert_same_rows(jdb, tdb):
    def rows(p, table):
        con = sqlite3.connect(p)
        try:
            return con.execute(f"SELECT * FROM {table} ORDER BY 1").fetchall()
        finally:
            con.close()

    assert rows(jdb, "cameras") == rows(tdb, "cameras")
    assert rows(jdb, "images") == rows(tdb, "images")
    with JaxDatabase.open_database(jdb) as a, ColmapDatabase.open_database(tdb) as b:
        for i in sorted(a.read_images()):
            ka, kb = a.read_keypoints(i), b.read_keypoints(i)
            assert ka.shape == kb.shape and len(ka) > 0
            np.testing.assert_allclose(kb, ka, atol=KP_TOL)
            da, db_ = a.read_descriptors(i), b.read_descriptors(i)
            assert np.abs(da.astype(int) - db_.astype(int)).max() <= 1


@pytest.mark.parametrize("transfer_format", ["yuv420", "yuv420c4"])
def test_extract_native_route_matches_jax(tmp_path, tiny_backbone, jax_lib, transfer_format):
    images = _scene(tmp_path / "images", bad=True)
    jex, tex = _extractors(tmp_path, transfer_format)
    jex.extract(images, tmp_path / "jax.db", "SIMPLE_PINHOLE")  # fits and saves the PCA
    native_io.decodes.clear()
    tex.extract(images, tmp_path / "torch.db", "SIMPLE_PINHOLE")  # loads it
    assert jex._yuv_full_range and tex._yuv_full_range
    # Five images decoded straight to I420, the damaged one skipped; no RGB
    # decode, the PCA file having loaded.
    assert native_io.decodes == {"i420": 5}
    _assert_same_rows(tmp_path / "jax.db", tmp_path / "torch.db")
    with ColmapDatabase.open_database(tmp_path / "torch.db") as db:
        names = {r["name"] for r in db.read_images().values()}
    assert "v2b.png" not in names and len(names) == 5

    # The first-build rule: a warm extract() takes the host route, still at
    # full range, in both packages.
    jex.extract(images, tmp_path / "jax2.db", "SIMPLE_PINHOLE")
    tex.extract(images, tmp_path / "torch2.db", "SIMPLE_PINHOLE")
    assert native_io.decodes["i420"] == 5 and tex._yuv_full_range
    _assert_same_rows(tmp_path / "jax2.db", tmp_path / "torch2.db")


def test_pca_fit_decodes_only_its_subset(tmp_path, tiny_backbone, port_lib):
    images = _scene(tmp_path / "images")
    tex = ViTExtractor(backbone="tiny", max_keypoints=64, image_batch=2, attn_impl="xla",
                       dtype=torch.float32, device="cpu", transfer_format="yuv420c4",
                       pca_fit_images=2)
    native_io.decodes.clear()
    tex.extract(images, tmp_path / "torch.db", "SIMPLE_PINHOLE")
    # The fit subset is the first two names, v0.jpg and v1.png: one JPEG
    # decoded to RGB (the PNG goes through the Python decoder).
    assert native_io.decodes == {"i420": 5, "rgb": 1}


def test_run_after_extract_batch_takes_the_host_route(tmp_path, tiny_backbone, jax_lib):
    """A forward built by ``extract_batch`` before the run closes the
    native route in both packages: studio-range host packing."""
    from vit_colmap_tpu.pipeline import Pipeline as JaxPipeline
    from vit_colmap_tpu.utils.config import Config as JaxConfig
    from vit_colmap_tpu_torch.pipeline import Pipeline
    from vit_colmap_tpu_torch.utils.config import Config

    images = _scene(tmp_path / "images")
    jex, tex = _extractors(tmp_path)
    batch = np.random.default_rng(3).integers(0, 256, (2, 112, 140, 3), dtype=np.uint8)
    jex.extract_batch(batch)  # builds the forward and fits a PCA
    tex.set_pca(*(np.asarray(a) for a in jex._pca))
    tex.extract_batch(batch)
    native_io.decodes.clear()
    dbs = {}
    for name, pipe_cls, cfg_cls, ex, kw in (
        ("jax", JaxPipeline, JaxConfig, jex, {}),
        ("torch", Pipeline, Config, tex, {"device": "cpu"}),
    ):
        cfg = cfg_cls()
        cfg.extractor.transfer_format = "yuv420"
        cfg.matching.do_verification = False
        cfg.do_reconstruction = False
        pipe = pipe_cls(cfg, **kw)
        pipe._make_extractor = lambda ex=ex: ex
        dbs[name] = tmp_path / f"{name}.db"
        pipe.run(images, tmp_path / f"{name}_out", dbs[name])
    assert not getattr(jex, "_yuv_full_range", False) and not tex._yuv_full_range
    assert native_io.decodes["i420"] == 0
    _assert_same_rows(dbs["jax"], dbs["torch"])


def test_serve_second_job_takes_the_host_route(tmp_path, tiny_backbone, jax_lib):
    """One server, two jobs: the first on the native route, the second on
    the warm extractor's host route at full range, in both packages."""
    from vit_colmap_tpu.pipeline.serve import PipelineServer as JaxServer
    from vit_colmap_tpu.pipeline.serve import SceneJob as JaxJob
    from vit_colmap_tpu.utils.config import Config as JaxConfig
    from vit_colmap_tpu_torch.pipeline.serve import PipelineServer, SceneJob
    from vit_colmap_tpu_torch.utils.config import Config

    scenes = [_scene(tmp_path / f"s{k}" / "images", seed=k) for k in range(2)]
    jex, tex = _extractors(tmp_path, "yuv420c4")
    counts = []
    for name, server_cls, job_cls, cfg_cls, ex, kw in (
        ("jax", JaxServer, JaxJob, JaxConfig, jex, {}),
        ("torch", PipelineServer, SceneJob, Config, tex, {"device": "cpu"}),
    ):
        cfg = cfg_cls()
        cfg.extractor.transfer_format = "yuv420c4"
        cfg.matching.do_verification = False
        cfg.do_reconstruction = False
        server = server_cls(cfg, **kw)
        server.pipeline._make_extractor = lambda ex=ex: ex
        native_io.decodes.clear()
        for k, images in enumerate(scenes):
            res = server.run_job(job_cls(image_dir=images, output_dir=tmp_path / f"{name}{k}"))
            assert res.ok, res.error
            counts.append(native_io.decodes["i420"])
    assert jex._yuv_full_range and tex._yuv_full_range
    assert counts[2:] == [5, 5]  # the port: 5 images natively, then none
    for k in range(2):
        _assert_same_rows(tmp_path / f"jax{k}" / "database.db",
                          tmp_path / f"torch{k}" / "database.db")


def test_hpatches_dataset_reads_jpeg_as_jax(tmp_path, port_lib):
    """A sequence image stored as JPEG (image 2 of each sequence) loads the
    same pixels in both packages' datasets (cv2.imread in the JAX one); at
    the images' own size, so that no INTER_AREA shrink (within 1 of cv2's,
    ``test_torch_image_io.py``) blurs the decode's comparison."""
    from test_dataset import _make_hpatches_tree
    from vit_colmap_tpu.dataloader import hpatches_dataset as jds
    from vit_colmap_tpu_torch.dataloader import hpatches_dataset as tds

    for name in _make_hpatches_tree(tmp_path, n_seq_i=1, n_seq_v=1, n_img=3, size=(56, 70)):
        ppm = tmp_path / name / "2.ppm"
        cv2.imwrite(str(ppm.with_suffix(".jpg")), cv2.imread(str(ppm)),
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        ppm.unlink()
    native_io.decodes.clear()
    kw = dict(pair_mode="all_pairs", target_height=56, target_width=70, seed=4)
    jd, td = jds.HPatchesDataset(tmp_path, **kw), tds.HPatchesDataset(tmp_path, **kw)
    assert len(td) == len(jd) > 0
    for k in range(len(jd)):
        a, b = jd[k], td[k]
        np.testing.assert_array_equal(b["H"], a["H"])
        for key in ("image1", "image2"):
            np.testing.assert_array_equal(b[key], a[key])
    assert native_io.decodes["rgb"] > 0
