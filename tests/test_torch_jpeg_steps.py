"""libjpeg's decode steps on the host (``csrc/host/jpeg_color.cc``), which
finish the nvJPEG route's planes on the card's machine, against libjpeg's
own decode on this machine.

* On the planes libjpeg decodes raw (``jpeg_read_raw_data``), the host
  fancy upsampling equals libjpeg's full-resolution YCbCr, and the host
  YCbCr -> RGB equals libjpeg's RGB, bit for bit: on the committed
  fixtures of ``tests/data/jpeg/`` and on JPEGs written here at edge sizes
  (chroma 1 or 2 samples wide, where libjpeg replicates instead) for
  every sampling (4:2:0, 4:2:2, 4:4:0, 4:4:4, gray).
* The committed bytes are still what the libjpeg route gives for the
  committed JPEGs (YCbCr, the extractor's I420 and RGB), so the card's
  tests hold nvJPEG to the reference (``scripts/torch_jpeg_fixtures.py``
  wrote them).
"""

from pathlib import Path

import numpy as np
import pytest

from vit_colmap_tpu_torch.kernels import host_build
from vit_colmap_tpu_torch.utils import native_io

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
NAMES = sorted(p.stem for p in FIXTURES.glob("*.jpg"))


@pytest.fixture(scope="module")
def libjpeg():
    if native_io.load_native() is None:
        pytest.skip("the port's host image library is unavailable")
    try:
        codec = host_build.jpeg_codec()
    except host_build.Unavailable as e:
        pytest.skip(str(e))
    if codec != "libjpeg":
        pytest.skip("libjpeg.so.62 is not installed (the reference codec)")
    return native_io


def _steps_equal_libjpeg(n, path):
    y, cb, cr = n.decode_jpeg_planes(path)
    assert y.shape == n.decode_jpeg_rgb(path).shape[:2]
    up = n.upsample_ycc(y, cb, cr)
    np.testing.assert_array_equal(up, n.decode_jpeg_ycc(path))
    np.testing.assert_array_equal(n.ycc_to_rgb(up), n.decode_jpeg_rgb(path))
    return y, cb, up


def test_fixtures_are_committed():
    assert len(NAMES) == 6 and all((FIXTURES / f"{s}.npz").exists() for s in NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_host_steps_equal_libjpeg_on_fixtures(libjpeg, name):
    path = FIXTURES / f"{name}.jpg"
    y, cb, up = _steps_equal_libjpeg(libjpeg, path)
    ref = np.load(FIXTURES / f"{name}.npz")
    np.testing.assert_array_equal(up, ref["ycc"])
    np.testing.assert_array_equal(libjpeg.decode_jpeg_rgb(path), ref["rgb"])
    tw, th = (int(v) for v in ref["size"])
    i420, ok = libjpeg.decode_batch_i420([path], tw, th)
    assert ok.all()
    np.testing.assert_array_equal(i420[0], ref["i420"])
    if name.startswith("gray"):
        assert cb.size == 0
    else:  # the sampling the name states
        sub = {"420": (2, 2), "422": (1, 2), "440": (2, 1), "444": (1, 1)}[name[1:4]]
        assert cb.shape == tuple(-(-s // f) for s, f in zip(y.shape, sub))


@pytest.mark.parametrize("chroma", [420, 422, 440, 444, 0])
def test_host_steps_equal_libjpeg_at_edge_sizes(libjpeg, tmp_path, chroma):
    rng = np.random.default_rng(chroma)
    for h, w in ((2, 2), (3, 5), (4, 2), (9, 4), (17, 3)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        path = tmp_path / f"e_{h}x{w}.jpg"
        if chroma:
            libjpeg.encode_jpeg(path, img, 92, chroma)
        else:
            libjpeg.encode_jpeg(path, img[..., 0], 92)
        _steps_equal_libjpeg(libjpeg, path)


def test_upsampler_rejects_a_sampling_it_does_not_take(libjpeg):
    y = np.zeros((10, 10), np.uint8)
    with pytest.raises(ValueError, match="no upsampling"):
        libjpeg.upsample_ycc(y, np.zeros((2, 7), np.uint8), np.zeros((2, 7), np.uint8))
    with pytest.raises(ValueError, match="chroma"):
        libjpeg.encode_jpeg(Path("x.jpg"), np.zeros((4, 4, 3), np.uint8), 90, 411)
