"""The port's exhaustive-matching benchmark (``scripts/torch_bench_matching.py``)
against the JAX script's protocol (``scripts/bench_matching.py``) on the CPU.

* The pairs and their padding: every pair (i < j) in the JAX script's order,
  the last chunk padded with (0, 0); 126 chunks of 16 at the defaults (64
  images), one launch of the matching kernel each on the card.
* The matches of the timed loop on 6 images x 256 keypoints equal the JAX
  ``get_pair_matcher()`` on the same numpy descriptors, index for index:
  on the benchmark's own random descriptors (nearly orthogonal, so the
  distance test keeps few matches), and on descriptors built to match
  (noisy, permuted copies of one image's), where most rows match.
* The printed JSON line has the JAX script's keys, and the script raises
  without CUDA unless ``--device cpu`` is given.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scripts.torch_bench_matching as tbm
from vit_colmap_tpu.ops import matching as jmatch


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


IMAGES, KEYPOINTS, DIM, PAIR_BATCH = 6, 256, 128, 4
JAX_KEYS = {"metric", "value", "unit", "num_pairs", "keypoints", "seconds", "device"}


def jax_matches(desc: np.ndarray, pair_batch: int) -> np.ndarray:
    """``scripts/bench_matching.py``'s loop on ``desc``: (chunks, P, K)."""
    match_pairs = jmatch.get_pair_matcher()
    n = desc.shape[0]
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    d, v = jnp.asarray(desc), jnp.ones(desc.shape[:2], bool)
    outs = []
    for s in range(0, len(pairs), pair_batch):
        chunk = pairs[s:s + pair_batch]
        chunk = chunk + [(0, 0)] * (pair_batch - len(chunk))
        ii = jnp.asarray([c[0] for c in chunk], jnp.int32)
        jj = jnp.asarray([c[1] for c in chunk], jnp.int32)
        outs.append(np.asarray(match_pairs(jnp.take(d, ii, 0), jnp.take(d, jj, 0),
                                           jnp.take(v, ii, 0), jnp.take(v, jj, 0))))
    return np.stack(outs)


def port_matches(desc: np.ndarray, pair_batch: int) -> np.ndarray:
    from vit_colmap_tpu_torch.ops.matching import get_pair_matcher

    t = torch.from_numpy(desc)
    outs = tbm.match_all(get_pair_matcher(), t, torch.ones(desc.shape[:2], dtype=torch.bool),
                         tbm.pair_chunks(desc.shape[0], pair_batch))
    return np.stack([o.numpy() for o in outs])


def test_pair_chunks_as_the_jax_script():
    chunks = tbm.pair_chunks(64, 16)
    assert chunks.shape == (126, 16, 2)
    flat = [tuple(p) for p in chunks.reshape(-1, 2)]
    assert flat == [(i, j) for i in range(64) for j in range(i + 1, 64)]  # no padding
    odd = tbm.pair_chunks(IMAGES, PAIR_BATCH).reshape(-1, 2)
    assert len(odd) == 16 and [tuple(p) for p in odd[15:]] == [(0, 0)]


def test_bench_matches_equal_jax_index_for_index():
    out = tbm.bench(IMAGES, KEYPOINTS, DIM, PAIR_BATCH, device="cpu")
    port = np.stack([o.numpy() for o in out["outs"]])
    rng = np.random.default_rng(0)
    raw = rng.standard_normal((IMAGES, KEYPOINTS, DIM)).astype(np.float32)
    want = jax_matches(np.asarray(jmatch.normalize_descriptors(jnp.asarray(raw))), PAIR_BATCH)
    assert port.shape == want.shape == (4, PAIR_BATCH, KEYPOINTS)
    np.testing.assert_array_equal(port, want)
    assert out["num_pairs"] == 15 and out["keypoints"] == KEYPOINTS


def test_loop_matches_equal_jax_where_rows_match():
    rng = np.random.default_rng(1)
    base = rng.standard_normal((KEYPOINTS, DIM)).astype(np.float32)
    desc = np.stack([base[rng.permutation(KEYPOINTS)]
                     + 0.3 * rng.standard_normal((KEYPOINTS, DIM)).astype(np.float32)
                     for _ in range(IMAGES)])
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    want = jax_matches(desc, PAIR_BATCH)
    np.testing.assert_array_equal(port_matches(desc, PAIR_BATCH), want)
    assert (want[:3] >= 0).mean() > 0.5  # the real pairs mostly match


def test_main_prints_the_jax_keys(capsys):
    tbm.main(["--images", "4", "--keypoints", "128", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == JAX_KEYS
    assert line["metric"] == "exhaustive_match_pairs_per_sec" and line["num_pairs"] == 6
    assert line["device"] == "cpu"


def test_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbm.main(["--images", "3", "--keypoints", "128"])
