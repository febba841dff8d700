"""Kernel 2 (fused row top-2 + column argmax) and the matching ops of the
PyTorch port against the JAX package (``pallas_topk2_colmax`` and
``pallas_match_pairs`` in interpret mode, ``match_pairs_batched``).

CPU tensors take the wrapper's plain PyTorch version; the CUDA kernel is
held against that plain version on the card by ``test_torch_gpu.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vit_colmap_tpu.ops import matching as jmatching
from vit_colmap_tpu.ops.pallas.match_kernel import (
    pallas_match_pairs,
    pallas_topk2_colmax,
)
from vit_colmap_tpu_torch.kernels import match
from vit_colmap_tpu_torch.ops import matching



def _normalized(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _case(kind: str, P=2, N=256, M=384):
    """(d1, d2, valid1, valid2) as numpy for one test case."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "random":
        d1, d2 = _normalized(rng, (P, N, 128)), _normalized(rng, (P, M, 128))
    elif kind == "permutation":
        # d2 holds noisy, permuted copies of d1's rows: many mutual matches.
        d1 = _normalized(rng, (P, N, 128))
        perm = rng.permutation(M) % N
        d2 = d1[:, perm] + 0.05 * rng.standard_normal((P, M, 128)).astype(np.float32)
        d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    elif kind == "ties":
        # Integer descriptors: every dot product is exact, ties abound.
        d1 = rng.integers(-2, 3, (P, N, 128)).astype(np.float32)
        d2 = np.concatenate([d1[:, N // 2:], d1[:, : N // 2]], axis=1)[:, :M]
        d2 = np.concatenate([d2, d2[:, : M - d2.shape[1]]], axis=1)
    else:
        raise ValueError(kind)
    v1 = rng.random((P, N)) < 0.9
    v2 = rng.random((P, d2.shape[1])) < 0.9
    return d1, d2, v1, v2


CASES = ["random", "permutation", "ties"]


@pytest.mark.parametrize("kind", CASES)
def test_topk2_colmax_matches_jax_kernel(kind):
    d1, d2, v1, v2 = _case(kind)
    ref = pallas_topk2_colmax(*map(jnp.asarray, (d1, d2, v1, v2)), interpret=True)
    out = match.match_topk2_colmax(*map(torch.from_numpy, (d1, d2, v1, v2)))
    best, second, best_idx, col_row = (np.asarray(r) for r in ref)
    np.testing.assert_array_equal(out[2].numpy(), best_idx)
    np.testing.assert_array_equal(out[3].numpy(), col_row)
    np.testing.assert_allclose(out[0].numpy(), best, atol=1e-6)
    np.testing.assert_allclose(out[1].numpy(), second, atol=1e-6)


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("cross_check", [True, False])
def test_match_pairs_matches_jax(kind, cross_check):
    d1, d2, v1, v2 = _case(kind)
    ref = np.asarray(pallas_match_pairs(
        *map(jnp.asarray, (d1, d2, v1, v2)), cross_check=cross_check,
        interpret=True,
    ))
    out = match.match_pairs(*map(torch.from_numpy, (d1, d2, v1, v2)),
                            cross_check=cross_check)
    np.testing.assert_array_equal(out.numpy(), ref)
    if kind == "permutation":
        assert (ref >= 0).sum() > 100


@pytest.mark.parametrize("kind", ["random", "permutation"])
def test_match_pairs_batched_matches_jax(kind):
    d1, d2, v1, v2 = _case(kind)
    ref = np.asarray(jmatching.match_pairs_batched(*map(jnp.asarray, (d1, d2, v1, v2))))
    out = matching.match_pairs_batched(*map(torch.from_numpy, (d1, d2, v1, v2)))
    np.testing.assert_array_equal(out.numpy(), ref)
    fused = matching.get_pair_matcher()(*map(torch.from_numpy, (d1, d2, v1, v2)))
    np.testing.assert_array_equal(fused.numpy(), ref)


@pytest.mark.parametrize("kind", ["random", "permutation"])
def test_pair_matcher_other_width_matches_jax(kind):
    """256-wide descriptors: on CPU tensors the matcher's plain version."""
    d1, d2, v1, v2 = _case(kind, P=1, N=128, M=128)
    d1, d2 = (np.concatenate([d, d[..., ::-1]], axis=-1) / np.sqrt(2.0) for d in (d1, d2))
    d1, d2 = d1.astype(np.float32), d2.astype(np.float32)
    ref = np.asarray(jmatching.match_pairs_batched(*map(jnp.asarray, (d1, d2, v1, v2))))
    out = matching.get_pair_matcher()(*map(torch.from_numpy, (d1, d2, v1, v2)))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_matmul_matcher_is_not_ported():
    with pytest.raises(NotImplementedError):
        matching.get_pair_matcher(use_pallas=False)


def test_ragged_shapes_take_plain_rule():
    """Sizes that are not tile multiples give the same answers."""
    d1, d2, v1, v2 = _case("permutation", P=1, N=200, M=130)
    t = match.match_topk2_colmax(*map(torch.from_numpy, (d1, d2, v1, v2)))
    sim = np.where(v2[:, None], d1 @ d2.transpose(0, 2, 1), -2.0)
    np.testing.assert_array_equal(t[2].numpy(), sim.argmax(-1))


def test_similarity_plain_is_the_fma_chain():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 16)).astype(np.float32)
    b = rng.standard_normal((4, 16)).astype(np.float32)
    s = np.zeros((3, 4), np.float32)
    for d in range(16):  # fma(a, b, s): exact product + one rounding
        s = (a[:, d, None].astype(np.float64) * b[None, :, d]
             + s.astype(np.float64)).astype(np.float32)
    out = match.similarity_plain(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(out.numpy(), s)


def test_compaction_round_trip():
    rng = np.random.default_rng(6)
    m = np.where(rng.random((3, 256)) < 0.3, rng.integers(0, 256, (3, 256)), -1)
    m = m.astype(np.int32)
    counts, packed = matching.compact_matches_device(torch.from_numpy(m))
    jc, jp = jmatching.compact_matches_device(jnp.asarray(m))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    for p in range(3):
        np.testing.assert_array_equal(
            matching.unpack_matches(packed[p].numpy(), int(counts[p])),
            matching.compact_matches(m[p], 256),
        )


def test_cpu_tensor_takes_plain_version():
    match.launches = 0
    d1, d2, v1, v2 = _case("random", P=1, N=128, M=128)
    match.match_topk2_colmax(*map(torch.from_numpy, (d1, d2, v1, v2)))
    assert match.launches == 0
