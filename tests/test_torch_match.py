"""Kernels 2, 4 and 5 (fused row top-2 + column argmax, row top-2, int8 row
top-2) and the matching ops of the PyTorch port against the JAX package
(``pallas_topk2_colmax``, ``pallas_topk2``, ``pallas_topk2_int8``,
``pallas_match_pairs[_int8]`` in interpret mode, ``match_pairs_batched``,
``prepare_int8_descriptors``).

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
    pallas_match_pairs_int8,
    pallas_topk2,
    pallas_topk2_colmax,
    pallas_topk2_int8,
)
from vit_colmap_tpu_torch.kernels import launches, match
from vit_colmap_tpu_torch.ops import matching



def _normalized(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _case(kind: str, P=2, N=256, M=384, D=128):
    """(d1, d2, valid1, valid2) as numpy for one test case."""
    rng = np.random.default_rng(sum(map(ord, kind)) + (D != 128) * D)
    if kind == "random":
        d1, d2 = _normalized(rng, (P, N, D)), _normalized(rng, (P, M, D))
    elif kind == "permutation":
        # d2 holds noisy, permuted copies of d1's rows: many mutual matches.
        d1 = _normalized(rng, (P, N, D))
        perm = rng.permutation(M) % N
        d2 = d1[:, perm] + 0.05 * rng.standard_normal((P, M, D)).astype(np.float32)
        d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    elif kind == "ties":
        # Integer descriptors: every dot product is exact, ties abound.
        d1 = rng.integers(-2, 3, (P, N, D)).astype(np.float32)
        d2 = np.concatenate([d1[:, N // 2:], d1[:, : N // 2]], axis=1)[:, :M]
        d2 = np.concatenate([d2, d2[:, : M - d2.shape[1]]], axis=1)
    else:
        raise ValueError(kind)
    v1 = rng.random((P, N)) < 0.9
    v2 = rng.random((P, d2.shape[1])) < 0.9
    return d1, d2, v1, v2


CASES = ["random", "permutation", "ties"]
# Wider descriptors, which the kernels take as the reference's do.
WIDE = [("random", 256), ("ties", 256), ("random", 384), ("ties", 384)]


def _with_widths(kinds, wide=WIDE):
    """(kind, D) cases: D = 128 under the kind's name, then the wide ones."""
    return ([pytest.param(k, 128, id=k) for k in kinds]
            + [pytest.param(k, d, id=f"{k}-{d}") for k, d in wide])


@pytest.mark.parametrize("kind,dim", _with_widths(CASES))
def test_topk2_colmax_matches_jax_kernel(kind, dim):
    d1, d2, v1, v2 = _case(kind, D=dim)
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


@pytest.mark.parametrize("kind,dim", [pytest.param("random", 256, id="random"),
                                      pytest.param("permutation", 256, id="permutation"),
                                      pytest.param("permutation", 200, id="permutation-200")])
def test_pair_matcher_other_width_matches_jax(kind, dim, monkeypatch):
    """Descriptors wider than 128.  A multiple of 128 (256) goes to the
    matching kernel, which takes its plain version on CPU tensors, as the
    reference's matcher takes its Pallas kernel; another width (200) goes to
    ``match_pairs_batched`` in both."""
    d1, d2, v1, v2 = _case(kind, P=1, N=128, M=128)
    d1, d2 = (np.concatenate([d, d[..., ::-1]], axis=-1)[..., :dim] for d in (d1, d2))
    d1, d2 = (d / np.linalg.norm(d, axis=-1, keepdims=True) for d in (d1, d2))
    d1, d2 = d1.astype(np.float32), d2.astype(np.float32)
    taken = []
    for name in ("match_pairs", "match_pairs_batched"):
        module = match if name == "match_pairs" else matching
        fn = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, fn=fn, name=name, **k: taken.append(name) or fn(*a, **k))
    ref = np.asarray(jmatching.match_pairs_batched(*map(jnp.asarray, (d1, d2, v1, v2))))
    out = matching.get_pair_matcher()(*map(torch.from_numpy, (d1, d2, v1, v2)))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert taken == ["match_pairs" if dim % 128 == 0 else "match_pairs_batched"]
    jax_matcher = np.asarray(jmatching.get_pair_matcher(True)(
        *map(jnp.asarray, (d1, d2, v1, v2))))
    np.testing.assert_array_equal(out.numpy(), jax_matcher)
    if kind == "permutation":
        assert (ref >= 0).sum() > 20


@pytest.mark.parametrize("cross_check", [True, False])
@pytest.mark.parametrize("kind", CASES)
def test_matmul_matcher_matches_jax(kind, cross_check):
    """use_pallas=False: the matmul matcher, as the reference's, on the same
    descriptors gives the JAX ``match_pairs_batched`` matches."""
    d1, d2, v1, v2 = _case(kind)
    if kind == "ties":  # scaled by a power of two: dot products stay exact
        d1, d2 = (d / 16.0 for d in (d1, d2))
    ref = np.asarray(jmatching.match_pairs_batched(
        *map(jnp.asarray, (d1, d2, v1, v2)), cross_check=cross_check))
    matcher = matching.get_pair_matcher(use_pallas=False)
    assert matcher is matching.match_pairs_batched
    out = matcher(*map(torch.from_numpy, (d1, d2, v1, v2)), cross_check=cross_check)
    np.testing.assert_array_equal(out.numpy(), ref)


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


@pytest.mark.parametrize("dim,takes", [(128, True), (256, True), (384, True),
                                       (64, False), (200, False), (130, False)])
def test_takes_width_is_a_multiple_of_the_width_step(dim, takes):
    """The kernels' width rule; the pair matcher routes by it, and the
    kernels' check on the card refuses what it refuses."""
    assert match.takes_width(dim) is takes


def test_cpu_tensor_takes_plain_version():
    launches.clear()
    d1, d2, v1, v2 = _case("random", P=1, N=128, M=128)
    match.match_topk2_colmax(*map(torch.from_numpy, (d1, d2, v1, v2)))
    match.match_topk2(*map(torch.from_numpy, (d1, d2, v2)))
    ops = matching.prepare_int8_descriptors(
        torch.zeros(1, 128, 128, dtype=torch.uint8), torch.from_numpy(v1), "signed")
    match.match_topk2_int8(ops[0], ops[0], ops[1], ops[1], ops[2], ops[2], ops[3])
    assert sum(launches.values()) == 0


# Kernel 4: row top-2 only (cross_check=False, and the two-pass cross-check).

@pytest.mark.parametrize("kind,dim", _with_widths(CASES))
def test_topk2_matches_jax_kernel(kind, dim):
    """Identical indices and bit-equal values, ties and invalid columns
    included."""
    d1, d2, _, v2 = _case(kind, D=dim)
    ref = pallas_topk2(*map(jnp.asarray, (d1, d2, v2)), interpret=True)
    out = match.match_topk2(*map(torch.from_numpy, (d1, d2, v2)))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("cross_check", [True, False])
def test_two_pass_match_pairs_matches_jax(kind, cross_check):
    """``fused_cross=False``: kernel 4, twice with the cross-check."""
    d1, d2, v1, v2 = _case(kind)
    args = dict(cross_check=cross_check, fused_cross=False)
    ref = np.asarray(pallas_match_pairs(*map(jnp.asarray, (d1, d2, v1, v2)),
                                        interpret=True, **args))
    out = match.match_pairs(*map(torch.from_numpy, (d1, d2, v1, v2)), **args)
    np.testing.assert_array_equal(out.numpy(), ref)
    fused = match.match_pairs(*map(torch.from_numpy, (d1, d2, v1, v2)),
                              cross_check=cross_check)
    np.testing.assert_array_equal(out.numpy(), fused.numpy())


def test_last_column_wins_differs_on_ties():
    """The tie input really has ties: a plain top-2 that lets the last
    maximal column win gives other indices."""
    d1, d2, _, v2 = _case("ties")
    d1, d2, v2 = map(torch.from_numpy, (d1, d2, v2))
    first = match.match_topk2(d1, d2, v2)[2]
    flip = torch.flip(torch.where(v2[:, None, :], d1 @ d2.transpose(1, 2), -2.0), [-1])
    last = d2.shape[1] - 1 - torch.argmax(flip, dim=-1)
    assert (last.int() != first).sum() > 0


# Kernel 5: int8 row top-2, and prepare_int8_descriptors.

def _u8_case(kind: str, P=2, N=256, M=384, D=128):
    """(q1, q2, valid1, valid2): uint8 descriptors as numpy."""
    rng = np.random.default_rng(sum(map(ord, kind)) + 1 + (D != 128) * D)
    q1 = rng.integers(0, 256, (P, N, D), dtype=np.uint8)
    if kind == "random":
        q2 = rng.integers(0, 256, (P, M, D), dtype=np.uint8)
    elif kind == "correlated":  # noisy, permuted copies: many matches
        noise = rng.integers(-20, 20, (P, M, D))
        q2 = np.clip(q1[:, rng.permutation(M) % N].astype(int) + noise, 0, 255)
        q2 = q2.astype(np.uint8)
    elif kind == "ties":  # every row of q1 twice in q2: exact ties
        q2 = np.repeat(np.roll(q1, N // 4, axis=1), 2, axis=1)[:, :M]
    else:
        raise ValueError(kind)
    return q1, q2, rng.random((P, N)) < 0.9, rng.random((P, M)) < 0.9


def _int8_ops(q1, q2, v1, v2, encoding, prepare):
    a1, s1, i1, coef = prepare(q1, v1, encoding)
    a2, s2, i2, _ = prepare(q2, v2, encoding)
    return a1, a2, s1, s2, i1, i2, coef


def _jax_prepare(q, v, encoding):
    return jmatching.prepare_int8_descriptors(jnp.asarray(q), jnp.asarray(v), encoding)


def _torch_prepare(q, v, encoding):
    return matching.prepare_int8_descriptors(torch.from_numpy(q), torch.from_numpy(v),
                                             encoding)


@pytest.mark.parametrize("encoding", ["signed", "unsigned"])
def test_prepare_int8_descriptors_bit_equal(encoding):
    q1, _, v1, _ = _u8_case("random")
    ref = _jax_prepare(q1, v1, encoding)
    out = _torch_prepare(q1, v1, encoding)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert o.numpy().dtype == r.dtype
        np.testing.assert_array_equal(o.numpy(), r)


@pytest.mark.parametrize("kind,dim", _with_widths(["random", "ties"]))
@pytest.mark.parametrize("encoding", ["signed", "unsigned"])
def test_topk2_int8_matches_jax_kernel(encoding, kind, dim):
    """Identical indices and bit-equal values: the plain version rounds each
    float operation of the epilogue on its own, in the reference's order,
    and so does the reference on the CPU.  At D = 384 the inputs' squared
    norms stay below 2^24, the condition for bit-equal operands
    (``prepare_int8_descriptors``)."""
    q1, q2, v1, v2 = _u8_case(kind, D=dim)
    u = np.concatenate([q1, q2], axis=1).astype(np.int64)
    u = 2 * u - 255 if encoding == "signed" else u
    assert (u * u).sum(-1).max() < 2**24
    ref = pallas_topk2_int8(*_int8_ops(q1, q2, v1, v2, encoding, _jax_prepare),
                            interpret=True)
    ops = _int8_ops(q1, q2, v1, v2, encoding, _torch_prepare)
    out = match.match_topk2_int8(*ops)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    if kind == "ties":  # a "last column wins" rule must give other indices
        sim = match.int8_similarity_plain(*(x[0] for x in ops[:-1]), ops[-1])
        last = sim.shape[1] - 1 - torch.argmax(torch.flip(sim, [-1]), dim=-1)
        assert (last.int() != out[2][0]).sum() > 0


@pytest.mark.parametrize("cross_check", [True, False])
@pytest.mark.parametrize("encoding", ["signed", "unsigned"])
def test_match_pairs_int8_matches_jax(encoding, cross_check):
    q1, q2, v1, v2 = _u8_case("correlated")
    ref = np.asarray(pallas_match_pairs_int8(
        *_int8_ops(q1, q2, v1, v2, encoding, _jax_prepare), jnp.asarray(v1),
        cross_check=cross_check, interpret=True))
    out = match.match_pairs_int8(
        *_int8_ops(q1, q2, v1, v2, encoding, _torch_prepare), torch.from_numpy(v1),
        cross_check=cross_check)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref >= 0).sum() > 100
