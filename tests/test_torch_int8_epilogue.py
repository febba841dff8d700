"""The rules of kernel 5's epilogue scan (``csrc/match_topk2_int8.cu``),
transcribed into PyTorch, against the plain version ``topk2_int8_plain``.

This pins the rules, not the kernel: the transcription is kept by hand
beside the source and can drift from it, and the kernel itself is held
bit-equal to the plain version only on the card (``tests/test_torch_gpu.py``
and ``chip_smoke.py``).  The rules: each lane of a quad scans columns 8c +
2q + e of every 128-column tile in increasing order with
``topk2::push_skip_nan`` (a masked column or a column past M reads NaN), the
best column kept as an index inside the tile and made global at the tile's
end, then the quad's 4 states merged by ``topk2::merge`` as the shuffles
pair them (lanes 1 apart, then 2 apart).  torch.fmax / torch.fmin return
the other operand for a NaN, as fmaxf / fminf do.
"""

import numpy as np
import pytest
import torch

from vit_colmap_tpu_torch.kernels import match
from vit_colmap_tpu_torch.ops.matching import prepare_int8_descriptors

TILE = 128


def _kernel_similarity(a1, a2, s1, s2, inv1, inv2, coef, m_pad):
    """The epilogue's similarities, NaN for masked columns and past M."""
    sim = match.int8_similarity_plain(a1, a2, s1, s2, inv1, inv2, coef)
    sim = torch.where(inv2[None, :] > 0, sim, torch.nan)
    pad = torch.full((sim.shape[0], m_pad - sim.shape[1]), torch.nan)
    return torch.cat([sim, pad], dim=1)


def _merge(a, b):
    """topk2::merge of state b into state a (tensors over rows)."""
    rb, rs, ri = a
    ob, os_, oi = b
    ns = torch.fmax(torch.fmin(rb, ob), torch.fmax(rs, os_))
    ri = torch.where((ob > rb) | ((ob == rb) & (oi < ri)), oi, ri)
    return torch.fmax(rb, ob), ns, ri


def _replay(sim):
    """(best, second, best_idx) of one pair's (N, M padded) similarities by
    the kernel's per-lane scan and quad merge."""
    n, m_pad = sim.shape
    lanes = []
    for q in range(4):
        rb = torch.full((n,), -2.0)
        rs = torch.full((n,), -2.0)
        ri = torch.zeros(n, dtype=torch.int64)
        for j in range(m_pad // TILE):
            local = torch.full((n,), -1, dtype=torch.int64)
            for c in range(16):
                for e in range(2):
                    s = sim[:, j * TILE + 8 * c + 2 * q + e]
                    rs = torch.fmin(rb, torch.fmax(rs, s))  # push_skip_nan
                    local = torch.where(s > rb, 8 * c + e, local)
                    rb = torch.fmax(rb, s)
            ri = torch.where(local >= 0, j * TILE + 2 * q + local, ri)
        lanes.append((rb, rs, ri))
    pairs = [_merge(lanes[0], lanes[1]), _merge(lanes[2], lanes[3])]
    return _merge(pairs[0], pairs[1])


def _u8_case(kind, P=2, N=96, M=300, D=128):
    rng = np.random.default_rng(len(kind) + D)
    q1 = rng.integers(0, 256, (P, N, D), dtype=np.uint8)
    if kind == "ties":  # every row of q1 twice in q2: exact ties
        q2 = np.repeat(np.roll(q1, N // 4, axis=1), 4, axis=1)[:, :M]
    else:
        q2 = rng.integers(0, 256, (P, M, D), dtype=np.uint8)
    v1 = rng.random((P, N)) < 0.8
    v2 = rng.random((P, M)) < 0.8
    return (torch.from_numpy(q1), torch.from_numpy(np.ascontiguousarray(q2)),
            torch.from_numpy(v1), torch.from_numpy(v2))


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("encoding", ["signed", "unsigned"])
def test_epilogue_replay_matches_plain(kind, encoding):
    """Ragged M (300: a tile and a half past 128), 20% of rows and columns
    invalid; the tie input gives exact ties within and across lanes and
    tiles.  Indices identical; best and second equal (an invalid row's
    zeros may differ in sign, which == ignores, as the card's check does)."""
    q1, q2, v1, v2 = _u8_case(kind)
    a1, s1, i1, coef = prepare_int8_descriptors(q1, v1, encoding)
    a2, s2, i2, _ = prepare_int8_descriptors(q2, v2, encoding)
    ref = match.topk2_int8_plain(a1, a2, s1, s2, i1, i2, coef)
    m_pad = -(-a2.shape[1] // TILE) * TILE
    for p in range(a1.shape[0]):
        sim = _kernel_similarity(a1[p], a2[p], s1[p], s2[p], i1[p], i2[p], coef, m_pad)
        best, second, idx = _replay(sim)
        assert torch.equal(best, ref[0][p])
        assert torch.equal(second, ref[1][p])
        assert torch.equal(idx.int(), ref[2][p])


def test_epilogue_replay_sees_ties():
    """The tie input does test the first-column rule: the last maximal
    column differs from the replay's on some rows."""
    q1, q2, v1, v2 = _u8_case("ties")
    a1, s1, i1, coef = prepare_int8_descriptors(q1, v1, "signed")
    a2, s2, i2, _ = prepare_int8_descriptors(q2, v2, "signed")
    sim = match.int8_similarity_plain(a1[0], a2[0], s1[0], s2[0], i1[0], i2[0], coef)
    first = torch.argmax(sim, dim=1)
    last = sim.shape[1] - 1 - torch.argmax(torch.flip(sim, [1]), dim=1)
    m_pad = -(-a2.shape[1] // TILE) * TILE
    _, _, idx = _replay(_kernel_similarity(a1[0], a2[0], s1[0], s2[0], i1[0], i2[0],
                                           coef, m_pad))
    valid = v1[0]
    assert torch.equal(idx[valid], first[valid])
    assert bool((last != first)[valid].any())
