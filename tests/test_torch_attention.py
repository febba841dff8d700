"""Kernels 1 and 3 (fixed-max attention on packed qkv and on head-major
tensors) of the PyTorch port against the JAX package's
``fixed_max_attention_qkv`` and ``fixed_max_attention`` (Pallas, interpret
mode).

CPU tensors take the wrapper's plain PyTorch version; the CUDA kernel is
held against that plain version on the card by ``test_torch_gpu.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vit_colmap_tpu.ops.pallas.attention_kernel import (
    fixed_max_attention,
    fixed_max_attention_qkv,
)
from vit_colmap_tpu_torch.kernels import attention, launches



def _softmax_ref(qkv: np.ndarray, heads: int, scale: float) -> np.ndarray:
    B, N, three_d = qkv.shape
    D = three_d // 3
    q, k, v = (qkv.reshape(B, N, 3, heads, 64)[:, :, i].transpose(0, 2, 1, 3)
               for i in range(3))
    s = np.einsum("bhnd,bhmd->bhnm", q, k).astype(np.float64) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bhnm,bhmd->bhnd", p, v)
    return out.transpose(0, 2, 1, 3).reshape(B, N, D)


@pytest.mark.parametrize("n", [300, 1031])
@pytest.mark.parametrize("heads", [2, 4])
def test_plain_matches_jax_kernel(n, heads):
    rng = np.random.default_rng(n + heads)
    qkv = rng.standard_normal((2, n, 3 * 64 * heads)).astype(np.float32)
    scale = 64**-0.5
    ref = np.asarray(fixed_max_attention_qkv(
        jnp.asarray(qkv), heads, scale, block_q=256, block_kv=256, interpret=True
    ))
    out = attention.attention_qkv(torch.from_numpy(qkv), heads, scale)
    assert out.shape == (2, n, 64 * heads)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3)


def test_pad_rows_do_not_leak():
    """N not a multiple of any tile: rows past N must get zero weight."""
    rng = np.random.default_rng(1)
    n, heads = 300, 2
    qkv = rng.standard_normal((1, n, 3 * 64 * heads)).astype(np.float32)
    qkv[..., 2 * 64 * heads:] *= 100.0  # large v: any leak would show
    out = attention.attention_qkv(torch.from_numpy(qkv), heads, 0.125).numpy()
    ref = _softmax_ref(qkv, heads, 0.125)
    # p is rounded to bf16 (rel. 2^-9), so the error scales with |v| ~ 100.
    assert np.abs(out - ref).max() < 2.0


def test_huge_logits_stay_finite():
    rng = np.random.default_rng(2)
    qkv = (50.0 * rng.standard_normal((1, 256, 3 * 128))).astype(np.float32)
    out = attention.attention_qkv(torch.from_numpy(qkv), 2, 0.125)
    assert torch.isfinite(out).all()


def test_bf16_plain_matches_softmax():
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((1, 700, 3 * 128)).astype(np.float32)
    t = torch.from_numpy(qkv).to(torch.bfloat16)
    out = attention.attention_qkv(t, 2, 0.125)
    assert out.dtype == torch.bfloat16
    ref = _softmax_ref(t.float().numpy(), 2, 0.125)
    assert np.abs(out.float().numpy() - ref).max() < 2e-2


@pytest.mark.parametrize("width,heads", [(3 * 96, 2), (3 * 192, 3)])
def test_rejects_non64_head_dim_and_odd_heads(width, heads):
    qkv = torch.zeros(1, 256, width)
    with pytest.raises(ValueError):
        attention.attention_qkv(qkv, heads, 0.125)


@pytest.mark.parametrize("dim,heads,head_dim,takes_qkv,takes_heads", [
    (768, 12, 64, True, True), (1024, 16, 64, True, True), (1536, 24, 64, True, True),
    (192, 3, 64, False, True), (128, 4, 32, False, True), (1536, 16, 96, False, False),
    (384, 6, 64, True, True), (64, 1, 64, False, True),
])
def test_takes_predicates_are_each_kernels_head_layout(dim, heads, head_dim, takes_qkv,
                                                       takes_heads):
    """Kernel 1 takes head dim 64 and an even head count, kernel 3 head dims
    up to 64; each wrapper's check refuses what its predicate refuses."""
    assert attention.takes_attention_qkv(dim, heads) is takes_qkv
    assert attention.takes_fixed_max_attention(head_dim) is takes_heads
    qkv = torch.zeros(1, 8, 3 * dim)
    if takes_qkv:
        attention._check_layout(qkv, heads)
    else:
        with pytest.raises(ValueError, match="head_dim == 64 and an even head count"):
            attention._check_layout(qkv, heads)
    z = torch.zeros(1, heads, 8, head_dim)
    if takes_heads:
        attention._check_heads(z, z, z)
    else:
        with pytest.raises(ValueError, match="head_dim <= 64"):
            attention._check_heads(z, z, z)


def test_cpu_tensor_takes_plain_version():
    launches.clear()
    attention.attention_qkv(torch.zeros(1, 64, 3 * 128), 2, 0.125)
    z = torch.zeros(1, 2, 64, 64)
    attention.fixed_max_attention(z, z, z, 0.125)
    assert sum(launches.values()) == 0


# Kernel 3: head-major (B, H, N, d <= 64).

def _heads(rng, n, d, scale_v=1.0, scale_qk=1.0):
    q, k, v = (rng.standard_normal((1, 2, n, d)).astype(np.float32) for _ in range(3))
    return scale_qk * q, scale_qk * k, scale_v * v


def _softmax_heads(q, k, v, scale):
    s = np.einsum("bhnd,bhmd->bhnm", q, k).astype(np.float64) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhnm,bhmd->bhnd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 40])
@pytest.mark.parametrize("n", [300, 1031])
def test_head_major_plain_matches_jax_kernel(n, d, dtype):
    """The plain version against the reference kernel on the same inputs in
    the same dtype (both round q and p alike): atol 1e-3."""
    q, k, v = _heads(np.random.default_rng(n + d), n, d)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = fixed_max_attention(*(jnp.asarray(x, jd) for x in (q, k, v)), d**-0.5,
                              block_q=256, block_kv=256, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    out = attention.fixed_max_attention(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)), d**-0.5)
    assert out.shape == (1, 2, n, d) and out.dtype == td
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-3)


def test_head_major_pad_rows_do_not_leak():
    q, k, v = _heads(np.random.default_rng(4), 300, 64, scale_v=100.0)
    out = attention.fixed_max_attention(*map(torch.from_numpy, (q, k, v)), 0.125)
    # p is rounded to bf16 (rel. 2^-9), so the error scales with |v| ~ 100.
    assert np.abs(out.numpy() - _softmax_heads(q, k, v, 0.125)).max() < 2.0


def test_head_major_huge_logits_stay_finite():
    q, k, v = _heads(np.random.default_rng(5), 256, 64, scale_qk=50.0)
    out = attention.fixed_max_attention(*map(torch.from_numpy, (q, k, v)), 0.125)
    assert torch.isfinite(out).all()


def test_head_major_rejects_head_dim_over_64():
    z = torch.zeros(1, 2, 256, 96)
    with pytest.raises(ValueError, match="head_dim <= 64"):
        attention.fixed_max_attention(z, z, z, 0.125)


def test_head_major_takes_strided_views():
    """The permuted heads of a packed qkv, as the backbone passes them, give
    kernel 1's answer; the result merges back into (B, N, D) as a view."""
    rng = np.random.default_rng(6)
    qkv = torch.from_numpy(rng.standard_normal((2, 200, 3 * 128)).astype(np.float32))
    q, k, v = qkv.reshape(2, 200, 3, 2, 64).permute(2, 0, 3, 1, 4)
    out = attention.fixed_max_attention(q, k, v, 0.125)
    merged = out.transpose(1, 2).reshape(2, 200, 128)
    assert merged.data_ptr() == out.data_ptr()
    torch.testing.assert_close(merged, attention.attention_qkv(qkv, 2, 0.125),
                               rtol=0, atol=0)


# The bf16 body's tensor maps: what fixed_max_attention_launch encodes from
# the element strides it is given (tma_layout), and which views are copied
# first (tma_operand).

def _qkv_bf16(B=2, N=300, heads=12):
    return torch.zeros(B, N, 3 * 64 * heads, dtype=torch.bfloat16)


def test_tma_maps_of_packed_qkv():
    """Kernel 1 reads q, k and v in place from the packed (B, N, 3D) array:
    one 4-D map each, with its own base, a token stride of 3D * 2 bytes and
    tokens on their own axis."""
    B, N, H = 2, 300, 12
    qkv = _qkv_bf16(B, N, H)
    views = attention._split_heads(qkv, H)
    row = 3 * 64 * H * 2
    for i, t in enumerate(views):
        assert attention.tma_ready(t) and attention.tma_operand(t) is t
        assert t.data_ptr() - qkv.data_ptr() == i * 64 * H * 2
        assert attention.tma_layout(t) == {
            "dims": (64, N, H, B), "strides": (row, 128, N * row),
            "box": (64, 128, 1, 1)}


@pytest.mark.parametrize("d", [64, 40])
def test_tma_maps_of_permuted_head_views(d):
    """Kernel 3 on the backbone's permuted views of its qkv projection, for
    d = 64 and the ragged d = 40 (the box runs past d: zero fill)."""
    B, N, H = 2, 1031, 2
    qkv = torch.zeros(B, N, 3 * H * d, dtype=torch.bfloat16)
    q, k, v = qkv.reshape(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
    row = 3 * H * d * 2
    for t in (q, k, v):
        assert attention.tma_operand(t) is t
        assert attention.tma_layout(t) == {
            "dims": (d, N, H, B), "strides": (row, d * 2, N * row),
            "box": (64, 128, 1, 1)}


@pytest.mark.parametrize("d,view", [(36, "contiguous"), (40, "odd token stride"),
                                    (64, "unaligned base")])
def test_tma_operand_copies_what_tma_cannot_read(d, view):
    """d % 8 != 0, a token stride that is not a multiple of 16 bytes, or an
    unaligned base: copied into zero-padded (B, H, N, ceil(d / 8) * 8)
    storage with the same values."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((1, 2, 50, 72)).astype(np.float32))
    x = x.to(torch.bfloat16)
    if view == "contiguous":
        t = x[..., :d].contiguous()
    elif view == "odd token stride":  # 108 elements: 216 bytes
        t = torch.as_strided(x, (1, 2, 30, d), (7200, 3600, 108, 1))
    else:  # 3 elements past an aligned allocation
        t = x.flatten()[3:3 + 2 * 50 * 64].reshape(1, 2, 50, 64)
    assert not attention.tma_ready(t)
    padded = attention.tma_operand(t)
    d8 = -(-d // 8) * 8
    assert padded.shape == (*t.shape[:3], d8) and padded.is_contiguous()
    assert attention.tma_ready(padded)
    assert torch.equal(padded[..., :d], t)
    assert not padded[..., d:].any()
    B, H, N, _ = t.shape
    assert attention.tma_layout(padded) == {
        "dims": (d8, N, H, B), "strides": (d8 * 2, N * d8 * 2, H * N * d8 * 2),
        "box": (64, 128, 1, 1)}
