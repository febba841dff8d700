"""Kernel 1 (packed-qkv fixed-max attention) of the PyTorch port against the
JAX package's ``fixed_max_attention_qkv`` (Pallas, interpret mode).

CPU tensors take the wrapper's plain PyTorch version; the CUDA kernel is
held against that plain version on the card by ``test_torch_gpu.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vit_colmap_tpu.ops.pallas.attention_kernel import fixed_max_attention_qkv
from vit_colmap_tpu_torch.kernels import attention



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


def test_cpu_tensor_takes_plain_version():
    attention.launches = 0
    attention.attention_qkv(torch.zeros(1, 64, 3 * 128), 2, 0.125)
    assert attention.launches == 0
