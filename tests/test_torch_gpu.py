"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports neither JAX nor the JAX package, so it also runs on a GPU
machine that has none of them:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu

(``--noconftest`` because ``tests/conftest.py`` sets JAX up.)
"""

import pytest
import torch

from vit_colmap_tpu_torch.kernels import attention, match


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; run with `pytest -m gpu` on the GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,heads", [(1, 1031, 2), (2, 9691, 12)])
def test_attention_kernel_matches_plain(cuda_device, b, n, heads):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    qkv = torch.randn(b, n, 3 * 64 * heads, generator=g, device=cuda_device)
    qkv = qkv.to(torch.bfloat16)
    before = attention.launches
    out = attention.attention_qkv(qkv, heads, 64**-0.5)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    ref = attention.attention_qkv_plain(qkv, heads, 64**-0.5).float()
    # Same bf16 roundings, different f32 sum order: at most about one bf16
    # ulp apart; bound at 4 x 2^-8 of the largest output.
    bound = 4 * 2.0**-8 * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= bound


@pytest.mark.gpu
def test_attention_kernel_rejects_f32(cuda_device):
    with pytest.raises(ValueError):
        attention.attention_qkv(torch.zeros(1, 64, 384, device=cuda_device), 2, 0.125)


def _match_case(kind, device, P=3, N=1000, M=1024):
    g = torch.Generator(device=device).manual_seed(len(kind))
    if kind == "ties":  # integer descriptors: exact dot products, many ties
        d1 = torch.randint(-2, 3, (P, N, 128), generator=g, device=device).float()
        d2 = torch.roll(d1, N // 2, dims=1)[:, : M - 24]
        d2 = torch.cat([d2, d2[:, :24]], dim=1).contiguous()
    else:
        d1 = torch.nn.functional.normalize(
            torch.randn(P, N, 128, generator=g, device=device), dim=-1)
        d2 = torch.nn.functional.normalize(
            torch.randn(P, M, 128, generator=g, device=device), dim=-1)
    v1 = torch.rand(P, N, generator=g, device=device) < 0.9
    v2 = torch.rand(P, M, generator=g, device=device) < 0.9
    return d1, d2, v1, v2


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_match_kernel_matches_plain(cuda_device, kind):
    inputs = _match_case(kind, cuda_device)
    before = match.launches
    out = match.match_topk2_colmax(*inputs)
    torch.cuda.synchronize()
    assert match.launches == before + 1
    ref = match.topk2_colmax_plain(*inputs)
    assert torch.equal(out[2], ref[2]) and torch.equal(out[3], ref[3])
    assert (out[0] - ref[0]).abs().max().item() <= 1e-6
    assert (out[1] - ref[1]).abs().max().item() <= 1e-6
    matches = match.match_pairs(*inputs)
    plain = match.filter_matches(*ref, inputs[2])
    assert torch.equal(matches, plain)


@pytest.mark.gpu
def test_match_kernel_rejects_other_widths(cuda_device):
    d = torch.zeros(1, 128, 256, device=cuda_device)
    v = torch.ones(1, 128, dtype=torch.bool, device=cuda_device)
    with pytest.raises(NotImplementedError):
        match.match_topk2_colmax(d, d, v, v)
