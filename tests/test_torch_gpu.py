"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports neither JAX nor the JAX package, so it also runs on a GPU
machine that has none of them:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu

(``--noconftest`` because ``tests/conftest.py`` sets JAX up.)
"""

import pytest
import torch

from vit_colmap_tpu_torch.kernels import attention, launches, match
from vit_colmap_tpu_torch.ops import detect, scoring
from vit_colmap_tpu_torch.ops.matching import prepare_int8_descriptors


@pytest.fixture
def cuda_device():
    """The card, with PyTorch's precision flags left at their defaults."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; run with `pytest -m gpu` on the GPU machine")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,heads", [(1, 1031, 2), (2, 9691, 12)])
def test_attention_kernel_matches_plain(cuda_device, b, n, heads, dtype):
    """bf16 runs the Hopper body, f32 the SIMT body."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    qkv = torch.randn(b, n, 3 * 64 * heads, generator=g, device=cuda_device)
    qkv = qkv.to(dtype)
    before = launches["attention_qkv"]
    out = attention.attention_qkv(qkv, heads, 64**-0.5)
    torch.cuda.synchronize()
    assert launches["attention_qkv"] == before + 1
    assert out.dtype == dtype
    ref = attention.attention_qkv_plain(qkv, heads, 64**-0.5).float()
    # Same roundings (q' to the input dtype, p to bf16), different f32 sum
    # order: at most about one bf16 ulp apart; bound at 4 x 2^-8 of the
    # largest output.
    bound = 4 * 2.0**-8 * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= bound


@pytest.mark.gpu
def test_attention_kernel_rejects_f16(cuda_device):
    """No fallback: a CUDA dtype the kernel does not take raises."""
    with pytest.raises(ValueError):
        attention.attention_qkv(
            torch.zeros(1, 64, 384, dtype=torch.float16, device=cuda_device), 2, 0.125)


def _match_case(kind, device, P=3, N=1000, M=1024, D=128):
    g = torch.Generator(device=device).manual_seed(len(kind) + (D != 128) * D)
    if kind == "ties":  # integer descriptors: exact dot products, many ties
        d1 = torch.randint(-2, 3, (P, N, D), generator=g, device=device).float()
        d2 = torch.roll(d1, N // 2, dims=1)[:, : M - 24]
        d2 = torch.cat([d2, d2[:, :24]], dim=1).contiguous()
    else:
        d1 = torch.nn.functional.normalize(
            torch.randn(P, N, D, generator=g, device=device), dim=-1)
        d2 = torch.nn.functional.normalize(
            torch.randn(P, M, D, generator=g, device=device), dim=-1)
    v1 = torch.rand(P, N, generator=g, device=device) < 0.9
    v2 = torch.rand(P, M, generator=g, device=device) < 0.9
    return d1, d2, v1, v2


# (kind, D, M): the main path's width under the kind's name, then wider
# ones, then M = 1000, not a multiple of the kernels' 128-column tiles (N =
# 1000 is ragged in every case).
WIDTHS = ([pytest.param(k, 128, 1024, id=k) for k in ("random", "ties")]
          + [pytest.param(k, d, 1024, id=f"{k}-{d}") for d in (256, 384)
             for k in ("random", "ties")]
          + [pytest.param(k, d, 1000, id=f"{k}-{d}-m1000")
             for k, d in (("random", 128), ("ties", 384))])


@pytest.mark.gpu
@pytest.mark.parametrize("kind,dim,m", WIDTHS)
def test_match_kernel_matches_plain(cuda_device, kind, dim, m):
    inputs = _match_case(kind, cuda_device, M=m, D=dim)
    before = launches["match_topk2_colmax"]
    out = match.match_topk2_colmax(*inputs)
    torch.cuda.synchronize()
    assert launches["match_topk2_colmax"] == before + 1
    ref = match.topk2_colmax_plain(*inputs)
    for o, r in zip(out, ref):  # identical indices, bit-equal values
        assert torch.equal(o, r)
    matches = match.match_pairs(*inputs)
    plain = match.filter_matches(*ref, inputs[2])
    assert torch.equal(matches, plain)


@pytest.mark.gpu
def test_match_kernel_rejects_other_widths(cuda_device):
    """No fallback: a width that is not a multiple of 128 raises."""
    d = torch.zeros(1, 128, 200, device=cuda_device)
    v = torch.ones(1, 128, dtype=torch.bool, device=cuda_device)
    with pytest.raises(NotImplementedError):
        match.match_topk2_colmax(d, d, v, v)


@pytest.mark.gpu
@pytest.mark.parametrize("dim,use_pallas", [(200, None), (128, False)])
def test_pair_matcher_takes_matmul_matcher(cuda_device, dim, use_pallas):
    """A width that is not a multiple of 128, or use_pallas=False, goes to
    the matmul matcher on the card, as in the reference; no kernel runs."""
    from vit_colmap_tpu_torch.ops.matching import get_pair_matcher, match_pairs_batched

    d1, d2, v1, v2 = _match_case("random", cuda_device, P=2, N=256, M=384)
    if dim != 128:
        d1, d2 = (torch.nn.functional.normalize(
            torch.cat([d, d.flip(-1)], dim=-1)[..., :dim], dim=-1) for d in (d1, d2))
    before = sum(launches.values())
    out = get_pair_matcher(use_pallas)(d1, d2, v1, v2)
    torch.cuda.synchronize()
    assert sum(launches.values()) == before
    assert torch.equal(out, match_pairs_batched(d1, d2, v1, v2))


@pytest.mark.gpu
def test_pair_matcher_takes_kernel_at_256(cuda_device):
    """256-wide descriptors go to kernel 2 on the card, as the reference's
    matcher takes its Pallas kernel for every multiple of 128; the matches
    equal the matmul matcher's on descriptors with many true matches."""
    from vit_colmap_tpu_torch.ops.matching import get_pair_matcher, match_pairs_batched

    g = torch.Generator(device=cuda_device).manual_seed(256)
    d1 = torch.nn.functional.normalize(
        torch.randn(2, 256, 256, generator=g, device=cuda_device), dim=-1)
    perm = torch.randperm(384, generator=g, device=cuda_device) % 256
    noise = 0.05 * torch.randn(2, 384, 256, generator=g, device=cuda_device)
    d2 = torch.nn.functional.normalize(d1[:, perm] + noise, dim=-1)
    v1 = torch.rand(2, 256, generator=g, device=cuda_device) < 0.9
    v2 = torch.rand(2, 384, generator=g, device=cuda_device) < 0.9
    before = launches["match_topk2_colmax"]
    out = get_pair_matcher()(d1, d2, v1, v2)
    torch.cuda.synchronize()
    assert launches["match_topk2_colmax"] == before + 1
    assert (out >= 0).sum() > 100
    assert torch.equal(out, match_pairs_batched(d1, d2, v1, v2))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,heads,n,d", [(2, 12, 9691, 64), (1, 2, 1031, 40),
                                         (1, 2, 300, 36)])
def test_head_major_attention_kernel_matches_plain(cuda_device, b, heads, n, d, dtype):
    """d = 36 takes the bf16 body through a zero-padded copy of q, k, v."""
    g = torch.Generator(device=cuda_device).manual_seed(n + d)
    q, k, v = (torch.randn(b, heads, n, d, generator=g, device=cuda_device)
               .to(dtype) for _ in range(3))
    before = launches["fixed_max_attention"]
    out = attention.fixed_max_attention(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert launches["fixed_max_attention"] == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref = attention.fixed_max_attention_plain(q, k, v, d**-0.5).float()
    # Kernel 1's bound: the same roundings in another f32 sum order.
    bound = 4 * 2.0**-8 * ref.abs().max().item()
    assert (out.float() - ref).abs().max().item() <= bound


@pytest.mark.gpu
def test_head_major_attention_kernel_takes_qkv_views(cuda_device):
    """The backbone's permuted views of its qkv projection: kernel 3 gives
    kernel 1's result (one CUDA body, other strides)."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    qkv = torch.randn(2, 1100, 3 * 128, generator=g, device=cuda_device)
    qkv = qkv.to(torch.bfloat16)
    q, k, v = qkv.reshape(2, 1100, 3, 2, 64).permute(2, 0, 3, 1, 4)
    out = attention.fixed_max_attention(q, k, v, 0.125)
    merged = out.transpose(1, 2).reshape(2, 1100, 128)
    assert torch.equal(merged, attention.attention_qkv(qkv, 2, 0.125))
    with pytest.raises(ValueError):
        z = torch.zeros(1, 2, 64, 96, dtype=torch.bfloat16, device=cuda_device)
        attention.fixed_max_attention(z, z, z, 0.125)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,dim,m", WIDTHS)
def test_topk2_kernel_matches_plain(cuda_device, kind, dim, m):
    d1, d2, v1, v2 = _match_case(kind, cuda_device, M=m, D=dim)
    before = launches["match_topk2"]
    out = match.match_topk2(d1, d2, v2)
    torch.cuda.synchronize()
    assert launches["match_topk2"] == before + 1
    ref = match.topk2_plain(d1, d2, v2)
    for o, r in zip(out, ref):  # identical indices, bit-equal values
        assert torch.equal(o, r)
    two_pass = match.match_pairs(d1, d2, v1, v2, fused_cross=False)
    assert torch.equal(two_pass, match.match_pairs(d1, d2, v1, v2))


def _u8_case(kind, device, P=3, N=1000, M=1024, D=128):
    g = torch.Generator(device=device).manual_seed(len(kind) + 1 + (D != 128) * D)
    q1 = torch.randint(0, 256, (P, N, D), generator=g, device=device).to(torch.uint8)
    if kind == "ties":  # every row of q1 twice in q2: exact ties
        q2 = torch.repeat_interleave(torch.roll(q1, N // 4, dims=1), 2, dim=1)[:, :M]
    else:
        q2 = torch.randint(0, 256, (P, M, D), generator=g, device=device)
        q2 = q2.to(torch.uint8)
    v1 = torch.rand(P, N, generator=g, device=device) < 0.9
    v2 = torch.rand(P, M, generator=g, device=device) < 0.9
    return q1, q2.contiguous(), v1, v2


# Kernel 5 also at D = 512 (four K slices of the ring a tile), 1,792 (the
# widest its SIMT body launched) and 2,048 (its shared memory does not grow
# with D).
INT8_WIDTHS = WIDTHS + [pytest.param("random", 512, 1000, id="random-512-m1000"),
                        pytest.param("ties", 1792, 1024, id="ties-1792"),
                        pytest.param("random", 2048, 1000, id="random-2048-m1000")]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,dim,m", INT8_WIDTHS)
@pytest.mark.parametrize("encoding", ["signed", "unsigned"])
def test_int8_kernel_matches_plain(cuda_device, encoding, kind, dim, m):
    """Uniform random bytes keep the squared norms below 2^24 up to D = 512
    (about 255^2 * D / 3), so the operands are exact there; the kernel and
    its plain version take the same operands at every width."""
    q1, q2, v1, v2 = _u8_case(kind, cuda_device, M=m, D=dim)
    a1, s1, i1, coef = prepare_int8_descriptors(q1, v1, encoding)
    a2, s2, i2, _ = prepare_int8_descriptors(q2, v2, encoding)
    ops = (a1, a2, s1, s2, i1, i2, coef)
    before = launches["match_topk2_int8"]
    out = match.match_topk2_int8(*ops)
    torch.cuda.synchronize()
    assert launches["match_topk2_int8"] == before + 1
    ref = match.topk2_int8_plain(*ops)
    for o, r in zip(out, ref):  # identical indices, bit-equal values
        assert torch.equal(o, r)
    matches = match.match_pairs_int8(*ops, v1)
    plain = match.filter_matches(*ref, match.topk2_int8_plain(
        a2, a1, s2, s1, i2, i1, coef)[2], v1)
    assert torch.equal(matches, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["flash", "auto"])
def test_flash_and_auto_take_fused_attention(cuda_device, impl, monkeypatch):
    """On the card "flash" and "auto" (N >= 1024) run PyTorch's fused
    attention; it agrees with eager softmax within 2e-2 of the largest
    output, the bound of the JAX package's kernel test."""
    from vit_colmap_tpu_torch.models import dinov2

    calls = []
    sdpa = dinov2.F.scaled_dot_product_attention
    monkeypatch.setattr(dinov2.F, "scaled_dot_product_attention",
                        lambda *a, **k: calls.append(1) or sdpa(*a, **k))

    cfg = dinov2.ViTConfig(embed_dim=128, depth=1, num_heads=2, attn_impl=impl)
    attn = dinov2.Attention(cfg).to(cuda_device)
    eager = dinov2.Attention(dinov2.ViTConfig(embed_dim=128, depth=1, num_heads=2,
                                              attn_impl="xla")).to(cuda_device)
    eager.load_state_dict(attn.state_dict())
    g = torch.Generator(device=cuda_device).manual_seed(12)
    x = torch.randn(2, 1024, 128, generator=g, device=cuda_device)
    with torch.no_grad():
        out, ref = attn(x).float(), eager(x).float()
    assert calls == [1]
    assert (out - ref).abs().max().item() <= 2e-2 * ref.abs().max().item()


def _keypoint_sets(fmap):
    scores = scoring.compute_saliency(fmap, "combined")
    xy, _, valid = detect.detect_keypoints(scores, k_total=4096, nms_mode="soft")
    return [set(map(tuple, xy[b][valid[b]].int().tolist())) for b in range(xy.shape[0])]


@pytest.mark.gpu
def test_saliency_keypoints_match_cpu_at_default_flags(cuda_device):
    """Saliency and detection on the card, with cuDNN's TF32 flag at its
    default, pick the CPU's keypoints: the blurs run in f32 on their own."""
    assert torch.backends.cudnn.allow_tf32  # PyTorch's default
    g = torch.Generator().manual_seed(13)
    fmap = torch.randn(2, 85, 114, 64, generator=g)
    cpu = _keypoint_sets(fmap)
    gpu = _keypoint_sets(fmap.to(cuda_device))
    assert torch.backends.cudnn.allow_tf32
    assert [len(k) for k in gpu] == [len(k) for k in cpu]
    assert gpu == cpu
