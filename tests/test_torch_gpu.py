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


def _calibrated_batch(device, pairs=6, points=256, seed=21):
    """Calibrated pairs (K: focal 600, 640 x 480) at inlier ratios 0.9, 0.5
    and 0.3 in turn, with uniform outliers, as (inputs on ``device``)."""
    import math

    g = torch.Generator().manual_seed(seed)
    p1s, p2s = [], []
    for b in range(pairs):
        n_in = int(points * (0.9, 0.5, 0.3)[b % 3])
        axis = torch.randn(3, generator=g)
        angle = 0.2 * torch.rand(1, generator=g).item()
        k = axis / axis.norm()
        S = torch.tensor([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = torch.eye(3) + math.sin(angle) * S + (1 - math.cos(angle)) * S @ S
        t = torch.tensor([1.0, 0.0, 0.0]) + 0.2 * torch.randn(3, generator=g)
        X = torch.stack([torch.rand(n_in, generator=g) * 2 - 1,
                         torch.rand(n_in, generator=g) * 1.5 - 0.75,
                         torch.rand(n_in, generator=g) * 4 + 4], dim=1)
        x1 = X[:, :2] / X[:, 2:]
        Xc = X @ R.T + t
        x2 = Xc[:, :2] / Xc[:, 2:]
        noise = 0.6 / 600 * torch.randn(2, n_in, 2, generator=g)
        out = torch.rand(2, points - n_in, 2, generator=g) * torch.tensor([640.0, 480.0])
        p1s.append(torch.cat([(x1 + noise[0]) * 600 + torch.tensor([320.0, 240.0]), out[0]]))
        p2s.append(torch.cat([(x2 + noise[1]) * 600 + torch.tensor([320.0, 240.0]), out[1]]))
    K = torch.tensor([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]]).expand(pairs, 3, 3)
    args = (torch.stack(p1s), torch.stack(p2s), torch.ones(pairs, points, dtype=torch.bool),
            K.contiguous(), K.contiguous(), torch.ones(pairs, dtype=torch.bool))
    return [a.to(device) for a in args]


@pytest.mark.gpu
def test_verification_on_cuda_equals_cpu(cuda_device):
    """Two-view verification on the card and on the CPU with the same
    uniforms: equal configs, inlier counts within chip_smoke.py's bound
    (8 points at the threshold or a near-tie between hypotheses)."""
    from vit_colmap_tpu_torch.ops import ransac

    kw = dict(iters=1024, five_point=True, five_point_chunk=16)
    cpu_args = _calibrated_batch("cpu")
    u = ransac.draw_uniforms(len(cpu_args[0]), torch.Generator().manual_seed(5), **kw)
    cpu = ransac.estimate_two_view_batched(*cpu_args, u, **kw)
    card = ransac.estimate_two_view_batched(
        *(a.to(cuda_device) for a in cpu_args),
        ransac.RansacUniforms(*(x.to(cuda_device) for x in u)), **kw)
    assert torch.equal(card.config.cpu(), cpu.config)
    assert (card.num_inliers.cpu() - cpu.num_inliers).abs().max().item() <= 8
    assert (cpu.config == 2).all()  # CALIBRATED: E wins on every lane


@pytest.mark.gpu
def test_verification_ignores_global_tf32(cuda_device):
    """A calibrated batch with ``allow_tf32`` set globally: the fits run in
    full f32 (the same results as with the flag off) and the caller's
    setting is back afterwards."""
    from vit_colmap_tpu_torch.ops import ransac

    kw = dict(iters=256, five_point=True, five_point_chunk=16)
    args = _calibrated_batch(cuda_device, pairs=3)
    u = ransac.draw_uniforms(3, torch.Generator().manual_seed(6), device=cuda_device, **kw)
    previous = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = ransac.estimate_two_view_batched(*args, u, **kw)
        torch.backends.cuda.matmul.allow_tf32 = True
        on = ransac.estimate_two_view_batched(*args, u, **kw)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
    for field in ("config", "num_inliers", "inlier_mask"):
        assert torch.equal(getattr(on, field), getattr(off, field)), field
    for field in ("F", "E", "H", "qvec", "tvec"):
        assert (getattr(on, field) - getattr(off, field)).abs().max().item() <= 1e-6, field


def _ba_problem(device, n_pts=200, n_img=6, seed=0):
    """Points in a box seen by cameras on an arc (0.5 px noise, the poses'
    translations and the points perturbed), the first two images fixed and
    the focal frozen (with it free, focal and depth trade off so weakly that
    the card's atomic sums in another order move the points by up to 4e-4
    between two runs)."""
    import numpy as np

    from vit_colmap_tpu_torch.sfm import bundle

    rng = np.random.default_rng(seed)
    X = rng.uniform([-1, -1, 3], [1, 1, 5], (n_pts, 3))
    cam = np.zeros((n_img, 6), np.float32)
    obs_xy = []
    for i in range(n_img):
        a = (i - n_img / 2) * 0.1
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        t = -R @ np.array([2.0 * np.sin(a), 0.1 * i, 4.0 - 4.0 * np.cos(a)])
        Xc = X @ R.T + t
        obs_xy.append(Xc[:, :2] / Xc[:, 2:] * 500 + [320, 240]
                      + 0.5 * rng.standard_normal((n_pts, 2)))
        cam[i, :3] = bundle.matrix_to_axis_angle(torch.tensor(R, dtype=torch.float32))
        cam[i, 3:] = t + (0.03 if i >= 2 else 0.0)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    n_obs = n_img * n_pts
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa: E731
    return bundle.BAProblem(
        cam_params=f32(cam), focal_log=f32([0.0]),
        points=f32(X + 0.03 * rng.standard_normal(X.shape)),
        obs_cam=torch.arange(n_img, device=device).repeat_interleave(n_pts),
        obs_point=torch.arange(n_pts, device=device).repeat(n_img),
        obs_xy=f32(np.concatenate(obs_xy)), obs_valid=torch.ones(n_obs, dtype=torch.bool,
                                                                 device=device),
        K=f32(np.tile(K, (n_img, 1, 1))), cam_of_img=torch.zeros(n_img, dtype=torch.long,
                                                                 device=device),
        fixed_cam_mask=torch.tensor([True, True] + [False] * (n_img - 2), device=device),
        refine_focal_mask=torch.zeros(1, dtype=torch.bool, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["schur", "cg"])
def test_bundle_adjust_on_cuda_equals_cpu(cuda_device, solver):
    """LM on the card and on the CPU from the same problem: the mean squared
    residual within 1e-4 relative and the parameters within 1e-3 (the
    card's segment reductions add in another order than the CPU's)."""
    from vit_colmap_tpu_torch.sfm import bundle

    cpu = bundle.bundle_adjust(_ba_problem("cpu"), iters=20, solver=solver)
    card = bundle.bundle_adjust(_ba_problem(cuda_device), iters=20, solver=solver)
    assert all(t.device.type == "cuda" for t in card)
    assert abs(card[4].item() - cpu[4].item()) <= 1e-4 * cpu[4].item()
    for k in (0, 1, 3):
        assert (card[k].cpu() - cpu[k]).abs().max().item() <= 1e-3, k


@pytest.mark.gpu
def test_bundle_adjust_ignores_global_tf32(cuda_device, monkeypatch):
    """With the global TF32 flag on, every product and the solve of the
    Schur step see it off, and the caller's setting is back afterwards.
    The results of the two runs are compared within the bounds kept from
    when the card's segment sums were float atomics (1e-4 relative on the
    mean squared residual, 1e-3 on the points); the spies, not the numbers,
    show the flag off, and ``test_mapper_is_deterministic_on_cuda`` holds
    two runs to the same bits."""
    from vit_colmap_tpu_torch.sfm import bundle

    seen = []
    for name in ("einsum", "linalg.solve_ex"):
        owner = torch.linalg if name == "linalg.solve_ex" else torch
        real = getattr(owner, name.split(".")[-1])

        def spy(*args, _real=real, _name=name, **kw):
            seen.append((_name, torch.backends.cuda.matmul.allow_tf32))
            return _real(*args, **kw)

        monkeypatch.setattr(owner, name.split(".")[-1], spy)
    previous = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = bundle.bundle_adjust(_ba_problem(cuda_device), iters=10, solver="schur")
        torch.backends.cuda.matmul.allow_tf32 = True
        seen.clear()
        on = bundle.bundle_adjust(_ba_problem(cuda_device), iters=10, solver="schur")
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
    assert {name for name, _ in seen} == {"einsum", "linalg.solve_ex"}
    assert not any(flag for _, flag in seen)
    assert abs(on[4].item() - off[4].item()) <= 1e-4 * off[4].item()
    assert (on[3] - off[3]).abs().max().item() <= 1e-3


def _pnp_args():
    """One image of _ba_problem's scene for PnP: its unperturbed points, its
    observations with the first 30 replaced by random pixels, and 512
    hypotheses' uniforms (CPU tensors)."""
    import numpy as np

    p = _ba_problem("cpu")
    n = p.points.shape[0]
    X = torch.tensor(np.random.default_rng(0).uniform([-1, -1, 3], [1, 1, 5], (n, 3)),
                     dtype=torch.float32)  # _ba_problem's unperturbed points
    xy = p.obs_xy[2 * n:3 * n].clone()
    xy[:30] = torch.rand(30, 2, generator=torch.Generator().manual_seed(1)) * 640
    u = torch.rand((512, 6), generator=torch.Generator().manual_seed(2))
    return xy, X, torch.ones(n, dtype=torch.bool), p.K[0], u


@pytest.mark.gpu
def test_pnp_on_cuda_equals_cpu(cuda_device):
    """PnP RANSAC with the same uniforms on the card and on the CPU: the
    same inliers, R and t within 1e-3."""
    from vit_colmap_tpu_torch.sfm import pnp

    args = _pnp_args()
    cpu = pnp.pnp_ransac(*args, max_error_px=8.0)
    card = pnp.pnp_ransac(*(a.to(cuda_device) for a in args), max_error_px=8.0)
    assert torch.equal(card.inlier_mask.cpu(), cpu.inlier_mask)
    assert (card.R.cpu() - cpu.R).abs().max().item() <= 1e-3
    assert (card.t.cpu() - cpu.t).abs().max().item() <= 1e-3


@pytest.mark.gpu
def test_pnp_ignores_global_tf32(cuda_device, monkeypatch):
    """With the global TF32 flag on, every batched product of PnP RANSAC
    sees it off, the caller's setting is back afterwards, and the result is
    the flag-off run's: the same inliers, R and t within 1e-6 (no atomics
    on this path)."""
    from vit_colmap_tpu_torch.sfm import pnp

    args = [a.to(cuda_device) for a in _pnp_args()]
    seen = []
    real = torch.einsum

    def spy(*a, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*a, **kw)

    monkeypatch.setattr(torch, "einsum", spy)
    previous = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = pnp.pnp_ransac(*args, max_error_px=8.0)
        torch.backends.cuda.matmul.allow_tf32 = True
        seen.clear()
        on = pnp.pnp_ransac(*args, max_error_px=8.0)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
    assert seen and not any(seen)
    assert torch.equal(on.inlier_mask, off.inlier_mask)
    assert (on.R - off.R).abs().max().item() <= 1e-6
    assert (on.t - off.t).abs().max().item() <= 1e-6


def _chip_smoke():
    """chip_smoke.py as a module (its scenes and its SIFT agreement rule)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_scenes", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.gpu
def test_mapper_is_deterministic_on_cuda(cuda_device, tmp_path):
    """tests/test_sfm_scale.py's 12-view scene mapped twice on the card:
    the same images and points, with bit-equal poses and positions (BA's
    segment sums reduce each segment in a fixed order)."""
    from vit_colmap_tpu_torch.sfm.incremental import incremental_mapping
    from vit_colmap_tpu_torch.utils.config import ReconstructionConfig

    cs = _chip_smoke()
    _, K, views = cs.scale_scene()
    cs.write_views_db(tmp_path / "scale.db", K, (800, 600), views, 20)
    cfg = ReconstructionConfig(min_num_matches=15, ba_local_iters=10, ba_global_iters=20)
    runs = [incremental_mapping(tmp_path / "scale.db", tmp_path, tmp_path / f"run{i}", cfg,
                                device=cuda_device)[0] for i in range(2)]
    assert len(runs[0].images) == cs.SCALE_VIEWS
    assert cs.models_bit_equal(*runs)


@pytest.mark.gpu
def test_segment_sums_are_deterministic_on_cuda(cuda_device):
    """BA's segment sums on the card: the same bits on every call, and
    index_add_'s sums within float rounding."""
    from vit_colmap_tpu_torch.sfm import bundle

    g = torch.Generator(device=cuda_device).manual_seed(0)
    ids = torch.randint(0, 300, (200_000,), generator=g, device=cuda_device)
    data = torch.randn(200_000, 3, generator=g, device=cuda_device)
    seg = bundle._SegmentSums()
    first = seg("k", data, ids, 300)
    assert all(torch.equal(first, bundle._SegmentSums()("k", data, ids, 300))
               for _ in range(3))
    ref = torch.zeros(300, 3, device=cuda_device).index_add_(0, ids, data)
    assert (first - ref).abs().max().item() <= 1e-3


@pytest.mark.gpu
def test_sift_on_cuda_matches_cpu(cuda_device, tmp_path):
    """extract_sift on two rendered 240 x 320 views, card against CPU, held
    to chip_smoke.py's SIFT_SHARES: 99% of the CPU's keypoints have a card
    keypoint within 0.01 px and scale, 97% of those one within 0.01 rad too,
    and over those pairs 99% of the descriptor bytes within 1 level."""
    import numpy as np

    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import render_multiview_scene
    from vit_colmap_tpu_torch.ops.sift import extract_sift
    from vit_colmap_tpu_torch.utils.image_io import imread_gray

    cs = _chip_smoke()
    render_multiview_scene(tmp_path, n_cams=2, size=(240, 320), focal=300.8, seed=7)
    gray = np.stack([imread_gray(tmp_path / f"view_{i:03d}.png") for i in range(2)])
    kw = dict(max_keypoints=1024, contrast_thresh=0.02)
    cpu = extract_sift(gray, device="cpu", **kw)
    card = extract_sift(gray, device=cuda_device, **kw)
    agree = cs.sift_agreement(cpu, card)
    assert min(agree["keypoints"]) > 50 and not cs.sift_missed(agree), agree


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["yuv420", "yuv420c4"])
def test_unpack_on_cuda_matches_cpu(cuda_device, fmt):
    """The wire unpackers on the card against the CPU, within 1e-3 of the
    [0, 255] RGB."""
    import numpy as np

    from vit_colmap_tpu_torch.ops import transfer

    rgb = np.random.default_rng(0).integers(0, 256, (2, 70, 84, 3), dtype=np.uint8)
    pack, unpack = ((transfer.pack_batch_yuv420, transfer.unpack_yuv420) if fmt == "yuv420"
                    else (transfer.pack_batch_yuv420_c4, transfer.unpack_yuv420_c4))
    wire = torch.from_numpy(pack(rgb))
    for full_range in (False, True):
        card = unpack(wire.to(cuda_device), full_range=full_range).cpu()
        assert (card - unpack(wire, full_range=full_range)).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [5, 300])
def test_quantdense_on_cuda_matches_cpu(cuda_device, rows):
    """QuantDense's int32 products on the card (torch._int_mm; 5 rows take
    the padding to 17) equal the CPU's bit for bit; its output within
    rtol 1e-6."""
    from vit_colmap_tpu_torch.models.dinov2 import QuantDense

    g = torch.Generator().manual_seed(rows)
    layer = QuantDense(256, 72)
    with torch.no_grad():
        layer.weight.normal_(generator=g)
        layer.bias.normal_(generator=g)
        x = torch.randn(rows, 256, generator=g).to(torch.bfloat16)
        acc, _, _ = layer.accumulate(x)
        out = layer.quantized(x, torch.float32)
        card = layer.to(cuda_device)
        acc_card, _, _ = card.accumulate(x.to(cuda_device))
        out_card = card.quantized(x.to(cuda_device), torch.float32)
    assert torch.equal(acc_card.cpu(), acc)
    torch.testing.assert_close(out_card.cpu(), out, rtol=1e-6, atol=1e-6 * out.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [dict(swiglu=True, mlp_ratio=8 / 3),
                                     dict(num_register_tokens=4), dict(quantize="int8")],
                         ids=["swiglu", "registers", "int8"])
def test_backbone_variants_on_cuda_match_cpu(cuda_device, variant):
    """A 2-layer backbone of each new variant at 1,120 patch tokens (kernel 1
    on the card, its plain version on the CPU), bf16: the patch tokens'
    per-token cosine at least 0.99 (int8 rounding amplifies one-ulp
    differences), the RMS of their difference within 3% of theirs for the
    float variants."""
    from vit_colmap_tpu_torch.models import dinov2

    cfg = dinov2.ViTConfig(embed_dim=384, depth=2, num_heads=6,
                           attn_impl="fixedmax_fused", **{"mlp_ratio": 4.0, **variant})
    model = dinov2.DinoV2(cfg, generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        for blk in model.blocks:
            blk.ls1.gamma.fill_(0.1)
            blk.ls2.gamma.fill_(0.1)
    x = torch.randn(2, 392, 560, 3, generator=torch.Generator().manual_seed(1))
    before = launches["attention_qkv"]
    with torch.no_grad():
        ref = model(x)["x_norm_patchtokens"].float()
        out = model.to(cuda_device)(x.to(cuda_device))["x_norm_patchtokens"].float().cpu()
    torch.cuda.synchronize()
    assert launches["attention_qkv"] == before + 2
    cos = torch.nn.functional.cosine_similarity(out, ref, dim=-1)
    assert cos.min().item() >= 0.99
    if cfg.quantize == "none":
        assert ((out - ref).square().mean() / ref.square().mean()).sqrt().item() <= 0.03


@pytest.mark.gpu
def test_trainable_extractor_on_cuda_matches_cpu(cuda_device):
    """TrainableViTExtractor (vits14, random heads with spread logits) in
    f32 on the card against the CPU: the heads within 1e-3 of their largest
    value, and 99% of the CPU's keypoints with a card keypoint within 0.01
    px."""
    import numpy as np

    from vit_colmap_tpu_torch.features.trainable_vit_extractor import (
        TrainableViTExtractor,
    )
    from vit_colmap_tpu_torch.models.dinov2 import preprocess

    kw = dict(backbone="vits14", num_keypoints=512, dtype=torch.float32, seed=3)
    cpu = TrainableViTExtractor(device="cpu", **kw)
    with torch.no_grad():
        cpu.model.heads.kp2.weight[0] *= 20.0
    card = TrainableViTExtractor(device=cuda_device, **kw)
    card.model.load_state_dict(cpu.model.state_dict())
    img = np.random.default_rng(0).integers(0, 256, (1, 224, 308, 3), dtype=np.uint8)
    with torch.no_grad():
        ref = cpu.model(preprocess(torch.from_numpy(img)))
        out = card.model(preprocess(torch.from_numpy(img).to(cuda_device)))
    for k in ref:
        err = (out[k].cpu() - ref[k]).abs().max() / ref[k].abs().max()
        assert err.item() <= 1e-3, k
    x, y, _, _, valid, _ = (t.cpu() for t in card.select(out))
    rx, ry, _, _, rvalid, _ = cpu.select(ref)
    ours = torch.stack([x[0], y[0]], -1)[valid[0]].double()
    theirs = torch.stack([rx[0], ry[0]], -1)[rvalid[0]].double()
    share = (torch.cdist(theirs, ours).min(dim=1).values <= 0.01).double().mean().item()
    assert len(theirs) > 100 and share >= 0.99


@pytest.mark.gpu
def test_relay_epoch_probe_on_cuda(cuda_device):
    from vit_colmap_tpu_torch.utils.profiling import relay_epoch_probe

    ms = relay_epoch_probe()
    assert 0.0 < ms < 1000.0


class _NumpyDraws:
    """The same uniforms for every device: a seeded numpy stream, handed to
    the port's ``draw_uniform`` as a callable."""

    def __init__(self, seed):
        self.rng = __import__("numpy").random.default_rng(seed)

    def __call__(self, shape):
        return torch.from_numpy(self.rng.random(shape, dtype="float32"))


def _train_step_on(device, state_dicts, batch, seed):
    """One training step of a tiny f32 model (backbone depth 2, embed 128;
    narrow heads) on ``device``: (loss, metrics, clipped heads gradients,
    updated heads), all on the CPU."""
    from vit_colmap_tpu_torch.models import dinov2, feature_model
    from vit_colmap_tpu_torch.training import train_step

    bb = dinov2.DinoV2(dinov2.ViTConfig(embed_dim=128, depth=2, num_heads=2, pretrain_grid=4,
                                        dtype=torch.float32)).to(device)
    heads = feature_model.FeatureHeads(feature_model.FeatureModelConfig(
        descriptor_dim=16, hidden=64, trunk_dim=32, dtype=torch.float32), 128).to(device)
    bb.load_state_dict(state_dicts[0])
    heads.load_state_dict(state_dicts[1])
    bb.requires_grad_(False)
    recipe = train_step.make_optimizer(1e-3, 1e-4, 10, 2)
    step, _ = train_step.make_train_step(bb, heads, recipe, batch_kwargs=dict(top_k=32))
    state, metrics = step(train_step.init_train_state(heads, recipe),
                          {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                          _NumpyDraws(seed))
    grads = {k: p.grad.cpu() for k, p in heads.named_parameters()}
    return ({k: float(v) for k, v in metrics.items()}, grads,
            {k: v.cpu() for k, v in heads.state_dict().items()})


@pytest.mark.gpu
def test_train_step_on_cuda_matches_cpu(cuda_device):
    """One fixed-batch step (two 112 x 140 images, a conservative random
    homography, the same uniforms) on the card against the CPU: every loss
    component within 1e-4 relative, every clipped heads gradient within
    1e-3 of its tensor's largest; each heads parameter moved at most the
    step's rate (1e-4), and within 2% of it of the CPU's move where the CPU
    moved it by at least 0.98 of the rate and its gradient is at least 1%
    of its tensor's largest (AdamW's first step is about rate * sign(g), so
    the sign of a gradient below the 1e-3 bound is rounding's)."""
    import numpy as np

    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import warp_perspective
    from vit_colmap_tpu_torch.dataloader.synthetic_homography import (
        SyntheticHomographyConfig,
        generate_random_homography,
    )
    from vit_colmap_tpu_torch.models import dinov2, feature_model

    rng = np.random.default_rng(0)
    imgs1 = np.stack([rng.integers(0, 256, (112, 140, 3), dtype=np.uint8) for _ in range(2)])
    Hs = np.stack([generate_random_homography(140, 112, SyntheticHomographyConfig.conservative(),
                                              rng) for _ in range(2)]).astype(np.float32)
    batch = {"image1": imgs1,
             "image2": np.stack([warp_perspective(i, H, (140, 112)) for i, H in zip(imgs1, Hs)]),
             "H": Hs}
    g = torch.Generator().manual_seed(1)
    bb = dinov2.DinoV2(dinov2.ViTConfig(embed_dim=128, depth=2, num_heads=2, pretrain_grid=4,
                                        dtype=torch.float32), generator=g)
    heads = feature_model.FeatureHeads(feature_model.FeatureModelConfig(
        descriptor_dim=16, hidden=64, trunk_dim=32, dtype=torch.float32), 128)
    feature_model.reset_heads(heads, g)
    sds = (bb.state_dict(), heads.state_dict())
    m_cpu, g_cpu, h_cpu = _train_step_on("cpu", sds, batch, seed=2)
    m_gpu, g_gpu, h_gpu = _train_step_on(cuda_device, sds, batch, seed=2)
    assert set(m_gpu) == set(m_cpu)
    for k, v in m_cpu.items():
        assert abs(m_gpu[k] - v) <= 1e-4 * max(abs(v), 1e-3), (k, m_gpu[k], v)
    for k, v in g_cpu.items():
        assert (g_gpu[k] - v).abs().max().item() <= 1e-3 * max(v.abs().max().item(), 1e-12), k
    rate = 1e-4
    for k, v in h_cpu.items():
        cpu_move, gpu_move = v - sds[1][k], h_gpu[k] - sds[1][k]
        assert gpu_move.abs().max().item() <= 1.01 * rate + 1e-7, k
        big = (cpu_move.abs() >= 0.98 * rate) & (g_cpu[k].abs() >= 0.01 * g_cpu[k].abs().max())
        diff = (gpu_move - cpu_move)[big].abs()
        assert diff.numel() == 0 or diff.max().item() <= 0.02 * rate, k


@pytest.mark.gpu
def test_checkpoint_round_trip_on_cuda(cuda_device, tmp_path):
    """The trainer on the card (vits14, 56 px synthetic pairs): checkpoints,
    --resume continuing the step count, best_model into
    TrainableViTExtractor on the card, and a --train-backbone checkpoint
    into ViTExtractor."""
    import json

    from vit_colmap_tpu_torch.features.trainable_vit_extractor import TrainableViTExtractor
    from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor
    from vit_colmap_tpu_torch.training import train
    from vit_colmap_tpu_torch.training.checkpoint import load_checkpoint

    args = ["--synthetic-only", "--synthetic-image-size", "56", "--backbone", "vits14",
            "--batch-size", "2", "--steps-per-epoch", "2", "--top-k", "16"]
    out = tmp_path / "ckpt"
    train.main(args + ["--epochs", "1", "--output-dir", str(out)])
    train.main(args + ["--epochs", "2", "--output-dir", str(out), "--resume",
                       str(out / "latest")])
    assert json.loads((out / "meta.json").read_text()) == {
        "epoch": 2, "step": 4, "train_backbone": False}
    ex = TrainableViTExtractor(str(out / "best_model"), backbone="vits14", num_keypoints=64)
    saved = load_checkpoint(out / "best_model")["heads"]
    for k, v in ex.model.heads.state_dict().items():
        assert v.device.type == "cuda" and torch.equal(v.cpu(), saved[k]), k
    bb = tmp_path / "ckpt_bb"
    train.main(args + ["--epochs", "1", "--output-dir", str(bb), "--train-backbone"])
    fz = ViTExtractor(str(bb / "latest"), backbone="vits14", max_keypoints=64)
    saved = load_checkpoint(bb / "latest")["backbone"]
    for k, v in fz.model.state_dict().items():
        assert torch.equal(v.cpu(), saved[k]), k


def _detector_image(h=480, w=640, seed=0):
    import numpy as np

    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import make_structured_image
    from vit_colmap_tpu_torch.utils.image_io import rgb_to_gray

    return torch.from_numpy(rgb_to_gray(make_structured_image(np.random.default_rng(seed), h, w)))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fast", "gftt", "orb", "sift"])
def test_cv_detector_on_cuda_matches_cpu(cuda_device, name):
    """The OpenCV detectors on the card against the CPU on a 480 x 640
    structured image: FAST and GFTT equal (points, responses, order); ORB
    and SIFT held to the bar of tests/test_torch_cv_detectors.py (counts
    within 2%, 95% of the points within 0.05 px both ways)."""
    from vit_colmap_tpu_torch.ops import cv_detectors as cd

    fn = {"fast": cd.detect_fast, "gftt": lambda g: cd.detect_gftt(g, 4096),
          "orb": lambda g: cd.detect_orb(g, 4096), "sift": lambda g: cd.detect_sift(g, 4096)}[name]
    gray = _detector_image()
    ref_pts, ref_resp = fn(gray)
    pts, resp = (t.cpu() for t in fn(gray.to(cuda_device)))
    assert len(ref_pts) > 100
    if name in ("fast", "gftt"):
        assert torch.equal(pts, ref_pts) and torch.equal(resp, ref_resp)
    else:
        agree = cd.point_agreement(ref_pts, pts)
        assert agree["count_rel"] <= 0.02 and min(agree["share_ref"], agree["share_out"]) >= 0.95


@pytest.mark.gpu
def test_hybrid_extractor_on_cuda_matches_cpu(cuda_device, tmp_path):
    """HybridExtractor.extract (vits14, f32, FAST) on two 224 x 308 views,
    card against CPU with one PCA file: equal keypoints, descriptor bytes
    within 1 and 99% of them equal."""
    import numpy as np

    from vit_colmap_tpu_torch.database import ColmapDatabase
    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import make_structured_image
    from vit_colmap_tpu_torch.features.hybrid_extractor import HybridExtractor
    from vit_colmap_tpu_torch.utils.image_io import write_png

    images = tmp_path / "images"
    images.mkdir()
    base = make_structured_image(np.random.default_rng(1), 224, 336)
    for i in range(2):
        write_png(images / f"v{i}.png", base[:, 14 * i : 14 * i + 308])
    rows = {}
    for dev in ("cpu", cuda_device):
        ex = HybridExtractor(backbone="vits14", detector="fast", max_keypoints=512,
                             dtype=torch.float32, pca_path=str(tmp_path / "pca.npz"),
                             seed=2, device=dev)
        ex.extract(images, tmp_path / f"{str(dev)}.db", "SIMPLE_PINHOLE")
        with ColmapDatabase.open_database(tmp_path / f"{str(dev)}.db") as db:
            rows[str(dev)] = [(db.read_keypoints(i), db.read_descriptors(i))
                              for i in sorted(db.read_images())]
    for (rk, rd), (k, d) in zip(rows["cpu"], rows[str(cuda_device)]):
        assert len(rk) > 50
        np.testing.assert_array_equal(k, rk)
        diff = np.abs(d.astype(int) - rd.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
