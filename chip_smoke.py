#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vit_colmap_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one flushed line each with elapsed seconds:

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: the port's CUDA kernels, one nvcc call, from the sources here;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes, in the working dtypes, and known-wrong variants
   of the plain version against the same bounds (each must fail them);
4. slice: the port's main path through ``Pipeline.run`` -- frozen DINOv2
   ViT-B/14 (random weights from a seed) on 8 synthetic 1190 x 1596 PNGs,
   4096 keypoints, COLMAP database, exhaustive matching of the 28 pairs in
   one batch, verification and reconstruction skipped -- with the kernels'
   launch counters reset just before and read just after, then checks of
   the database and of both kernels against the plain path (with the
   known-wrong variants again);
5. times: CUDA-event medians of each kernel, its plain version and one
   PyTorch library call computing the same function, and the pipeline's
   extraction / matching rates on a second, warm run.

It prints a ``{"kernels": [...]}`` line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line.  Any failed
check raises, and the script exits non-zero without that line.  It needs
one CUDA GPU and ``nvcc``; without CUDA, or outside a checkout of the
repository, it exits with status 2 before printing any result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

T0 = time.perf_counter()
DEVICE = "cuda"  # the one device driven; a CPU rehearsal sets "cpu"

# Main-path shapes: bench.py's workload.
NUM_IMAGES = 8
HEIGHT, WIDTH = 1190, 1596  # 85 x 114 = 9,690 patch tokens + CLS
MAX_KEYPOINTS = 4096
NUM_PAIRS = NUM_IMAGES * (NUM_IMAGES - 1) // 2
PAIR_BATCH = 28  # all 28 pairs of 8 images in one batch
IMAGE_BATCH = 2  # ExtractorConfig.image_batch default
HEADS = 12

# Published H100 SXM peaks (dense): bf16 tensor cores, fp32 outside them,
# HBM bandwidth.  Bounds are stated against these at the card's power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Kernel 1 and its plain version do the same bf16 roundings and differ in
# f32 sum order and exp2 ulps, so their bf16 outputs differ by at most about
# one ulp (2^-8 to 2^-7 relative).  Bound: max |kernel - plain| <=
# ATTN_ULPS * 2^-8 * max |plain|.
ATTN_ULPS = 4
MATCH_VALUE_TOL = 1e-6  # best / second; indices must be identical
# Patch tokens of a batch of images through 12 layers with kernel 1 vs its
# plain version.  Each layer can flip activations by one bf16 ulp, and the
# flips compound through the residual stream.  Bound the RMS of the
# difference relative to the RMS of the tokens, and the largest difference
# relative to the largest token.  On an H100 a correct kernel reads about
# 0.5% and 2%, q scaled without log2(e) 5% and 7%: the bounds sit between.
TOKEN_RMS_TOL = 1e-2
TOKEN_MAX_TOL = 3.5e-2
# The random backbone's q projections are scaled by this gain so that the
# attention logits have a standard deviation near 3 and each query attends
# to a few keys: with the plain init (std near 1) attention averages
# thousands of keys and the token map barely depends on it.
Q_GAIN = 3.0

# Known-wrong variants of kernel 1 whose readings passed a bound they must
# fail: collected, and raised at the end so that one run shows them all.
POWERLESS: list[str] = []


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def synthetic_images(seed: int):
    """bench.py's images: a random base at 1/8 scale, shifted by 2 px per
    image, bilinearly upscaled to full size."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (HEIGHT // 8, WIDTH // 8, 3), dtype=np.uint8)
    for i in range(NUM_IMAGES):
        shifted = torch.from_numpy(np.roll(base, i * 2, axis=1)).float()
        up = F.interpolate(shifted.permute(2, 0, 1)[None], size=(HEIGHT, WIDTH),
                           mode="bilinear", align_corners=False)
        yield up[0].permute(1, 2, 0).clamp(0, 255).to(torch.uint8).numpy()


def random_weights(path: Path, seed: int) -> None:
    """A seeded random ViT-B/14 state dict.  Three departures from the flax
    init keep the checks meaningful: LayerScale at 0.1 (1e-5 would make every
    block, and so attention, vanish from the tokens), q projections scaled by
    ``Q_GAIN`` (see there), and LayerNorm weights 1 + 0.1 N(0, 1) and biases
    0.1 N(0, 1) (with unit weights and zero biases the channel mean of the
    final norm's output, which drives the saliency, is rounding noise)."""
    import torch

    from vit_colmap_tpu_torch.models.dinov2 import make_backbone

    g = torch.Generator().manual_seed(seed)
    model, cfg = make_backbone("vitb14", generator=g)
    sd = model.state_dict()
    for key, value in sd.items():
        if key.endswith("attn.qkv.weight") or key.endswith("attn.qkv.bias"):
            value[: cfg.embed_dim] *= Q_GAIN
        elif key.endswith(".gamma"):
            value.fill_(0.1)
        elif "norm" in key and key.endswith(".weight"):
            value.add_(0.1 * torch.randn(value.shape, generator=g))
        elif "norm" in key and key.endswith(".bias"):
            value.copy_(0.1 * torch.randn(value.shape, generator=g))
    torch.save(sd, path)


def device_phase():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    kind = torch.cuda.get_device_name(0)
    log(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {kind} x{torch.cuda.device_count()}")
    return card, kind


def build_phase():
    from vit_colmap_tpu_torch.kernels import build

    t = time.perf_counter()
    build.library()
    seconds = time.perf_counter() - t
    log(f"build: 2 kernels, one nvcc call, {seconds:.1f} s")
    return seconds


def wrong_no_log2e(qkv, num_heads: int, sm_scale: float):
    """Known-wrong kernel 1: q scaled without log2(e)."""
    from vit_colmap_tpu_torch.kernels import attention

    return attention.attention_qkv_plain(qkv, num_heads, sm_scale / attention.LOG2E)


def wrong_first_image(qkv, num_heads: int, sm_scale: float):
    """Known-wrong kernel 1: every image of the batch gets image 0's output
    (a per-image offset left out)."""
    from vit_colmap_tpu_torch.kernels import attention

    out = attention.attention_qkv_plain(qkv[:1], num_heads, sm_scale)
    return out.expand(qkv.shape[0], -1, -1).contiguous()


def wrong_tail_dropped(qkv, num_heads: int, sm_scale: float):
    """Known-wrong kernel 1: the plain arithmetic with the last, ragged kv
    tile of 64 rows left out."""
    import torch

    from vit_colmap_tpu_torch.kernels import attention

    B, N, three_d = qkv.shape
    D = three_d // 3
    keep = N - (N % 64 or 64)
    out = torch.empty(B, N, D, dtype=qkv.dtype, device=qkv.device)
    for h in range(num_heads):
        cols = slice(64 * h, 64 * h + 64)
        q = (qkv[..., cols].float() * (sm_scale * attention.LOG2E)).to(qkv.dtype).float()
        k = qkv[:, :keep, D:][..., cols].float()
        v = qkv[:, :keep, 2 * D:][..., cols].float()
        for b in range(B):
            p = torch.exp2(torch.clamp_max(q[b] @ k[b].T, attention.CLAMP))
            p = p.to(torch.bfloat16).float()
            out[b, :, cols] = ((p @ v[b]) / p.sum(-1, keepdim=True)).to(qkv.dtype)
    return out


def wrong_kernels(batch: int):
    """The known-wrong variants that apply to a batch of ``batch`` images."""
    wrong = {"no log2e": wrong_no_log2e, "last kv tile dropped": wrong_tail_dropped}
    if batch > 1:
        wrong["image 0 for all"] = wrong_first_image
    return wrong


def attention_check(B: int, N: int, H: int, seed: int):
    import torch

    from vit_colmap_tpu_torch.kernels import attention

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    qkv = torch.randn(B, N, 3 * 64 * H, generator=g, device=DEVICE).to(torch.bfloat16)
    out = attention.attention_qkv(qkv, H, 64**-0.5)
    sync()
    ref = attention.attention_qkv_plain(qkv, H, 64**-0.5).float()
    bound = ATTN_ULPS * 2.0**-8 * ref.abs().max().item()
    err = (out.float() - ref).abs().max().item()
    check(math.isfinite(err) and err <= bound,
          f"attention_qkv (B={B}, N={N}, H={H}): max err {err} > {bound}")
    log(f"kernels: attention_qkv B={B} N={N} heads={H}: max |kernel - plain| "
        f"{err:.3g} <= {bound:.3g} ({ATTN_ULPS} x 2^-8 x max |plain|)")
    for name, fn in wrong_kernels(B).items():
        wrong = (fn(qkv, H, 64**-0.5).float() - ref).abs().max().item()
        log(f"kernels: known-wrong '{name}' B={B} N={N}: max |wrong - plain| "
            f"{wrong:.3g} (must exceed {bound:.3g})")
        if not wrong > bound:
            POWERLESS.append(f"attention B={B} N={N} '{name}': {wrong} <= {bound}")
    return err


def match_inputs(P: int, N: int, M: int, seed: int, integer: bool = False):
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    if integer:  # every dot product exact: ties everywhere
        d1 = torch.randint(-2, 3, (P, N, 128), generator=g, device=DEVICE).float()
        d2 = torch.roll(d1, N // 2, dims=1)[:, :M].contiguous()
    else:
        d1 = torch.nn.functional.normalize(
            torch.randn(P, N, 128, generator=g, device=DEVICE), dim=-1)
        d2 = torch.nn.functional.normalize(
            torch.randn(P, M, 128, generator=g, device=DEVICE), dim=-1)
    v1 = torch.rand(P, N, generator=g, device=DEVICE) < 0.9
    v2 = torch.rand(P, M, generator=g, device=DEVICE) < 0.9
    return d1, d2, v1, v2


def match_check(inputs, label: str):
    from vit_colmap_tpu_torch.kernels import match

    out = match.match_topk2_colmax(*inputs)
    ref = match.topk2_colmax_plain(*inputs)
    for name, a, b in zip(("best_idx", "col_row"), out[2:], ref[2:]):
        n_diff = int((a != b).sum())
        check(n_diff == 0, f"match_topk2_colmax {label}: {n_diff} {name} differ")
    err = max((a - b).abs().max().item() for a, b in zip(out[:2], ref[:2]))
    check(err <= MATCH_VALUE_TOL,
          f"match_topk2_colmax {label}: best/second err {err} > {MATCH_VALUE_TOL}")
    log(f"kernels: match_topk2_colmax {label}: indices identical, "
        f"best/second max err {err:.3g}")
    return err


def slice_phase(work: Path):
    """The main path through Pipeline.run, counts reset just before."""
    from vit_colmap_tpu_torch.kernels import attention, match
    from vit_colmap_tpu_torch.pipeline import Pipeline
    from vit_colmap_tpu_torch.utils.config import Config
    from vit_colmap_tpu_torch.utils.image_io import write_png

    img_dir = work / "images"
    img_dir.mkdir()
    for i, img in enumerate(synthetic_images(seed=0)):
        write_png(img_dir / f"img_{i:02d}.png", img)
    weights = work / "vitb14_random.pth"
    random_weights(weights, seed=0)
    log(f"slice: wrote {NUM_IMAGES} PNGs {WIDTH}x{HEIGHT} and seeded ViT-B/14 weights")

    config = Config()
    config.extractor.extractor_type = "vit"
    config.extractor.backbone = "vitb14"
    config.extractor.vit_weights_path = str(weights)
    config.extractor.max_keypoints = MAX_KEYPOINTS
    config.extractor.image_batch = IMAGE_BATCH
    config.matching.pair_batch = PAIR_BATCH
    config.matching.do_verification = False
    config.do_reconstruction = False
    pipeline = Pipeline(config, device=DEVICE)

    attention.launches = 0
    match.launches = 0
    sync()
    t = time.perf_counter()
    report = pipeline.run(img_dir, work / "out", work / "run1.db")
    sync()
    wall = time.perf_counter() - t
    launches = {"attention_qkv": attention.launches,
                "match_topk2_colmax": match.launches}
    log(f"slice: Pipeline.run in {wall:.1f} s, report {report}, launches {launches}")
    # Backbone passes: the PCA fit over the 8 images, then extraction, each
    # in batches of IMAGE_BATCH; 12 attention layers per pass.
    passes = 2 * math.ceil(NUM_IMAGES / IMAGE_BATCH)
    check(launches["attention_qkv"] == HEADS * passes,
          f"attention_qkv launched {launches['attention_qkv']} times, "
          f"expected {HEADS * passes}")
    check(launches["match_topk2_colmax"] == math.ceil(NUM_PAIRS / PAIR_BATCH),
          f"match_topk2_colmax launched {launches['match_topk2_colmax']} times")
    return pipeline, report, launches


def check_database(db_path: Path):
    from vit_colmap_tpu_torch.database import ColmapDatabase

    with ColmapDatabase.open_database(db_path) as db:
        n_img, n_kp = db.num_images, db.num_keypoints
        n_pairs, n_matches = db.num_matched_pairs, db.num_matches
        images = db.read_images()
        ids = sorted(images)
        per_shift = [db.read_matches(a, b) for a, b in zip(ids, ids[1:])]
        per_shift = [0 if m is None else len(m) for m in per_shift]
        descs = [db.read_descriptors(i) for i in ids]
        kpts = [db.read_keypoints(i) for i in ids]
    check(n_img == NUM_IMAGES, f"{n_img} images in the database")
    check(all(d.shape == (len(k), 128) for d, k in zip(descs, kpts)),
          "descriptor rows do not match keypoint rows")
    check(0 < n_kp <= NUM_IMAGES * MAX_KEYPOINTS, f"{n_kp} keypoints")
    check(all(p > 0 for p in per_shift),
          f"matches between consecutive (shifted) images: {per_shift}")
    import numpy as np

    for k in kpts:
        check(bool(np.isfinite(k).all()) and k[:, 0].min() >= 0
              and k[:, 0].max() <= WIDTH and k[:, 1].max() <= HEIGHT,
              "keypoints outside the image")
    log(f"slice: database {n_img} images, {n_kp} keypoints, {n_pairs} matched "
        f"pairs, {n_matches} matches; consecutive pairs {per_shift}")
    return {"images": n_img, "keypoints": n_kp, "matched_pairs": n_pairs,
            "matches": n_matches}


def check_tokens(pipeline, img_dir: Path):
    """Patch tokens of one image batch: kernel 1 against its plain version,
    and the known-wrong variants against the same bounds."""
    from unittest import mock

    import numpy as np

    from vit_colmap_tpu_torch.kernels import attention
    from vit_colmap_tpu_torch.utils.image_io import imread_rgb

    extractor = next(iter(pipeline._extractors.values()))
    imgs = np.stack([imread_rgb(f) for f in sorted(img_dir.iterdir())[:IMAGE_BATCH]])

    def tokens(fn):
        with mock.patch.object(attention, "attention_qkv", fn):
            return extractor.dense_features(imgs)

    def errors(tok):
        diff = tok - plain
        rms = (diff.square().mean().sqrt() / plain.square().mean().sqrt()).item()
        return rms, (diff.abs().max() / plain.abs().max()).item()

    kern = extractor.dense_features(imgs)
    plain = tokens(attention.attention_qkv_plain)
    rms, rel = errors(kern)
    check(bool(kern.isfinite().all()) and rms <= TOKEN_RMS_TOL and rel <= TOKEN_MAX_TOL,
          f"patch tokens kernel vs plain: rms rel err {rms}, max rel err {rel}")
    log(f"slice: patch tokens {tuple(kern.shape)} kernel vs plain path: "
        f"rms rel err {rms:.3g} <= {TOKEN_RMS_TOL}, max rel err {rel:.3g} "
        f"<= {TOKEN_MAX_TOL}")
    # The dropped tail moves a few of 9,691 keys: the kernel check must see
    # it; the token map is not meant to, and its reading is only logged.
    for name, fn in wrong_kernels(IMAGE_BATCH).items():
        w_rms, w_rel = errors(tokens(fn))
        must = name != "last kv tile dropped"
        log(f"slice: known-wrong '{name}' patch tokens: rms rel err {w_rms:.3g}, "
            f"max rel err {w_rel:.3g}" + (" (one must exceed its bound)" if must else ""))
        if must and not (w_rms > TOKEN_RMS_TOL or w_rel > TOKEN_MAX_TOL):
            POWERLESS.append(f"patch tokens '{name}': rms {w_rms}, max {w_rel}")
    return extractor


def check_matches(db_path: Path):
    """The database's matches (kernel 2 on the main path) against the plain
    path's matches from the same descriptors."""
    import numpy as np
    import torch

    from vit_colmap_tpu_torch.database import ColmapDatabase
    from vit_colmap_tpu_torch.kernels import match
    from vit_colmap_tpu_torch.ops.matching import normalize_descriptors

    with ColmapDatabase.open_database(db_path) as db:
        ids = sorted(db.read_images())
        descs = [db.read_descriptors(i) for i in ids]
        stored = {(a, b): db.read_matches(ids[a], ids[b])
                  for a in range(len(ids)) for b in range(a + 1, len(ids))}
    n = 128
    while n < max(len(d) for d in descs):
        n *= 2
    desc = torch.zeros(len(ids), n, 128, device=DEVICE)
    valid = torch.zeros(len(ids), n, dtype=torch.bool, device=DEVICE)
    for i, d in enumerate(descs):
        desc[i, : len(d)] = torch.from_numpy(d).to(DEVICE).float() / 127.5 - 1.0
        valid[i, : len(d)] = True
    desc = normalize_descriptors(desc)
    pairs = list(stored)
    i1 = torch.tensor([p[0] for p in pairs], device=DEVICE)
    i2 = torch.tensor([p[1] for p in pairs], device=DEVICE)
    inputs = (desc[i1], desc[i2], valid[i1], valid[i2])
    plain = match.filter_matches(*match.topk2_colmax_plain(*inputs), inputs[2])
    plain = plain.cpu().numpy()
    for k, (a, b) in enumerate(pairs):
        rows = np.nonzero(plain[k] >= 0)[0]
        expect = np.stack([rows, plain[k][rows]], axis=1).astype(np.uint32)
        got = stored[(a, b)]
        got = np.zeros((0, 2), np.uint32) if got is None else got
        check(np.array_equal(got, expect),
              f"pair {(a, b)}: {len(got)} kernel matches vs {len(expect)} plain")
    log(f"slice: matches of all {len(pairs)} pairs identical to the plain path")
    return inputs


def times_phase(pipeline, work: Path, img_dir: Path, match_inputs_main):
    import torch
    import torch.nn.functional as F

    from vit_colmap_tpu_torch.kernels import attention, match

    out = {}
    # Kernel 1 at the main path's shape: one batch of IMAGE_BATCH images.
    B, N, D = IMAGE_BATCH, 1 + (HEIGHT // 14) * (WIDTH // 14), 64 * HEADS
    g = torch.Generator(device=DEVICE).manual_seed(7)
    qkv = torch.randn(B, N, 3 * D, generator=g, device=DEVICE).to(torch.bfloat16)
    q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(B, N, HEADS, 64).transpose(1, 2)
               .contiguous() for i in range(3))
    out["attention_qkv"] = {
        "ms": cuda_ms(lambda: attention.attention_qkv(qkv, HEADS, 64**-0.5), 10),
        "plain_ms": cuda_ms(lambda: attention.attention_qkv_plain(qkv, HEADS, 64**-0.5), 3),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10),
        "flops": 4.0 * B * HEADS * N * N * 64,
        "bytes": qkv.numel() * 2 + B * N * D * 2,
        "peak": PEAK_BF16_FLOPS,
    }
    # Kernel 2 at the main path's shape: the 28 pairs of the slice's
    # database descriptors (P, 4096, 128).
    d1, d2, v1, v2 = match_inputs_main
    P, Nm, Dm = d1.shape
    Mm = d2.shape[1]

    def library_match():
        sim = torch.bmm(d1, d2.transpose(1, 2))
        sim = sim.masked_fill(~v2[:, None, :], -2.0)
        top = torch.topk(sim, 2, dim=-1)
        col = sim.masked_fill(~v1[:, :, None], -2.0).argmax(dim=1)
        return top, col

    out["match_topk2_colmax"] = {
        "ms": cuda_ms(lambda: match.match_topk2_colmax(d1, d2, v1, v2), 10),
        "plain_ms": cuda_ms(lambda: match.topk2_colmax_plain(d1, d2, v1, v2), 3),
        "library_ms": cuda_ms(library_match, 10),
        "flops": 2.0 * P * Nm * Mm * Dm,
        "bytes": (d1.numel() + d2.numel()) * 4 + v1.numel() + v2.numel()
        + P * Nm * 12 + P * Mm * 4,
        "peak": PEAK_FP32_FLOPS,
    }
    for name, t in out.items():
        t["bound_ops_ms"] = t["flops"] / t["peak"] * 1e3
        t["bound_bytes_ms"] = t["bytes"] / PEAK_BYTES * 1e3
        log(f"times: {name}: kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
            f"library {t['library_ms']:.3f} ms, bound {max(t['bound_ops_ms'], t['bound_bytes_ms']):.3f} ms")

    # Warm end-to-end rates: a second Pipeline.run on the same pipeline.
    sync()
    report = pipeline.run(img_dir, work / "out", work / "run2.db")
    rates = {
        "extract_img_per_s": NUM_IMAGES / report["extract_s"],
        "match_pairs_per_s": NUM_PAIRS / report["match_verify_s"],
        "extract_match_pairs_per_s": NUM_PAIRS / (report["extract_s"] + report["match_verify_s"]),
        "extract_s": report["extract_s"],
        "match_s": report["match_verify_s"],
    }
    log(f"times: warm Pipeline.run: {rates}")
    return out, rates


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the smoke run needs a GPU",
              file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "vit_colmap_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no vit_colmap_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card, kind = device_phase()
    build_s = build_phase()

    attn_err = max(attention_check(1, 1031, 2, seed=1),
                   attention_check(IMAGE_BATCH, 9691, HEADS, seed=2))
    match_err = max(
        match_check(match_inputs(PAIR_BATCH, 4096, 4096, seed=3), "random 28x4096x4096"),
        match_check(match_inputs(4, 4096, 4096, seed=4, integer=True), "integer ties 4x4096x4096"),
    )

    with tempfile.TemporaryDirectory(prefix="vit_colmap_smoke_") as tmp:
        work = Path(tmp)
        pipeline, report, launches = slice_phase(work)
        db_counts = check_database(work / "run1.db")
        check_tokens(pipeline, work / "images")
        inputs_main = check_matches(work / "run1.db")
        times, rates = times_phase(pipeline, work, work / "images", inputs_main)
    check(not POWERLESS, "known-wrong kernels passed a check: " + "; ".join(POWERLESS))

    sources = {
        "attention_qkv": ("vit_colmap_tpu_torch/csrc/attention_qkv.cu",
                          "vit_colmap_tpu/ops/pallas/attention_kernel.py:279",
                          attn_err),
        "match_topk2_colmax": ("vit_colmap_tpu_torch/csrc/match_topk2_colmax.cu",
                               "vit_colmap_tpu/ops/pallas/match_kernel.py:340",
                               match_err),
    }
    kernels = []
    for name, (source, replaces, err) in sources.items():
        t = times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": max(t["bound_ops_ms"], t["bound_bytes_ms"]),
            "bound_by": "operations" if t["bound_ops_ms"] >= t["bound_bytes_ms"] else "bytes",
            "library_ms": t["library_ms"],
        })
    log(f"done: build {build_s:.1f} s, database {db_counts}, rates {rates}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
