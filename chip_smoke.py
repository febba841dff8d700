#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vit_colmap_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one flushed line each with elapsed seconds:

1. device: the card's name, power limit and maximum SM clock (nvidia-smi)
   and torch's name;
2. build: the port's CUDA kernels from the sources here, one nvcc per source,
   all started together, then one link; the attention kernels' SASS
   (``cuobjdump -sass`` of the built library) is counted, and the bf16 body
   must multiply on the tensor cores (HGMMA) and load by TMA (UTMALDG); the
   fp32 matcher body's registers and spills (``-Xptxas -v``, no spill
   allowed) and its main loop's FFMA, shared loads and asynchronous copies
   (LDGSTS or UTMALDG, one at least) are counted too; so are the int8
   matcher's (kernel 5): no spill, IGMMA or IMMA in its main loop, an
   asynchronous copy in its body and no IDP4A;
3. kernels: each of the five kernels against its plain PyTorch version on
   the card, at the paths' shapes, in the working dtypes (and kernels 1 and
   3 also in f32, on their SIMT body), the matchers also at descriptor
   widths 256 and 384; known-wrong variants of the attention plain versions
   against the same bounds (each must fail them), "last column wins"
   variants of the matchers' plain versions on inputs with ties (each must
   differ), and the float similarity summed in reverse order of d (it must
   fail the bit-equality of kernels 2 and 4); kernel 5 also with
   coefficients that are not powers of two, beside its epilogue with alpha *
   acc + beta * (s1 + s2) contracted into one FMA (it must differ);
   ``get_pair_matcher`` on
   256-wide descriptors (kernel 2) and 200-wide ones (the matmul matcher);
4. slice: the port's main path through ``Pipeline.run`` -- frozen DINOv2
   ViT-B/14 (random weights from a seed) on 8 synthetic 1190 x 1596 PNGs,
   4096 keypoints, COLMAP database, exhaustive matching of the 28 pairs in
   one batch, verification and reconstruction skipped -- then checks of the
   database and of kernels 1 and 2 against the plain path, and of the
   saliency keypoints against the CPU's at PyTorch's default precision
   flags (the script sets none);
5. paths: the slice's other entry points on the same images and weights:
   (a) ``ViTExtractor(attn_impl="fixedmax")`` extraction into a database
   (kernel 3), (b) ``match_exhaustive`` of that database with
   ``cross_check=False`` (kernel 4), (c) the two-pass cross-check
   (``fused_cross=False``) against the fused one, (d)
   ``prepare_int8_descriptors`` + ``match_pairs_int8`` on the database's
   uint8 descriptors (kernel 5);
6. times: CUDA-event medians of each kernel, its plain version and one
   PyTorch library call computing the same function (kernels 1 and 3 also
   in f32), each kernel's mean over calls run back to back beside its
   median (logged only), the attention bound split into
   tensor-core, SFU (exp2) and byte times, kernel 5's epilogue floor (its
   main loop's instructions per similarity from the SASS over the dispatch
   and pipe rates), the bare fp32 ``torch.bmm`` beside kernels 2 and 4 with
   the SM clock and power that nvidia-smi reads while kernel 2 runs back to
   back, and the pipeline's extraction / matching rates on a second, warm run.

Every path (the main one and each of 5a-5d) is driven with the kernels'
launch counts set to 0 just before it and read just after; each kernel must
have launched on its path, and the kernels it replaces must not have.

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
# Attention launches of one extraction: the PCA fit over the 8 images, then
# extraction, each in batches of IMAGE_BATCH, 12 layers per backbone pass.
BACKBONE_LAYERS = 12 * 2 * math.ceil(NUM_IMAGES / IMAGE_BATCH)
MATCH_BATCHES = math.ceil(NUM_PAIRS / PAIR_BATCH)
TOKENS = 1 + (HEIGHT // 14) * (WIDTH // 14)  # 9,691

# Published H100 SXM peaks (dense): bf16 tensor cores, fp32 outside them,
# HBM bandwidth.  Bounds are stated against these at the card's power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# exp2 results per SM per clock on the SFU (CUDA's throughput table for
# compute capability 9.0) and the card's SMs; the SFU time of the attention
# kernels is stated at the SM clock nvidia-smi reads as the card's maximum.
SFU_PER_SM_CLOCK = 16
SMS = 132

# Kernel 1 and its plain version do the same bf16 roundings and differ in
# f32 sum order and exp2 ulps, so their bf16 outputs differ by at most about
# one ulp (2^-8 to 2^-7 relative).  Bound: max |kernel - plain| <=
# ATTN_ULPS * 2^-8 * max |plain|.
ATTN_ULPS = 4
# Kernels 2, 4 and 5 repeat their plain versions' float operations in order:
# identical indices and bit-equal best / second.
# Descriptor widths checked beside the main path's 128, each at (P, N, M):
# N is ragged in both, M in the second.
WIDE_SHAPES = {256: (3, 1000, 1024), 384: (3, 1000, 1000)}
# Kernel 5's (alpha, beta, gamma) for the check that a contracted epilogue
# fails: with the encodings' coefficients every operation before "* inv1"
# is exact integer arithmetic below 2^24, so a contraction would change no
# bit there; these make every rounding count.
ODD_COEF = (0.7071068, 1.3717421, 0.5773503)
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

# Known-wrong variants of kernels 1 and 3 whose readings passed a bound they
# must fail: collected, and raised at the end so that one run shows them all.
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


def back_to_back_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls run back to back
    between one pair of CUDA events.  The host's work before each launch
    (the wrapper's checks and allocations, a launcher's tensor maps)
    overlaps the card's work of the call before, where ``cuda_ms`` counts
    it; logged beside ``cuda_ms``, which the kernels line keeps."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn) -> dict:
    """A kernel's ``ms`` (``cuda_ms``) and ``back_to_back_ms``."""
    return {"ms": cuda_ms(fn, 10), "b2b_ms": back_to_back_ms(fn, 10)}


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


def nvidia_smi(query: str) -> str:
    smi = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"


def device_phase():
    """The card's name and power limit, torch's name for it, and its
    maximum SM clock in MHz."""
    import torch

    card = nvidia_smi("name,power.limit")
    max_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    kind = torch.cuda.get_device_name(0)
    log(f"device: {card} | max SM clock {max_mhz:.0f} MHz | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {kind} x{torch.cuda.device_count()}")
    return card, kind, max_mhz


def build_phase():
    from vit_colmap_tpu_torch.kernels import build

    t = time.perf_counter()
    build.library()
    seconds = time.perf_counter() - t
    sources = sorted(p.name for p in build.CSRC_DIR.glob("*.cu"))
    log(f"build: {', '.join(sources)} (5 kernels), one nvcc per source in "
        f"parallel and one link, {seconds:.1f} s")
    return seconds


# SASS opcodes counted in the attention kernels and in the fp32 matcher
# body of the built library.
SASS_OPS = ("HGMMA", "UTMALDG", "MUFU.EX2", "FFMA", "SYNCS", "BAR")
MATCH_SASS_OPS = ("FFMA", "LDS", "LDGSTS", "UTMALDG", "BAR", "SHFL")


def sass_counts(lines, ops=SASS_OPS) -> dict:
    import re

    lines = list(lines)
    return {op: sum(bool(re.search(rf"\b{re.escape(op)}\b", x)) for x in lines)
            for op in ops}


def ptxas_report(source: str) -> dict:
    """Registers and spill bytes (stores + loads) of each kernel of
    ``csrc/<source>``, keyed by mangled name, from the build's
    ``-Xptxas -v`` output."""
    import re

    from vit_colmap_tpu_torch.kernels import build

    out, name = {}, None
    for line in build.log_path(source).read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line)):
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


def main_loop(instructions, needs=(("HGMMA",),), body: str = "bf16 attention body"):
    """The instructions of the innermost loop that holds, for each group of
    opcodes in ``needs``, one of them: the backward branch of smallest span
    whose range holds them and no EXIT (the out-of-line retries of barrier
    waits branch back across the exits)."""
    import re

    sites = [[a for a, x in instructions if any(op in x for op in group)]
             for group in needs]
    exits = [a for a, x in instructions if re.search(r"\bEXIT\b", x)]
    loops = []
    for addr, text in instructions:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    loops = [(lo, hi) for lo, hi in loops
             if all(any(lo <= a <= hi for a in s) for s in sites)
             and not any(lo <= a <= hi for a in exits)]
    check(bool(loops), f"{body}: no loop holds {needs}")
    lo, hi = min(loops, key=lambda r: r[1] - r[0])
    return lo, hi, [x for a, x in instructions if lo <= a <= hi]


def sass_phase():
    """Opcode counts of the two attention bodies in the built library
    (``cuobjdump -sass``), and of the bf16 body's main loop.  The bf16 body
    must multiply on the tensor cores (HGMMA, in its main loop) and receive
    its tiles by TMA (UTMALDG)."""
    import re

    from vit_colmap_tpu_torch.kernels import build

    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.BUILD_DIR / build.LIBRARY_NAME)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    bodies, body = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            body = next((b for b in ("hopper", "simt") if f"{b}16attention_kernel" in name),
                        None)
            if body is None and "match_topk2_kernel" in name:  # ILb1E: kColmax
                body = "match_topk2_colmax" if "ILb1E" in name else "match_topk2"
            if body is None and "match_topk2_int8_kernel" in name:  # ILi128E: D = 128
                body = "match_topk2_int8" if "ILi128E" in name else "match_topk2_int8_runtime"
            if body:
                bodies[body] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*)", line)
        if body and m:
            bodies[body].append((int(m.group(1), 16), m.group(2)))
    check(set(bodies) == {"hopper", "simt", "match_topk2_colmax", "match_topk2",
                          "match_topk2_int8", "match_topk2_int8_runtime"},
          f"attention and matcher bodies in the SASS: {sorted(bodies)}")
    counts = {b: sass_counts(x for _, x in ins) for b, ins in bodies.items()
              if b in ("hopper", "simt")}
    lo, hi, loop = main_loop(bodies["hopper"])
    counts["hopper_main_loop"] = sass_counts(loop)
    check(counts["hopper_main_loop"]["HGMMA"] > 0 and counts["hopper"]["UTMALDG"] > 0,
          f"bf16 attention body without HGMMA in its main loop or UTMALDG: {counts}")
    log(f"sass: attention opcode counts (cuobjdump -sass): bf16 body {counts['hopper']}, "
        f"its main loop ({hex(lo)}-{hex(hi)}, {len(loop)} instructions) "
        f"{counts['hopper_main_loop']}; f32 body {counts['simt']}")
    counts["matcher"] = matcher_sass(bodies)
    ptxas = ptxas_report("match_topk2_int8.cu")
    for name in ("match_topk2_int8", "match_topk2_int8_runtime"):
        info = next((v for k, v in ptxas.items() if "match_topk2_int8_kernel" in k
                     and ("ILi128E" in k) == (name == "match_topk2_int8")), {})
        counts[name] = int8_body_check(name, bodies[name], info)
        c = counts[name]
        log(f"sass: {name} body (ptxas -v): {info['registers']} registers, "
            f"{info['spill_bytes']} spill bytes; opcodes {c['body']}; main loop "
            f"({c['main_loop_range'][0]}-{c['main_loop_range'][1]}, "
            f"{c['main_loop_range'][2]} instructions) {c['main_loop']}")
    return counts


# Kernel 5 (csrc/match_topk2_int8.cu): opcodes counted in its bodies; its
# main loop must multiply on the tensor cores (IGMMA or IMMA), its body
# must receive tiles by an asynchronous copy (UTMALDG or LDGSTS), and no
# IDP4A (the SIMT dot product it replaced) may be left.
INT8_SASS_OPS = ("IGMMA", "IMMA", "IDP4A", "UTMALDG", "LDGSTS", "I2FP", "FADD", "FMUL",
                 "FFMA", "FMNMX", "FSETP", "SEL", "IADD3", "LDS", "BAR")
# Dispatch slots per SM and clock (4 schedulers x 32 lanes), and lanes per SM
# and clock of the pipes the int8 epilogue uses (CUDA's throughput table for
# compute capability 9.0): fp32 add / multiply; integer add, compare,
# min / max and select.  __int2float_rn compiles to I2FP.F32.S32 on this
# card, which the measured times show is not held to the multi-function
# unit's I2F rate: it is counted with the ALU ops (an assumption; no table
# lists it).
DISPATCH_PER_SM_CLOCK = 128
EPILOGUE_PIPES = {
    "fp32": (128, ("FADD", "FMUL", "FFMA")),
    "alu": (64, ("FMNMX", "FSETP", "FSEL", "SEL", "IADD3", "VIADD", "LOP3", "ISETP",
                 "SHF", "MOV", "IMAD", "LEA", "PRMT", "I2FP")),
}


def opcode(text: str) -> str:
    """The mnemonic of one SASS instruction, without predicate or
    modifiers: '@!P0 FMNMX.FTZ R1, ...' -> 'FMNMX'."""
    import re

    m = re.match(r"\s*(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", text)
    return m.group(1) if m else ""


def int8_body_check(name: str, instructions, ptxas_info: dict) -> dict:
    """Kernel 5's checks on one body, ``instructions`` as (address, text)
    pairs of ``cuobjdump -sass``: ptxas reports 0 spill bytes, the main loop
    (the innermost loop around an IGMMA or IMMA) exists, the body holds an
    asynchronous copy and no IDP4A.  Returns the opcode counts of the body
    and of its main loop, and the main loop's opcodes by mnemonic."""
    from collections import Counter

    check("registers" in ptxas_info and ptxas_info.get("spill_bytes") == 0,
          f"{name} body: ptxas reports {ptxas_info} (0 spill bytes required)")
    whole = sass_counts((x for _, x in instructions), INT8_SASS_OPS)
    check(whole["IDP4A"] == 0, f"{name} body: {whole['IDP4A']} IDP4A left")
    check(whole["UTMALDG"] + whole["LDGSTS"] > 0, f"{name} body: no asynchronous copy")
    lo, hi, loop = main_loop(instructions, needs=(("IGMMA", "IMMA"),), body=f"{name} body")
    return {**ptxas_info, "body": whole, "main_loop": sass_counts(loop, INT8_SASS_OPS),
            "main_loop_range": [hex(lo), hex(hi), len(loop)],
            "main_loop_opcodes": dict(Counter(opcode(x) for x in loop))}


def epilogue_floor(loop_opcodes: dict, similarities: float, mhz: float,
                   tile_k_steps: int = 128 // 32) -> dict:
    """Kernel 5's epilogue floor from its D = 128 main loop: the loop's
    instructions per similarity (a trip of ``t`` tiles is t x 64 similarities
    a thread; a tile is ``tile_k_steps`` IGMMA k32 steps), times
    ``similarities``, over the dispatch rate and over each pipe's rate at
    ``mhz``; the floor is the largest of these times."""
    mma = loop_opcodes.get("IGMMA", 0) + loop_opcodes.get("IMMA", 0)
    per_thread = 64 * mma / tile_k_steps
    per_sim = {"dispatch": sum(loop_opcodes.values()) / per_thread}
    ms = {"dispatch": similarities * per_sim["dispatch"] / DISPATCH_PER_SM_CLOCK}
    for pipe, (rate, ops) in EPILOGUE_PIPES.items():
        per_sim[pipe] = sum(loop_opcodes.get(op, 0) for op in ops) / per_thread
        ms[pipe] = similarities * per_sim[pipe] / rate
    ms = {k: v / (SMS * mhz * 1e6) * 1e3 for k, v in ms.items()}
    return {"per_similarity": per_sim, "ms": ms, "floor_ms": max(ms.values()),
            "bound_by": max(ms, key=ms.get)}


def matcher_sass(bodies: dict) -> dict:
    """The fp32 matcher body (kernels 2 and 4, two instantiations of
    ``csrc/match_topk2.cu``): registers and spill bytes from ptxas (no spill
    allowed), and the opcode counts of each body and of its main loop (the
    innermost loop that holds FFMA and an asynchronous copy, LDGSTS or
    UTMALDG, which it must have)."""
    ptxas = {("match_topk2_colmax" if "ILb1E" in k else "match_topk2"): v
             for k, v in ptxas_report("match_topk2.cu").items()
             if "match_topk2_kernel" in k}
    out = {}
    for name in ("match_topk2_colmax", "match_topk2"):
        info = ptxas.get(name, {})
        check("registers" in info and info.get("spill_bytes") == 0,
              f"{name} body: ptxas reports {info} (0 spill bytes required)")
        lo, hi, loop = main_loop(bodies[name], needs=(("FFMA",), ("LDGSTS", "UTMALDG")),
                                 body=f"{name} body")
        whole = sass_counts((x for _, x in bodies[name]), MATCH_SASS_OPS)
        in_loop = sass_counts(loop, MATCH_SASS_OPS)
        check(whole["LDGSTS"] + whole["UTMALDG"] > 0, f"{name} body: no asynchronous copy")
        out[name] = {**info, "body": whole, "main_loop": in_loop,
                     "main_loop_range": [hex(lo), hex(hi), len(loop)]}
        log(f"sass: {name} body (ptxas -v): {info['registers']} registers, "
            f"{info['spill_bytes']} spill bytes; opcodes {whole}; main loop "
            f"({hex(lo)}-{hex(hi)}, {len(loop)} instructions) {in_loop}: "
            f"{in_loop['FFMA'] / max(in_loop['LDS'], 1):.1f} FFMA per LDS")
    return out


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


def split_heads(qkv, num_heads: int):
    """(B, N, 3*D) packed qkv -> q, k, v as (B, H, N, 64) views."""
    B, N, _ = qkv.shape
    return qkv.reshape(B, N, 3, num_heads, 64).permute(2, 0, 3, 1, 4)


def heads_tail_dropped(q, k, v, sm_scale: float):
    """Known-wrong kernels 1 and 3: the plain arithmetic with the last,
    ragged kv tile of 64 rows left out."""
    import torch

    from vit_colmap_tpu_torch.kernels import attention

    N = q.shape[2]
    keep = N - (N % 64 or 64)
    out = torch.empty_like(q)
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            qs = (q[b, h].float() * (sm_scale * attention.LOG2E)).to(q.dtype).float()
            p = torch.exp2(torch.clamp_max(qs @ k[b, h, :keep].float().T,
                                           attention.CLAMP))
            p = p.to(torch.bfloat16).float()
            out[b, h] = ((p @ v[b, h, :keep].float()) / p.sum(-1, keepdim=True)).to(q.dtype)
    return out


def wrong_tail_dropped(qkv, num_heads: int, sm_scale: float):
    """Known-wrong kernel 1: the last, ragged kv tile left out."""
    B, N, three_d = qkv.shape
    out = heads_tail_dropped(*split_heads(qkv, num_heads), sm_scale)
    return out.transpose(1, 2).reshape(B, N, three_d // 3)


def wrong_kernels(batch: int):
    """The known-wrong variants that apply to a batch of ``batch`` images."""
    wrong = {"no log2e": wrong_no_log2e, "last kv tile dropped": wrong_tail_dropped}
    if batch > 1:
        wrong["image 0 for all"] = wrong_first_image
    return wrong


def attention_check(B: int, N: int, H: int, seed: int, dtype: str = "bfloat16"):
    """Kernel 1 on packed ``dtype`` qkv against its plain version, and its
    known-wrong variants against the same bound."""
    import torch

    from vit_colmap_tpu_torch.kernels import attention

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    qkv = torch.randn(B, N, 3 * 64 * H, generator=g, device=DEVICE)
    qkv = qkv.to(getattr(torch, dtype))
    out = attention.attention_qkv(qkv, H, 64**-0.5)
    sync()
    ref = attention.attention_qkv_plain(qkv, H, 64**-0.5).float()
    bound = ATTN_ULPS * 2.0**-8 * ref.abs().max().item()
    err = (out.float() - ref).abs().max().item()
    label = f"{dtype} B={B} N={N}"
    check(math.isfinite(err) and err <= bound,
          f"attention_qkv ({label}, H={H}): max err {err} > {bound}")
    log(f"kernels: attention_qkv {label} heads={H}: max |kernel - plain| "
        f"{err:.3g} <= {bound:.3g} ({ATTN_ULPS} x 2^-8 x max |plain|)")
    for name, fn in wrong_kernels(B).items():
        wrong = (fn(qkv, H, 64**-0.5).float() - ref).abs().max().item()
        log(f"kernels: known-wrong '{name}' {label}: max |wrong - plain| "
            f"{wrong:.3g} (must exceed {bound:.3g})")
        if not wrong > bound:
            POWERLESS.append(f"attention {label} '{name}': {wrong} <= {bound}")
    return err


def wrong_heads_no_log2e(q, k, v, sm_scale: float):
    """Known-wrong kernel 3: q scaled without log2(e)."""
    from vit_colmap_tpu_torch.kernels import attention

    return attention.fixed_max_attention_plain(q, k, v, sm_scale / attention.LOG2E)


def wrong_head_zero(q, k, v, sm_scale: float):
    """Known-wrong kernel 3: every head gets head 0's output (a per-head
    offset left out)."""
    from vit_colmap_tpu_torch.kernels import attention

    out = attention.fixed_max_attention_plain(q[:, :1], k[:, :1], v[:, :1], sm_scale)
    return out.expand(-1, q.shape[1], -1, -1)


WRONG_HEAD_MAJOR = {"no log2e": wrong_heads_no_log2e,
                    "head 0 for all": wrong_head_zero,
                    "last kv tile dropped": heads_tail_dropped}


def head_major_check(B: int, H: int, N: int, d: int, seed: int,
                     dtype: str = "bfloat16"):
    """Kernel 3 on head-major ``dtype`` q, k, v against its plain version,
    and its known-wrong variants against the same bound."""
    import torch

    from vit_colmap_tpu_torch.kernels import attention

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q, k, v = (torch.randn(B, H, N, d, generator=g, device=DEVICE)
               .to(getattr(torch, dtype)) for _ in range(3))
    out = attention.fixed_max_attention(q, k, v, d**-0.5)
    sync()
    ref = attention.fixed_max_attention_plain(q, k, v, d**-0.5).float()
    bound = ATTN_ULPS * 2.0**-8 * ref.abs().max().item()
    err = (out.float() - ref).abs().max().item()
    label = f"{dtype} (B={B}, H={H}, N={N}, d={d})"
    check(math.isfinite(err) and err <= bound,
          f"fixed_max_attention {label}: max err {err} > {bound}")
    log(f"kernels: fixed_max_attention {label}: max |kernel - plain| {err:.3g} "
        f"<= {bound:.3g} ({ATTN_ULPS} x 2^-8 x max |plain|)")
    for name, fn in WRONG_HEAD_MAJOR.items():
        wrong = (fn(q, k, v, d**-0.5).float() - ref).abs().max().item()
        log(f"kernels: known-wrong '{name}' {label}: max |wrong - plain| "
            f"{wrong:.3g} (must exceed {bound:.3g})")
        if not wrong > bound:
            POWERLESS.append(f"fixed_max_attention {label} '{name}': {wrong} <= {bound}")
    return err


def last_column_wins(sim):
    """Known-wrong row argmax: the last maximal column instead of the first."""
    import torch

    return (sim.shape[1] - 1 - torch.argmax(torch.flip(sim, [1]), dim=1)).int()


def match_inputs(P: int, N: int, M: int, seed: int, integer: bool = False, D: int = 128):
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    if integer:  # every dot product exact: ties everywhere (d1's rows rolled)
        d1 = torch.randint(-2, 3, (P, N, D), generator=g, device=DEVICE).float()
        d2 = d1[:, (torch.arange(M, device=DEVICE) - N // 2) % N].contiguous()
    else:
        d1 = torch.nn.functional.normalize(
            torch.randn(P, N, D, generator=g, device=DEVICE), dim=-1)
        d2 = torch.nn.functional.normalize(
            torch.randn(P, M, D, generator=g, device=DEVICE), dim=-1)
    v1 = torch.rand(P, N, generator=g, device=DEVICE) < 0.9
    v2 = torch.rand(P, M, generator=g, device=DEVICE) < 0.9
    return d1, d2, v1, v2


def reversed_chain(plain, d1, d2, *rest):
    """Known-wrong kernels 2 and 4: their plain version with each similarity
    summed over d = D-1..0 (both descriptors reversed along d), the order a
    retiled kernel that split or reordered d would drift to."""
    return plain(d1.flip(-1).contiguous(), d2.flip(-1).contiguous(), *rest)


def reversed_shown(name: str, out, wrong, label: str) -> None:
    """The reversed-order variant must fail the bit-equality of best/second."""
    n_diff = sum(int((a != b).sum()) for a, b in zip(out[:2], wrong[:2]))
    log(f"kernels: known-wrong 'reversed FMA chain' {name} {label}: {n_diff} "
        f"best/second differ (must be > 0)")
    if n_diff == 0:
        POWERLESS.append(f"{name} {label} 'reversed FMA chain': bit-equal")


def match_check(inputs, label: str, reverse: bool = False):
    """Kernel 2 against its plain version: identical best_idx and col_row,
    bit-equal best / second; with ``reverse`` the reversed-order variant
    must fail that."""
    from vit_colmap_tpu_torch.kernels import match

    out = match.match_topk2_colmax(*inputs)
    ref = match.topk2_colmax_plain(*inputs)
    n_diff = int((out[3] != ref[3]).sum())
    check(n_diff == 0, f"match_topk2_colmax {label}: {n_diff} col_row differ")
    err = exact_check("match_topk2_colmax", out[:3], ref[:3], label)
    if reverse:
        reversed_shown("match_topk2_colmax", out,
                       reversed_chain(match.topk2_colmax_plain, *inputs), label)
    return err


def u8_inputs(P: int, N: int, M: int, seed: int, ties: bool = False, D: int = 128):
    """uint8 descriptors and masks; with ``ties`` every row of q1 appears
    twice in q2, so exact ties abound."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q1 = torch.randint(0, 256, (P, N, D), generator=g, device=DEVICE).to(torch.uint8)
    if ties:
        q2 = torch.repeat_interleave(torch.roll(q1, N // 4, dims=1), 2, dim=1)[:, :M]
    else:
        q2 = torch.randint(0, 256, (P, M, D), generator=g, device=DEVICE).to(torch.uint8)
    v1 = torch.rand(P, N, generator=g, device=DEVICE) < 0.9
    v2 = torch.rand(P, M, generator=g, device=DEVICE) < 0.9
    return q1, q2.contiguous(), v1, v2


def int8_operands(q1, q2, v1, v2, encoding: str = "signed"):
    from vit_colmap_tpu_torch.ops.matching import prepare_int8_descriptors

    a1, s1, i1, coef = prepare_int8_descriptors(q1, v1, encoding)
    a2, s2, i2, _ = prepare_int8_descriptors(q2, v2, encoding)
    return a1, a2, s1, s2, i1, i2, coef


def exact_check(name: str, out, ref, label: str) -> float:
    """Identical indices and bit-equal best / second; returns the largest
    |kernel - plain| of best / second (0 when the check passes)."""
    import torch

    for part, a, b in zip(("best", "second", "best_idx"), out, ref):
        n_diff = int((a != b).sum())
        check(n_diff == 0 and torch.equal(a, b), f"{name} {label}: {n_diff} {part} differ")
    log(f"kernels: {name} {label}: indices identical, best/second bit-equal")
    return max((a - b).abs().max().item() for a, b in zip(out[:2], ref[:2]))


def ties_shown(name: str, best_idx, sims, label: str) -> None:
    """The tie input must tell the first-column rule from the last."""
    n_diff = sum(int((last_column_wins(sim) != best_idx[p]).sum())
                 for p, sim in enumerate(sims))
    log(f"kernels: {name} {label}: 'last column wins' differs on {n_diff} rows")
    check(n_diff > 0, f"{name} {label}: no ties ('last column wins' agrees)")


def topk2_checks():
    """Kernel 4 on random and integer-tie inputs."""
    import torch

    from vit_colmap_tpu_torch.kernels import match

    n = MAX_KEYPOINTS
    d1, d2, _, v2 = match_inputs(PAIR_BATCH, n, n, seed=5)
    out = match.match_topk2(d1, d2, v2)
    label = f"random {PAIR_BATCH}x{n}x{n}"
    err = exact_check("match_topk2", out, match.topk2_plain(d1, d2, v2), label)
    reversed_shown("match_topk2", out, reversed_chain(match.topk2_plain, d1, d2, v2), label)
    d1, d2, _, v2 = match_inputs(4, n, n, seed=6, integer=True)
    out = match.match_topk2(d1, d2, v2)
    err = max(err, exact_check("match_topk2", out, match.topk2_plain(d1, d2, v2),
                               f"integer ties 4x{n}x{n}"))
    sims = (torch.where(v2[p][None], match.similarity_plain(d1[p], d2[p]), -2.0)
            for p in range(d1.shape[0]))
    ties_shown("match_topk2", out[2], sims, "integer ties")
    return err


def contracted_int8_plain(a1, a2, s1, s2, inv1, inv2, coef):
    """Known-wrong kernel 5: its plain version with alpha * acc + beta * (s1
    + s2) contracted into one fused multiply-add (computed in f64, rounded
    once to f32), as nvcc would contract it without __fmul_rn / __fadd_rn."""
    import torch

    from vit_colmap_tpu_torch.kernels import match

    P, N, _ = a1.shape
    best, second, best_idx = match._row_results(P, N, a1.device)
    for p in range(P):
        f = (a1[p].double() @ a2[p].double().T).float()
        bs = coef[1] * (s1[p][:, None] + s2[p][None, :])
        dot = (coef[0].double() * f.double() + bs.double()).float() + coef[2]
        sim = dot * inv1[p][:, None] * inv2[p][None, :]
        sim = torch.where(inv2[p][None, :] > 0, sim, -2.0)
        best[p], second[p], best_idx[p] = match._row_top2(sim)
    return best, second, best_idx


def int8_checks():
    """Kernel 5 on random and duplicated-row uint8 inputs (signed), and on
    the random inputs with coefficients that are not powers of two, beside
    its known-wrong contracted variant, which must differ there."""
    import torch

    from vit_colmap_tpu_torch.kernels import match

    n = MAX_KEYPOINTS
    ops = int8_operands(*u8_inputs(PAIR_BATCH, n, n, seed=7))
    err = exact_check("match_topk2_int8", match.match_topk2_int8(*ops),
                      match.topk2_int8_plain(*ops), f"random {PAIR_BATCH}x{n}x{n}")
    a1, a2, s1, s2, i1, i2, _ = ops
    coef = torch.tensor(ODD_COEF, device=DEVICE)
    odd = (a1, a2, s1, s2, i1, i2, coef)
    out = match.match_topk2_int8(*odd)
    label = f"random {PAIR_BATCH}x{n}x{n}, coef {coef.tolist()}"
    err = max(err, exact_check("match_topk2_int8", out, match.topk2_int8_plain(*odd),
                               label))
    wrong = contracted_int8_plain(*odd)
    n_diff = sum(int((a != b).sum()) for a, b in zip(out[:2], wrong[:2]))
    log(f"kernels: known-wrong 'contracted alpha * acc + beta * (s1 + s2)' "
        f"match_topk2_int8 {label}: {n_diff} best/second differ (must be > 0)")
    if n_diff == 0:
        POWERLESS.append(f"match_topk2_int8 {label} 'contracted FMA': bit-equal")
    ops = int8_operands(*u8_inputs(4, n, n, seed=8, ties=True))
    out = match.match_topk2_int8(*ops)
    err = max(err, exact_check("match_topk2_int8", out, match.topk2_int8_plain(*ops),
                               f"duplicated rows 4x{n}x{n}"))
    a1, a2, s1, s2, i1, i2, coef = ops
    sims = (match.int8_similarity_plain(a1[p], a2[p], s1[p], s2[p], i1[p], i2[p], coef)
            for p in range(a1.shape[0]))
    ties_shown("match_topk2_int8", out[2], sims, "duplicated rows")
    return err


def wide_checks() -> dict:
    """Kernels 2, 4 and 5 at the widths and shapes of ``WIDE_SHAPES`` on
    random and tie inputs, with the reversed-order variant on the random
    float inputs; then ``get_pair_matcher``'s dispatch by width."""
    from vit_colmap_tpu_torch.kernels import match

    errs = dict.fromkeys(("match_topk2_colmax", "match_topk2", "match_topk2_int8"), 0.0)
    for D, (P, N, M) in WIDE_SHAPES.items():
        for kind in ("random", "ties"):
            seed, label = D + len(kind), f"{kind} {P}x{N}x{M} D={D}"
            inputs = match_inputs(P, N, M, seed, integer=kind == "ties", D=D)
            random = kind == "random"
            errs["match_topk2_colmax"] = max(errs["match_topk2_colmax"],
                                             match_check(inputs, label, reverse=random))
            d1, d2, _, v2 = inputs
            out = match.match_topk2(d1, d2, v2)
            errs["match_topk2"] = max(errs["match_topk2"], exact_check(
                "match_topk2", out, match.topk2_plain(d1, d2, v2), label))
            if random:
                reversed_shown("match_topk2", out,
                               reversed_chain(match.topk2_plain, d1, d2, v2), label)
            ops = int8_operands(*u8_inputs(P, N, M, seed, ties=not random, D=D))
            errs["match_topk2_int8"] = max(errs["match_topk2_int8"], exact_check(
                "match_topk2_int8", match.match_topk2_int8(*ops),
                match.topk2_int8_plain(*ops), label))
    pair_matcher_widths()
    return errs


def pair_matcher_widths() -> None:
    """``get_pair_matcher()`` on the card: 256-wide descriptors go to kernel
    2, 200-wide ones to the matmul matcher (no kernel), each with the matmul
    matcher's matches on descriptors with many true matches."""
    import torch

    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.ops.matching import get_pair_matcher, match_pairs_batched

    g = torch.Generator(device=DEVICE).manual_seed(30)
    for D, expected in ((256, {"match_topk2_colmax": 1}), (200, {})):
        d1 = torch.nn.functional.normalize(
            torch.randn(2, 1024, D, generator=g, device=DEVICE), dim=-1)
        perm = torch.randperm(1024, generator=g, device=DEVICE)
        noise = 0.02 * torch.randn(2, 1024, D, generator=g, device=DEVICE)
        d2 = torch.nn.functional.normalize(d1[:, perm] + noise, dim=-1)
        v1, v2 = (torch.rand(2, 1024, generator=g, device=DEVICE) < 0.9 for _ in range(2))
        sync()
        counts.clear()
        out = get_pair_matcher()(d1, d2, v1, v2)
        sync()
        launches = dict(counts)
        expect_launches(launches, expected, f"get_pair_matcher D={D}")
        n_diff = int((out != match_pairs_batched(d1, d2, v1, v2)).sum())
        check(n_diff == 0, f"get_pair_matcher D={D}: {n_diff} rows differ from the "
              "matmul matcher")
        log(f"kernels: get_pair_matcher D={D}: launches {launches}, "
            f"{int((out >= 0).sum())} matches, identical to match_pairs_batched")


def slice_phase(work: Path):
    """The main path through Pipeline.run, counts reset just before."""
    from vit_colmap_tpu_torch.kernels import launches as counts
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

    sync()
    counts.clear()
    t = time.perf_counter()
    report = pipeline.run(img_dir, work / "out", work / "run1.db")
    sync()
    wall = time.perf_counter() - t
    launches = dict(counts)
    log(f"slice: Pipeline.run in {wall:.1f} s, report {report}, launches {launches}")
    expect_launches(launches, {"attention_qkv": BACKBONE_LAYERS,
                               "match_topk2_colmax": MATCH_BATCHES}, "main path")
    return pipeline, report, launches


def expect_launches(launches: dict, expected: dict, path: str) -> None:
    """Exactly the expected kernels launched on a path, as often as
    expected; every other kernel not at all."""
    for name in sorted(set(launches) | set(expected)):
        got, want = launches.get(name, 0), expected.get(name, 0)
        check(got == want, f"{path}: {name} launched {got} times, expected {want}")


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


def check_tokens(extractor, img_dir: Path, kernel: str, plain, wrong: dict,
                 phase: str):
    """Patch tokens of one image batch: the extractor's attention kernel
    (``kernel``, a function of ``kernels.attention``) against its plain
    version, and the known-wrong variants against the same bounds."""
    from unittest import mock

    import numpy as np

    from vit_colmap_tpu_torch.kernels import attention
    from vit_colmap_tpu_torch.utils.image_io import imread_rgb

    imgs = np.stack([imread_rgb(f) for f in sorted(img_dir.iterdir())[:IMAGE_BATCH]])

    def tokens(fn):
        with mock.patch.object(attention, kernel, fn):
            return extractor.dense_features(imgs)

    def errors(tok):
        diff = tok - plain_tok
        rms = (diff.square().mean().sqrt() / plain_tok.square().mean().sqrt()).item()
        return rms, (diff.abs().max() / plain_tok.abs().max()).item()

    kern = extractor.dense_features(imgs)
    plain_tok = tokens(plain)
    rms, rel = errors(kern)
    check(bool(kern.isfinite().all()) and rms <= TOKEN_RMS_TOL and rel <= TOKEN_MAX_TOL,
          f"patch tokens {kernel} vs plain: rms rel err {rms}, max rel err {rel}")
    log(f"{phase}: patch tokens {tuple(kern.shape)} {kernel} vs plain path: "
        f"rms rel err {rms:.3g} <= {TOKEN_RMS_TOL}, max rel err {rel:.3g} "
        f"<= {TOKEN_MAX_TOL}")
    # The dropped tail moves a few of 9,691 keys: the kernel check must see
    # it; the token map is not meant to, and its reading is only logged.
    for name, fn in wrong.items():
        w_rms, w_rel = errors(tokens(fn))
        must = name != "last kv tile dropped"
        log(f"{phase}: known-wrong '{name}' patch tokens: rms rel err {w_rms:.3g}, "
            f"max rel err {w_rel:.3g}" + (" (one must exceed its bound)" if must else ""))
        if must and not (w_rms > TOKEN_RMS_TOL or w_rel > TOKEN_MAX_TOL):
            POWERLESS.append(f"patch tokens {kernel} '{name}': rms {w_rms}, max {w_rel}")


def saliency_check(extractor, img_dir: Path):
    """Keypoints of one image batch's feature maps from the card's saliency
    and detection, with PyTorch's precision flags at their defaults, against
    the CPU's on the same maps: identical sets.  Then the same with the
    blurs' convolutions in TF32 (cuDNN's default, which the port overrides):
    how many keypoints that moves is logged."""
    import contextlib
    from unittest import mock

    import numpy as np
    import torch

    from vit_colmap_tpu_torch.ops import detect, scoring
    from vit_colmap_tpu_torch.utils.image_io import imread_rgb

    check(torch.backends.cudnn.allow_tf32,
          "saliency check: cuDNN's TF32 flag is not at PyTorch's default")
    imgs = np.stack([imread_rgb(f) for f in sorted(img_dir.iterdir())[:IMAGE_BATCH]])
    with torch.no_grad():
        fmap = extractor.dense_features(imgs).float()

    def keypoints(f):
        scores = scoring.compute_saliency(f, extractor.saliency)
        xy, _, valid = detect.detect_keypoints(
            scores, nms_radius=extractor.nms_radius, bin_size=extractor.bin_size,
            k_per_bin=extractor.k_per_bin, k_total=MAX_KEYPOINTS,
            nms_mode=extractor.nms_mode)
        return [set(map(tuple, xy[b][valid[b]].int().tolist()))
                for b in range(xy.shape[0])]

    @contextlib.contextmanager
    def tf32_convolutions():
        previous = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = previous

    def score_err(f):
        return (scoring.compute_saliency(f, extractor.saliency).cpu() - cpu_scores).abs().max().item()

    cpu = keypoints(fmap.cpu())
    cpu_scores = scoring.compute_saliency(fmap.cpu(), extractor.saliency)
    card = keypoints(fmap)
    moved = sum(len(c - r) for c, r in zip(card, cpu))
    err = score_err(fmap)
    with mock.patch.object(scoring, "exact_f32_convolutions", tf32_convolutions):
        tf32 = keypoints(fmap)
        tf32_err = score_err(fmap)
    tf32_moved = sum(len(c - r) for c, r in zip(tf32, cpu))
    total = sum(len(r) for r in cpu)
    check(moved == 0, f"saliency keypoints: {moved} of {total} differ from the CPU's")
    log(f"slice: saliency keypoints of {IMAGE_BATCH} images on the card at default "
        f"flags: {moved} of {total} differ from the CPU's (scores within {err:.3g}); "
        f"with TF32 blurs {tf32_moved} differ (scores within {tf32_err:.3g})")

    # The f32 patch embedding's convolution (ViTExtractor(dtype=f32)) on the
    # same images, in the port's exact f32 and in TF32, against the CPU's.
    from vit_colmap_tpu_torch.device import exact_f32_convolutions
    from vit_colmap_tpu_torch.features.vit_extractor import preprocess

    pe = extractor.model.patch_embed.proj
    x = preprocess(torch.as_tensor(imgs).to(DEVICE)).permute(0, 3, 1, 2).float()
    w, b = pe.weight.float(), pe.bias.float()
    ref = torch.nn.functional.conv2d(x.cpu(), w.cpu(), b.cpu(), stride=14)
    scale = ref.abs().max().item()
    with exact_f32_convolutions():
        exact = torch.nn.functional.conv2d(x, w, b, stride=14).cpu()
    with tf32_convolutions():
        loose = torch.nn.functional.conv2d(x, w, b, stride=14).cpu()
    embed = {"exact": (exact - ref).abs().max().item() / scale,
             "tf32": (loose - ref).abs().max().item() / scale}
    log(f"slice: f32 patch-embed convolution vs the CPU's, max |diff| / max |ref|: "
        f"{embed['exact']:.3g} exact f32, {embed['tf32']:.3g} in TF32")
    return {"keypoints": total, "differ": moved, "differ_tf32": tf32_moved,
            "score_err": err, "score_err_tf32": tf32_err,
            "patch_embed_rel_err": embed["exact"], "patch_embed_rel_err_tf32": embed["tf32"]}


def db_pairs(db_path: Path):
    """The database's uint8 descriptors padded to one power-of-two width
    >= 128 with validity masks, as the matching driver pads them, and every
    image pair with its stored matches."""
    import torch

    from vit_colmap_tpu_torch.database import ColmapDatabase

    with ColmapDatabase.open_database(db_path) as db:
        ids = sorted(db.read_images())
        descs = [db.read_descriptors(i) for i in ids]
        stored = {(a, b): db.read_matches(ids[a], ids[b])
                  for a in range(len(ids)) for b in range(a + 1, len(ids))}
    n = 128
    while n < max(len(d) for d in descs):
        n *= 2
    desc = torch.zeros(len(ids), n, 128, dtype=torch.uint8, device=DEVICE)
    valid = torch.zeros(len(ids), n, dtype=torch.bool, device=DEVICE)
    for i, d in enumerate(descs):
        desc[i, : len(d)] = torch.from_numpy(d).to(DEVICE)
        valid[i, : len(d)] = True
    pairs = list(stored)
    i1 = torch.tensor([p[0] for p in pairs], device=DEVICE)
    i2 = torch.tensor([p[1] for p in pairs], device=DEVICE)
    return desc[i1], desc[i2], valid[i1], valid[i2], stored


def check_matches(db_path: Path, plain_fn, label: str):
    """The database's matches against ``plain_fn`` (the plain path's
    matcher) on the same descriptors, decoded (signed) and normalized as
    pipeline/match.py does; returns the float inputs and the uint8 ones."""
    import numpy as np

    from vit_colmap_tpu_torch.ops.matching import normalize_descriptors

    q1, q2, v1, v2, stored = db_pairs(db_path)
    d1, d2 = (normalize_descriptors(q.float() / 127.5 - 1.0) for q in (q1, q2))
    inputs = (d1, d2, v1, v2)
    plain = plain_fn(*inputs).cpu().numpy()
    for k, (a, b) in enumerate(stored):
        rows = np.nonzero(plain[k] >= 0)[0]
        expect = np.stack([rows, plain[k][rows]], axis=1).astype(np.uint32)
        got = stored[(a, b)]
        got = np.zeros((0, 2), np.uint32) if got is None else got
        check(np.array_equal(got, expect),
              f"{label} pair {(a, b)}: {len(got)} kernel matches vs "
              f"{len(expect)} plain")
    log(f"{label}: matches of all {len(stored)} pairs identical to the plain path")
    return inputs, (q1, q2, v1, v2)


def plain_fused(d1, d2, v1, v2):
    from vit_colmap_tpu_torch.kernels import match

    return match.filter_matches(*match.topk2_colmax_plain(d1, d2, v1, v2), v1)


def plain_no_cross(d1, d2, v1, v2):
    from vit_colmap_tpu_torch.kernels import match

    return match.filter_matches(*match.topk2_plain(d1, d2, v2), None, v1,
                                cross_check=False)


def fixedmax_path(work: Path):
    """(a) ``ViTExtractor(attn_impl="fixedmax")`` extraction of the slice's
    images into a database: kernel 3 in every layer, kernel 1 nowhere."""
    from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor
    from vit_colmap_tpu_torch.kernels import attention
    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.utils.config import CameraConfig

    extractor = ViTExtractor(
        weights_path=str(work / "vitb14_random.pth"), backbone="vitb14",
        max_keypoints=MAX_KEYPOINTS, image_batch=IMAGE_BATCH,
        attn_impl="fixedmax", device=DEVICE,
    )
    camera = CameraConfig()
    sync()
    counts.clear()
    t = time.perf_counter()
    extractor.extract(work / "images", work / "fixedmax.db", camera.model, camera.params)
    sync()
    wall = time.perf_counter() - t
    launches = dict(counts)
    log(f"paths: (a) fixedmax extraction in {wall:.1f} s, launches {launches}")
    expect_launches(launches, {"fixed_max_attention": BACKBONE_LAYERS},
                    "(a) fixedmax extraction")
    check_tokens(extractor, work / "images", "fixed_max_attention",
                 attention.fixed_max_attention_plain, WRONG_HEAD_MAJOR, "paths: (a)")
    return extractor, launches


def matcher_paths(work: Path, extractor):
    """(b) match_exhaustive with cross_check=False, (c) the two-pass
    cross-check against the fused one, (d) the int8 matcher, each with the
    counts reset just before it."""
    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.kernels import match
    from vit_colmap_tpu_torch.pipeline.match import match_exhaustive
    from vit_colmap_tpu_torch.utils.config import MatchingConfig

    db = work / "fixedmax.db"
    config = MatchingConfig(cross_check=False, pair_batch=PAIR_BATCH,
                            do_verification=False, descriptor_encoding="signed")
    sync()
    counts.clear()
    stats = match_exhaustive(db, config, device_descriptors=extractor.device_cache,
                             device=DEVICE)
    sync()
    launches = {"b": dict(counts)}
    log(f"paths: (b) match_exhaustive cross_check=False: {stats.total_matches} "
        f"matches, launches {launches['b']}")
    expect_launches(launches["b"], {"match_topk2": MATCH_BATCHES},
                    "(b) cross_check=False matching")
    inputs, u8 = check_matches(db, plain_no_cross, "paths: (b)")

    fused = match.match_pairs(*inputs)
    sync()
    counts.clear()
    two_pass = match.match_pairs(*inputs, fused_cross=False)
    sync()
    launches["c"] = dict(counts)
    expect_launches(launches["c"], {"match_topk2": 2}, "(c) two-pass cross-check")
    n_diff = int((two_pass != fused).sum())
    check(n_diff == 0, f"(c) two-pass vs fused cross-check: {n_diff} rows differ")
    log(f"paths: (c) two-pass cross-check identical to the fused one on "
        f"{inputs[0].shape[0]} pairs ({int((fused >= 0).sum())} matches), "
        f"launches {launches['c']}")

    q1, q2, v1, v2 = u8
    ops = int8_operands(q1, q2, v1, v2, "signed")
    sync()
    counts.clear()
    int8 = match.match_pairs_int8(*ops, v1)
    sync()
    launches["d"] = dict(counts)
    expect_launches(launches["d"], {"match_topk2_int8": 2}, "(d) int8 matching")
    a1, a2, s1, s2, i1, i2, coef = ops
    plain = match.filter_matches(
        *match.topk2_int8_plain(*ops),
        match.topk2_int8_plain(a2, a1, s2, s1, i2, i1, coef)[2], v1)
    n_diff = int((int8 != plain).sum())
    check(n_diff == 0, f"(d) int8 matcher vs its plain version: {n_diff} rows differ")
    vs_float = int((int8 != fused).sum())
    log(f"paths: (d) int8 matcher identical to its plain version "
        f"({int((int8 >= 0).sum())} matches), launches {launches['d']}; "
        f"rows that differ from the float matcher: {vs_float} of {int8.numel()}")
    return launches, inputs, ops, vs_float


def times_phase(pipeline, work: Path, img_dir: Path, match_inputs_main,
                fixedmax_extractor, int8_ops, max_mhz: float, int8_loop: dict):
    import torch
    import torch.nn.functional as F

    from vit_colmap_tpu_torch.kernels import attention, match
    from vit_colmap_tpu_torch.utils.config import CameraConfig

    out = {}
    # Kernels 1 and 3 at the main path's shape: one batch of IMAGE_BATCH
    # images; kernel 3 on the permuted views the backbone passes it.
    B, N, D = IMAGE_BATCH, TOKENS, 64 * HEADS
    g = torch.Generator(device=DEVICE).manual_seed(7)
    qkv = torch.randn(B, N, 3 * D, generator=g, device=DEVICE).to(torch.bfloat16)
    qh, kh, vh = split_heads(qkv, HEADS)
    q, k, v = (t.contiguous() for t in (qh, kh, vh))
    attn_cost = {
        "flops": 4.0 * B * HEADS * N * N * 64,
        "bytes": qkv.numel() * 2 + B * N * D * 2,
        "peak": PEAK_BF16_FLOPS,
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10),
    }
    out["attention_qkv"] = {
        **kernel_ms(lambda: attention.attention_qkv(qkv, HEADS, 64**-0.5)),
        "plain_ms": cuda_ms(lambda: attention.attention_qkv_plain(qkv, HEADS, 64**-0.5), 3),
        **attn_cost,
    }
    out["fixed_max_attention"] = {
        **kernel_ms(lambda: attention.fixed_max_attention(qh, kh, vh, 64**-0.5)),
        "plain_ms": cuda_ms(
            lambda: attention.fixed_max_attention_plain(qh, kh, vh, 64**-0.5), 3),
        **attn_cost,
    }
    # The same shapes in f32 (the SIMT body), and the bf16 bound split: the
    # tensor-core time, the SFU time of the B * H * N^2 exp2 at the card's
    # maximum SM clock, and the bytes.
    qkv32, q32, k32, v32 = (t.float() for t in (qkv, qh, kh, vh))
    f32_ms = {
        "attention_qkv": cuda_ms(lambda: attention.attention_qkv(qkv32, HEADS, 64**-0.5), 3),
        "fixed_max_attention": cuda_ms(
            lambda: attention.fixed_max_attention(q32, k32, v32, 64**-0.5), 3),
    }
    split = {
        "mma_ms": attn_cost["flops"] / PEAK_BF16_FLOPS * 1e3,
        "sfu_ms": B * HEADS * N * N / (SFU_PER_SM_CLOCK * SMS * max_mhz * 1e6) * 1e3,
        "bytes_ms": attn_cost["bytes"] / PEAK_BYTES * 1e3,
        "max_sm_mhz": max_mhz,
    }
    log(f"times: attention bound split at ({B}, {N}, {HEADS} heads, 64) bf16: "
        f"tensor cores {split['mma_ms']:.3f} ms, SFU exp2 {split['sfu_ms']:.3f} ms "
        f"at {max_mhz:.0f} MHz, bytes {split['bytes_ms']:.4f} ms; f32 (SIMT body) "
        f"kernel 1 {f32_ms['attention_qkv']:.3f} ms, kernel 3 "
        f"{f32_ms['fixed_max_attention']:.3f} ms")
    # Kernels 2 and 4 at the main path's shape: the 28 pairs of the slice's
    # database descriptors (P, 4096, 128).
    d1, d2, v1, v2 = match_inputs_main
    P, Nm, Dm = d1.shape
    Mm = d2.shape[1]
    desc_bytes = (d1.numel() + d2.numel()) * 4 + v2.numel() + P * Nm * 12

    def library_topk2():
        sim = torch.bmm(d1, d2.transpose(1, 2))
        return torch.topk(sim.masked_fill(~v2[:, None, :], -2.0), 2, dim=-1)

    def library_match():
        sim = torch.bmm(d1, d2.transpose(1, 2))
        sim = sim.masked_fill(~v2[:, None, :], -2.0)
        top = torch.topk(sim, 2, dim=-1)
        col = sim.masked_fill(~v1[:, :, None], -2.0).argmax(dim=1)
        return top, col

    out["match_topk2_colmax"] = {
        **kernel_ms(lambda: match.match_topk2_colmax(d1, d2, v1, v2)),
        "plain_ms": cuda_ms(lambda: match.topk2_colmax_plain(d1, d2, v1, v2), 3),
        "library_ms": cuda_ms(library_match, 10),
        "flops": 2.0 * P * Nm * Mm * Dm,
        "bytes": desc_bytes + v1.numel() + P * Mm * 4,
        "peak": PEAK_FP32_FLOPS,
    }
    out["match_topk2"] = {
        **kernel_ms(lambda: match.match_topk2(d1, d2, v2)),
        "plain_ms": cuda_ms(lambda: match.topk2_plain(d1, d2, v2), 3),
        "library_ms": cuda_ms(library_topk2, 10),
        "flops": 2.0 * P * Nm * Mm * Dm,
        "bytes": desc_bytes,
        "peak": PEAK_FP32_FLOPS,
    }
    # Kernel 5 on the same database's uint8 descriptors (path (d)).
    a1, a2, s1, s2, i1, i2, coef = int8_ops

    def library_int8():  # one integer matmul per pair, then the epilogue
        tops = []
        for p in range(a1.shape[0]):
            acc = torch._int_mm(a1[p], a2[p].T).float()
            dot = coef[0] * acc + coef[1] * (s1[p][:, None] + s2[p][None, :]) + coef[2]
            sim = torch.where(i2[p][None, :] > 0, dot * i1[p][:, None] * i2[p][None, :],
                              -2.0)
            tops.append(torch.topk(sim, 2, dim=-1))
        return tops

    out["match_topk2_int8"] = {
        **kernel_ms(lambda: match.match_topk2_int8(*int8_ops)),
        "plain_ms": cuda_ms(lambda: match.topk2_int8_plain(*int8_ops), 3),
        "library_ms": cuda_ms(library_int8, 10),
        "flops": 2.0 * a1.shape[0] * a1.shape[1] * a2.shape[1] * a1.shape[2],
        "bytes": a1.numel() + a2.numel()
        + 4 * (s1.numel() + s2.numel() + i1.numel() + i2.numel()) + 12
        + a1.shape[0] * a1.shape[1] * 12,
        "peak": PEAK_INT8_OPS,
        # The epilogue's floor from the SASS of its main loop, at the card's
        # maximum SM clock: the kernel's time cannot go below it either.
        "epilogue": epilogue_floor(int8_loop, a1.shape[0] * a1.shape[1] * a2.shape[1],
                                   max_mhz),
    }

    # Warm end-to-end rates: a second Pipeline.run on the same pipeline, and
    # a second fixedmax extraction on the same extractor.
    sync()
    report = pipeline.run(img_dir, work / "out", work / "run2.db")
    sync()
    t = time.perf_counter()
    fixedmax_extractor.extract(img_dir, work / "fixedmax2.db", CameraConfig().model)
    sync()
    fixedmax_s = time.perf_counter() - t
    rates = {
        "extract_img_per_s": NUM_IMAGES / report["extract_s"],
        "match_pairs_per_s": NUM_PAIRS / report["match_verify_s"],
        "extract_match_pairs_per_s": NUM_PAIRS / (report["extract_s"] + report["match_verify_s"]),
        "extract_s": report["extract_s"],
        "match_s": report["match_verify_s"],
        "fixedmax_extract_img_per_s": NUM_IMAGES / fixedmax_s,
        "fixedmax_extract_s": fixedmax_s,
    }
    log(f"times: warm Pipeline.run and fixedmax extraction: {rates}")

    # After the warm run, so that only the kernel timings above run before
    # it and its rates compare between versions of the kernels: the bare
    # fp32 product (PyTorch's default, full fp32, no TF32), the practical
    # FMA ceiling of the card, and the SM clock and power that nvidia-smi
    # reads while kernel 2 runs back to back.
    bmm_ms = cuda_ms(lambda: torch.bmm(d1, d2.transpose(1, 2)), 10)
    held = sustained(lambda: match.match_topk2_colmax(d1, d2, v1, v2))
    for name, t in out.items():
        t["bound_ops_ms"] = t["flops"] / t["peak"] * 1e3
        t["bound_bytes_ms"] = t["bytes"] / PEAK_BYTES * 1e3
        bmm = f", bare fp32 bmm {bmm_ms:.3f} ms" if name in ("match_topk2_colmax",
                                                             "match_topk2") else ""
        floor = ""
        if "epilogue" in t:
            e = t["epilogue"]
            floor = (f", epilogue floor {e['floor_ms']:.3f} ms ({e['bound_by']}; ms by "
                     f"{ {k: round(v, 4) for k, v in e['ms'].items()} }, instructions per "
                     f"similarity { {k: round(v, 2) for k, v in e['per_similarity'].items()} })")
        log(f"times: {name}: kernel {t['ms']:.3f} ms (back to back {t['b2b_ms']:.3f} ms), "
            f"plain {t['plain_ms']:.3f} ms, "
            f"library {t['library_ms']:.3f} ms{bmm}, bound "
            f"{max(t['bound_ops_ms'], t['bound_bytes_ms']):.3f} ms{floor}")
    # Kernels 2 and 4's share of their fp32 bound, at the published peak
    # (1,980 MHz, the card's maximum SM clock) and at the clock held.
    mhz = statistics.median(held["mhz"]) if held["mhz"] else float("nan")
    matcher = {"bmm_ms": bmm_ms, "held_sm_mhz": held["mhz"], "power_w": held["watts"],
               "max_sm_mhz": max_mhz}
    for name in ("match_topk2_colmax", "match_topk2"):
        t = out[name]
        matcher[name] = {"share_of_bound": t["bound_ops_ms"] / t["ms"],
                         "share_at_held_clock": t["bound_ops_ms"] * max_mhz / mhz / t["ms"]}
    log(f"times: kernels 2 and 4 while kernel 2 runs back to back: SM clock "
        f"{held['mhz']} MHz, power {held['watts']} W; share of the fp32 bound "
        f"at {max_mhz:.0f} MHz / at the median held {mhz:.0f} MHz: kernel 2 "
        f"{matcher['match_topk2_colmax']['share_of_bound']:.1%} / "
        f"{matcher['match_topk2_colmax']['share_at_held_clock']:.1%}, kernel 4 "
        f"{matcher['match_topk2']['share_of_bound']:.1%} / "
        f"{matcher['match_topk2']['share_at_held_clock']:.1%}")
    return out, rates, split, f32_ms, matcher


def sustained(fn) -> dict:
    """nvidia-smi's SM clock (MHz) and power draw (W), six samples over
    about two seconds while ``fn`` runs back to back."""
    import threading

    samples = []

    def sample():
        for _ in range(6):
            samples.append(nvidia_smi("clocks.sm,power.draw"))
            time.sleep(0.3)

    sampler = threading.Thread(target=sample)
    sampler.start()
    while sampler.is_alive():
        for _ in range(10):
            fn()
        sync()
    sampler.join()
    mhz, watts = [], []
    for line in samples:
        try:
            clock, power = line.split(",")
            mhz.append(float(clock.split()[0]))
            watts.append(float(power.split()[0]))
        except ValueError:
            continue
    return {"mhz": mhz, "watts": watts}


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
    # No precision flag is set: the port's numerics must not depend on them.

    from vit_colmap_tpu_torch.kernels import attention

    card, kind, max_mhz = device_phase()
    build_s = build_phase()
    sass = sass_phase()

    errs = {
        "attention_qkv": max(attention_check(1, 1031, 2, seed=1),
                             attention_check(IMAGE_BATCH, TOKENS, HEADS, seed=2),
                             attention_check(1, 1031, 2, seed=1, dtype="float32")),
        "fixed_max_attention": max(head_major_check(1, 2, 1031, 40, seed=9),
                                   head_major_check(IMAGE_BATCH, HEADS, TOKENS, 64,
                                                    seed=10),
                                   head_major_check(1, 2, 1031, 40, seed=9,
                                                    dtype="float32")),
        "match_topk2_colmax": max(
            match_check(match_inputs(PAIR_BATCH, MAX_KEYPOINTS, MAX_KEYPOINTS, seed=3),
                        "random 28x4096x4096", reverse=True),
            match_check(match_inputs(4, MAX_KEYPOINTS, MAX_KEYPOINTS, seed=4, integer=True),
                        "integer ties 4x4096x4096")),
        "match_topk2": topk2_checks(),
        "match_topk2_int8": int8_checks(),
    }
    for name, err in wide_checks().items():
        errs[name] = max(errs[name], err)

    with tempfile.TemporaryDirectory(prefix="vit_colmap_smoke_") as tmp:
        work = Path(tmp)
        pipeline, report, main_launches = slice_phase(work)
        db_counts = check_database(work / "run1.db")
        extractor = next(iter(pipeline._extractors.values()))
        check_tokens(extractor, work / "images", "attention_qkv",
                     attention.attention_qkv_plain, wrong_kernels(IMAGE_BATCH), "slice")
        saliency = saliency_check(extractor, work / "images")
        inputs_main, _ = check_matches(work / "run1.db", plain_fused, "slice")
        fixedmax_extractor, fixedmax_launches = fixedmax_path(work)
        path_launches, _, int8_ops, int8_vs_float = matcher_paths(work, fixedmax_extractor)
        times, rates, split, f32_ms, matcher = times_phase(
            pipeline, work, work / "images", inputs_main, fixedmax_extractor, int8_ops,
            max_mhz, sass["match_topk2_int8"]["main_loop_opcodes"])
    check(not POWERLESS, "known-wrong kernels passed a check: " + "; ".join(POWERLESS))

    # name -> (source, TPU kernel it replaces, launches on its own path)
    kernel_rows = {
        "attention_qkv": ("vit_colmap_tpu_torch/csrc/fixed_max_attention.cu",
                          "vit_colmap_tpu/ops/pallas/attention_kernel.py:279",
                          main_launches),
        "fixed_max_attention": ("vit_colmap_tpu_torch/csrc/fixed_max_attention.cu",
                                "vit_colmap_tpu/ops/pallas/attention_kernel.py:147",
                                fixedmax_launches),
        "match_topk2_colmax": ("vit_colmap_tpu_torch/csrc/match_topk2.cu",
                               "vit_colmap_tpu/ops/pallas/match_kernel.py:340",
                               main_launches),
        "match_topk2": ("vit_colmap_tpu_torch/csrc/match_topk2.cu",
                        "vit_colmap_tpu/ops/pallas/match_kernel.py:91",
                        path_launches["b"]),
        "match_topk2_int8": ("vit_colmap_tpu_torch/csrc/match_topk2_int8.cu",
                             "vit_colmap_tpu/ops/pallas/match_kernel.py:192",
                             path_launches["d"]),
    }
    kernels = []
    for name, (source, replaces, launches) in kernel_rows.items():
        t = times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": max(t["bound_ops_ms"], t["bound_bytes_ms"]),
            "bound_by": "operations" if t["bound_ops_ms"] >= t["bound_bytes_ms"] else "bytes",
            "library_ms": t["library_ms"],
        })
    log(f"done: build {build_s:.1f} s, database {db_counts}, rates {rates}, "
        f"int8 rows differing from the float matcher {int8_vs_float}, saliency "
        f"{saliency}, attention bound split {split}, f32 attention ms {f32_ms}, "
        f"matcher times {matcher}, SASS {sass}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
