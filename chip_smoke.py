#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vit_colmap_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one flushed line each with elapsed seconds:

1. device: the card's name, power limit and maximum SM clock (nvidia-smi)
   and torch's name;
2. build: the port's CUDA kernels from the sources here, one nvcc per source,
   all started together, then one link, and the host C++ libraries (the
   database writer and the image decoder), one g++ each, started together;
   the attention kernels' SASS
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
   one batch, two-view verification, incremental reconstruction (timed and
   logged, no quality bar: the images are shifted copies of one texture)
   -- then checks
   of the database (every consecutive pair, one 16 px shift apart,
   verified as PLANAR_OR_PANORAMIC with inliers that follow the shift) and
   of kernels 1 and 2 against the plain path, and of the saliency
   keypoints against the CPU's at PyTorch's default precision flags (the
   script sets none);
5. paths: the slice's other entry points on the same images and weights:
   (a) ``ViTExtractor(attn_impl="fixedmax")`` extraction into a database
   (kernel 3), (b) ``match_exhaustive`` of that database with
   ``cross_check=False`` (kernel 4), (c) the two-pass cross-check
   (``fused_cross=False``) against the fused one, (d)
   ``prepare_int8_descriptors`` + ``match_pairs_int8`` on the database's
   uint8 descriptors (kernel 5);
   then calibrated verification, which the main path's uncalibrated pairs
   leave to arbitration: 63 synthetic pairs through
   ``estimate_two_view_batched`` on the card, some of its lanes on the CPU
   with the same uniforms, the card's results against the ground truth,
   a known-wrong Sampson error that must miss the bars, and the launches
   of one 5-point chunk (``torch.profiler``);
   then the mapper at the reference's 50-view scale: the correspondence
   form of the rendered 50-view scene (3,000 points on its three planes) as
   a verified database through ``incremental_mapping`` on the card, held to
   MAPPER_BARS against the ground truth, a known-wrong BA that must miss
   them, and the launches of one LM iteration of a global BA call; and
   the 12-view scene of
   ``tests/test_sfm_scale.py`` on the card twice and on the CPU once with
   the same PnP uniforms (card against CPU, and the two card runs bit for
   bit: BA's segment sums add in a fixed order);
   then SIFT and its scene: the rendered 50-view scene
   (``scripts/bench_reconstruction.py``'s protocol: 480 x 640, seed 7,
   the port's numpy renderer), ``extract_sift`` on two of its views on the
   card against the CPU (SIFT_SHARES) and a known-wrong variant whose
   descriptor angles are not rotated (it must miss a bar), SIFT's rates at
   480 x 640 and 1190 x 1596 and one call's launches (``torch.profiler``);
   the 50 views through ``Pipeline.run`` with SIFT, 2048 keypoints and
   the renderer's PINHOLE camera (kernel 2 on all 1,225 pairs, no other
   kernel), held to SCENE_BARS against the renderer's poses, with its
   stage seconds, and a known-wrong SIFT without the octave factor on the
   keypoints of octaves >= 1 that must miss a bar; then the YUV420 wire:
   both unpackers on the card against the CPU, a
   ``ViTExtractor(transfer_format="yuv420c4")`` extraction of the main
   path's 8 images into a database (kernel 1) on the studio-range host
   route (no native decoder for its first ``extract``: no native decode,
   full range off), its tokens against the rgb extractor's (cosine per
   token) and the two extractions' warm seconds;
   then the trainable ViT and the backbone remainder: ``Pipeline.run
   (extractor_type="trainable_vit")`` on the 8 images from a
   reference-layout ``.pt`` written here (BatchNorm heads with randomized
   running statistics, score logits spread to a standard deviation of 3,
   the slice's ViT-B/14 embedded), twice (kernel 1 in every layer, kernel 2
   once), with kernel 1's tokens against its plain version, the heads on
   the card against the reference heads on the CPU in f32, their keypoints
   against a plain selection on the CPU, the database (6-column keypoints,
   signed descriptors) and three known-wrong variants (the deconvolution
   not flipped, BatchNorm folded with var, offsets not x4); ViT-g/14 (one
   batch at full size: tokens against the plain version, block 0's SwiGLU
   against a plain CPU product and with its halves swapped, kernel 1 at 24
   heads); ViT-B/14 with 4 register tokens (tokens against the plain
   version, the first block's input against the CPU's and a known-wrong
   assembly); ``ViTExtractor(quantize="int8")`` on the 8 images (int32
   products of two layers bit for bit against the CPU, and with a
   per-tensor weight scale; tokens against the CPU's and against bf16's;
   warm rates beside bf16's in turns); and one ``Pipeline.run`` with a
   profile directory (a trace file and the three timer stages); then the
   hybrid: the 8 images through ``Pipeline.run(extractor_type="hybrid")``
   (OpenCV's SIFT detector in PyTorch on the card, ViT-B/14 descriptors,
   the main path's PCA loaded from a file: kernel 1 in every layer, kernel
   2 once), its tokens and matches against the plain versions, and each of
   the four detectors on one 1190 x 1596 image card against CPU (FAST and
   GFTT equal, SIFT and ORB within the bar) with its card milliseconds;
   serve: one ``PipelineServer`` (the vit extractor) on the 8 images, a
   copy of them and a plain file in place of a directory (results [True,
   True, False], one extractor built, kernel 1 96 times on the first job
   and 48 on the warm second); device loops: ``device_extract_pipelined``
   on the 8 staged images (the device rate) and ``device_extract_looped``'s
   checksum against separate calls; native-io: the host C++ libraries
   (both must load; the sonames ldd resolves; the JPEG codec is libjpeg or,
   without it, nvJPEG), the 8 PNGs through ``Pipeline.run`` with
   yuv420c4 twice on one extractor (the native route: 8 I420 decodes in
   C++, kernel 1 96 times; then the warm host route at full range: no
   native decode, 48 times; kernel 2 once and the native database writer
   each time), its tokens against the plain path, the decoder's I420
   against ``pack_yuv420_full`` of the same pixels, decode + pack and the
   extract stage native against the numpy route in turns, the 8 images
   written as JPEG (quality 95) through ``Pipeline.run`` with rgb and with
   yuv420c4 (registered images, verified pairs and matches beside the PNG
   run; the codec within a mean absolute error of 8 of the pixels it
   encoded), scene-50's database through ``match_exhaustive`` with the
   native writer and with ``ColmapDatabase`` in turns (equal rows; match
   and verify seconds, and the seconds spent in the writer), and the JPEG
   decode rate on 1, 2 and 8 threads;
6. times: CUDA-event medians of each kernel, its plain version and one
   PyTorch library call computing the same function (kernels 1 and 3 also
   in f32), each kernel's mean over calls run back to back beside its
   median (logged only), the attention bound split into
   tensor-core, SFU (exp2) and byte times, kernel 5's epilogue floor (its
   main loop's instructions per similarity from the SASS over the dispatch
   and pipe rates), the bare fp32 ``torch.bmm`` beside kernels 2 and 4 with
   the SM clock and power that nvidia-smi reads while kernel 2 runs back to
   back, and the pipeline's extraction / matching / verification /
   reconstruction times on a second, warm run;
7. train: the training stack (``vit_colmap_tpu_torch.training.train.main``)
   on an HPatches-layout tree written by ``generate_synthetic_hpatches`` at
   1200 x 1600 (2 illumination and 4 viewpoint sequences; the dataset
   gives 1190 x 1596), from the slice's random ViT-B/14 ``.pth``, at the
   reference's defaults (batch 4, top-k 512, 8 / 4 / 4 negatives,
   all_pairs, synthetic ratio 0.5, photometric 0.5): a few steps of one
   epoch and a validation pass, the same resumed from ``latest`` (the
   step count must continue), and a few steps of ``--train-backbone``
   (PyTorch's fused attention and its backward), each run held to its
   step count; per run the median step time of the warm steps, the peak
   memory above what was allocated before it and the loss components of
   the first and last steps; one fixed batch in f32 on the card against
   the CPU (loss components and heads gradients); then the fine-tuned
   ``best_model`` through ``Pipeline.run(extractor_type="trainable_vit")``
   on the slice's 8 images (kernel 1 in every backbone layer, kernel 2
   once), its matches and tokens against the plain versions;
8. parallel: ``parallel/`` on the one card as two mesh slots on it: (a) a
   two-slot ``ViTExtractor`` (the slice's PCA) on the 8 images, one image a
   slot in each batch (kernel 1 96 times, twice a batch's 12 a slot), and
   ``match_exhaustive`` over the slots (kernel 2 once a slot); the slice's
   database through the two-slot matcher gives the slice's matches bit for
   bit; (b) two images over two slots against each alone, bit for bit, and
   the largest token difference from the slice's batch of two (logged);
   (c) ``shard_descriptors`` over the slots gives the replicated rows bit
   for bit; (d) one training step over two slots against one slot on a
   batch of 4 of the train tree in f32 (loss components and heads
   gradients), and DDP's per-slot loss, which must miss the loss bound;
   (e) ``multihost.initialize`` from the environment contract, a world of
   one over NCCL, ``is_primary``, ``local_image_slice`` and one
   ``all_gather`` of a card tensor.  The native-io phase also holds the
   JPEG route to libjpeg's bytes of the committed ``tests/data/jpeg/``
   fixtures, per plane (``NVJPEG_BOUNDS``);
9. eval: the evaluation entry points with the slice's random weights, at
   their defaults (480 x 640, ViT-B/14, 2,048 keypoints) on a synthetic
   HPatches tree cut to one illumination and one viewpoint sequence of 4
   images (6 pairs): (a) ``scripts/torch_eval_hpatches.py``'s evaluation of
   sift, vit, trainable_vit and hybrid (kernel 1 in every layer of each
   unique image, kernel 2 once a pair), every pair's kernel-2 matches
   against plain ``match_pair`` on the card index for index, and the vit
   row against the CPU's on 2 pairs (``EVAL_CPU_*``); (b)
   ``scripts/torch_quality_bakeoff.py --extractors sift,vit,trainable_vit
   --train`` (1 epoch of 4 steps at batch 2, 8 rendered views): every row in
   QUALITY.json and QUALITY.md, the trained row loaded from the checkpoint
   it trained; (c) its reconstruction rows exported and compared
   (``torch_compare_metrics.py``) and aggregated
   (``torch_aggregate_results.py``), each report naming every row; the
   phase within ``EVAL_BUDGET_S``;
10. scripts: the remaining script entry points: (a)
   ``scripts/torch_bench_matching.py`` at its defaults (2,016 pairs of 64 x
   4,096 random descriptors, kernel 2 once a chunk of 16), two of its chunks
   and a chunk of matching descriptors against the plain matcher index for
   index; (b) ``torch_bench_trainstep.py`` (vitb14, batch 2 at 476 x 644;
   no kernel of the port) and its step sequence again from the same seeds,
   bit for bit; (c) ``torch_bench_serve.py`` at 480 x 640 and
   2,048 SIFT keypoints (kernel 2 once a matching chunk); (d)
   ``torch_sift_fidelity_table.py`` on its 8 cases against the committed
   cv2 rows (``tests/data/sift_fidelity/``), held to the reference's bars,
   and its two pinned-zoom rows, reported outside the means;
   (e) the three token visualisers' compute functions at vits14; (f)
   ``torch_diag_scene.py`` on a served scene's database; (g)
   ``torch_bisect_geometry.py`` with the trainable phase's checkpoint
   (kernel 1 in every backbone layer, kernel 2 once a matching chunk); the
   phase within ``SCRIPTS_BUDGET_S``.

Every path (the main one, each of 5a-5d, calibrated verification, the
mapper, SIFT, the 50-view scene, the wire, the trainable path, vitg14,
registers, int8, the hybrid, each serve job, the device loops, each
native-io run, the train path's Pipeline.run, each run of the parallel
phase, each extractor of the evaluation and the bake-off, each script of
the scripts phase) is driven with
the kernels'
launch counts set to 0 just before it and read just after; each kernel
must have launched on its path, and the kernels it replaces must not have
(verification, the mapper and SIFT launch none of the five).

It prints a ``{"kernels": [...]}`` line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line.  Any failed
check raises, and the script exits non-zero without that line.  It needs
one CUDA GPU, ``nvcc`` and ``g++``; without CUDA, or outside a checkout of the
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
from typing import Optional

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
# Consecutive synthetic images differ by 2 px at 1/8 scale along x.
SHIFT_PX = 16.0

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
# Both bounds are for TOKEN_DEPTH layers and grow linearly with the depth.
# With a correct kernel on an H100, ViT-B/14's 12 layers read about 0.55%
# rms and ViT-g/14's 40 layers 1.43% rms, 3.31% max: growth between the
# square root of the depth (1.0% at 40) and linear (1.83%), so linear is the
# upper model.  ViT-g/14's bounds, 3.33% and 11.7%, sit between its correct
# readings and its known-wrong ones (q without log2(e) 9.6% / 12.7%, image
# 0 for all 34% / 67%).
TOKEN_DEPTH = 12
# int8's per-tensor rounding turns a one-ulp difference near a rounding
# edge into a whole int8 step.  With a correct kernel on an H100, ViT-B/14's
# 12 int8 layers read 1.22% rms and 2.47% max against bf16's 0.55% and
# 1.61% in the same call, and the known-wrongs 5.1% / 7.2% (q without
# log2(e)) and 20% / 42% (image 0 for all).  int8's bounds are the
# others times this gain, 2.5% rms at 12 layers: the geometric mean of the
# correct and the no-log2e rms readings.
INT8_TOKEN_GAIN = 2.5
# The random backbone's q projections are scaled by this gain so that the
# attention logits have a standard deviation near 3 and each query attends
# to a few keys: with the plain init (std near 1) attention averages
# thousands of keys and the token map barely depends on it.
Q_GAIN = 3.0

# Known-wrong variants of kernels 1 and 3 whose readings passed a bound they
# must fail: collected, and raised at the end so that one run shows them all.
POWERLESS: list[str] = []

# Calibrated verification phase: scripts/ab_five_point.py's problems (640 x
# 480 images, focal 600 px, 512 correspondences, 0.6 px noise on the
# inliers, uniform outliers) at three inlier ratios, CAL_PAIRS_PER_RATIO
# pairs each, verified in one batch with both cameras calibrated.
CAL_RATIOS = (0.9, 0.5, 0.3)
CAL_PAIRS_PER_RATIO = 21
CAL_POINTS = 512
CAL_ITERS = 1024
# Lanes of each ratio that the CPU also verifies, on the card's uniforms.
CAL_CPU_LANES_PER_RATIO = 3
# The card and the CPU fit the same samples with other roundings, which can
# move points at the threshold or change which of two near-equal hypotheses
# a chunk keeps: each lane's config must agree, and its inlier count within
# CAL_BOUNDARY_POINTS.
CAL_BOUNDARY_POINTS = 8
# Ground-truth bars per inlier ratio: (least mean inlier recall, least
# CALIBRATED rate, largest median rotation error in degrees over the
# verified pairs).  Set below the JAX package's readings on the same
# problems, on the CPU:
#     python3 scripts/torch_verify_bars.py
# (recall 0.02 lower, CALIBRATED rate 0.15 lower, rotation error twice the
# reading plus 0.2 deg).  Its readings: recall 0.9995 / 0.9994 / 0.9685,
# CALIBRATED rate 1.0 / 1.0 / 0.857, median rotation error 0.370 / 0.622 /
# 0.972 deg at ratios 0.9 / 0.5 / 0.3.
CAL_BARS = {0.9: (0.979, 0.85, 0.94), 0.5: (0.979, 0.85, 1.44), 0.3: (0.948, 0.70, 2.14)}

# Mapper phase: the correspondence form of the JAX package's 50-view
# rendered scene (vit_colmap_tpu/dataloader/synthetic_benchmark.py:
# render_multiview_scene, the scene of scripts/bench_reconstruction.py
# --images 50): 50 cameras on a 0.35 rad arc, C = (2 sin a, 0.04 i,
# 5 - 5 cos a), 640 x 480, focal 600 px, looking at its three planes (a far
# backdrop and two slanted near planes, corners below).  MAPPER_POINTS points
# sampled on the planes by area; a view keeps a point when it projects into
# the image in front of the camera and no nearer plane hides it, then drops
# MAPPER_DROPOUT of them at random and adds MAPPER_NOISE_PX Gaussian noise;
# every pair of views sharing MAPPER_MIN_SHARED points is written as a
# verified CALIBRATED pair with those matches.
MAPPER_VIEWS = 50
MAPPER_POINTS = 3000
MAPPER_SIZE = (640, 480)
MAPPER_FOCAL = 600.0
MAPPER_ARC = 0.35
MAPPER_DROPOUT = 0.25
MAPPER_NOISE_PX = 0.4
MAPPER_MIN_SHARED = 20
ARC_PLANES = (
    ((-3.2, -2.4, 6.5), (3.2, -2.4, 6.5), (3.2, 2.4, 6.5), (-3.2, 2.4, 6.5)),
    ((-2.2, -1.5, 5.4), (0.2, -1.4, 4.6), (0.2, 1.4, 4.6), (-2.2, 1.5, 5.4)),
    ((0.3, -1.3, 4.4), (2.3, -1.5, 5.2), (2.3, 1.5, 5.2), (0.3, 1.3, 4.4)),
)
# Bars of the mapper phase against the ground truth: every view registered,
# at least MAPPER_BARS["points_share"] of the scene points seen by two views
# in the model, mean reprojection error and mean track length, and the
# poses through sfm/align.pose_errors_vs_gt (rotation in degrees, camera
# centre relative to the extent of the ground-truth centres).
MAPPER_BARS = {"registered": MAPPER_VIEWS, "points_share": 0.9, "reproj_px": 1.0,
               "track_length": 4.0, "rot_mean_deg": 0.1, "rot_max_deg": 0.3,
               "center_rel": 0.01}
# Bound on the BA Jacobian's rows on the card against central differences
# of its residuals in float64 (ba_jacobian_error): the largest row error
# ||J - J_fd|| / ||J_fd||.  f32 rounding gives about 1e-6 on this scene;
# the Jacobian of a perturbation on SO(3) is off by about half the camera's
# rotation angle in its rotation columns (up to 0.17 rad on the arc).
MAPPER_JACOBIAN_ERR = 1e-3
# Card against CPU: tests/test_sfm_scale.py's scene (12 views on a 0.55 rad
# arc, 800 points, 25% dropout, 0.4 px noise) with its configuration, run on
# the card and on the CPU with the same PnP uniforms (each mapper draws them
# on a CPU generator seeded 0): the same registered images, point counts
# within SCALE_POINTS_SHARE, rotations within SCALE_ROT_DEG degrees of each
# other and camera centres within SCALE_CENTER_REL of the scene's extent.
SCALE_VIEWS = 12
SCALE_POINTS = 800
SCALE_POINTS_SHARE = 0.02
SCALE_ROT_DEG = 0.05
SCALE_CENTER_REL = 1e-3


# The rendered 50-view scene: scripts/bench_reconstruction.py's protocol
# (render_multiview_scene at 480 x 640, seed 7, focal 0.94 x the longer
# side) through Pipeline.run with SIFT, 2048 keypoints and a PINHOLE camera
# at the renderer's K.  SCENE_BARS come from the JAX package's reading of
# these very views on the CPU (scripts/torch_recon_bars.py: 50/50
# registered, 0.392 px, rotation error 0.0341 deg mean and 0.103 max,
# centres 0.00137 of the extent), with margins: 2 views, twice the
# reprojection error, about 4x and 5x the rotation errors, 7x the centre
# error.  results/RECON_r5.json (OpenCV's pixels, a TPU: 0.385 px, 0.0383
# and 0.0905 deg, 0.00127) is a comparison, not a bar.
SCENE_VIEWS = 50
SCENE_SIZE = (480, 640)  # (height, width)
SCENE_FOCAL = 0.94 * max(SCENE_SIZE)
SCENE_SEED = 7
SCENE_KEYPOINTS = 2048
SCENE_BARS = {"registered": 48, "reproj_px": 0.8, "rot_mean_deg": 0.15,
              "rot_max_deg": 0.5, "center_rel_mean": 0.01}
# SIFT on the card against the port's CPU path on two of the scene's views
# (sift_agreement): the CPU's keypoints with a card keypoint within SIFT_TOL
# px in position and scale, of those the ones within SIFT_TOL rad in
# orientation too, and over those pairs the descriptor bytes within 1
# level (the 99% with which tests/test_torch_sift.py holds the port's CPU
# path to the JAX package; the largest byte difference is logged).
# Orientation has the lowest bar: the card's and the CPU's atan2, exp and
# convolutions differ in their last bits, and where two histogram bins
# nearly tie that moves the peak to the neighbour bin.
SIFT_VIEWS = (0, 25)
SIFT_TOL = 0.01
SIFT_SHARES = {"position": 0.99, "orientation": 0.97, "descriptor": 0.99}
# The wire phase: unpacking on the card against the CPU (f32 RGB in
# [0, 255]), and dense tokens of the yuv420c4 wire against rgb's (the
# bars of tests/test_transfer.py::test_backbone_features_agree_across_formats).
WIRE_UNPACK_TOL = 1e-3
WIRE_COS_MEAN = 0.97
WIRE_COS_MIN = 0.8

# The trainable path: a reference-layout checkpoint whose score logits
# spread to a standard deviation of TRAINABLE_LOGIT_STD (with the seeded
# heads they would sit within a few tenths of 0, and keypoint choice would
# be rounding noise).  The heads on the card in f32 against the reference
# heads on the CPU on a TRAINABLE_CROP patch crop of one image's features:
# each output's max |difference| within TRAINABLE_HEADS_TOL of its largest
# value (f32 sums in another order: about 1e-5); keypoints from them, the
# share of the CPU's within TRAINABLE_KP_TOL px of the card's.
TRAINABLE_LOGIT_STD = 3.0
TRAINABLE_CROP = (40, 56)
TRAINABLE_HEADS_TOL = 1e-3
TRAINABLE_KP_TOL = 0.01
TRAINABLE_KP_SHARE = 0.99
VITG_NAME = "vitg14"
REGISTERS = 4
# int8: the int32 products of a layer's first INT8_ROWS rows; tokens of one
# image cropped to INT8_CPU_HW (31 x 42 patches: kernel 1 on the card) on
# the card against the CPU, and int8 against bf16 at full size, held to
# per-token cosine bars (mean, min).  On the CPU at INT8_CPU_HW the int8
# tokens read 0.99991 / 0.9998 against bf16's and against int8 with eager
# attention; the bars sit below, above test_quantize.py's (0.995, 0.97).
INT8_ROWS = 2048
INT8_CPU_HW = (434, 588)
INT8_CPU_COS = (0.999, 0.99)
INT8_COS = (0.999, 0.99)

# The train phase: an HPatches-layout tree (TRAIN_SEQUENCES illumination and
# viewpoint sequences of TRAIN_IMAGES images at TRAIN_SIZE, which the
# dataset resizes to 1190 x 1596: 85 x 114 tokens), the trainer at the
# reference's defaults (vitb14, descriptor 128, batch 4, top-k 512, 8 / 4 / 4
# negatives, all_pairs, synthetic ratio 0.5, photometric 0.5) for
# TRAIN_STEPS steps and a validation pass, then the same resumed for
# TRAIN_STEPS more, then TRAIN_BB_STEPS of --train-backbone (batch
# TRAIN_BB_BATCH).  Validation takes TRAIN_VAL_FRACTION of the 27 samples
# (5: one batch of 4).  One fixed batch (two pairs of the tree at
# TRAIN_CHECK_HW, top-k TRAIN_CHECK_TOPK, the same uniforms) in f32 on the
# card against the CPU: each loss component within TRAIN_LOSS_TOL
# relative, each heads gradient within TRAIN_GRAD_TOL of its tensor's
# largest (f32 sums in another order, and the card's H^-1 moving points by
# up to 3e-5 px; a probe with fresh heads read 1.9e-7 and 7.5e-4); a
# known-wrong step whose homographies are not inverted for the transfer
# must miss the loss bound.

TRAIN_BACKBONE = "vitb14"
TRAIN_SEQUENCES = (2, 4)
TRAIN_IMAGES = 3
TRAIN_SIZE = (1200, 1600)
TRAIN_BATCH = 4
TRAIN_STEPS = 3
TRAIN_BB_STEPS = 3
TRAIN_BB_BATCH = 4
TRAIN_VAL_FRACTION = 0.2
TRAIN_CHECK_HW = (224, 294)
TRAIN_CHECK_TOPK = 128
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 3e-3


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


def profiled(fn) -> dict:
    """CUDA kernels the card ran, and the runtime's launch calls, in one
    call of ``fn`` (torch.profiler), synchronized."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    events = prof.key_averages()
    return {"kernels": sum(e.count for e in events if getattr(e, "device_type", None)
                           == torch.autograd.DeviceType.CUDA),
            "launch_calls": sum(e.count for e in events if e.key in (
                "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx"))}


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


def make_problem(rng, n_points, inlier_ratio, noise_px, w, h, focal):
    """A calibrated two-view pair (scripts/ab_five_point.py's generator):
    ``n_points`` pixel correspondences, round(n * ratio) of them projections
    of a rigid scene (+ noise), the rest uniform outliers, shuffled.
    Returns (pts1, pts2, R, inlier mask, K)."""
    import numpy as np

    aa = rng.standard_normal(3) * 0.25
    th = float(np.linalg.norm(aa))
    k = aa / max(th, 1e-9)
    K_ = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K_ + (1 - np.cos(th)) * K_ @ K_
    t = rng.standard_normal(3)
    t /= np.linalg.norm(t)
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])
    n_inl = int(round(n_points * inlier_ratio))
    pts1 = np.zeros((n_points, 2), np.float32)
    pts2 = np.zeros((n_points, 2), np.float32)
    got = 0
    while got < n_inl:  # 3D points seen inside both images
        X = np.stack([rng.uniform(-2, 2, 4 * n_inl), rng.uniform(-1.5, 1.5, 4 * n_inl),
                      rng.uniform(3, 9, 4 * n_inl)], axis=1)
        p1 = (K @ (X.T / X[:, 2])).T[:, :2]
        Xc = (R @ X.T).T + t
        p2 = (K @ (Xc.T / np.maximum(Xc[:, 2], 1e-6))).T[:, :2]
        ok = ((Xc[:, 2] > 0.1)
              & (p1[:, 0] >= 0) & (p1[:, 0] < w) & (p1[:, 1] >= 0) & (p1[:, 1] < h)
              & (p2[:, 0] >= 0) & (p2[:, 0] < w) & (p2[:, 1] >= 0) & (p2[:, 1] < h))
        take = min(n_inl - got, int(ok.sum()))
        pts1[got : got + take] = p1[ok][:take]
        pts2[got : got + take] = p2[ok][:take]
        got += take
    pts1[:n_inl] += rng.standard_normal((n_inl, 2)) * noise_px
    pts2[:n_inl] += rng.standard_normal((n_inl, 2)) * noise_px
    n_out = n_points - n_inl
    pts1[n_inl:] = np.stack([rng.uniform(0, w, n_out), rng.uniform(0, h, n_out)], axis=1)
    pts2[n_inl:] = np.stack([rng.uniform(0, w, n_out), rng.uniform(0, h, n_out)], axis=1)
    perm = rng.permutation(n_points)
    inl_mask = np.zeros(n_points, bool)
    inl_mask[:n_inl] = True
    return pts1[perm], pts2[perm], R.astype(np.float32), inl_mask[perm], K


def calibrated_problems(seed: int = 0) -> dict:
    """The calibrated phase's batch as numpy arrays: pts1, pts2 (P, N, 2),
    K (P, 3, 3), R (P, 3, 3), inlier (P, N) and ratio (P,), the lanes of
    each ratio in a row."""
    import numpy as np

    rng = np.random.default_rng(seed)
    probs, ratios = [], []
    for ratio in CAL_RATIOS:
        for _ in range(CAL_PAIRS_PER_RATIO):
            probs.append(make_problem(rng, CAL_POINTS, ratio, 0.6, 640, 480, 600.0))
            ratios.append(ratio)
    pts1, pts2, R, inl, K = (np.stack(a) for a in zip(*probs))
    return {"pts1": pts1, "pts2": pts2, "K": K.astype(np.float32), "R": R,
            "inlier": inl, "ratio": np.array(ratios)}


def rot_err_deg(R_gt, qvec) -> float:
    """Angle in degrees between R_gt and the rotation of quaternion qvec."""
    import numpy as np

    w, x, y, z = qvec
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    c = (np.trace(R_gt.T @ R) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def calibrated_quality(problems: dict, config, num_inliers, inlier_mask, qvec,
                       min_num_inliers: int = 15) -> dict:
    """Per inlier ratio: mean recall of the true inliers, the CALIBRATED
    (config 2) rate and the median rotation error of the verified pairs."""
    import numpy as np

    out = {}
    for ratio in CAL_RATIOS:
        lanes = np.nonzero(problems["ratio"] == ratio)[0]
        gt = problems["inlier"][lanes]
        recall = (inlier_mask[lanes] & gt).sum(1) / gt.sum(1)
        verified = [i for i in lanes if num_inliers[i] >= min_num_inliers]
        rot = [rot_err_deg(problems["R"][i], qvec[i]) for i in verified]
        out[ratio] = {"recall": float(recall.mean()),
                      "calibrated_rate": float((config[lanes] == 2).mean()),
                      "rot_err_med_deg": float(np.median(rot)) if rot else float("inf")}
    return out


def meets_bars(quality: dict) -> list[str]:
    """The bars of CAL_BARS that ``quality`` misses, as text."""
    missed = []
    for ratio, (recall, calibrated, rot) in CAL_BARS.items():
        q = quality[ratio]
        if q["recall"] < recall:
            missed.append(f"ratio {ratio}: recall {q['recall']:.4f} < {recall}")
        if q["calibrated_rate"] < calibrated:
            missed.append(f"ratio {ratio}: CALIBRATED rate {q['calibrated_rate']:.3f} "
                          f"< {calibrated}")
        if not q["rot_err_med_deg"] <= rot:
            missed.append(f"ratio {ratio}: median rotation error "
                          f"{q['rot_err_med_deg']:.3f} deg > {rot}")
    return missed


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
    perturb_backbone(model, cfg, g)
    torch.save(model.state_dict(), path)


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
    from vit_colmap_tpu_torch.kernels import build, host_build

    # Always one fresh build (the library is otherwise cached under a hash
    # of the sources, flags and nvcc), which library() then loads.
    t = time.perf_counter()
    build.build(build.cache_dir())
    build.library()
    seconds = time.perf_counter() - t
    sources = sorted(p.name for p in build.CSRC_DIR.glob("*.cu"))
    log(f"build: {', '.join(sources)} (5 kernels), one nvcc per source in "
        f"parallel and one link, {seconds:.1f} s")
    # The host C++ libraries (database writer, image decoder), one g++ each
    # started together, also built fresh.
    host = host_build.build_all(force=True)
    log(f"build: host libraries with g++ in parallel, seconds {host}, JPEG codec "
        f"{host_build.jpeg_codec()}")
    return seconds, host


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
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.cache_dir() / build.LIBRARY_NAME)],
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
    from vit_colmap_tpu_torch.database.native import writers
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
    pipeline = Pipeline(config, device=DEVICE)

    sync()
    counts.clear()
    writers.clear()
    t = time.perf_counter()
    report = pipeline.run(img_dir, work / "out", work / "run1.db")
    sync()
    wall = time.perf_counter() - t
    launches = dict(counts)
    log(f"slice: Pipeline.run in {wall:.1f} s, report {report}, launches {launches}, "
        f"database writers {dict(writers)}")
    check(writers == {"native": 1}, f"slice: bulk writes through {dict(writers)}, not the "
          "native writer")
    # No quality bar here: the 8 images are horizontal shifts of one random
    # texture seen by a random backbone (the mapper phase holds the mapper
    # to the ground truth).
    check(report["reconstruction_s"] > 0, "Pipeline.run skipped reconstruction")
    log(f"slice: reconstruction (no quality bar: shifted copies of one texture) "
        f"{report['reconstruction_s']} s, {report.get('registered_images', 0)} registered "
        f"images, {report.get('points3d', 0)} points, {len(pipeline.reconstructions)} models")
    expect_launches(launches, {"attention_qkv": BACKBONE_LAYERS,
                               "match_topk2_colmax": MATCH_BATCHES}, "main path")
    return pipeline, report, launches


def verified_pairs(db_path: Path) -> dict:
    """pair -> (config, inlier matches as bytes) of a database."""
    from vit_colmap_tpu_torch.database import ColmapDatabase

    with ColmapDatabase.open_database(db_path) as db:
        return {k: (g["config"], g["inlier_matches"].tobytes())
                for k, g in db.read_all_two_view_geometries().items()}


def model_sizes(recs: dict) -> list:
    return [(len(r.images), len(r.points3D)) for r in recs.values()]


def expect_launches(launches: dict, expected: dict, path: str) -> None:
    """Exactly the expected kernels launched on a path, as often as
    expected; every other kernel not at all."""
    for name in sorted(set(launches) | set(expected)):
        got, want = launches.get(name, 0), expected.get(name, 0)
        check(got == want, f"{path}: {name} launched {got} times, expected {want}")


def check_database(db_path: Path, label: str = "slice"):
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
    log(f"{label}: database {n_img} images, {n_kp} keypoints, {n_pairs} matched "
        f"pairs, {n_matches} matches; consecutive pairs {per_shift}")
    return {"images": n_img, "keypoints": n_kp, "matched_pairs": n_pairs,
            "matches": n_matches, **check_geometries(db_path, label)}


def check_geometries(db_path: Path, label: str = "slice") -> dict:
    """The main path's two-view geometries.  Consecutive images differ by
    one shift of SHIFT_PX along x (synthetic_images), a pure image
    translation: every consecutive pair must verify, as
    PLANAR_OR_PANORAMIC (a homography explains it), and its inliers must
    follow the shift: the median inlier's departure from it within the
    RANSAC threshold, the 90th percentile's within twice the threshold.
    Not every inlier: the random backbone's features sit on the 14 px patch
    grid, so matched keypoints move by 14 px give or take the sub-cell
    refinement; the inliers of F (which wins the inlier set unless H has
    more) are only held to the horizontal epipolar lines; and np.roll's
    wrap-around adds a few matches across the image."""
    import numpy as np

    from vit_colmap_tpu_torch.database import TWO_VIEW_CONFIG, ColmapDatabase
    from vit_colmap_tpu_torch.utils.config import MatchingConfig

    tol = MatchingConfig().ransac_max_error_px
    with ColmapDatabase.open_database(db_path) as db:
        ids = sorted(db.read_images())
        n_verified = db.num_verified_pairs
        pairs = []
        for a, b in zip(ids, ids[1:]):
            g = db.read_two_view_geometry(a, b)
            check(g is not None, f"consecutive pair {(a, b)} did not verify")
            inl = g["inlier_matches"]
            move = db.read_keypoints(b)[inl[:, 1], :2] - db.read_keypoints(a)[inl[:, 0], :2]
            off = np.linalg.norm(move - [SHIFT_PX, 0.0], axis=1)
            q50, q90 = (float(np.quantile(off, q)) if len(off) else np.inf for q in (0.5, 0.9))
            pairs.append((len(inl), round(q50, 2), round(q90, 2)))
            check(g["config"] == TWO_VIEW_CONFIG["PLANAR_OR_PANORAMIC"],
                  f"pair {(a, b)}: config {g['config']}, not PLANAR_OR_PANORAMIC")
            check(len(inl) >= MatchingConfig().min_num_inliers and q50 <= tol
                  and q90 <= 2 * tol,
                  f"pair {(a, b)}: {len(inl)} inliers depart from the {SHIFT_PX} px "
                  f"shift by {q50:.2f} px (median) and {q90:.2f} px (90th percentile); "
                  f"threshold {tol} px")
    log(f"{label}: two_view_geometries {n_verified} pairs; every consecutive pair "
        f"PLANAR_OR_PANORAMIC, (inliers, median and 90th-percentile departure in px "
        f"from the {SHIFT_PX} px shift) {pairs}")
    return {"verified_pairs": n_verified, "consecutive": pairs}


def check_tokens(extractor, img_dir: Path, kernel: str, plain, wrong: dict,
                 phase: str, depth: int = TOKEN_DEPTH, gain: float = 1.0):
    """Patch tokens of one image batch: the extractor's attention kernel
    (``kernel``, a function of ``kernels.attention``) against its plain
    version, and the known-wrong variants against the same bounds (those of
    a backbone ``depth`` layers deep, times ``gain``)."""
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

    rms_tol, max_tol = (tol * gain * depth / TOKEN_DEPTH
                        for tol in (TOKEN_RMS_TOL, TOKEN_MAX_TOL))
    kern = extractor.dense_features(imgs)
    plain_tok = tokens(plain)
    rms, rel = errors(kern)
    log(f"{phase}: patch tokens {tuple(kern.shape)} {kernel} vs plain path: "
        f"rms rel err {rms:.3g} (bound {rms_tol:.3g}), max rel err {rel:.3g} "
        f"(bound {max_tol:.3g})")
    # Every reading is logged before the check, so that one run shows them
    # all.  The dropped tail moves a few of 9,691 keys: the kernel check must
    # see it; the token map is not meant to, and its reading is only logged.
    for name, fn in wrong.items():
        w_rms, w_rel = errors(tokens(fn))
        must = name != "last kv tile dropped"
        log(f"{phase}: known-wrong '{name}' patch tokens: rms rel err {w_rms:.3g}, "
            f"max rel err {w_rel:.3g}" + (" (one must exceed its bound)" if must else ""))
        if must and not (w_rms > rms_tol or w_rel > max_tol):
            POWERLESS.append(f"patch tokens {kernel} '{name}': rms {w_rms}, max {w_rel}")
    check(bool(kern.isfinite().all()) and rms <= rms_tol and rel <= max_tol,
          f"{phase}: patch tokens {kernel} vs plain: rms rel err {rms}, max rel err {rel}")


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


def chunk_launches(pts1, pts2, mask, u, thresh) -> dict:
    """CUDA launches of one 5-point chunk (ops/ransac.multi_chunk: sample,
    solve, score, pick) on every lane, from torch.profiler: kernels the
    card ran, and the runtime's launch calls."""
    import torch

    from vit_colmap_tpu_torch.ops import ransac
    from vit_colmap_tpu_torch.sfm import geometry
    from vit_colmap_tpu_torch.sfm.five_point import fit_essential_5pt

    num_valid = mask.sum(-1, dtype=torch.int32)

    def chunk():
        ransac.multi_chunk(fit_essential_5pt, geometry.sampson_error, pts1, pts2, mask,
                           num_valid, u, 5, thresh)

    chunk()
    sync()
    counted = profiled(chunk)
    t = time.perf_counter()
    for _ in range(3):
        chunk()
    sync()
    return {**counted, "chunk_ms": (time.perf_counter() - t) / 3 * 1e3}


def verification_phase() -> dict:
    """Calibrated two-view verification, which the main path (no camera
    prior) leaves to F and H: CAL_RATIOS x CAL_PAIRS_PER_RATIO synthetic
    pairs through estimate_two_view_batched on the card, some lanes also on
    the CPU with the same uniforms (configs equal, inlier counts within
    CAL_BOUNDARY_POINTS), the card's results against the ground truth
    (CAL_BARS), and the Sampson error with the views swapped, which must
    miss a bar.  Counts set to 0 before: no kernel of the five runs."""
    from collections import Counter
    from unittest import mock

    import numpy as np
    import torch

    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.ops import ransac
    from vit_colmap_tpu_torch.sfm import geometry

    plain_sampson = geometry.sampson_error

    def swapped_sampson(F, pts1, pts2):  # known-wrong: the views swapped
        return plain_sampson(F, pts2, pts1)

    prob = calibrated_problems(seed=0)
    P = len(prob["ratio"])
    kw = dict(iters=CAL_ITERS, five_point=True, five_point_chunk=16)
    host = [torch.from_numpy(a) for a in (prob["pts1"], prob["pts2"],
                                          np.ones(prob["pts1"].shape[:2], bool),
                                          prob["K"], prob["K"], np.ones(P, bool))]
    uniforms = ransac.draw_uniforms(P, torch.Generator().manual_seed(7), **kw)
    card_args = [a.to(DEVICE) for a in host]
    card_u = ransac.RansacUniforms(*(x.to(DEVICE) for x in uniforms))

    def run(args, u, chunks=None):
        res = ransac.estimate_two_view_batched(*args, u, chunks=chunks, **kw)
        return {k: v.cpu().numpy() for k, v in res._asdict().items()}

    sync()
    counts.clear()
    chunks = Counter()
    t = time.perf_counter()
    card = run(card_args, card_u, chunks)
    card_s = time.perf_counter() - t
    expect_launches(dict(counts), {}, "calibrated verification")
    quality = calibrated_quality(prob, card["config"], card["num_inliers"],
                                 card["inlier_mask"], card["qvec"])
    missed = meets_bars(quality)
    check(not missed, "calibrated verification on the card: " + "; ".join(missed))
    log(f"verify: {P} calibrated pairs x {CAL_POINTS} points on the card in "
        f"{card_s:.2f} s, chunks {dict(chunks)}; against the ground truth per inlier "
        f"ratio {quality} (bars {CAL_BARS})")

    # The same uniforms on the CPU, for CAL_CPU_LANES_PER_RATIO lanes of
    # each ratio (a lane's result does not depend on its batchmates).
    lanes = np.concatenate([np.nonzero(prob["ratio"] == r)[0][:CAL_CPU_LANES_PER_RATIO]
                            for r in CAL_RATIOS])
    sub = torch.from_numpy(lanes)
    t = time.perf_counter()
    cpu = run([a[sub] for a in host], ransac.RansacUniforms(*(x[sub] for x in uniforms)))
    cpu_s = time.perf_counter() - t
    same_config = cpu["config"] == card["config"][lanes]
    diff = np.abs(cpu["num_inliers"].astype(int) - card["num_inliers"][lanes].astype(int))
    flags = (cpu["inlier_mask"] != card["inlier_mask"][lanes]).sum(1)
    check(same_config.all() and diff.max() <= CAL_BOUNDARY_POINTS,
          f"card vs CPU on lanes {lanes.tolist()}: configs {card['config'][lanes].tolist()} "
          f"vs {cpu['config'].tolist()}, inlier counts differ by {diff.tolist()} "
          f"(bound {CAL_BOUNDARY_POINTS})")
    log(f"verify: card vs CPU on {len(lanes)} lanes (CPU {cpu_s:.1f} s): configs equal, "
        f"inlier counts differ by at most {int(diff.max())} (bound "
        f"{CAL_BOUNDARY_POINTS}), inlier flags differ in {flags.tolist()}")

    with mock.patch.object(geometry, "sampson_error", swapped_sampson):
        wrong = run(card_args, card_u)
    wrong_quality = calibrated_quality(prob, wrong["config"], wrong["num_inliers"],
                                       wrong["inlier_mask"], wrong["qvec"])
    wrong_missed = meets_bars(wrong_quality)
    log(f"verify: known-wrong 'Sampson error with the views swapped' misses "
        f"{len(wrong_missed)} bars: {wrong_missed[:3]}")
    if not wrong_missed:
        POWERLESS.append(f"calibrated verification 'swapped Sampson': {wrong_quality}")

    # The chunk on normalized coordinates and the 4 px threshold, as
    # estimate_two_view_batched runs it (every camera: focal 600, centre
    # (320, 240)).
    K = card_args[3]
    p1n, p2n = ((pts - K[:, None, :2, 2]) / K[:, None, 0, 0, None]
                for pts in card_args[:2])
    thresh = 16.0 / K[:, 0, 0] ** 2
    per_chunk = chunk_launches(p1n, p2n, card_args[2], card_u.e5[:, 0], thresh)
    log(f"verify: one 5-point chunk ({P} lanes x 16 samples x 20 candidates): "
        f"{per_chunk}")
    return {"card_s": card_s, "chunks": dict(chunks), "quality": quality,
            "cpu_s": cpu_s, "max_count_diff": int(diff.max()),
            "five_point_chunk": per_chunk, "wrong_missed": len(wrong_missed)}


def arc_scene(n_views: int = MAPPER_VIEWS, n_points: int = MAPPER_POINTS, seed: int = 0):
    """The mapper phase's scene: ground-truth cameras [(R, t)], K, and per
    view the indices of the points it keeps with their noisy pixels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w, h = MAPPER_SIZE
    K = np.array([[MAPPER_FOCAL, 0, w / 2], [0, MAPPER_FOCAL, h / 2], [0, 0, 1]])
    planes = [np.array(c, np.float64) for c in ARC_PLANES]
    area = np.array([np.linalg.norm(np.cross(c[1] - c[0], c[3] - c[0])) for c in planes])
    which = rng.choice(len(planes), n_points, p=area / area.sum())
    a, b = rng.random((2, n_points, 1))
    c = np.stack(planes)[which]  # (n, 4, 3)
    X = ((1 - a) * (1 - b) * c[:, 0] + a * (1 - b) * c[:, 1] + a * b * c[:, 2]
         + (1 - a) * b * c[:, 3])
    cams, views = [], []
    for i in range(n_views):
        ang = (i - (n_views - 1) / 2) * (MAPPER_ARC / max(n_views - 1, 1))
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        C = np.array([2.0 * np.sin(ang), 0.04 * i, 5.0 - 5.0 * np.cos(ang)])
        t = -R @ C
        cams.append((R, t))
        Xc = X @ R.T + t
        xn = Xc[:, :2] / Xc[:, 2:]
        uv = xn * MAPPER_FOCAL + [w / 2, h / 2]
        keep = ((Xc[:, 2] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0)
                & (uv[:, 1] < h))
        for k, corners in enumerate(planes):  # hidden behind a nearer plane?
            cc = corners @ R.T + t
            q = cc[:, :2] / cc[:, 2:]
            edges = np.roll(q, -1, axis=0) - q
            rel = xn[:, None, :] - q[None]
            cross = edges[None, :, 0] * rel[..., 1] - edges[None, :, 1] * rel[..., 0]
            inside = (cross > 0).all(1) | (cross < 0).all(1)
            normal = np.cross(cc[1] - cc[0], cc[3] - cc[0])
            ray = np.concatenate([xn, np.ones((n_points, 1))], axis=1)
            depth = (normal @ cc[0]) / (ray @ normal)  # the plane's z on each ray
            keep &= ~(inside & (which != k) & (depth > 0) & (depth < Xc[:, 2] - 1e-6))
        keep &= rng.random(n_points) > MAPPER_DROPOUT
        idx = np.nonzero(keep)[0]
        views.append((idx, uv[idx] + MAPPER_NOISE_PX * rng.standard_normal((len(idx), 2))))
    return cams, K, views


def write_views_db(db_path: Path, K, size, views, min_shared: int) -> dict:
    """Views' keypoints and the verified pairs they share (CALIBRATED, the
    shared points as matches) as a COLMAP database; returns counts."""
    import numpy as np

    from vit_colmap_tpu_torch.database import TWO_VIEW_CONFIG, ColmapDatabase

    db = ColmapDatabase(db_path)
    cid = db.add_pinhole_camera(size[0], size[1], K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    ids = [db.add_image(f"view_{i:03d}.png", cid) for i in range(len(views))]
    local = []
    for iid, (idx, uv) in zip(ids, views):
        db.add_keypoints(iid, uv.astype(np.float32))
        local.append({int(g): k for k, g in enumerate(idx)})
    pairs = matches = 0
    for a in range(len(views)):
        for b in range(a + 1, len(views)):
            shared = np.intersect1d(views[a][0], views[b][0])
            if len(shared) < min_shared:
                continue
            m = np.array([[local[a][int(g)], local[b][int(g)]] for g in shared], np.uint32)
            db.add_matches(ids[a], ids[b], m)
            db.add_two_view_geometry(ids[a], ids[b], m,
                                     config=TWO_VIEW_CONFIG["CALIBRATED"])
            pairs += 1
            matches += len(m)
    db.commit()
    db.close()
    seen = np.bincount(np.concatenate([idx for idx, _ in views]))
    return {"pairs": pairs, "matches": matches, "points_in_two_views": int((seen >= 2).sum()),
            "observations": int(seen.sum())}


def gt_by_name(cams) -> dict:
    return {f"view_{i:03d}.png": (R, t) for i, (R, t) in enumerate(cams)}


def as_f64(rec):
    """The model with float64 quaternions, so that the oracle's rotation
    angles are not limited by an f32 trace (about 0.02 degrees)."""
    import copy

    import numpy as np

    out = copy.copy(rec)
    out.images = {iid: copy.copy(im) for iid, im in rec.images.items()}
    for im in out.images.values():
        im.qvec = np.asarray(im.qvec, np.float64)
    return out


def model_quality(recs: dict, cams, points_in_two_views: int) -> dict:
    """The largest model against the ground truth (MAPPER_BARS' terms)."""
    from vit_colmap_tpu_torch.sfm.align import pose_errors_vs_gt

    if not recs:
        return {"registered": 0, "points": 0, "points_share": 0.0, "reproj_px": None,
                "track_length": 0.0, "pose": None}
    rec = max(recs.values(), key=lambda r: len(r.images))
    pose = pose_errors_vs_gt(as_f64(rec), gt_by_name(cams))
    return {
        "models": len(recs), "registered": len(rec.images), "points": len(rec.points3D),
        "points_share": len(rec.points3D) / points_in_two_views,
        "reproj_px": rec.mean_reprojection_error(), "track_length": rec.mean_track_length(),
        "pose": None if pose is None else {k: v for k, v in pose.items() if k != "per_image"},
    }


def mapper_missed(q: dict) -> list[str]:
    b, pose = MAPPER_BARS, q["pose"]
    missed = []
    if q["registered"] < b["registered"]:
        missed.append(f"registered {q['registered']} < {b['registered']}")
    if q["points_share"] < b["points_share"]:
        missed.append(f"points share {q['points_share']:.3f} < {b['points_share']}")
    if q["reproj_px"] is None or q["reproj_px"] >= b["reproj_px"]:
        missed.append(f"mean reprojection error {q['reproj_px']} >= {b['reproj_px']} px")
    if q["track_length"] <= b["track_length"]:
        missed.append(f"mean track length {q['track_length']:.2f} <= {b['track_length']}")
    if pose is None:
        missed.append("fewer than 3 posed images")
    else:
        for key, bar in (("pose_rot_err_deg_mean", "rot_mean_deg"),
                         ("pose_rot_err_deg_max", "rot_max_deg"),
                         ("pose_center_err_rel_max", "center_rel")):
            if not pose[key] < b[bar]:
                missed.append(f"{key} {pose[key]:.4f} >= {b[bar]}")
    return missed


def ba_sizes(kw: dict) -> dict:
    return {k: kw[k] for k in ("n_img", "n_cam", "n_pts", "n_obs")}


def ba_launches(call) -> dict:
    """CUDA launches of the mapper's recorded global BA call (torch.profiler),
    replayed through bundle_adjust_packed with its points moved by 1% of
    their spread so that LM does not stop after one iteration: a call of
    one and a call of two LM iterations give the kernels of one iteration
    (their difference) and of the call's fixed part; also the runtime's
    launch calls and the two-iteration call's time without the profiler."""
    from unittest import mock

    import torch

    from vit_colmap_tpu_torch.sfm import bundle

    (fbuf, ibuf, bbuf), kw = call
    sizes = ba_sizes(kw)
    check(all(b.device.type == DEVICE for b in (fbuf, ibuf, bbuf)),
          "BA problem tensors not on the card")
    pts = bundle.unpack_ba_problem(fbuf, ibuf, bbuf, **sizes).points
    g = torch.Generator(device=pts.device).manual_seed(0)
    o = sizes["n_img"] * 6 + sizes["n_cam"] * 3
    fbuf = fbuf.clone()
    fbuf[o:o + pts.numel()] += (0.01 * pts.std(0) * torch.randn(
        pts.shape, generator=g, device=pts.device)).reshape(-1)
    kw = {k: v for k, v in kw.items() if k not in ("iters", "stats")}
    kernels, calls, lm = {}, {}, {}
    for iters in (1, 2):
        stats, out = {}, []
        counted = profiled(lambda: out.append(bundle.bundle_adjust_packed(
            fbuf, ibuf, bbuf, iters=iters, stats=stats, **kw)))
        check(out[0].device.type == DEVICE, "BA result not on the card")
        kernels[iters], calls[iters] = counted["kernels"], counted["launch_calls"]
        lm[iters] = stats["lm_iters"]
    check(lm == {1: 1, 2: 2}, f"LM stopped early in the profiled calls: {lm}")
    t = time.perf_counter()
    bundle.bundle_adjust_packed(fbuf, ibuf, bbuf, iters=2, **kw)
    sync()
    two_iter_s = time.perf_counter() - t

    # The cost of the deterministic segment sums: an LM iteration (a
    # two-iteration call less a one-iteration call) with them and with
    # index_add_ in their place, in turns (sorted, index_add_, index_add_,
    # sorted), each the median of 3 pairs of calls.
    def lm_iter_s() -> float:
        spans = []
        for _ in range(3):
            t1 = time.perf_counter()
            bundle.bundle_adjust_packed(fbuf, ibuf, bbuf, iters=1, **kw)
            sync()
            t2 = time.perf_counter()
            bundle.bundle_adjust_packed(fbuf, ibuf, bbuf, iters=2, **kw)
            sync()
            spans.append((time.perf_counter() - t2) - (t2 - t1))
        return statistics.median(spans)

    ab = {"sorted": [], "index_add": []}
    for variant in ("sorted", "index_add", "index_add", "sorted"):
        if variant == "sorted":
            ab[variant].append(lm_iter_s())
        else:
            with mock.patch.object(bundle, "_SegmentSums", AtomicSegmentSums):
                ab[variant].append(lm_iter_s())
    with mock.patch.object(bundle, "_SegmentSums", AtomicSegmentSums):
        atomic_kernels = profiled(lambda: bundle.bundle_adjust_packed(
            fbuf, ibuf, bbuf, iters=2, **kw))["kernels"]
    return {**sizes, "solver": kw.get("solver"),
            "reduced_size": 6 * sizes["n_img"] + 3 * sizes["n_cam"],
            "kernels_per_lm_iter": kernels[2] - kernels[1],
            "kernels_fixed": 2 * kernels[1] - kernels[2],
            "launch_calls_per_lm_iter": calls[2] - calls[1],
            "two_iter_call_s": two_iter_s,
            "lm_iter_s": {k: statistics.mean(v) for k, v in ab.items()},
            "lm_iter_s_turns": ab,
            "index_add_two_iter_kernels": atomic_kernels, "sorted_two_iter_kernels": kernels[2]}


class AtomicSegmentSums:
    """BA's segment sums as ``index_add_`` (float atomics on the card, in an
    order that changes from run to run), the way they were before they were
    made deterministic; only for the cost comparison of ``ba_launches``."""

    def __call__(self, key, data, ids, n):
        import torch

        flat = (ids() if callable(ids) else ids).reshape(-1)
        out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
        return out.index_add_(0, flat, data)


def ba_jacobian_error(call, huber_delta: float = 3.0) -> dict:
    """The BA's per-observation Jacobian rows (bundle._obs_jacobians) on the
    card for the mapper's recorded global BA problem, against central
    differences of its residuals (bundle._residuals) in float64 on the CPU,
    taken in the parameters LM updates additively (axis-angle, translation,
    log focal, k1 k2, point).  Each observation depends on one camera and
    one point, so moving one column of every camera (or point) at once
    gives that column of every row.  Rows whose residual is near the Huber
    threshold are left out (there the differences see the weight change,
    which the Gauss-Newton rows hold constant).  Returns the largest and
    the median row error ||J - J_fd|| / ||J_fd||."""
    import torch

    from vit_colmap_tpu_torch.device import exact_f32_matmuls
    from vit_colmap_tpu_torch.sfm import bundle

    (fbuf, ibuf, bbuf), kw = call
    p = bundle.unpack_ba_problem(fbuf, ibuf, bbuf, **ba_sizes(kw))
    with exact_f32_matmuls():
        J, r = bundle._obs_jacobians(p.cam_params, p.focal_log, p.dist, p.points, p,
                                     huber_delta)
    J = J.double().cpu()
    q = p._replace(**{k: getattr(p, k).cpu().double() if getattr(p, k).is_floating_point()
                      else getattr(p, k).cpu() for k in p._fields})
    params = [q.cam_params, q.focal_log[:, None], q.dist, q.points]
    columns = [(0, j) for j in range(6)] + [(1, 0)] + [(2, j) for j in range(2)] + [
        (3, j) for j in range(3)]
    h = 1e-6

    def residuals(which, j, step):
        moved = [x.clone() for x in params]
        moved[which][:, j] += step
        return bundle._residuals(moved[0], moved[1][:, 0], moved[2], moved[3], q, huber_delta)

    J_fd = torch.stack([(residuals(w, j, h) - residuals(w, j, -h)) / (2 * h)
                        for w, j in columns], dim=-1)  # (n_obs, 2, 12)
    r0 = bundle._residuals(*params[:1], params[1][:, 0], *params[2:], q, huber_delta)
    keep = torch.linalg.vector_norm(r0, dim=-1) < 0.5 * huber_delta
    err = (torch.linalg.vector_norm((J - J_fd)[keep], dim=(-2, -1))
           / torch.linalg.vector_norm(J_fd[keep], dim=(-2, -1)))
    return {"rows": int(keep.sum()), "of": int(keep.numel()), "max": float(err.max()),
            "median": float(err.median())}


def swapped_xy_ba(real):
    """Known-wrong BA: every observation read as (y, x)."""

    def wrong(fbuf, ibuf, bbuf, *, n_img, n_cam, n_pts, n_obs, **kw):
        o = n_img * 6 + n_cam * 3 + n_pts * 3
        fbuf = fbuf.clone()
        fbuf[o:o + 2 * n_obs] = fbuf[o:o + 2 * n_obs].view(n_obs, 2).flip(1).reshape(-1)
        return real(fbuf, ibuf, bbuf, n_img=n_img, n_cam=n_cam, n_pts=n_pts, n_obs=n_obs,
                    **kw)

    return wrong


def so3_rotation(real):
    """Known-wrong BA: the rotation as exp(d) R0 with the perturbation d
    differentiated at 0 and R0 held constant, so that the Gauss-Newton rows
    are those of a perturbation on SO(3) while LM still adds its step to
    the axis-angle vector.  The values are unchanged (exp(0) is the
    identity): only the Jacobian's rotation columns differ."""

    def wrong(aa):
        return real(aa - aa.detach()) @ real(aa.detach())

    return wrong


def mapper_phase(work: Path) -> dict:
    """The incremental mapper at the reference's 50-view scale on the card:
    the scene of arc_scene as a verified database, incremental_mapping with
    the default ReconstructionConfig, and the model against the ground
    truth (MAPPER_BARS); the BA and PnP calls' tensors on the card; the
    BA's Jacobian on the mapper's last global BA problem against central
    differences (MAPPER_JACOBIAN_ERR); two known-wrong BAs, observations
    read as (y, x) (a whole mapping, held to the bars) and the Jacobian of
    a perturbation on SO(3) (on the last global BA problem, held to the
    Jacobian bound), each of which must miss; and the launches of one LM
    iteration of the mapper's last global BA call.  Counts set to 0
    before: no kernel of the five runs."""
    from unittest import mock

    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.sfm import bundle, incremental
    from vit_colmap_tpu_torch.utils.config import ReconstructionConfig

    cams, K, views = arc_scene()
    t = time.perf_counter()
    scene = write_views_db(work / "arc.db", K, MAPPER_SIZE, views, MAPPER_MIN_SHARED)
    log(f"mapper: {MAPPER_VIEWS} views, {MAPPER_POINTS} points, database in "
        f"{time.perf_counter() - t:.1f} s: {scene}")

    devices, global_ba = set(), []

    def recording(real, ba: bool = False):
        def call(*args, **kw):
            out = real(*args, **kw)
            devices.add((real.__name__, out.device.type))
            if ba:  # keep the last call of the most images with one fixed
                n_fixed = int(args[2][kw["n_obs"]:kw["n_obs"] + kw["n_img"]].sum())
                if n_fixed == 1 and (not global_ba or kw["n_img"] >= global_ba[-1][1]["n_img"]):
                    global_ba[:] = [(tuple(a.clone() for a in args), dict(kw))]
            return out
        return call

    sync()
    counts.clear()
    mlog = {}
    t = time.perf_counter()
    with mock.patch.object(incremental, "bundle_adjust_packed",
                           recording(incremental.bundle_adjust_packed, ba=True)), \
            mock.patch.object(incremental, "pnp_ransac_packed",
                              recording(incremental.pnp_ransac_packed)):
        recs = incremental.incremental_mapping(work / "arc.db", work, work / "arc_sparse",
                                               ReconstructionConfig(), device=DEVICE, log=mlog)
    sync()
    secs = time.perf_counter() - t
    expect_launches(dict(counts), {}, "mapper")
    check(devices == {("bundle_adjust_packed", DEVICE), ("pnp_ransac_packed", DEVICE)},
          f"mapper BA / PnP results on {devices}")
    check(bool(global_ba), "the mapper made no global BA call")
    quality = model_quality(recs, cams, scene["points_in_two_views"])
    missed = mapper_missed(quality)
    check(not missed, "mapper on the card: " + "; ".join(missed))
    jac = ba_jacobian_error(global_ba[0])
    check(jac["max"] <= MAPPER_JACOBIAN_ERR,
          f"BA Jacobian on the card against central differences: {jac}")
    ba = mlog[0]["ba"]
    log(f"mapper: incremental_mapping in {secs:.1f} s on {DEVICE}: {quality} (bars "
        f"{MAPPER_BARS}); substep seconds "
        f"{ {k: round(v, 2) for k, v in mlog[0]['substeps'].items()} }; BA {ba['calls']} "
        f"calls, {ba['lm_iters']} LM iterations, {ba['syncs']} host syncs "
        f"({ba['lm_iters'] / ba['calls']:.1f} and {ba['syncs'] / ba['calls']:.1f} per call), "
        f"phase seconds asm {ba['asm']:.2f} solve {ba['solve']:.2f} readback "
        f"{ba['readback']:.2f}; Jacobian of the last global BA problem against central "
        f"differences {jac} (bound {MAPPER_JACOBIAN_ERR})")

    per_call = ba_launches(global_ba[0])
    log(f"mapper: the mapper's last global BA call (points moved by 1% of their "
        f"spread): {per_call}")

    # Known-wrong (y, x) observations run the whole mapping: only the bars
    # see them.  The SO(3) Jacobian changes nothing but the Jacobian (the
    # bars cannot see it: a whole mapping with it met every one), so
    # it runs at the depth of one problem, the mapper's last global BA.
    recorded = global_ba[0]
    wrong_missed = {}
    for name, target, variant in (
            ("BA reads observations as (y, x)", incremental, "bundle_adjust_packed"),
            ("BA Jacobian of a perturbation on SO(3)", bundle, "axis_angle_to_matrix")):
        whole = variant == "bundle_adjust_packed"
        make = swapped_xy_ba if whole else so3_rotation
        global_ba.clear()
        wlog, wrong_quality, bars = {}, "not mapped", []
        t = time.perf_counter()
        with mock.patch.object(target, variant, make(getattr(target, variant))):
            if whole:
                with mock.patch.object(incremental, "bundle_adjust_packed",
                                       recording(incremental.bundle_adjust_packed, ba=True)):
                    wrong = incremental.incremental_mapping(
                        work / "arc.db", work, work / "arc_wrong", ReconstructionConfig(),
                        device=DEVICE, log=wlog)
                wrong_quality = model_quality(wrong, cams, scene["points_in_two_views"])
                bars = mapper_missed(wrong_quality)
            wrong_jac = ba_jacobian_error(global_ba[0] if whole else recorded) \
                if global_ba or not whole else None
        wrong_secs = time.perf_counter() - t
        jac_missed = wrong_jac is not None and not wrong_jac["max"] <= MAPPER_JACOBIAN_ERR
        seen = f"misses {len(bars)} bars: {bars[:4]}" if whole else "bars not run"
        log(f"mapper: known-wrong '{name}' in {wrong_secs:.1f} s {seen}; Jacobian {wrong_jac}"
            f"{' misses' if jac_missed else ' within'} its bound; BA LM iterations "
            f"{wlog.get(0, {}).get('ba', {}).get('lm_iters')}; model {wrong_quality}")
        wrong_missed[name] = {"bars": len(bars), "jacobian": jac_missed}
        if not bars and not jac_missed:
            POWERLESS.append(f"mapper '{name}': {wrong_quality}, Jacobian {wrong_jac}")
    return {"seconds": secs, "scene": scene, "quality": quality,
            "substeps": mlog[0]["substeps"], "ba": ba, "global_ba_call": per_call,
            "jacobian": jac, "wrong_missed": wrong_missed}


def scale_scene(seed: int = 0):
    """tests/test_sfm_scale.py's scene: 12 views, 800 points."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.uniform(-2, 2, (SCALE_POINTS, 2)),
                        rng.uniform(4, 8, (SCALE_POINTS, 1))], axis=1)
    K = np.array([[600.0, 0, 400], [0, 600.0, 300], [0, 0, 1]])
    cams, views = [], []
    for i in range(SCALE_VIEWS):
        ang = (i - SCALE_VIEWS / 2) * 0.05
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        C = np.array([3.0 * np.sin(ang), 0.05 * i, 6 - 6 * np.cos(ang)])
        t = -R @ C
        Xc = X @ R.T + t
        uv = (Xc[:, :2] / Xc[:, 2:]) * 600 + np.array([400, 300])
        uv += 0.4 * rng.standard_normal(uv.shape)
        visible = ((Xc[:, 2] > 0.1) & (uv[:, 0] > 0) & (uv[:, 0] < 800) & (uv[:, 1] > 0)
                   & (uv[:, 1] < 600) & (rng.random(SCALE_POINTS) > 0.25))
        idx = np.nonzero(visible)[0]
        cams.append((R, t))
        views.append((idx, uv[idx]))
    return cams, K, views


def rotation_between_deg(q1, q2) -> float:
    """Angle between two unit quaternions (w, x, y, z), in float64."""
    import numpy as np

    q1, q2 = (np.asarray(q, np.float64) / np.linalg.norm(q) for q in (q1, q2))
    v = np.linalg.norm(q1[0] * q2[1:] - q2[0] * q1[1:] - np.cross(q1[1:], q2[1:]))
    return float(np.degrees(2.0 * np.arctan2(v, abs(float(q1 @ q2)))))


def model_difference(a, b) -> dict:
    """How far two models of one scene differ: registered images, points,
    rotations (both fix the same first image, so directly) and centres
    after the oracle's gauge alignment."""
    from vit_colmap_tpu_torch.sfm.align import pose_errors_vs_gt

    same = sorted(a.images) == sorted(b.images)
    rot = max(rotation_between_deg(a.images[i].qvec, b.images[i].qvec)
              for i in a.images if i in b.images)
    poses_b = {im.name: (im.R(), im.tvec) for im in as_f64(b).images.values()}
    pose = pose_errors_vs_gt(as_f64(a), poses_b)
    return {"same_images": same, "images": (len(a.images), len(b.images)),
            "points": (len(a.points3D), len(b.points3D)),
            "points_share": abs(len(a.points3D) - len(b.points3D)) / max(len(b.points3D), 1),
            "rot_deg_max": rot,
            "center_rel_max": None if pose is None else pose["pose_center_err_rel_max"],
            "reproj_px": (a.mean_reprojection_error(), b.mean_reprojection_error())}


def models_bit_equal(a, b) -> bool:
    """The same images and points, with bit-equal poses and positions."""
    import numpy as np

    return (sorted(a.images) == sorted(b.images) and sorted(a.points3D) == sorted(b.points3D)
            and all(np.array_equal(a.images[i].qvec, b.images[i].qvec)
                    and np.array_equal(a.images[i].tvec, b.images[i].tvec) for i in a.images)
            and all(np.array_equal(a.points3D[p].xyz, b.points3D[p].xyz)
                    for p in a.points3D))


def card_cpu_phase(work: Path) -> dict:
    """tests/test_sfm_scale.py's 12-view scene through incremental_mapping
    twice on the card and once on the CPU, with the same PnP uniforms: the
    card's first run against the CPU's (SCALE_* bounds), and the two card
    runs bit for bit (BA's segment sums add in a fixed order)."""
    from vit_colmap_tpu_torch.sfm.incremental import incremental_mapping
    from vit_colmap_tpu_torch.utils.config import ReconstructionConfig

    cams, K, views = scale_scene()
    scene = write_views_db(work / "scale.db", K, (800, 600), views, 20)
    cfg = ReconstructionConfig(min_num_matches=15, ba_local_iters=10, ba_global_iters=20)
    runs, secs = {}, {}
    for name, device in (("card", DEVICE), ("card2", DEVICE), ("cpu", "cpu")):
        t = time.perf_counter()
        recs = incremental_mapping(work / "scale.db", work, work / f"scale_{name}", cfg,
                                   device=device)
        sync()
        secs[name] = time.perf_counter() - t
        check(len(recs) >= 1, f"12-view scene: no model on {device}")
        runs[name] = recs[0]
    vs_cpu = model_difference(runs["card"], runs["cpu"])
    check(vs_cpu["same_images"] and len(runs["card"].images) == SCALE_VIEWS
          and vs_cpu["points_share"] <= SCALE_POINTS_SHARE
          and vs_cpu["rot_deg_max"] < SCALE_ROT_DEG
          and vs_cpu["center_rel_max"] < SCALE_CENTER_REL,
          f"12-view scene, card vs CPU: {vs_cpu}")
    runs_apart = model_difference(runs["card"], runs["card2"])
    bit_equal = models_bit_equal(runs["card"], runs["card2"])
    quality = model_quality({0: runs["card"]}, cams, scene["points_in_two_views"])
    log(f"card vs CPU: 12-view scene ({scene}) in {secs['card']:.1f} / {secs['card2']:.1f} s "
        f"on the card, {secs['cpu']:.1f} s on the CPU; card vs CPU {vs_cpu}; determinism: "
        f"two card runs bit-equal {bit_equal}, apart {runs_apart}; card model vs ground "
        f"truth {quality}")
    check(bit_equal, f"12-view scene: two card runs differ: {runs_apart}")
    return {"seconds": secs, "vs_cpu": vs_cpu, "card_runs_bit_equal": bit_equal,
            "quality": quality}


def render_phase(work: Path):
    """The rendered 50-view scene, written by the port's numpy renderer."""
    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import render_multiview_scene

    t = time.perf_counter()
    img_dir = work / "scene50"
    _, K = render_multiview_scene(img_dir, n_cams=SCENE_VIEWS, size=SCENE_SIZE,
                                  focal=SCENE_FOCAL, seed=SCENE_SEED)
    seconds = time.perf_counter() - t
    log(f"render: {SCENE_VIEWS} views {SCENE_SIZE[1]}x{SCENE_SIZE[0]} (seed {SCENE_SEED}, "
        f"focal {SCENE_FOCAL:.1f}) in {seconds:.1f} s")
    return img_dir, K, seconds


def sift_kwargs() -> dict:
    """extract_sift's arguments as SiftExtractor passes them."""
    return dict(max_keypoints=SCENE_KEYPOINTS, num_octaves=4, contrast_thresh=0.02,
                num_orientations=2)


def sift_agreement(ref, out) -> dict:
    """How far ``out``'s SIFT (kpts, descs per image) follows ``ref``'s, the
    least over the images: ``position``, the share of ref's keypoints with
    one of out's within SIFT_TOL px in x, y and scale (keypoints of nearly
    equal score may swap ranks, so rows are paired by position);
    ``orientation``, the share of those with one also within SIFT_TOL rad
    (a last-bit difference can move a histogram peak to its neighbour bin);
    over the pairs so found, ``descriptor``, the share of descriptor bytes
    within 1 level, and ``max_byte_diff``."""
    import numpy as np

    shares = {"position": [], "orientation": [], "descriptor": [], "max_byte_diff": []}
    for (kr, dr), (ko, do) in zip(zip(*ref), zip(*out)):
        n_pos = n_ori = 0
        diffs = []
        for start in range(0, len(kr), 512):  # (512, N) blocks
            k = kr[start:start + 512]
            near = np.abs(k[:, None, :3] - ko[None, :, :3]).max(-1) <= SIFT_TOL
            ang = np.abs(np.angle(np.exp(1j * (k[:, None, 3].astype(np.float64)
                                               - ko[None, :, 3]))))
            both = near & (ang <= SIFT_TOL)
            n_pos += int(near.any(1).sum())
            n_ori += int(both.any(1).sum())
            rows = np.nonzero(both.any(1))[0]
            cols = np.argmax(both[rows], axis=1)
            diffs.append(np.abs(dr[start + rows].astype(int) - do[cols].astype(int)))
        d = np.concatenate(diffs) if diffs else np.zeros((0, 128), int)
        shares["position"].append(n_pos / max(len(kr), 1))
        shares["orientation"].append(n_ori / max(n_pos, 1))
        shares["descriptor"].append(float((d <= 1).mean()) if d.size else 1.0)
        shares["max_byte_diff"].append(int(d.max()) if d.size else 0)
    return {**{k: min(v) for k, v in shares.items() if k != "max_byte_diff"},
            "max_byte_diff": max(shares["max_byte_diff"]), "per_image": shares,
            "keypoints": [len(k) for k in ref[0]], "out_keypoints": [len(k) for k in out[0]]}


def sift_missed(agree: dict) -> list[str]:
    """The SIFT_SHARES that a sift_agreement misses, as text."""
    return [f"{k} {agree[k]:.4f} < {v}" for k, v in SIFT_SHARES.items() if agree[k] < v]


def unrotated_descriptors(fm_stacked, xy, level, orientation, scale_px, H, W, window=16):
    """Known-wrong descriptors: the sample grid is rotated, but the gradient
    angles are not taken relative to the keypoint's orientation."""
    from vit_colmap_tpu_torch.ops import sift

    rel_np = sift._window_grid(window)
    pts, gw = sift._descriptor_samples(xy, orientation, scale_px, rel_np)
    samp = sift._sample_level_stacked(fm_stacked, pts, level, H, W)
    return sift._descriptor_core(samp[..., 0] * gw[None, None], samp[..., 1], rel_np)


def sift_rate(gray, reps: int = 3) -> dict:
    """extract_sift on one batch, host to host: median seconds of ``reps``
    warm calls and images a second."""
    from vit_colmap_tpu_torch.ops.sift import extract_sift

    extract_sift(gray, device=DEVICE, **sift_kwargs())
    times = []
    for _ in range(reps):
        sync()
        t = time.perf_counter()
        extract_sift(gray, device=DEVICE, **sift_kwargs())
        sync()
        times.append(time.perf_counter() - t)
    s = statistics.median(times)
    return {"batch": int(gray.shape[0]), "size": tuple(gray.shape[1:]), "s": s,
            "img_per_s": gray.shape[0] / s}


def sift_phase(scene_dir: Path, main_dir: Path) -> dict:
    """SIFT on the card against the port's CPU path on two rendered views
    (SIFT_SHARES), the known-wrong unrotated descriptors against the same
    bars (they must miss one), the rates at 480 x 640 and at the main
    path's 1190 x 1596, and one call's kernel launches."""
    from unittest import mock

    import numpy as np

    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.ops import sift
    from vit_colmap_tpu_torch.utils.image_io import imread_gray

    gray = np.stack([imread_gray(scene_dir / f"view_{i:03d}.png") for i in SIFT_VIEWS])
    sync()
    counts.clear()
    card = sift.extract_sift(gray, device=DEVICE, **sift_kwargs())
    expect_launches(dict(counts), {}, "sift")
    cpu = sift.extract_sift(gray, device="cpu", **sift_kwargs())
    agree = sift_agreement(cpu, card)
    missed = sift_missed(agree)
    with mock.patch.object(sift, "sift_descriptors_multilevel", unrotated_descriptors):
        wrong = sift_agreement(cpu, sift.extract_sift(gray, device=DEVICE, **sift_kwargs()))
    log(f"sift: card vs CPU on views {SIFT_VIEWS}: {agree} (bars {SIFT_SHARES}); "
        f"known-wrong 'descriptor angles not rotated': {wrong} (must miss a bar)")
    check(not missed, "sift: card vs CPU: " + "; ".join(missed))
    if not sift_missed(wrong):
        POWERLESS.append(f"sift 'descriptor angles not rotated': {wrong}")
    main = np.stack([imread_gray(f) for f in sorted(main_dir.iterdir())[:4]])
    rates = {"480x640": sift_rate(np.stack([imread_gray(scene_dir / f"view_{i:03d}.png")
                                            for i in range(4)])),
             "1190x1596": sift_rate(main)}
    launched = (profiled(lambda: sift.extract_sift(gray, device=DEVICE, **sift_kwargs()))
                if DEVICE == "cuda" else {})
    log(f"sift: rates (batches of 4, host to host) {rates}; one call on 2 views "
        f"{SIFT_VIEWS}: {launched}")
    return {"card_vs_cpu": {k: agree[k] for k in SIFT_SHARES},
            "wrong_descriptor_share": wrong["descriptor"], "rates": rates,
            "launches": launched}


def scene_quality(pipeline, scene_dir: Path) -> dict:
    """The reference's bench_reconstruction fields for a Pipeline.run's
    models, against the renderer's poses."""
    from vit_colmap_tpu_torch.sfm.align import best_pose_errors, gt_poses_for_rendered_scene

    recs = pipeline.reconstructions
    if not recs:
        return {"registered": 0, "points3d": 0}
    pose = best_pose_errors(recs, gt_poses_for_rendered_scene(scene_dir))
    biggest = max(recs.values(), key=lambda r: len(r.images))
    lens = [len(p.track) for r in recs.values() for p in r.points3D.values()]
    return {"registered": sum(len(r.images) for r in recs.values()),
            "points3d": len(lens), "observations": int(sum(lens)),
            "mean_track_length": sum(lens) / max(len(lens), 1),
            "reproj_px": biggest.mean_reprojection_error(),
            "rot_mean_deg": pose["pose_rot_err_deg_mean"] if pose else float("inf"),
            "rot_max_deg": pose["pose_rot_err_deg_max"] if pose else float("inf"),
            "center_rel_mean": pose["pose_center_err_rel_mean"] if pose else float("inf"),
            "center_rel_max": pose["pose_center_err_rel_max"] if pose else float("inf"),
            "aligned_cameras": pose["aligned_cameras"] if pose else 0}


def scene_missed(q: dict) -> list[str]:
    """The SCENE_BARS that ``q`` misses, as text."""
    missed = []
    if q["registered"] < SCENE_BARS["registered"]:
        missed.append(f"registered {q['registered']} < {SCENE_BARS['registered']}")
    for key in ("reproj_px", "rot_mean_deg", "rot_max_deg", "center_rel_mean"):
        if not q.get(key, float("inf")) <= SCENE_BARS[key]:
            missed.append(f"{key} {q.get(key)} > {SCENE_BARS[key]}")
    return missed


def scene_phase(work: Path, scene_dir: Path, K, render_s: float) -> dict:
    """The rendered 50-view scene through Pipeline.run with SIFT (counts
    cleared: kernel 2 launches, no other kernel), held to SCENE_BARS
    against the renderer's poses; then the known-wrong SIFT without the
    octave factor on the keypoints of octaves >= 1, which must miss one."""
    from unittest import mock

    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.ops import sift
    from vit_colmap_tpu_torch.pipeline import Pipeline
    from vit_colmap_tpu_torch.utils.config import Config

    def run(tag: str):
        config = Config()
        config.extractor.extractor_type = "sift"
        config.extractor.max_keypoints = SCENE_KEYPOINTS
        config.camera.model = "PINHOLE"
        config.camera.params = [float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                                float(K[1, 2])]
        pipeline = Pipeline(config, device=DEVICE)
        sync()
        counts.clear()
        t = time.perf_counter()
        report = pipeline.run(scene_dir, work / f"scene_{tag}", work / f"scene_{tag}.db")
        sync()
        return pipeline, report, time.perf_counter() - t, dict(counts), config

    pipeline, report, wall, launches, config = run("sift")
    pairs = SCENE_VIEWS * (SCENE_VIEWS - 1) // 2
    expect_launches(launches, {"match_topk2_colmax":
                               math.ceil(pairs / config.matching.pair_batch)}, "scene-50")
    quality = scene_quality(pipeline, scene_dir)
    missed = scene_missed(quality)
    stages = {"render": render_s, "extract": report["extract_s"], "match": report["match_s"],
              "verify": report["verify_s"], "reconstruct": report["reconstruction_s"]}
    log(f"scene-50: Pipeline.run in {wall:.1f} s, stage seconds {stages}, verification "
        f"chunks {report['verify_chunks']}, launches {launches}; quality {quality} "
        f"(bars {SCENE_BARS})")
    check(not missed, "scene-50 against the renderer's poses: " + "; ".join(missed))
    with mock.patch.object(sift, "OCTAVE_STEP", 1):
        wrong_pipeline, _, wrong_wall, _, _ = run("wrong")
    wrong_quality = scene_quality(wrong_pipeline, scene_dir)
    wrong_missed = scene_missed(wrong_quality)
    log(f"scene-50: known-wrong 'no octave factor on octaves >= 1' in {wrong_wall:.1f} s "
        f"misses {len(wrong_missed)} bars: {wrong_missed}; quality {wrong_quality}")
    if not wrong_missed:
        POWERLESS.append(f"scene-50 'no octave factor': {wrong_quality}")
    return {"stages": stages, "wall_s": wall, "quality": quality,
            "launches": launches, "wrong_missed": len(wrong_missed)}


def wire_phase(work: Path, rgb_extractor, weights: Path) -> dict:
    """The YUV420 wire: both unpackers on the card against the CPU on the
    main path's 8 images; ViTExtractor(transfer_format="yuv420c4")
    extraction of them into a database (counts cleared: kernel 1 launches,
    as on the main path's first run), its dense tokens against the rgb
    extractor's (cosine per token), and both extractions' warm seconds.
    The extractor keeps the studio-range host route (the route where the
    decoder does not load): its first ``extract`` sees no native decoder,
    so no image is decoded natively and full range stays off; the native
    route is the native-io phase's."""
    from unittest import mock

    import numpy as np
    import torch

    from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor
    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.ops import transfer
    from vit_colmap_tpu_torch.utils import native_io
    from vit_colmap_tpu_torch.utils.config import CameraConfig
    from vit_colmap_tpu_torch.utils.image_io import imread_rgb

    img_dir = work / "images"
    rgb = np.stack([imread_rgb(f) for f in sorted(img_dir.iterdir())])
    native_io.decodes.clear()
    t = time.perf_counter()
    transfer.pack_batch_yuv420_c4(rgb)
    pack_s = time.perf_counter() - t  # the host's share of the wire
    errs = {}
    for name, wire, fn in (("yuv420", transfer.pack_batch_yuv420(rgb), transfer.unpack_yuv420),
                           ("yuv420c4", transfer.pack_batch_yuv420_c4(rgb),
                            transfer.unpack_yuv420_c4)):
        card = fn(torch.from_numpy(wire).to(DEVICE)).cpu()
        errs[name] = (card - fn(torch.from_numpy(wire))).abs().max().item()
    check(max(errs.values()) <= WIRE_UNPACK_TOL,
          f"wire: unpack card vs CPU {errs} (bound {WIRE_UNPACK_TOL})")

    yuv = ViTExtractor(weights_path=str(weights), backbone="vitb14",
                       max_keypoints=MAX_KEYPOINTS, image_batch=IMAGE_BATCH,
                       transfer_format="yuv420c4", device=DEVICE)
    sync()
    counts.clear()
    with mock.patch.object(native_io, "load_native", lambda: None):
        yuv.extract(img_dir, work / "wire.db", CameraConfig().model)
    sync()
    launches = dict(counts)
    expect_launches(launches, {"attention_qkv": BACKBONE_LAYERS}, "wire")
    batch = rgb[:IMAGE_BATCH]
    a = rgb_extractor.dense_features(batch).float().reshape(-1, 768)
    b = yuv.dense_features(yuv.to_wire(batch)).float().reshape(-1, 768)
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    cos_mean, cos_min = cos.mean().item(), cos.min().item()
    check(cos_mean > WIRE_COS_MEAN and cos_min > WIRE_COS_MIN,
          f"wire: yuv420c4 tokens vs rgb cosine mean {cos_mean}, min {cos_min}")
    seconds = {}
    for name, ex in (("rgb", rgb_extractor), ("yuv420c4", yuv)):
        ex.extract(img_dir, work / f"wire_{name}_warm.db", CameraConfig().model)  # warm
        sync()
        t = time.perf_counter()
        ex.extract(img_dir, work / f"wire_{name}.db", CameraConfig().model)
        sync()
        seconds[name] = time.perf_counter() - t
    check(not native_io.decodes and not yuv._yuv_full_range,
          f"wire: the studio-range route decoded natively ({dict(native_io.decodes)}) or "
          f"set full range ({yuv._yuv_full_range})")
    rates = {k: NUM_IMAGES / v for k, v in seconds.items()}
    log(f"wire: unpack card vs CPU max abs err {errs} (bound {WIRE_UNPACK_TOL}); "
        f"yuv420c4 extraction launches {launches}; tokens vs rgb cosine mean "
        f"{cos_mean:.4f} (> {WIRE_COS_MEAN}), min {cos_min:.4f} (> {WIRE_COS_MIN}); warm "
        f"extraction of {NUM_IMAGES} images, seconds {seconds}, img/s {rates}; host "
        f"packing of the {NUM_IMAGES} images into yuv420c4 {pack_s:.3f} s")
    return {"unpack_err": errs, "launches": launches, "cos_mean": cos_mean,
            "cos_min": cos_min, "extract_s": seconds, "img_per_s": rates,
            "host_pack_s": pack_s}


class ReferenceHeads:
    """The reference ``ViTFeatureModel``'s heads as its trained checkpoints
    store them (``upsampler.{0,1}.{deconv,conv,bn}``, ``trunk``,
    ``keypoint_head``, ``descriptor_head``, BatchNorm after each conv but the
    last two), at full width, and their eval-mode forward in plain PyTorch:
    the CPU reference of the trainable phase.  Built lazily (torch is
    imported inside functions)."""

    @staticmethod
    def build(seed: int):
        import torch
        import torch.nn as nn

        g = torch.Generator().manual_seed(seed)

        class Up(nn.Module):
            def __init__(self, i, o):
                super().__init__()
                self.deconv = nn.ConvTranspose2d(i, o, 4, 2, 1)
                self.conv = nn.Conv2d(o, o, 3, padding=1)
                self.bn = nn.BatchNorm2d(o)

        def head(mid, out):
            return nn.Sequential(nn.Conv2d(256, mid, 3, padding=1), nn.BatchNorm2d(mid),
                                 nn.GELU(), nn.Conv2d(mid, out, 1))

        m = nn.Module()
        m.upsampler = nn.Sequential(Up(768, 512), Up(512, 512))
        m.trunk = nn.Sequential(nn.Conv2d(512, 256, 3, padding=1), nn.BatchNorm2d(256),
                                nn.GELU())
        m.keypoint_head = head(64, 4)
        m.descriptor_head = head(128, 128)
        with torch.no_grad():
            for mod in m.modules():
                if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                    fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
                    mod.weight.normal_(0.0, fan_in**-0.5, generator=g)
                    mod.bias.normal_(0.0, 0.05, generator=g)
                elif isinstance(mod, nn.BatchNorm2d):  # running stats to fold
                    n = mod.num_features
                    mod.running_mean.copy_(0.3 * torch.randn(n, generator=g))
                    mod.running_var.copy_(0.5 + 1.5 * torch.rand(n, generator=g))
                    mod.weight.copy_(0.7 + 0.6 * torch.rand(n, generator=g))
                    mod.bias.copy_(0.1 * torch.randn(n, generator=g))
        return m.eval()

    @staticmethod
    def forward(m, feats):
        """(B, gh, gw, 768) f32 -> the port's head outputs, from the
        reference's raw 4-channel keypoint map (tanh x 0.5 offsets, tanh x pi
        orientation) and F.normalize'd descriptors."""
        import torch
        import torch.nn.functional as F

        with torch.no_grad():
            x = feats.permute(0, 3, 1, 2)
            for up in m.upsampler:
                x = F.gelu(up.bn(up.conv(up.deconv(x))))
            h, w = feats.shape[1:3]
            x = F.interpolate(x, size=(h * 14 // 4, w * 14 // 4), mode="bilinear",
                              align_corners=False)
            t = m.trunk(x)
            kp = m.keypoint_head(t).permute(0, 2, 3, 1)
            ds = F.normalize(m.descriptor_head(t), p=2, dim=1, eps=1e-8).permute(0, 2, 3, 1)
        return {"score_logits": kp[..., 0], "offsets": torch.tanh(kp[..., 1:3]) * 0.5,
                "orientation": torch.tanh(kp[..., 3]) * math.pi, "descriptors": ds}


def plain_keypoints(out, k: int, threshold: float = 0.4, min_k: int = 256):
    """The trainable extractor's selection written plainly: sigmoid,
    3x3 max-pool NMS, a stable descending sort, the threshold with the
    min_k floor, pixel positions (cell + 0.5 + offset) x 4.  Returns (K, 2)
    positions of the valid keypoints of image 0, numpy."""
    import torch
    import torch.nn.functional as F

    s = torch.sigmoid(out["score_logits"][0].float().cpu())
    peak = torch.where(s >= F.max_pool2d(s[None, None], 3, 1, 1)[0, 0], s, 0.0)
    top, idx = torch.sort(peak.flatten(), descending=True, stable=True)
    top, idx = top[:k], idx[:k]
    keep = (top > threshold) | ((torch.arange(k) < min_k) & (top > 0))
    W = s.shape[1]
    off = out["offsets"][0].float().cpu().reshape(-1, 2)[idx]
    xy = torch.stack([idx % W, idx // W], dim=-1).float() + 0.5 + off
    return (xy * 4.0)[keep].numpy()


def keypoint_share(ref_xy, xy, tol: float = TRAINABLE_KP_TOL) -> float:
    """Share of the reference keypoints with a keypoint of ``xy`` within
    ``tol`` px."""
    import torch

    if len(ref_xy) == 0 or len(xy) == 0:
        return 0.0
    d = torch.cdist(torch.from_numpy(ref_xy).double(), torch.from_numpy(xy).double())
    return (d.min(dim=1).values <= tol).double().mean().item()


def relative_errors(out, ref) -> dict:
    """max |out - ref| / max |ref| per head output (out on any device)."""
    return {k: ((out[k].float().cpu() - ref[k]).abs().max() / ref[k].abs().max()).item()
            for k in ref}


def trainable_checkpoint(work: Path, extractor) -> Path:
    """The trainable phase's reference-layout ``.pt``: the seeded heads with
    randomized BatchNorm statistics, their score logits spread to a
    standard deviation of TRAINABLE_LOGIT_STD around 0 on one image's
    features, and the slice's ViT-B/14 (randomized LayerNorms) embedded
    under ``backbone.``."""
    import torch

    from vit_colmap_tpu_torch.utils.image_io import imread_rgb

    heads = ReferenceHeads.build(seed=12)
    img = imread_rgb(sorted((work / "images").iterdir())[0])[None]
    feats = extractor.dense_features(img).float()[:, :TRAINABLE_CROP[0], :TRAINABLE_CROP[1]]
    logits = ReferenceHeads.forward(heads, feats.cpu())["score_logits"]
    gain = TRAINABLE_LOGIT_STD / logits.std().item()
    last = heads.keypoint_head[3]
    with torch.no_grad():
        last.weight[0] *= gain
        last.bias[0] = (last.bias[0] - logits.mean()) * gain
    sd = {f"backbone.{k}": v for k, v in
          torch.load(work / "vitb14_random.pth", weights_only=True).items()}
    sd.update(heads.state_dict())
    path = work / "trainable_heads.pt"
    torch.save({"model_state_dict": sd, "epoch": 0}, path)
    return path


def trainable_config(weights: Path):
    from vit_colmap_tpu_torch.utils.config import Config

    config = Config()
    config.extractor.extractor_type = "trainable_vit"
    config.extractor.backbone = "vitb14"
    config.extractor.vit_weights_path = str(weights)
    config.extractor.sfm_max_keypoints = MAX_KEYPOINTS
    config.extractor.image_batch = IMAGE_BATCH
    config.matching.pair_batch = PAIR_BATCH
    return config


def trainable_phase(work: Path, vit_extractor) -> dict:
    """The trainable main path: ``Pipeline.run(extractor_type=
    "trainable_vit")`` on the slice's 8 images from a reference-layout
    ``.pt`` (counts cleared: kernel 1 in every layer of the 4 batches,
    kernel 2 once), then a warm run for its stage seconds; kernel 2's
    matches and kernel 1's tokens against their plain versions; the heads
    on the card against the reference
    heads on the CPU in f32 (one image's features, cropped), their
    keypoints against a plain selection on the CPU; the database; and three
    known-wrong variants."""
    import dataclasses
    import types
    from unittest import mock

    import numpy as np
    import torch

    from vit_colmap_tpu_torch.database import ColmapDatabase
    from vit_colmap_tpu_torch.kernels import attention
    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.models import convert
    from vit_colmap_tpu_torch.models.dinov2 import preprocess
    from vit_colmap_tpu_torch.models.feature_model import FeatureHeads
    from vit_colmap_tpu_torch.pipeline import Pipeline
    from vit_colmap_tpu_torch.utils.image_io import imread_rgb

    weights = trainable_checkpoint(work, vit_extractor)
    pipeline = Pipeline(trainable_config(weights), device=DEVICE)
    sync()
    counts.clear()
    report = pipeline.run(work / "images", work / "trainable_out", work / "trainable.db")
    sync()
    launches = dict(counts)
    log(f"trainable: Pipeline.run report {report}, launches {launches}")
    expect_launches(launches, {"attention_qkv": BACKBONE_LAYERS // 2,
                               "match_topk2_colmax": MATCH_BATCHES}, "trainable path")
    check(pipeline.config.matching.descriptor_encoding == "signed",
          "trainable: descriptors not matched as signed")
    check(report["reconstruction_s"] > 0, "trainable: Pipeline.run skipped reconstruction")
    with ColmapDatabase.open_database(work / "trainable.db") as db:
        ids = sorted(db.read_images())
        kpts = [db.read_keypoints(i) for i in ids]
        descs = [db.read_descriptors(i) for i in ids]
        n_matches, n_verified = db.num_matches, db.num_verified_pairs
    check(len(ids) == NUM_IMAGES and all(k.shape == (MAX_KEYPOINTS, 6) for k in kpts)
          and all((k[:, 2] == 1).all() and (k[:, 5] == 0).all() for k in kpts)
          and all(d.shape == (MAX_KEYPOINTS, 128) and d.dtype == np.uint8 for d in descs),
          f"trainable: database keypoints {[k.shape for k in kpts]}")
    check(n_matches > 0, "trainable: no matches")
    check_matches(work / "trainable.db", plain_fused, "trainable")
    log(f"trainable: database {len(ids)} images x {MAX_KEYPOINTS} 6-column keypoints "
        f"(scale 1, orientation, score), signed descriptors; {n_matches} matches, "
        f"{n_verified} verified pairs; reconstruction {report['reconstruction_s']} s, "
        f"{report.get('registered_images', 0)} registered images, "
        f"{report.get('points3d', 0)} points")
    warm = pipeline.run(work / "images", work / "trainable_out", work / "trainable2.db")
    sync()
    log(f"trainable: warm Pipeline.run report {warm}")

    ex = next(iter(pipeline._extractors.values()))
    tokens = types.SimpleNamespace(dense_features=lambda imgs: ex.model.backbone_features(
        preprocess(torch.as_tensor(imgs).to(DEVICE))))
    check_tokens(tokens, work / "images", "attention_qkv", attention.attention_qkv_plain,
                 {}, "trainable")

    # The heads in f32 on the card against the reference heads on the CPU.
    img = imread_rgb(sorted((work / "images").iterdir())[0])[None]
    feats = tokens.dense_features(img).float()[:, :TRAINABLE_CROP[0], :TRAINABLE_CROP[1]]
    ref_heads = ReferenceHeads.build(seed=12)
    sd = torch.load(weights, weights_only=True)["model_state_dict"]
    ref_heads.load_state_dict({k: v for k, v in sd.items() if not k.startswith("backbone.")})
    ref = ReferenceHeads.forward(ref_heads, feats.cpu())
    heads32 = FeatureHeads(dataclasses.replace(ex.cfg, dtype=torch.float32), 768)
    heads32 = heads32.to(DEVICE).eval()

    def card_heads(state):
        heads32.load_state_dict(state)
        with torch.no_grad():
            out = heads32(feats)
        sync()
        return out

    port_sd = ex.model.heads.state_dict()
    out = card_heads(port_sd)
    errs = relative_errors(out, ref)
    check(max(errs.values()) <= TRAINABLE_HEADS_TOL,
          f"trainable: heads card vs CPU relative errors {errs}")
    ref_xy = plain_keypoints(ref, MAX_KEYPOINTS)

    def card_xy(head_out):
        x, y, _, _, valid, _ = ex.select(head_out)
        return torch.stack([x[0], y[0]], -1)[valid[0]].cpu().numpy()

    share = keypoint_share(ref_xy, card_xy(out))
    check(share >= TRAINABLE_KP_SHARE,
          f"trainable: {share:.4f} of the CPU's keypoints within {TRAINABLE_KP_TOL} px")
    log(f"trainable: heads f32 on a {TRAINABLE_CROP} feature crop, card vs the reference "
        f"heads on the CPU, max |diff| / max |CPU| {errs} (bound {TRAINABLE_HEADS_TOL}); "
        f"keypoints: {share:.4f} of the CPU's {len(ref_xy)} within {TRAINABLE_KP_TOL} px "
        f"(bar {TRAINABLE_KP_SHARE})")

    def wrong_fold(conv_w, conv_b, bn, eps=1e-5):
        s = bn["weight"] / bn["running_var"]
        return conv_w * s[:, None, None, None], (conv_b - bn["running_mean"]) * s + bn["bias"]

    unflipped = {k: (v.flip(2, 3) if k.endswith("deconv.weight") else v)
                 for k, v in port_sd.items()}
    with mock.patch.object(convert, "fold_batchnorm", wrong_fold):
        var_fold = convert.load_torch_feature_model(str(weights))[0]
    for name, state in (("deconv weight not flipped", unflipped),
                        ("BN folded with var, not sqrt(var + eps)", var_fold)):
        wrong = max(relative_errors(card_heads(state), ref).values())
        log(f"trainable: known-wrong '{name}': heads max relative error {wrong:.3g} "
            f"(must exceed {TRAINABLE_HEADS_TOL})")
        if not wrong > TRAINABLE_HEADS_TOL:
            POWERLESS.append(f"trainable '{name}': {wrong}")
    not_x4 = dict(out, offsets=out["offsets"] / 4.0)  # (cell + 0.5) * 4 + offset
    wrong_share = keypoint_share(ref_xy, card_xy(not_x4))
    log(f"trainable: known-wrong 'offsets not x4': {wrong_share:.4f} of the keypoints "
        f"within {TRAINABLE_KP_TOL} px (must fall below {TRAINABLE_KP_SHARE})")
    if not wrong_share < TRAINABLE_KP_SHARE:
        POWERLESS.append(f"trainable 'offsets not x4': {wrong_share}")
    del heads32, ref_heads
    return {"launches": launches, "first": report, "warm": warm, "heads_err": errs,
            "keypoint_share": share, "pipeline": pipeline}


def perturb_backbone(model, cfg, g) -> None:
    """In place, the departures from the flax init that keep the checks
    meaningful (see ``random_weights``): LayerScale 0.1, q projections x
    Q_GAIN, LayerNorm weights 1 + 0.1 N(0, 1) and biases 0.1 N(0, 1)."""
    import torch

    with torch.no_grad():
        for key, value in model.state_dict().items():
            noise = lambda: torch.randn(value.shape, generator=g).to(value.device)  # noqa: E731
            if key.endswith("attn.qkv.weight") or key.endswith("attn.qkv.bias"):
                value[: cfg.embed_dim] *= Q_GAIN
            elif key.endswith(".gamma"):
                value.fill_(0.1)
            elif "norm" in key and key.endswith(".weight"):
                value.add_(0.1 * noise())
            elif "norm" in key and key.endswith(".bias"):
                value.copy_(0.1 * noise())


def phase_images(work: Path, hw=None):
    """The slice's first IMAGE_BATCH images, uint8 (B, H, W, 3), cropped to
    ``hw`` when given."""
    import numpy as np

    from vit_colmap_tpu_torch.utils.image_io import imread_rgb

    imgs = np.stack([imread_rgb(f) for f in sorted((work / "images").iterdir())[:IMAGE_BATCH]])
    return imgs if hw is None else np.ascontiguousarray(imgs[:, : hw[0], : hw[1]])


def rms_errors(out, ref) -> tuple[float, float]:
    """(RMS of the difference / RMS of ref, max |difference| / max |ref|)."""
    out, ref = out.float().cpu(), ref.float().cpu()
    diff = out - ref
    return ((diff.square().mean().sqrt() / ref.square().mean().sqrt()).item(),
            (diff.abs().max() / ref.abs().max()).item())


def vitg14_phase(work: Path) -> dict:
    """ViT-g/14 (40 layers, 24 heads, SwiGLU hidden 2736): one batch of
    IMAGE_BATCH full-size images through ``ViTExtractor(backbone="vitg14")``
    (counts cleared: kernel 1 in each layer), kernel 1's tokens against its
    plain version, the SwiGLU MLP of block 0 on its real input on the card
    against a plain f32 product on the CPU (one image's rows) and its
    known-wrong with the halves swapped, and kernel 1's time at 24 heads."""
    import torch
    import torch.nn.functional as F

    from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor
    from vit_colmap_tpu_torch.kernels import attention
    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.models.dinov2 import _linear

    t = time.perf_counter()
    ex = ViTExtractor(backbone=VITG_NAME, image_batch=IMAGE_BATCH, device=DEVICE)
    perturb_backbone(ex.model, ex.cfg, torch.Generator().manual_seed(14))
    cfg = ex.cfg
    n_params = sum(p.numel() for p in ex.model.parameters())
    init_s = time.perf_counter() - t
    imgs = phase_images(work)
    mlp_in = []
    hook = ex.model.blocks[0].mlp.register_forward_pre_hook(lambda m, a: mlp_in.append(a[0]))
    sync()
    counts.clear()
    t = time.perf_counter()
    ex.dense_features(imgs)
    sync()
    forward_s = time.perf_counter() - t
    launches = dict(counts)
    hook.remove()
    expect_launches(launches, {"attention_qkv": cfg.depth}, "vitg14")
    log(f"vitg14: {n_params / 1e9:.3f} B parameters ({cfg.depth} layers, {cfg.num_heads} "
        f"heads), built in {init_s:.1f} s; one batch of {IMAGE_BATCH} at {HEIGHT}x{WIDTH} in "
        f"{forward_s:.2f} s (first call), launches {launches}")
    check_tokens(ex, work / "images", "attention_qkv", attention.attention_qkv_plain,
                 {"no log2e": wrong_no_log2e, "image 0 for all": wrong_first_image},
                 "vitg14", depth=cfg.depth)
    sync()
    t = time.perf_counter()
    ex.dense_features(imgs)
    sync()
    warm_s = time.perf_counter() - t

    mlp = ex.model.blocks[0].mlp
    x = mlp_in[0][:1]  # one image's rows, bf16, as the block gives them
    with torch.no_grad():
        out = mlp(x)
        x1, x2 = _linear(x, mlp.w12, cfg.dtype).chunk(2, dim=-1)
        swapped = _linear(F.silu(x2) * x1, mlp.w3, cfg.dtype)
        xc = x.float().cpu()
        h = xc @ mlp.w12.weight.float().cpu().T + mlp.w12.bias.float().cpu()
        a, b = h.split(h.shape[-1] // 2, dim=-1)
        ref = (F.silu(a) * b) @ mlp.w3.weight.float().cpu().T + mlp.w3.bias.float().cpu()
    sync()
    rms, rel = rms_errors(out, ref)
    check(rms <= TOKEN_RMS_TOL and rel <= TOKEN_MAX_TOL,
          f"vitg14: SwiGLU card vs CPU rms rel err {rms}, max rel err {rel}")
    w_rms, w_rel = rms_errors(swapped, ref)
    log(f"vitg14: SwiGLU MLP of block 0 on its input {tuple(x.shape)}, card (bf16) vs "
        f"plain f32 on the CPU: rms rel err {rms:.3g} <= {TOKEN_RMS_TOL}, max rel err "
        f"{rel:.3g} <= {TOKEN_MAX_TOL}; known-wrong 'SwiGLU halves swapped': rms "
        f"{w_rms:.3g}, max {w_rel:.3g} (one must exceed its bound)")
    if not (w_rms > TOKEN_RMS_TOL or w_rel > TOKEN_MAX_TOL):
        POWERLESS.append(f"vitg14 'SwiGLU halves swapped': rms {w_rms}, max {w_rel}")
    g = torch.Generator(device=DEVICE).manual_seed(24)
    qkv = torch.randn(IMAGE_BATCH, TOKENS, 3 * 64 * cfg.num_heads, generator=g,
                      device=DEVICE).to(torch.bfloat16)
    ms = kernel_ms(lambda: attention.attention_qkv(qkv, cfg.num_heads, 64**-0.5))
    flops = 4.0 * IMAGE_BATCH * cfg.num_heads * TOKENS * TOKENS * 64
    log(f"vitg14: a warm batch (host to tokens on the card) {warm_s * 1e3:.1f} ms; kernel 1 "
        f"at ({IMAGE_BATCH}, {TOKENS}, {cfg.num_heads} heads, 64) bf16: {ms}, bound "
        f"{flops / PEAK_BF16_FLOPS * 1e3:.3f} ms (tensor cores)")
    del ex, mlp_in, qkv
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "params_b": n_params / 1e9, "forward_s": forward_s,
            "warm_s": warm_s, "swiglu_rms": rms, "kernel_ms": ms}


def wrong_register_assembly(model, x):
    """Known-wrong: the registers inserted before the pos-embed is added,
    the pos-embed stretched over them by repeating the cls row.  Returns
    the first block's input."""
    import torch
    import torch.nn.functional as F

    from vit_colmap_tpu_torch.models.dinov2 import interpolate_pos_embed

    c = model.cfg
    B, H, W, _ = x.shape
    gh, gw = H // c.patch_size, W // c.patch_size
    pe = model.patch_embed.proj
    t = F.conv2d(x.permute(0, 3, 1, 2).to(c.dtype), pe.weight.to(c.dtype),
                 pe.bias.to(c.dtype), stride=c.patch_size).flatten(2).transpose(1, 2)
    pos = interpolate_pos_embed(model.pos_embed, gh, gw, c.pretrain_grid)
    pos = torch.cat([pos[:, :1].expand(-1, 1 + c.num_register_tokens, -1), pos[:, 1:]], 1)
    reg = model.register_tokens.to(c.dtype).expand(B, -1, -1)
    cls = model.cls_token.to(c.dtype).expand(B, -1, -1)
    return torch.cat([cls, reg, t], dim=1) + pos.to(c.dtype)


class FirstBlockInput(Exception):
    pass


def first_block_input(model, x):
    """The sequence the first block receives (the forward stops there)."""
    seen = []

    def stop(module, args):
        seen.append(args[0])
        raise FirstBlockInput

    hook = model.blocks[0].register_forward_pre_hook(stop)
    try:
        model(x)
    except FirstBlockInput:
        pass
    finally:
        hook.remove()
    return seen[0]


def registers_phase(work: Path) -> dict:
    """ViT-B/14 with REGISTERS register tokens (the slice's weights,
    seeded registers): one batch at full size (counts cleared: kernel 1 in
    each layer, N = 9,695), kernel 1's tokens against its plain version,
    and the first block's input on the card against the CPU's (the register
    rows bit for bit, the rest within 2^-8 of the largest value) with the
    known-wrong assembly."""
    import copy
    import types

    import torch

    from vit_colmap_tpu_torch.kernels import attention
    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.models.dinov2 import make_backbone, preprocess

    g = torch.Generator().manual_seed(4)
    model, cfg = make_backbone("vitb14", num_register_tokens=REGISTERS,
                               attn_impl="fixedmax_fused", generator=g)
    missing, _ = model.load_state_dict(torch.load(work / "vitb14_random.pth",
                                                  weights_only=True), strict=False)
    check(missing == ["register_tokens"], f"registers: missing keys {missing}")
    with torch.no_grad():
        model.register_tokens.copy_(0.5 * torch.randn(model.register_tokens.shape, generator=g))
    cpu_model = model.eval().requires_grad_(False)
    model = copy.deepcopy(cpu_model).to(DEVICE)

    def tokens(imgs):
        with torch.no_grad():
            out = model(preprocess(torch.as_tensor(imgs).to(DEVICE)))
        gh, gw = out["grid"]
        return out["x_norm_patchtokens"].reshape(len(imgs), gh, gw, -1)

    imgs = phase_images(work)
    sync()
    counts.clear()
    tok = tokens(imgs)
    sync()
    launches = dict(counts)
    expect_launches(launches, {"attention_qkv": cfg.depth}, "registers")
    check(tok.shape == (IMAGE_BATCH, HEIGHT // 14, WIDTH // 14, 768),
          f"registers: patch tokens {tuple(tok.shape)}")
    check_tokens(types.SimpleNamespace(dense_features=tokens), work / "images",
                 "attention_qkv", attention.attention_qkv_plain, {}, "registers")
    x = preprocess(torch.as_tensor(phase_images(work)[:1]))
    with torch.no_grad():
        ref = first_block_input(cpu_model, x).float()
        card = first_block_input(model, x.to(DEVICE)).float().cpu()
        wrong = wrong_register_assembly(model, x.to(DEVICE)).float().cpu()
    n = 1 + REGISTERS
    bound = 2.0**-8 * ref.abs().max().item()

    def errors(seq):
        return ((seq[:, 1:n] - ref[:, 1:n]).abs().max().item(),
                (seq - ref).abs().max().item())

    reg_err, err = errors(card)
    check(reg_err == 0 and err <= bound,
          f"registers: first block input card vs CPU: registers {reg_err}, all {err}")
    w_reg, w_err = errors(wrong)
    log(f"registers: first block input {tuple(card.shape)} card vs CPU: register rows max "
        f"|diff| {reg_err} (must be 0), all rows {err:.3g} <= {bound:.3g}; known-wrong "
        f"'registers inserted before the pos-embed': register rows {w_reg:.3g}, all "
        f"{w_err:.3g}; launches {launches}")
    if not (w_reg > 0 or w_err > bound):
        POWERLESS.append(f"registers 'inserted before the pos-embed': {w_reg}, {w_err}")
    del model, cpu_model
    return {"launches": launches, "first_block_err": err}


def layer_attention_check(extractor, imgs, phase: str) -> float:
    """Kernel 1 on the packed qkv each layer of ``extractor``'s backbone
    gives it on ``imgs``, against its plain version on the same qkv, at the
    bound of ``attention_check``; the known-wrong variants on layer 0.
    Returns the largest error relative to its bound."""
    from unittest import mock

    from vit_colmap_tpu_torch.kernels import attention

    kernel, seen = attention.attention_qkv, []

    def record(qkv, num_heads, sm_scale):
        seen.append((qkv, num_heads, sm_scale))
        return kernel(qkv, num_heads, sm_scale)

    with mock.patch.object(attention, "attention_qkv", record):
        extractor.dense_features(imgs)
    worst = 0.0
    for layer, args in enumerate(seen):
        ref = attention.attention_qkv_plain(*args).float()
        bound = ATTN_ULPS * 2.0**-8 * ref.abs().max().item()
        err = (kernel(*args).float() - ref).abs().max().item()
        check(math.isfinite(err) and err <= bound,
              f"{phase}: layer {layer} attention_qkv vs plain: max err {err} > {bound}")
        worst = max(worst, err / bound)
        if layer == 0:
            for name, fn in wrong_kernels(args[0].shape[0]).items():
                wrong = (fn(*args).float() - ref).abs().max().item()
                log(f"{phase}: known-wrong '{name}' on layer 0's qkv: max |wrong - plain| "
                    f"{wrong:.3g} (must exceed {bound:.3g})")
                if not wrong > bound:
                    POWERLESS.append(f"{phase} layer 0 '{name}': {wrong} <= {bound}")
    log(f"{phase}: attention_qkv on each of the {len(seen)} layers' own qkv "
        f"{tuple(seen[0][0].shape)} vs plain: largest max |kernel - plain| {worst:.3g} of "
        f"its bound ({ATTN_ULPS} x 2^-8 x max |plain|)")
    return worst


def int8_phase(work: Path, bf16_extractor, weights: Path) -> dict:
    """``ViTExtractor(quantize="int8")`` on the slice's 8 images into a
    database (counts cleared: kernel 1 as on the main path's first run);
    kernel 1 against its plain version on each layer's qkv from
    ``QuantDense`` and on the patch tokens of a full-size batch; the int32
    products of block 0's qkv and fc1 on the card against a plain
    f64 product of the same int8 operands on the CPU, bit for bit, with the
    known-wrong per-tensor weight scale; tokens on the card against the CPU
    at INT8_CPU_HW; the int8 tokens against bf16's at full size; and the
    warm extraction rates of both in turns."""
    from unittest import mock

    import torch

    from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor
    from vit_colmap_tpu_torch.kernels import attention
    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.models import dinov2
    from vit_colmap_tpu_torch.utils.config import CameraConfig

    ex = ViTExtractor(weights_path=str(weights), backbone="vitb14",
                      max_keypoints=MAX_KEYPOINTS, image_batch=IMAGE_BATCH,
                      quantize="int8", device=DEVICE)
    camera = CameraConfig()
    sync()
    counts.clear()
    ex.extract(work / "images", work / "int8.db", camera.model, camera.params)
    sync()
    launches = dict(counts)
    expect_launches(launches, {"attention_qkv": BACKBONE_LAYERS}, "int8 extraction")
    imgs = phase_images(work)
    layer_worst = layer_attention_check(ex, imgs, "int8")
    check_tokens(ex, work / "images", "attention_qkv", attention.attention_qkv_plain,
                 {"no log2e": wrong_no_log2e, "image 0 for all": wrong_first_image}, "int8",
                 gain=INT8_TOKEN_GAIN)

    # Block 0's qkv and fc1 inputs, as the int8 backbone gives them.
    inputs = {}
    quantized = dinov2.QuantDense.quantized

    def record(layer, x, dtype):
        inputs.setdefault(id(layer), x)
        return quantized(layer, x, dtype)

    with mock.patch.object(dinov2.QuantDense, "quantized", record):
        ex.dense_features(imgs)
    blk = ex.model.blocks[0]

    def plain_acc(layer, x, rows):
        w = layer.weight.float().cpu()
        s_w = torch.clamp_min(w.abs().amax(dim=1), 1e-12) / 127.0
        w8 = torch.round(w / s_w[:, None])
        xf = x.float().cpu().reshape(-1, x.shape[-1])
        s_x = torch.clamp_min(xf.abs().amax(), 1e-12) / 127.0
        x8 = torch.clamp(torch.round(xf[:rows] / s_x), -127, 127)
        return (x8.double() @ w8.double().T).to(torch.int64)

    def per_tensor_weight_int8(layer):
        w = layer.weight.float()
        s = torch.clamp_min(w.abs().amax(), 1e-12) / 127.0
        s_w = s.expand(w.shape[0])
        return torch.round(w / s_w[:, None]).to(torch.int8), s_w

    exact = {}
    for name, layer in (("qkv", blk.attn.qkv), ("fc1", blk.mlp.fc1)):
        x = inputs[id(layer)]
        with torch.no_grad():
            acc = layer.accumulate(x)[0][:INT8_ROWS].cpu().to(torch.int64)
            ref = plain_acc(layer, x, INT8_ROWS)
            with mock.patch.object(dinov2.QuantDense, "weight_int8", per_tensor_weight_int8):
                wrong = layer.accumulate(x)[0][:INT8_ROWS].cpu().to(torch.int64)
        exact[name] = int((acc != ref).sum())
        check(exact[name] == 0,
              f"int8: {name} int32 products card vs CPU: {exact[name]} differ")
        w_diff = int((wrong != ref).sum())
        log(f"int8: block 0 {name} on {tuple(x.shape)}: int32 products of its first "
            f"{INT8_ROWS} rows card vs plain CPU: {exact[name]} differ (must be 0); "
            f"known-wrong 'per-tensor weight scale': {w_diff} differ")
        if w_diff == 0:
            POWERLESS.append(f"int8 {name} 'per-tensor weight scale': bit-equal")

    # Tokens on the card against the CPU, on one image at INT8_CPU_HW.
    small = phase_images(work, INT8_CPU_HW)[:1]
    cpu_ex = ViTExtractor(weights_path=str(weights), backbone="vitb14", quantize="int8",
                          device="cpu")
    card_tok = ex.dense_features(small).float().cpu().reshape(-1, 768)
    cpu_tok = cpu_ex.dense_features(small).float().reshape(-1, 768)
    cpu_cos = torch.nn.functional.cosine_similarity(card_tok, cpu_tok, dim=-1)
    # The int8 tokens against bf16's, at full size, on the card.
    t8 = ex.dense_features(imgs).float().reshape(-1, 768)
    t16 = bf16_extractor.dense_features(imgs).float().reshape(-1, 768)
    cos = torch.nn.functional.cosine_similarity(t8, t16, dim=-1)
    cpu_mean, cpu_min = cpu_cos.mean().item(), cpu_cos.min().item()
    cos_mean, cos_min = cos.mean().item(), cos.min().item()
    check(cpu_mean > INT8_CPU_COS[0] and cpu_min > INT8_CPU_COS[1],
          f"int8: tokens card vs CPU cosine mean {cpu_mean}, min {cpu_min}")
    check(cos_mean > INT8_COS[0] and cos_min > INT8_COS[1],
          f"int8: int8 vs bf16 tokens cosine mean {cos_mean}, min {cos_min}")
    seconds = {}
    for i, (name, e) in enumerate((("bf16", bf16_extractor), ("int8", ex), ("int8", ex),
                                   ("bf16", bf16_extractor))):
        sync()
        t = time.perf_counter()
        e.extract(work / "images", work / f"int8_rate_{i}.db", camera.model, camera.params)
        sync()
        seconds.setdefault(name, []).append(time.perf_counter() - t)
    rates = {k: [NUM_IMAGES / s for s in v] for k, v in seconds.items()}
    log(f"int8: extraction launches {launches}; tokens card vs CPU at {INT8_CPU_HW} cosine "
        f"mean {cpu_mean:.4f} (> {INT8_CPU_COS[0]}), min {cpu_min:.4f} (> {INT8_CPU_COS[1]}); "
        f"int8 vs bf16 tokens at full size cosine mean {cos_mean:.4f} (> {INT8_COS[0]}), "
        f"min {cos_min:.4f} (> {INT8_COS[1]}); warm extraction of {NUM_IMAGES} images in "
        f"turns (bf16, int8, int8, bf16) img/s {rates}")
    del ex, cpu_ex
    return {"launches": launches, "layer_err_of_bound": layer_worst, "cos_mean": cos_mean,
            "cos_min": cos_min, "cpu_cos_mean": cpu_mean, "img_per_s": rates}


def kernel_busy_share(trace_path: Path) -> dict:
    """From a torch.profiler Chrome trace: the union of the CUDA kernels'
    intervals over the span of the trace's events."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events if "ts" in e]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel" and "dur" in e)
    busy, end = 0.0, -math.inf
    for a, b in kernels:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = max(b for _, b in spans) - min(a for a, _ in spans) if spans else 0.0
    return {"kernels": len(kernels), "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "busy_share": busy / span if span else 0.0}


def profile_phase(work: Path, weights: Path) -> dict:
    """One ``Pipeline.run`` of the trainable path with a profile directory
    (``VIT_COLMAP_PROFILE_DIR``, what ``--profile-dir`` sets) on 2 of the
    slice's images: a trace file must appear and the stage timer must hold
    the three stages; the trace's kernel-busy share is logged."""
    import os
    import shutil

    from vit_colmap_tpu_torch.pipeline import Pipeline
    from vit_colmap_tpu_torch.utils.profiling import GLOBAL_TIMER

    img_dir = work / "profile_images"
    img_dir.mkdir()
    for f in sorted((work / "images").iterdir())[:2]:
        shutil.copy(f, img_dir / f.name)
    prof_dir = work / "profile"
    before = dict(GLOBAL_TIMER.counts)
    os.environ["VIT_COLMAP_PROFILE_DIR"] = str(prof_dir)
    try:
        t = time.perf_counter()
        report = Pipeline(trainable_config(weights), device=DEVICE).run(
            img_dir, work / "profile_out", work / "profile.db")
        wall = time.perf_counter() - t
    finally:
        del os.environ["VIT_COLMAP_PROFILE_DIR"]
    traces = sorted(prof_dir.glob("trace_*.json"))
    check(len(traces) == 1, f"profile: trace files {traces}")
    stages = {s: GLOBAL_TIMER.counts[s] - before.get(s, 0)
              for s in ("extract", "match+verify", "reconstruction")}
    check(all(n == 1 for n in stages.values()), f"profile: stage timer counts {stages}")
    busy = kernel_busy_share(traces[0])
    log(f"profile: Pipeline.run of 2 images with a profile directory in {wall:.1f} s, "
        f"report {report}, trace {traces[0].name} ({traces[0].stat().st_size / 1e6:.1f} MB), "
        f"stages {stages}; kernels busy {busy}\n{GLOBAL_TIMER.summary()}")
    return {"trace_mb": traces[0].stat().st_size / 1e6, **busy}


def train_scalars(out: Path) -> list:
    return [json.loads(x) for x in (out / "scalars.jsonl").read_text().splitlines()]


def train_run(out: Path, data: Path, weights: Path, args: list, n_steps: int) -> dict:
    """One run of the port's training CLI on the tree, which must log
    ``n_steps`` steps (the CLI logs a step that raised and goes on): its
    train lines, the median step seconds of the warm steps (all but the
    run's first), and the card's peak memory above what was allocated
    before the run (earlier phases' tensors), with that baseline."""
    import torch

    from vit_colmap_tpu_torch.training import train

    before = len(train_scalars(out)) if (out / "scalars.jsonl").exists() else 0
    base = 0
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    train.main(["--data-dir", str(data), "--backbone", TRAIN_BACKBONE, "--backbone-weights",
                str(weights), "--target-height", str(TRAIN_SIZE[0] // 14 * 14),
                "--target-width", str(TRAIN_SIZE[1] // 14 * 14), "--val-fraction",
                str(TRAIN_VAL_FRACTION), "--log-interval", "1", "--output-dir", str(out),
                "--device", DEVICE, *args])
    sync()
    wall = time.perf_counter() - t
    lines = train_scalars(out)[before:]
    steps = [x for x in lines if x["event"] == "train"]
    vals = [x for x in lines if x["event"] == "val"]
    check(len(steps) == n_steps and all(math.isfinite(x["total_loss"]) for x in steps)
          and len(vals) == 1 and math.isfinite(vals[0]["total_loss"]),
          f"train: a run logged {len(steps)} of {n_steps} steps, its losses are not finite "
          f"or validation did not run: {lines}")
    cuda = DEVICE == "cuda"
    return {"steps": steps, "val": vals[0]["total_loss"], "wall_s": wall,
            "step_s_first": steps[0]["step_s"],
            "step_s_warm_median": statistics.median(x["step_s"] for x in steps[1:]),
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9 if cuda else None,
            "baseline_gb": base / 1e9 if cuda else None}


LOSS_KEYS = ("total_loss", "detector_loss", "descriptor_loss", "score_loss", "orient_loss",
             "positive_loss", "triplet_loss", "nce_loss", "variance_loss", "token_loss")


def loss_line(step: dict) -> dict:
    return {k: round(step[k], 5) for k in LOSS_KEYS if k in step}


def train_card_cpu(data: Path, weights: Path, heads_dir: Path) -> dict:
    """One fixed batch (two real pairs of the tree at TRAIN_CHECK_HW) through
    one training step in f32 on the card and on the CPU, from the same
    backbone, the trained heads and the same uniforms: the loss components
    and the clipped heads gradients, card against CPU."""
    from unittest import mock

    import numpy as np
    import torch

    from vit_colmap_tpu_torch.dataloader.hpatches_dataset import HPatchesDataset, stack_items
    from vit_colmap_tpu_torch.models.convert import load_torch_checkpoint
    from vit_colmap_tpu_torch.models.dinov2 import make_backbone
    from vit_colmap_tpu_torch.models.feature_model import FeatureHeads, FeatureModelConfig
    from vit_colmap_tpu_torch.training import train_step
    from vit_colmap_tpu_torch.training.checkpoint import load_checkpoint

    ds = HPatchesDataset(data, pair_mode="all_pairs", target_height=TRAIN_CHECK_HW[0],
                         target_width=TRAIN_CHECK_HW[1], seed=0)
    batch = stack_items([ds[0], ds[len(ds) - 1]])  # an illumination and a viewpoint pair
    backbone_sd = load_torch_checkpoint(str(weights))
    heads_sd = load_checkpoint(heads_dir)["heads"]

    def step_on(device, wrong: bool = False):
        if wrong:  # H12 used where H12^-1 belongs
            with mock.patch.object(torch.linalg, "inv", lambda H: H):
                return step_on(device)
        bb, _ = make_backbone(TRAIN_BACKBONE, dtype=torch.float32)
        bb.load_state_dict(backbone_sd)
        heads = FeatureHeads(FeatureModelConfig(backbone=TRAIN_BACKBONE, dtype=torch.float32),
                             bb.cfg.embed_dim)
        heads.load_state_dict(heads_sd)
        bb.to(device).requires_grad_(False)
        heads.to(device)
        recipe = train_step.make_optimizer(total_steps=10, warmup_steps=2)
        step, _ = train_step.make_train_step(bb, heads, recipe,
                                             batch_kwargs=dict(top_k=TRAIN_CHECK_TOPK))
        rng = np.random.default_rng(5)
        _, metrics = step(train_step.init_train_state(heads, recipe),
                          {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                          lambda shape: torch.from_numpy(rng.random(shape, dtype=np.float32)))
        sync()
        return ({k: float(v) for k, v in metrics.items()},
                {k: p.grad.float().cpu() for k, p in heads.named_parameters()})

    def loss_err(m, ref):
        return {k: abs(m[k] - v) / max(abs(v), 1e-6) for k, v in ref.items() if k in LOSS_KEYS}

    m_card, g_card = step_on(DEVICE)
    m_cpu, g_cpu = step_on("cpu")
    grad_err = max((g_card[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-12)
                   for k, g in g_cpu.items())
    wrong = max(loss_err(step_on(DEVICE, wrong=True)[0], m_cpu).values())
    log(f"train: known-wrong 'H not inverted for the transfer': loss relative error "
        f"{wrong:.3g} (must exceed {TRAIN_LOSS_TOL})")
    if not wrong > TRAIN_LOSS_TOL:
        POWERLESS.append(f"train 'H not inverted': {wrong}")
    return {"loss_rel_err": loss_err(m_card, m_cpu), "grad_rel_err": grad_err,
            "loss_card": {k: m_card[k] for k in loss_err(m_card, m_cpu)}}


def train_phase(work: Path, weights: Path) -> dict:
    """The training stack on the card, closed into the trainable_vit
    extractor: the HPatches-layout tree, a frozen-backbone run and its
    resume (the step count continues), a --train-backbone run, one fixed
    batch card against CPU, and the fine-tuned best_model through
    Pipeline.run(extractor_type="trainable_vit") on the slice's images
    (counts cleared: kernel 1 in every backbone layer, kernel 2 once), whose
    matches and fine-tuned backbone's tokens are held against the plain
    versions."""
    import types

    import torch

    from vit_colmap_tpu_torch.database import ColmapDatabase
    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import generate_synthetic_hpatches
    from vit_colmap_tpu_torch.kernels import attention
    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.models.dinov2 import preprocess
    from vit_colmap_tpu_torch.pipeline import Pipeline

    card = nvidia_smi("name,power.limit")
    data = work / "hpatches"
    t = time.perf_counter()
    names = generate_synthetic_hpatches(data, n_illum=TRAIN_SEQUENCES[0],
                                        n_view=TRAIN_SEQUENCES[1], n_img=TRAIN_IMAGES,
                                        size=TRAIN_SIZE, seed=0)
    log(f"train: wrote {len(names)} HPatches-layout sequences of {TRAIN_IMAGES} images at "
        f"{TRAIN_SIZE[1]}x{TRAIN_SIZE[0]} in {time.perf_counter() - t:.1f} s")

    frozen = work / "train_frozen"
    base = ["--batch-size", str(TRAIN_BATCH), "--steps-per-epoch", str(TRAIN_STEPS)]
    first = train_run(frozen, data, weights, base + ["--epochs", "1"], TRAIN_STEPS)
    meta = json.loads((frozen / "meta.json").read_text())
    check(meta == {"epoch": 1, "step": TRAIN_STEPS, "train_backbone": False}
          and (frozen / "best_model" / "state.pt").exists(),
          f"train: frozen run's meta {meta}")
    resumed = train_run(frozen, data, weights,
                        base + ["--epochs", "2", "--resume", str(frozen / "latest")],
                        TRAIN_STEPS)
    meta = json.loads((frozen / "meta.json").read_text())
    check(meta["step"] == 2 * TRAIN_STEPS and resumed["steps"][0]["step"] == TRAIN_STEPS + 1,
          f"train: --resume did not continue the step count: {meta}, "
          f"first resumed step {resumed['steps'][0]['step']}")
    tuned = work / "train_backbone"
    bb = train_run(tuned, data, weights, ["--batch-size", str(TRAIN_BB_BATCH),
                                          "--steps-per-epoch", str(TRAIN_BB_STEPS),
                                          "--epochs", "1", "--train-backbone"],
                   TRAIN_BB_STEPS)
    meta = json.loads((tuned / "meta.json").read_text())
    check(meta == {"epoch": 1, "step": TRAIN_BB_STEPS, "train_backbone": True},
          f"train: --train-backbone run's meta {meta}")
    check(all("token_loss" in x for x in bb["steps"]), "train: no token loss while fine-tuning")
    for label, run in (("frozen", first), ("resumed", resumed), ("train-backbone", bb)):
        log(f"train: {label} run on {card}: {len(run['steps'])} steps, first step "
            f"{run['step_s_first']:.3f} s, warm steps median {run['step_s_warm_median']} s "
            f"(host clock to the loss on the host), run {run['wall_s']:.1f} s with data and "
            f"checkpoints, peak memory {run['peak_gb']} GB above the {run['baseline_gb']} GB "
            f"allocated before the run, validation loss {run['val']:.5f}; "
            f"losses first {loss_line(run['steps'][0])} last {loss_line(run['steps'][-1])}")

    agree = train_card_cpu(data, weights, frozen / "best_model")
    log(f"train: one fixed batch in f32, card vs CPU on {card}: loss relative errors "
        f"{agree['loss_rel_err']} (bound {TRAIN_LOSS_TOL}), heads gradients max |diff| / "
        f"max |CPU| {agree['grad_rel_err']:.3g} (bound {TRAIN_GRAD_TOL})")
    check(max(agree["loss_rel_err"].values()) <= TRAIN_LOSS_TOL
          and agree["grad_rel_err"] <= TRAIN_GRAD_TOL, f"train: card vs CPU {agree}")

    pipeline = Pipeline(trainable_config(tuned / "best_model"), device=DEVICE)
    sync()
    counts.clear()
    report = pipeline.run(work / "images", work / "train_out", work / "train.db")
    sync()
    launches = dict(counts)
    log(f"train: Pipeline.run(trainable_vit) on the fine-tuned best_model, report {report}, "
        f"launches {launches}")
    expect_launches(launches, {"attention_qkv": BACKBONE_LAYERS // 2,
                               "match_topk2_colmax": MATCH_BATCHES}, "train path")
    check_matches(work / "train.db", plain_fused, "train")
    ex = next(iter(pipeline._extractors.values()))
    tokens = types.SimpleNamespace(dense_features=lambda imgs: ex.model.backbone_features(
        preprocess(torch.as_tensor(imgs).to(DEVICE))))
    check_tokens(tokens, work / "images", "attention_qkv", attention.attention_qkv_plain,
                 {}, "train")
    with ColmapDatabase.open_database(work / "train.db") as db:
        ids = sorted(db.read_images())
        kpts = [db.read_keypoints(i) for i in ids]
        descs = [db.read_descriptors(i) for i in ids]
        n_matches = db.num_matches
    check(len(ids) == NUM_IMAGES and all(k.shape[1] == 6 and 256 <= len(k) <= MAX_KEYPOINTS
                                         for k in kpts)
          and all(d.shape == (len(k), 128) for d, k in zip(descs, kpts)) and n_matches > 0,
          f"train: database {[k.shape for k in kpts]}, {n_matches} matches")
    return {"launches": launches, "frozen": first, "resumed": resumed, "train_backbone": bb,
            "card_cpu": agree, "report": report}


# The parallel phase: the mesh paths of parallel/ on one card, as two slots
# on DEVICE (the card reports one device; no several-card machine is
# assumed).  Training: a batch of PAR_TRAIN_BATCH pairs of the train phase's
# tree through one step over two slots and over one, in f32: the split
# changes only which rows each forward holds, so loss components and heads
# gradients agree within f32 rounding (PAR_LOSS_TOL relative, PAR_GRAD_TOL of
# each tensor's largest gradient); DDP's per-slot loss (each slot's own
# roll of the cross-image negatives, pos_weight and variance, averaged) must
# miss PAR_LOSS_TOL.
PAR_SLOTS = 2
PAR_TRAIN_BATCH = 4
PAR_LOSS_TOL = 1e-4
PAR_GRAD_TOL = 3e-3


def match_rows(db_path: Path) -> list:
    import sqlite3

    with sqlite3.connect(db_path) as conn:
        return sorted(conn.execute("SELECT pair_id, rows, cols, data FROM matches").fetchall())


def cleared_copy(src: Path, dst: Path) -> Path:
    """``src`` without its matches and two-view geometries."""
    import shutil
    import sqlite3

    shutil.copy(src, dst)
    with sqlite3.connect(dst) as conn:
        conn.execute("DELETE FROM matches")
        conn.execute("DELETE FROM two_view_geometries")
    return dst


def parallel_train(data: Path, weights: Path, heads_dir: Path, mesh) -> dict:
    """One step over PAR_SLOTS slots and over one, and DDP's per-slot loss,
    on one fixed batch from the same parameters and uniforms."""
    import numpy as np
    import torch

    from vit_colmap_tpu_torch.dataloader.hpatches_dataset import HPatchesDataset, stack_items
    from vit_colmap_tpu_torch.dataloader.training_batch import process_batch
    from vit_colmap_tpu_torch.losses.feature_losses import total_loss
    from vit_colmap_tpu_torch.models.convert import load_torch_checkpoint
    from vit_colmap_tpu_torch.models.dinov2 import make_backbone
    from vit_colmap_tpu_torch.models.feature_model import FeatureHeads, FeatureModelConfig
    from vit_colmap_tpu_torch.training import train_step
    from vit_colmap_tpu_torch.training.checkpoint import load_checkpoint

    ds = HPatchesDataset(data, pair_mode="all_pairs", target_height=TRAIN_CHECK_HW[0],
                         target_width=TRAIN_CHECK_HW[1], seed=0)
    n = len(ds)
    batch = stack_items([ds[i] for i in (0, 1, n - 2, n - 1)][:PAR_TRAIN_BATCH])
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    bb, _ = make_backbone(TRAIN_BACKBONE, dtype=torch.float32)
    bb.load_state_dict(load_torch_checkpoint(str(weights)))
    bb.to(DEVICE).requires_grad_(False)
    heads_sd = load_checkpoint(heads_dir)["heads"]

    def fresh_heads():
        heads = FeatureHeads(FeatureModelConfig(backbone=TRAIN_BACKBONE, dtype=torch.float32),
                             bb.cfg.embed_dim)
        heads.load_state_dict(heads_sd)
        return heads.to(DEVICE)

    def draws():
        rng = np.random.default_rng(7)
        return lambda shape: torch.from_numpy(rng.random(shape, dtype=np.float32))

    def step_over(devices):
        heads = fresh_heads()
        recipe = train_step.make_optimizer(total_steps=10, warmup_steps=2)
        step, _ = train_step.make_train_step(bb, heads, recipe,
                                             batch_kwargs=dict(top_k=TRAIN_CHECK_TOPK),
                                             devices=devices)
        _, metrics = step(train_step.init_train_state(heads, recipe), batch, draws())
        sync()
        return ({k: float(v) for k, v in metrics.items()},
                {k: p.grad.float().cpu() for k, p in heads.named_parameters()})

    def per_slot_loss(k):
        heads, uniforms, parts = fresh_heads(), draws(), []
        with torch.no_grad():
            for i in range(k):
                share = {key: v.chunk(k)[i] for key, v in batch.items()}
                out = total_loss(*process_batch(bb, heads, share, uniforms,
                                                top_k=TRAIN_CHECK_TOPK))
                parts.append({"total_loss": float(out.total),
                              **{key: float(v) for key, v in out.components.items()}})
        return {key: float(np.mean([p[key] for p in parts])) for key in parts[0]}

    def loss_err(m, ref):
        return {k: abs(m[k] - v) / max(abs(v), 1e-6) for k, v in ref.items() if k in LOSS_KEYS}

    m_one, g_one = step_over(mesh.data_devices[:1])
    m_two, g_two = step_over(mesh.data_devices)
    grad_err = max((g_two[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-12)
                   for k, g in g_one.items())
    wrong = loss_err(per_slot_loss(PAR_SLOTS), m_one)
    log(f"parallel: known-wrong 'DDP per-slot loss averaged': loss relative errors {wrong} "
        f"(the largest must exceed {PAR_LOSS_TOL})")
    if not max(wrong.values()) > PAR_LOSS_TOL:
        POWERLESS.append(f"parallel 'DDP per-slot loss': {wrong}")
    return {"loss_rel_err": loss_err(m_two, m_one), "grad_rel_err": grad_err,
            "wrong_loss_rel_err": wrong}


def process_seam() -> dict:
    """parallel/multihost.py from the environment contract: a world of one
    (NCCL on the card), rank, primary, the image plan and one all_gather of
    a device tensor; the group destroyed and the environment put back."""
    import os
    import socket

    import torch
    import torch.distributed as dist

    from vit_colmap_tpu_torch.parallel import multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "NUM_PROCESSES": "1",
           "PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        multi = multihost.initialize()
        check(dist.is_initialized() and dist.get_world_size() == 1 and not multi,
              "parallel: the process group did not form a world of one")
        backend = dist.get_backend()
        check(backend == ("nccl" if DEVICE == "cuda" else "gloo"),
              f"parallel: backend {backend}")
        paths = [f"img_{i:02d}.png" for i in range(NUM_IMAGES)]
        check(multihost.is_primary() and multihost.local_image_slice(paths) == paths,
              "parallel: rank 0 is not primary or does not plan every image")
        x = torch.arange(4, device=DEVICE, dtype=torch.float32) + 1
        got = [torch.zeros_like(x)]
        dist.all_gather(got, x)
        sync()
        check(torch.equal(got[0], x), f"parallel: all_gather gave {got}")
    finally:
        multihost.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(not dist.is_initialized(), "parallel: the process group outlived shutdown")
    return {"backend": backend, "world": 1, "port": port}


def parallel_phase(work: Path, weights: Path, extractor, data: Path, heads_dir: Path) -> dict:
    """The mesh paths of ``parallel/`` as PAR_SLOTS slots on the card: (a) a
    two-slot ViTExtractor (the slice's PCA) extracts the 8 images, one image
    a slot in each batch of IMAGE_BATCH (kernel 1 twice as often a batch as
    on one device), and ``match_exhaustive`` over the slots matches them
    (kernel 2 once a slot for the one pair batch); the slice's one-device
    database through the two-slot matcher gives the slice's matches bit for
    bit; (b) the two-slot extraction of two images against each image
    extracted alone (padded with a zero image, slot 0), bit for bit, and the
    largest token difference from the slice extractor's batch of two;
    (c) ``shard_descriptors`` over the two slots gives the replicated rows
    bit for bit; (d) one training step over two slots against one slot, and
    DDP's per-slot loss; (e) the process seam over NCCL."""
    import dataclasses

    import numpy as np

    from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor
    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.parallel.mesh import get_mesh
    from vit_colmap_tpu_torch.pipeline.match import match_exhaustive
    from vit_colmap_tpu_torch.utils.config import CameraConfig, MatchingConfig
    from vit_colmap_tpu_torch.utils.image_io import imread_rgb

    t0 = time.perf_counter()
    mesh = get_mesh([DEVICE] * PAR_SLOTS)
    ex2 = ViTExtractor(weights_path=str(weights), backbone="vitb14",
                       max_keypoints=MAX_KEYPOINTS, image_batch=IMAGE_BATCH, mesh=mesh)
    ex2.set_pca(*(t.cpu().numpy() for t in extractor._pca))
    cfg = MatchingConfig(pair_batch=PAIR_BATCH, descriptor_encoding="signed",
                         do_verification=False)
    launches = {}

    # (a) Extraction and matching over the slots.
    sync()
    counts.clear()
    ex2.extract(work / "images", work / "par.db", CameraConfig().model)
    sync()
    launches["extract"] = dict(counts)
    expect_launches(launches["extract"], {"attention_qkv": 12 * NUM_IMAGES},
                    "parallel extraction (one image a slot)")
    counts.clear()
    stats = match_exhaustive(work / "par.db", cfg, device_descriptors=ex2.device_cache,
                             mesh=mesh)
    sync()
    launches["match"] = dict(counts)
    expect_launches(launches["match"], {"match_topk2_colmax": PAR_SLOTS * MATCH_BATCHES},
                    "parallel matching")
    check(stats.matched_pairs > 0, f"parallel: no pair matched: {stats}")
    slice_rows = match_rows(work / "run1.db")
    counts.clear()
    match_exhaustive(cleared_copy(work / "run1.db", work / "par_rep.db"), cfg, mesh=mesh)
    sync()
    launches["replicated"] = dict(counts)
    expect_launches(launches["replicated"], {"match_topk2_colmax": PAR_SLOTS * MATCH_BATCHES},
                    "parallel matching of the slice's database")
    check(match_rows(work / "par_rep.db") == slice_rows,
          "parallel: the two-slot matcher's rows differ from the slice's")

    # (c) Descriptors sharded over the slots.
    counts.clear()
    match_exhaustive(cleared_copy(work / "run1.db", work / "par_shard.db"),
                     dataclasses.replace(cfg, shard_descriptors=True), mesh=mesh)
    sync()
    launches["shard_descriptors"] = dict(counts)
    expect_launches(launches["shard_descriptors"],
                    {"match_topk2_colmax": PAR_SLOTS * MATCH_BATCHES},
                    "parallel shard_descriptors matching")
    check(match_rows(work / "par_shard.db") == slice_rows,
          "parallel: shard_descriptors rows differ from the replicated ones")

    # (b) One image a slot against each image alone, bit for bit.
    imgs = np.stack([imread_rgb(f) for f in sorted((work / "images").iterdir())[:PAR_SLOTS]])
    both = ex2.extract_batch(imgs)
    for i in range(PAR_SLOTS):
        alone = ex2.extract_batch(imgs[i:i + 1])
        check(all(np.array_equal(a[i], b[0]) for a, b in zip(both, alone)),
              f"parallel: image {i} of the two-slot batch differs from its extraction alone")
    token_diff = float((ex2.dense_features(imgs) - extractor.dense_features(imgs))
                       .abs().max())
    log(f"parallel: two-slot extraction of {PAR_SLOTS} images equal bit for bit to each "
        f"extracted alone; largest token difference from the slice extractor's batch of "
        f"{PAR_SLOTS} on one device {token_diff:.4g} (logged only: cuBLAS may take other "
        f"kernels for another batch)")

    # (d) Training; (e) the process seam.
    train = parallel_train(data, weights, heads_dir, mesh)
    log(f"parallel: one training step over {PAR_SLOTS} slots against one slot, f32: loss "
        f"relative errors {train['loss_rel_err']} (bound {PAR_LOSS_TOL}), heads gradients "
        f"max |diff| / max |one slot| {train['grad_rel_err']:.3g} (bound {PAR_GRAD_TOL})")
    check(max(train["loss_rel_err"].values()) <= PAR_LOSS_TOL
          and train["grad_rel_err"] <= PAR_GRAD_TOL, f"parallel: training {train}")
    seam = process_seam()
    total = {}
    for run in launches.values():
        for k, v in run.items():
            total[k] = total.get(k, 0) + v
    wall = time.perf_counter() - t0
    log(f"parallel: {PAR_SLOTS} slots on {DEVICE}, launches {launches}, matched pairs "
        f"{stats.matched_pairs}, process seam {seam}, {wall:.1f} s")
    return {"launches": total, "by_run": launches, "train": train, "seam": seam,
            "token_diff": token_diff, "wall_s": wall}


# The hybrid, serve and device-loops phases.  The detectors on one
# structured image at the main path's size, card against CPU: FAST and
# GFTT must be equal; SIFT and ORB are held to tests/test_torch_cv_detectors.py's
# bar against OpenCV (counts within 2%, 95% of the distinct points within
# 0.05 px both ways).
DETECTOR_TOL = 0.05
DETECTOR_SHARE = 0.95
DETECTOR_COUNT_REL = 0.02
DETECTOR_REPS = 3
DEVICE_LOOP_REPS = 3  # back-to-back extractions of the 8 staged images
LOOPED_REPS = 2
LOOPED_REL = 1e-6  # looped checksum against two separate calls'


def detector_calls() -> dict:
    """The hybrid's four detectors at its settings (max_keypoints 4096)."""
    from vit_colmap_tpu_torch.ops import cv_detectors as cd

    return {"sift": lambda g: cd.detect_sift(g, MAX_KEYPOINTS),
            "fast": cd.detect_fast,
            "gftt": lambda g: cd.detect_gftt(g, MAX_KEYPOINTS),
            "orb": lambda g: cd.detect_orb(g, MAX_KEYPOINTS)}


def detectors_check() -> dict:
    """Each detector on one 1190x1596 structured image (seed 0) on the card
    and on the CPU, its card milliseconds (median of DETECTOR_REPS) and the
    kernels one call runs (``torch.profiler``)."""
    import numpy as np
    import torch

    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import make_structured_image
    from vit_colmap_tpu_torch.ops.cv_detectors import point_agreement
    from vit_colmap_tpu_torch.utils.image_io import rgb_to_gray

    gray = torch.from_numpy(rgb_to_gray(make_structured_image(np.random.default_rng(0),
                                                              HEIGHT, WIDTH)))
    gray_dev = gray.to(DEVICE)
    out = {}
    for name, fn in detector_calls().items():
        t = time.perf_counter()
        ref = fn(gray)
        cpu_s = time.perf_counter() - t
        card = [x.cpu() for x in fn(gray_dev)]
        equal = torch.equal(card[0], ref[0]) and torch.equal(card[1], ref[1])
        agree = point_agreement(ref[0], card[0], DETECTOR_TOL)
        ms = cuda_ms(lambda: fn(gray_dev), DETECTOR_REPS)
        calls = profiled(lambda: fn(gray_dev)) if DEVICE == "cuda" else {}
        out[name] = {"keypoints": len(card[0]), "card_ms": ms, "cpu_s": cpu_s,
                     "equal": equal, **agree, **calls}
        log(f"hybrid: detector {name} on {WIDTH}x{HEIGHT}: {len(card[0])} keypoints "
            f"(CPU {len(ref[0])}), card {ms:.2f} ms ({calls}), CPU {cpu_s:.2f} s, "
            f"bit-equal {equal}, agreement {agree}")
    for name, r in out.items():
        if name in ("fast", "gftt"):
            check(r["equal"], f"hybrid: {name} on the card differs from the CPU: {r}")
        else:
            check(r["count_rel"] <= DETECTOR_COUNT_REL
                  and min(r["share_ref"], r["share_out"]) >= DETECTOR_SHARE,
                  f"hybrid: {name} card vs CPU misses the bar: {r}")
    return out


def hybrid_config(weights: Path, pca: Optional[Path] = None, extractor: str = "hybrid"):
    from vit_colmap_tpu_torch.utils.config import Config

    config = Config()
    config.extractor.extractor_type = extractor
    config.extractor.backbone = "vitb14"
    config.extractor.vit_weights_path = str(weights)
    config.extractor.max_keypoints = MAX_KEYPOINTS
    config.extractor.image_batch = IMAGE_BATCH
    config.extractor.pca_path = str(pca) if pca else None
    config.matching.pair_batch = PAIR_BATCH
    return config


def hybrid_phase(work: Path, vit_extractor, weights: Path) -> dict:
    """The slice's 8 images through ``Pipeline.run(extractor_type="hybrid")``
    (OpenCV's SIFT detector on the card, ViT-B/14 descriptors), with the
    main path's PCA saved to a file so the run is warm: counts cleared,
    kernel 1 in every layer (48) and kernel 2 once; the dense tokens and the
    matches against their plain versions; then the four detectors card
    against CPU."""
    import types

    from vit_colmap_tpu_torch.kernels import attention
    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.ops.interpolate import save_pca
    from vit_colmap_tpu_torch.pipeline import Pipeline

    pca = work / "slice_pca.npz"
    save_pca(pca, *vit_extractor._pca)
    pipeline = Pipeline(hybrid_config(weights, pca), device=DEVICE)
    sync()
    counts.clear()
    t = time.perf_counter()
    report = pipeline.run(work / "images", work / "hybrid_out", work / "hybrid.db")
    sync()
    wall = time.perf_counter() - t
    launches = dict(counts)
    log(f"hybrid: Pipeline.run in {wall:.1f} s, report {report}, launches {launches}")
    expect_launches(launches, {"attention_qkv": BACKBONE_LAYERS // 2,
                               "match_topk2_colmax": MATCH_BATCHES}, "hybrid path")
    db_counts = check_database(work / "hybrid.db", "hybrid")
    hybrid = next(iter(pipeline._extractors.values()))
    check_tokens(types.SimpleNamespace(dense_features=hybrid._dense_features),
                 work / "images", "attention_qkv", attention.attention_qkv_plain, {}, "hybrid")
    check_matches(work / "hybrid.db", plain_fused, "hybrid")
    return {"wall_s": wall, "report": report, "launches": launches, "database": db_counts,
            "detectors": detectors_check()}


def serve_phase(work: Path, weights: Path) -> dict:
    """One PipelineServer on the card (the vit extractor, no PCA file) runs
    the 8 images, a copy of them in a second directory, and a job whose
    image_dir is a plain file: results [True, True, False], one extractor
    built; the first job fits the PCA (kernel 1 96 times), the second
    reuses the warm extractor and the built kernels (48)."""
    import shutil

    from vit_colmap_tpu_torch.database import ColmapDatabase
    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.pipeline.serve import PipelineServer, SceneJob

    copy = work / "serve_copy"
    shutil.copytree(work / "images", copy)
    not_a_dir = work / "serve_not_a_dir"
    not_a_dir.write_text("a plain file where a directory should be")
    server = PipelineServer(hybrid_config(weights, extractor="vit"), device=DEVICE)
    jobs = [SceneJob(image_dir=d, output_dir=work / f"serve_{i}")
            for i, d in enumerate((work / "images", copy, not_a_dir))]
    launches = []
    for job in jobs:
        sync()
        counts.clear()
        server.run_job(job)
        sync()
        launches.append(dict(counts))
    results = server.results
    walls = [round(r.wall_s, 3) for r in results]
    log(f"serve: jobs ok {[r.ok for r in results]}, wall_s {walls}, launches {launches}, "
        f"extractors built {len(server.pipeline._extractors)}, reports "
        f"{[r.report for r in results[:2]]}, error {results[2].error}")
    check([r.ok for r in results] == [True, True, False],
          f"serve: job results {[r.ok for r in results]}")
    check(len(server.pipeline._extractors) == 1,
          f"serve: {len(server.pipeline._extractors)} extractors built")
    expect_launches(launches[0], {"attention_qkv": BACKBONE_LAYERS,
                                  "match_topk2_colmax": MATCH_BATCHES}, "serve job 1")
    expect_launches(launches[1], {"attention_qkv": BACKBONE_LAYERS // 2,
                                  "match_topk2_colmax": MATCH_BATCHES}, "serve job 2")
    rows = []
    for i in range(2):
        with ColmapDatabase.open_database(work / f"serve_{i}" / "database.db") as db:
            ids = sorted(db.read_images())
            rows.append([db.read_keypoints(k).tobytes() for k in ids])
    log(f"serve: job 2's keypoints equal job 1's: {rows[0] == rows[1]}")
    total = {}
    for n in launches:
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
    return {"wall_s": walls, "ok": [r.ok for r in results], "launches": total,
            "same_keypoints": rows[0] == rows[1]}


def device_loops_phase(work: Path, extractor) -> dict:
    """The main path's ViTExtractor on its 8 images staged on the card:
    ``device_extract_pipelined`` gives the device rate; the checksum of
    ``device_extract_looped`` must equal the same checksum summed from
    separate ``extract_batch_async`` calls."""
    import numpy as np
    import torch

    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.utils.image_io import imread_rgb

    imgs = np.stack([imread_rgb(f) for f in sorted((work / "images").iterdir())])
    staged = torch.from_numpy(extractor.to_wire(imgs)).to(DEVICE)
    sync()
    counts.clear()
    secs = extractor.device_extract_pipelined(staged, DEVICE_LOOP_REPS)
    launches = dict(counts)
    rate = DEVICE_LOOP_REPS * len(imgs) / secs
    looped = float(extractor.device_extract_looped(staged, LOOPED_REPS))
    acc = torch.zeros((), dtype=torch.float32, device=DEVICE)
    with torch.no_grad():
        for i in range(LOOPED_REPS):
            _, sc, _, desc = extractor.extract_batch_async(staged + i, packed=True)[:4]
            acc = acc + sc.sum(dtype=torch.float32) + desc.sum(dtype=torch.int32).to(torch.float32)
    separate = float(acc)
    log(f"device loops: device_extract_pipelined {DEVICE_LOOP_REPS} x {len(imgs)} images in "
        f"{secs:.3f} s ({rate:.2f} img/s), launches {launches}; looped checksum {looped!r}, "
        f"separate calls {separate!r} (bit-equal {looped == separate})")
    check(abs(looped - separate) <= LOOPED_REL * abs(separate),
          f"device loops: looped checksum {looped} vs separate calls {separate}")
    return {"pipelined_s": secs, "img_per_s": rate, "looped": looped, "separate": separate,
            "launches": launches}


# The native-io phase: host C++ decode and database writes.
NATIVE_JPEG_QUALITY = 95
NATIVE_JPEG_ERR = 8.0  # mean |decoded - source| of a JPEG it wrote (the JAX test's bound)
NATIVE_TURNS = 2  # native and host extractions, in turns
NATIVE_DECODE_THREADS = (1, 2, 8)
NATIVE_DECODE_REPS = 3


def ldd_sonames(path: Path) -> list[str]:
    """The shared libraries ``ldd`` resolves for ``path``, as "soname =>
    file"; unresolved ones say "not found"."""
    out = subprocess.run(["ldd", str(path)], capture_output=True, text=True).stdout
    return [line.strip().split(" (0x")[0] for line in out.splitlines() if "=>" in line]


def db_summary(db_path: Path, report: dict) -> dict:
    from vit_colmap_tpu_torch.database import ColmapDatabase

    with ColmapDatabase.open_database(db_path) as db:
        return {"images": db.num_images, "verified_pairs": db.num_verified_pairs,
                "matches": db.num_matches,
                "registered": report.get("registered_images", 0)}


def table_rows(db_path: Path, table: str) -> list:
    import sqlite3

    con = sqlite3.connect(db_path)
    try:
        return con.execute(f"SELECT * FROM {table} ORDER BY 1").fetchall()
    finally:
        con.close()


# libjpeg's bytes of the committed JPEGs (tests/data/jpeg/, written by
# scripts/torch_jpeg_fixtures.py): the codec's route against them, per plane.
# nvJPEG's planes are finished by libjpeg's own upsampling and colour
# conversion (csrc/host/jpeg_color.cc), so only its IDCT differs: it rounds a
# sample to the other side of a half at most, one level, and the triangle
# filters and the resample are averages, which keep a one-level error at one
# (YCbCr and I420 planes, max 1).  RGB adds Y's level to 1.402 (R), 1.772
# (B) or 0.344 + 0.714 (G) levels of chroma: at most 3 after rounding.  The
# means bound the share of samples the IDCT moves: 5% of the YCbCr / I420
# samples by one level (PR 16's card: 1.0-2.7%), and 0.10 for RGB (0.03-0.06).
JPEG_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "jpeg"
NVJPEG_BOUNDS = {"ycc": (1, 0.05), "i420": (1, 0.05), "rgb": (3, 0.10)}


def jpeg_fixture_diffs() -> dict:
    """route ("ycc", "i420", "rgb") -> plane -> (max, mean) absolute
    difference of this machine's JPEG route from libjpeg's committed bytes,
    the worst over the fixtures (I420 decoded on card 0)."""
    import numpy as np

    from vit_colmap_tpu_torch.utils import native_io

    worst: dict = {}
    jpgs = sorted(JPEG_FIXTURES.glob("*.jpg"))
    check(len(jpgs) == 6, f"JPEG fixtures: {len(jpgs)} under {JPEG_FIXTURES}")
    for jpg in jpgs:
        ref = np.load(jpg.with_suffix(".npz"))
        tw, th = (int(v) for v in ref["size"])
        i420, ok = native_io.decode_batch_i420([jpg], tw, th, device=0)
        check(bool(ok.all()), f"JPEG fixture {jpg.name}: decode failed")
        n, nc = tw * th, (tw // 2) * (th // 2)
        cut = {"Y": slice(0, n), "U": slice(n, n + nc), "V": slice(n + nc, n + 2 * nc)}
        got = {"ycc": native_io.decode_jpeg_ycc(jpg), "rgb": native_io.decode_jpeg_rgb(jpg)}
        planes = {route: {p: (got[route][..., c], ref[route][..., c])
                          for c, p in enumerate("YUV" if route == "ycc" else "RGB")}
                  for route in got}
        planes["i420"] = {p: (i420[0].ravel()[c], ref["i420"].ravel()[c])
                          for p, c in cut.items()}
        for route, by_plane in planes.items():
            for p, (a, b) in by_plane.items():
                d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                mx, mean = worst.setdefault(route, {}).get(p, (0, 0.0))
                worst[route][p] = (max(mx, int(d.max())), max(mean, float(d.mean())))
    return worst


def native_io_phase(work: Path, weights: Path) -> dict:
    """The host C++ libraries on the main path: (a) both load, with the
    sonames ldd resolves; (b) the 8 PNGs through ``Pipeline.run`` with
    yuv420c4 twice on one extractor, the first on the native route (8 I420
    decodes, kernel 1 96 times) and the second on the host route at full
    range (none, 48), kernel 2 once and the native writer each time; tokens
    against the plain path; the decoder's I420 against ``pack_yuv420_full``
    of the same pixels (no resize at this size); decode + pack and the
    extract stage native against the numpy route, in turns; (c) the 8
    images written as JPEG (quality 95) through ``Pipeline.run`` with rgb
    and with yuv420c4 beside the PNG run, and the codec against the pixels
    it encoded; (d) scene-50's database through ``match_exhaustive`` with
    the native writer and with ColmapDatabase in turns: equal rows; (e)
    JPEG decode rates on 1, 2 and 8 threads.  The mapper logs each image
    it could not register with its PnP inliers."""
    import contextlib
    import shutil
    import sqlite3
    import types
    from unittest import mock

    import numpy as np
    import torch

    from vit_colmap_tpu_torch.database import native as db_native
    from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor
    from vit_colmap_tpu_torch.kernels import attention, host_build
    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.ops import transfer
    from vit_colmap_tpu_torch.pipeline import Pipeline
    from vit_colmap_tpu_torch.pipeline import match as match_module
    from vit_colmap_tpu_torch.pipeline.match import match_exhaustive
    from vit_colmap_tpu_torch.utils import native_io
    from vit_colmap_tpu_torch.utils.config import CameraConfig, MatchingConfig
    from vit_colmap_tpu_torch.utils.image_io import imread_rgb, write_jpeg

    # (a) The libraries: neither may be missing on the card.
    libs = {"image_io": native_io.load_native(), "db_writer": db_native.load_native()}
    check(all(lib is not None for lib in libs.values()),
          f"native-io: host library unavailable: {libs}")
    sonames = {name: ldd_sonames(host_build.library_path(name)) for name in libs}
    codec = host_build.jpeg_codec()
    log(f"native-io: libraries load, JPEG codec {codec}, ldd {sonames}")
    check(not any("not found" in s for v in sonames.values() for s in v),
          f"native-io: unresolved libraries {sonames}")

    def counted_run(pipeline, image_dir: Path, tag: str):
        sync()
        counts.clear()
        native_io.decodes.clear()
        db_native.writers.clear()
        t = time.perf_counter()
        report = pipeline.run(image_dir, work / f"{tag}_out", work / f"{tag}.db")
        sync()
        run = {"wall_s": time.perf_counter() - t, "report": report,
               "launches": dict(counts), "decodes": dict(native_io.decodes),
               "writers": dict(db_native.writers)}
        run["database"] = db_summary(work / f"{tag}.db", report)
        log(f"native-io: {tag}: Pipeline.run in {run['wall_s']:.2f} s, report {report}, "
            f"launches {run['launches']}, decodes {run['decodes']}, writers "
            f"{run['writers']}, database {run['database']}")
        check(run["writers"] == {"native": 1}, f"native-io: {tag} wrote through "
              f"{run['writers']}, not the native writer")
        return run

    def yuv_config(fmt: str):
        config = hybrid_config(weights, extractor="vit")
        config.extractor.transfer_format = fmt
        return config

    # (b) The 8 PNGs, native route then host route at full range.
    img_dir = work / "images"
    pngs = sorted(img_dir.iterdir())
    pipeline = Pipeline(yuv_config("yuv420c4"), device=DEVICE)
    png_runs = [counted_run(pipeline, img_dir, f"native_png_{k}") for k in range(2)]
    expect_launches(png_runs[0]["launches"], {"attention_qkv": BACKBONE_LAYERS,
                                              "match_topk2_colmax": MATCH_BATCHES},
                    "native-io png run 1")
    expect_launches(png_runs[1]["launches"], {"attention_qkv": BACKBONE_LAYERS // 2,
                                              "match_topk2_colmax": MATCH_BATCHES},
                    "native-io png run 2")
    check(png_runs[0]["decodes"] == {"i420": NUM_IMAGES},
          f"native-io: the first run took the host route: decodes {png_runs[0]['decodes']}")
    check(png_runs[1]["decodes"] == {},
          f"native-io: the warm run decoded natively: {png_runs[1]['decodes']}")
    extractor = next(iter(pipeline._extractors.values()))
    check(extractor._yuv_full_range, "native-io: full range not set by the native route")
    check_tokens(types.SimpleNamespace(
        dense_features=lambda x: extractor.dense_features(extractor.to_wire(x))),
        img_dir, "attention_qkv", attention.attention_qkv_plain, {}, "native-io")

    rgb = np.stack([imread_rgb(f) for f in pngs])
    packed, ok = native_io.decode_batch_i420(pngs, WIDTH, HEIGHT)
    ref = np.stack([transfer.pack_yuv420_full(im) for im in rgb])
    n_y = HEIGHT * WIDTH
    diff = packed.reshape(NUM_IMAGES, -1).astype(np.int16) - ref.reshape(NUM_IMAGES, -1)
    i420_diff = {"luma_bytes": int(np.count_nonzero(diff[:, :n_y])),
                 "chroma_bytes": int(np.count_nonzero(diff[:, n_y:])),
                 "chroma_max": int(np.abs(diff[:, n_y:]).max()),
                 "chroma_of": int(diff[:, n_y:].size)}
    log(f"native-io: I420 of the 8 PNGs against pack_yuv420_full: {i420_diff} (luma "
        "must be equal; chroma is the mean of rounded samples against the rounded "
        "mean, within 1)")
    check(bool(ok.all()) and i420_diff["luma_bytes"] == 0 and i420_diff["chroma_max"] <= 1,
          f"native-io: I420 against pack_yuv420_full: {i420_diff}")

    def native_pack():
        return transfer.i420_to_c4(native_io.decode_batch_i420(pngs, WIDTH, HEIGHT)[0])

    def numpy_pack():
        return transfer.pack_batch_yuv420_c4(
            np.stack([imread_rgb(f) for f in pngs]), full_range=True)

    pack_s = {"native": [], "numpy": []}
    for name in ("native", "numpy", "numpy", "native"):
        t = time.perf_counter()
        (native_pack if name == "native" else numpy_pack)()
        pack_s[name].append(time.perf_counter() - t)
    extract_s = {"native": [], "host": []}
    for k in range(NATIVE_TURNS):
        ex = ViTExtractor(weights_path=str(weights), backbone="vitb14",
                          max_keypoints=MAX_KEYPOINTS, image_batch=IMAGE_BATCH,
                          pca_path=str(work / "slice_pca.npz"),
                          transfer_format="yuv420c4", device=DEVICE)
        for route in ("native", "host"):
            native_io.decodes.clear()
            sync()
            t = time.perf_counter()
            ex.extract(img_dir, work / f"native_turn_{k}_{route}.db", CameraConfig().model)
            sync()
            extract_s[route].append(time.perf_counter() - t)
            check((native_io.decodes.get("i420", 0) == NUM_IMAGES) == (route == "native"),
                  f"native-io: turn {k} {route} decodes {dict(native_io.decodes)}")
    log(f"native-io: decode + yuv420c4 pack of the 8 PNGs, seconds in turns {pack_s}; "
        f"extract stage (PCA loaded) seconds in turns {extract_s}; Pipeline.run extract "
        f"stage: native route (PCA fit) {png_runs[0]['report']['extract_s']} s, host "
        f"route {png_runs[1]['report']['extract_s']} s")

    # (c) The same images as JPEG, with both wire formats; the codec against
    # the pixels it encoded.
    jpg_dir = work / "native_jpeg"
    jpg_dir.mkdir()
    for f, im in zip(pngs, rgb):
        write_jpeg(jpg_dir / f"{f.stem}.jpg", im, quality=NATIVE_JPEG_QUALITY)
    jpgs = sorted(jpg_dir.iterdir())
    packed, ok = native_io.decode_batch_i420(jpgs, WIDTH, HEIGHT)
    check(bool(ok.all()), f"native-io: JPEG decode failed: {ok}")
    unpacked = transfer.unpack_yuv420(torch.from_numpy(packed).to(DEVICE), full_range=True)
    jpeg_err = {
        "i420": float((unpacked.cpu() - torch.from_numpy(rgb).float()).abs().mean()),
        "rgb": float(np.mean([np.abs(imread_rgb(j).astype(np.float32) - im).mean()
                              for j, im in zip(jpgs, rgb)])),
    }
    log(f"native-io: {NUM_IMAGES} JPEGs (quality {NATIVE_JPEG_QUALITY}, {codec}) decoded "
        f"against their source pixels, mean abs {jpeg_err} (bound {NATIVE_JPEG_ERR})")
    check(max(jpeg_err.values()) < NATIVE_JPEG_ERR, f"native-io: JPEG error {jpeg_err}")
    fixture_diffs = jpeg_fixture_diffs()
    log(f"native-io: the {codec} route against libjpeg's bytes of the committed JPEGs "
        f"(4:2:0, 4:2:2, 4:4:0, 4:4:4, gray), worst (max, mean) |diff| per plane "
        f"{fixture_diffs}, bounds (max, mean) {NVJPEG_BOUNDS}")
    for route, by_plane in fixture_diffs.items():
        mx, mean = NVJPEG_BOUNDS[route]
        check(all(d[0] <= mx and d[1] <= mean for d in by_plane.values()),
              f"native-io: {route} planes {by_plane} beyond ({mx}, {mean})")
    jpeg_runs = {}
    for fmt, decodes in (("rgb", {"rgb": NUM_IMAGES}),
                         ("yuv420c4", {"i420": NUM_IMAGES, "rgb": NUM_IMAGES})):
        run = counted_run(Pipeline(yuv_config(fmt), device=DEVICE), jpg_dir,
                          f"native_jpeg_{fmt}")
        expect_launches(run["launches"], {"attention_qkv": BACKBONE_LAYERS,
                                          "match_topk2_colmax": MATCH_BATCHES},
                        f"native-io jpeg {fmt}")
        check(run["decodes"] == decodes,
              f"native-io: jpeg {fmt} decodes {run['decodes']}, expected {decodes}")
        check(run["database"]["images"] == NUM_IMAGES,
              f"native-io: jpeg {fmt} database {run['database']}")
        jpeg_runs[fmt] = run
    log(f"native-io: JPEG runs beside the PNG run: png {png_runs[0]['database']}, "
        f"jpeg rgb {jpeg_runs['rgb']['database']}, jpeg yuv420c4 "
        f"{jpeg_runs['yuv420c4']['database']}")

    # (d) Scene-50's 1,225 pairs through either writer, in turns; the
    # seconds spent in the writer (opening it, every insert, the commits
    # and closing it) are summed by a proxy around the one the matcher opens.
    class TimedWriter:
        def __init__(self, writer, seconds: list):
            self._writer, self._seconds = writer, seconds

        def __getattr__(self, name):
            fn = getattr(self._writer, name)

            def timed(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self._seconds[0] += time.perf_counter() - t
            return timed

    def timed_open(db_path, seconds: list):
        t = time.perf_counter()
        writer = db_native.open_bulk_writer(db_path)
        seconds[0] += time.perf_counter() - t
        return TimedWriter(writer, seconds)

    config = MatchingConfig()
    pairs = SCENE_VIEWS * (SCENE_VIEWS - 1) // 2
    writer_s, rows, scene_launches = {"native": [], "python": []}, {}, {}
    for writer in ("native", "python", "python", "native"):
        db = work / f"native_scene_{writer}.db"
        shutil.copy(work / "scene_sift.db", db)
        with contextlib.closing(sqlite3.connect(db)) as con:
            for table in ("matches", "two_view_geometries"):
                con.execute(f"DELETE FROM {table}")
            con.commit()
        fallback = (mock.patch.object(db_native, "load_native", lambda: None)
                    if writer == "python" else contextlib.nullcontext())
        sync()
        counts.clear()
        db_native.writers.clear()
        write_s = [0.0]
        with fallback, mock.patch.object(match_module, "open_bulk_writer",
                                         lambda p: timed_open(p, write_s)):
            stats = match_exhaustive(db, config, device=DEVICE)
        sync()
        scene_launches = dict(counts)
        check(db_native.writers == {writer: 1},
              f"native-io: scene-50 {writer} run wrote through {dict(db_native.writers)}")
        expect_launches(scene_launches, {"match_topk2_colmax":
                                         math.ceil(pairs / config.pair_batch)},
                        f"native-io scene-50 {writer}")
        writer_s[writer].append({"match_s": stats.match_seconds,
                                 "verify_s": stats.verify_seconds, "write_s": write_s[0]})
        got = [table_rows(db, t) for t in ("matches", "two_view_geometries")]
        check(rows.setdefault(writer, got) == got, f"native-io: scene-50 {writer} rows "
              "differ between its two runs")
    same = rows["native"] == rows["python"]
    log(f"native-io: scene-50 {pairs} pairs, match / verify / write seconds by writer in turns "
        f"{writer_s}; {len(rows['native'][0])} match rows, {len(rows['native'][1])} "
        f"geometry rows, equal across writers: {same}")
    check(same and len(rows["native"][0]) > 0, "native-io: scene-50 rows differ by writer")

    # (e) JPEG decode rates.
    ms_per_image = {}
    for n in NATIVE_DECODE_THREADS:
        ts = []
        for _ in range(NATIVE_DECODE_REPS):
            t = time.perf_counter()
            native_io.decode_batch_i420(jpgs, WIDTH, HEIGHT, n_threads=n)
            ts.append(time.perf_counter() - t)
        ms_per_image[n] = 1e3 * statistics.median(ts) / NUM_IMAGES
    log(f"native-io: JPEG decode to I420 at {WIDTH}x{HEIGHT} ({codec}), ms per image by "
        f"threads {ms_per_image}")

    launches = {}
    for run in (*png_runs, *jpeg_runs.values()):
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"codec": codec, "sonames": sonames, "i420_vs_pack": i420_diff,
            "pack_s": pack_s, "extract_s": extract_s,
            "png": [r["database"] for r in png_runs],
            "jpeg": {k: r["database"] for k, r in jpeg_runs.items()},
            "jpeg_err": jpeg_err, "jpeg_fixtures": fixture_diffs, "writer_s": writer_s,
            "decode_ms": ms_per_image,
            "launches": launches, "scene_launches": scene_launches}


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
    first_models = dict(pipeline.reconstructions)
    report = pipeline.run(img_dir, work / "out", work / "run2.db")
    sync()
    same_pairs = verified_pairs(work / "run1.db") == verified_pairs(work / "run2.db")
    log(f"times: warm run's verified pairs equal to the first run's: {same_pairs}; models "
        f"(registered images, points) first {model_sizes(first_models)}, warm "
        f"{model_sizes(pipeline.reconstructions)}")
    check(not same_pairs or model_sizes(first_models) == model_sizes(pipeline.reconstructions),
          "the warm run mapped equal verified pairs into another model")
    t = time.perf_counter()
    fixedmax_extractor.extract(img_dir, work / "fixedmax2.db", CameraConfig().model)
    sync()
    fixedmax_s = time.perf_counter() - t
    rates = {
        "extract_img_per_s": NUM_IMAGES / report["extract_s"],
        "match_pairs_per_s": NUM_PAIRS / report["match_s"],
        "extract_match_pairs_per_s": NUM_PAIRS / (report["extract_s"] + report["match_s"]),
        "extract_s": report["extract_s"],
        "match_s": report["match_s"],
        "verify_s": report["verify_s"],
        "verify_chunks": report["verify_chunks"],
        "match_verify_s": report["match_verify_s"],
        "reconstruction_s": report["reconstruction_s"],
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


# The eval phase: the evaluation entry points (scripts/torch_eval_hpatches.py,
# torch_quality_bakeoff.py, torch_compare_metrics.py, torch_aggregate_results.py)
# on the card, at their defaults (480 x 640, ViT-B/14, 2,048 keypoints,
# reference_only pairs) on a synthetic tree cut to one illumination and one
# viewpoint sequence of EVAL_IMAGES images (6 pairs).  The vit row on the
# card is held against the same row on the CPU on EVAL_CPU_PAIRS pairs: equal
# keypoint counts (every valid token of the grid is a keypoint on both), and
# average matches within EVAL_CPU_MATCHES (relative, or 2 matches) and MMA@3
# within EVAL_CPU_MMA: the backbone runs in bf16 on both, the card through
# kernel 1 and the CPU through PyTorch's plain attention, which round
# differently and move a few keypoints and descriptor bytes; the same bounds
# hold the port's evaluation against the JAX package's in
# tests/test_torch_eval_hpatches.py.  The bake-off trains 1 epoch of
# EVAL_TRAIN_STEPS steps at batch EVAL_TRAIN_BATCH and reconstructs
# EVAL_RECON_CAMS rendered views.  The phase must end within EVAL_BUDGET_S,
# which keeps the whole script well inside its time limit: this work took
# 71.95 s on one host and 108.1 s on another whose host-bound phases ran
# 1.3-1.5x slower (the reconstructions and evaluations are host-bound;
# PERF.md section 6), so the bound is that slower reading and a tenth.
EVAL_EXTRACTORS = ("sift", "vit", "trainable_vit", "hybrid")
EVAL_SIZE = (480, 640)
EVAL_IMAGES = 4
EVAL_KEYPOINTS = 2048
EVAL_CPU_PAIRS = 2
EVAL_CPU_MATCHES = 0.1
EVAL_CPU_MMA = 0.1
EVAL_TRAIN_STEPS = 4
EVAL_TRAIN_BATCH = 2
EVAL_RECON_CAMS = 8
EVAL_BUDGET_S = 120.0
BAKEOFF_ROWS = ("sift", "vit", "trainable_vit", "trainable_vit_trained")


def eval_row(result) -> dict:
    return {"pairs": len(result.pairs), "avg_matches": result.avg_matches,
            "mma": result.mma, "h_acc": result.homography_accuracy}


def plain_pair_matcher(d1, d2, v1, v2):
    """The plain single-pair matcher on a batch of one pair."""
    from vit_colmap_tpu_torch.ops.matching import match_pair

    return match_pair(d1[0], d2[0], v1[0], v2[0])[None]


def hpatches_eval(work: Path, weights: Path) -> dict:
    """(a) Each extractor of the port's HPatches evaluation on the cut tree,
    its launch counts cleared before and read after: kernel 1 in every
    backbone layer of each unique image for the ViT extractors, kernel 2
    once a pair for all; then every pair's kernel-2 matches against plain
    ``match_pair`` on the card, and the vit row against the CPU's."""
    import threading

    import numpy as np

    import scripts.torch_eval_hpatches as teval
    from scripts.torch_quality_bakeoff import with_backbone
    from vit_colmap_tpu_torch.dataloader.hpatches_dataset import HPatchesDataset
    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import generate_synthetic_hpatches
    from vit_colmap_tpu_torch.kernels import launches as counts

    tree = work / "eval_hpatches"
    generate_synthetic_hpatches(tree, n_illum=1, n_view=1, n_img=EVAL_IMAGES, size=EVAL_SIZE,
                                seed=0)
    ds = HPatchesDataset(tree, split="all", pair_mode="reference_only",
                         target_height=EVAL_SIZE[0], target_width=EVAL_SIZE[1])
    check(len(ds) == 2 * (EVAL_IMAGES - 1), f"eval: {len(ds)} pairs")

    def vit_row(device) -> dict:
        """The vit row on the first EVAL_CPU_PAIRS pairs (a fresh extractor:
        the PCA fitted on image 1, as in the full evaluation)."""
        fn = teval.make_extract_fn("vit", "vitb14", str(weights), EVAL_KEYPOINTS, device=device)
        feats = []
        t = time.perf_counter()
        res, _ = teval.evaluate_dataset(
            ds, lambda img: feats.append(fn(img)) or feats[-1], EVAL_CPU_PAIRS, device=device)
        return {**eval_row(res), "keypoints": [len(f[0]) for f in feats],
                "wall_s": time.perf_counter() - t}

    # The CPU's row runs on a thread of its own while the card evaluates
    # (the CPU's operations hold no lock that the card's path needs).
    cpu_out = {}

    def cpu_row():
        try:
            cpu_out["row"] = vit_row("cpu")
        except BaseException as e:  # re-raised on the main thread below
            cpu_out["error"] = e

    cpu_thread = threading.Thread(target=cpu_row, name="eval-cpu", daemon=True)
    cpu_thread.start()
    trainable = with_backbone(None, str(weights), work / "eval_trainable", "vitb14")
    real_match = teval.mutual_match
    rows, launches, total = {}, {}, {}
    for name in EVAL_EXTRACTORS:
        w = trainable if name == "trainable_vit" else str(weights)
        fn = teval.make_extract_fn(name, "vitb14", w, EVAL_KEYPOINTS, device=DEVICE)
        pairs = []

        def recorded(f1, f2, device=None, matcher=None):
            out = real_match(f1, f2, device, matcher)
            if threading.current_thread() is threading.main_thread():  # not the CPU's row
                pairs.append((f1, f2, out))
            return out

        teval.mutual_match = recorded
        try:
            sync()
            counts.clear()
            t = time.perf_counter()
            result, pps = teval.evaluate_dataset(ds, fn, device=DEVICE)
            sync()
            wall = time.perf_counter() - t
            launches[name] = dict(counts)
        finally:
            teval.mutual_match = real_match
        matched = sum(1 for f1, f2, _ in pairs if len(f1[0]) and len(f2[0]))
        layers = 12 * 2 * EVAL_IMAGES if name != "sift" else 0
        expect_launches(launches[name], {"attention_qkv": layers,
                                         "match_topk2_colmax": matched}, f"eval {name}")
        for f1, f2, out in pairs:
            plain = real_match(f1, f2, DEVICE, plain_pair_matcher)
            check(np.array_equal(out, plain), f"eval {name}: kernel 2's matches differ from "
                  f"plain match_pair ({len(out)} vs {len(plain)} rows)")
        rows[name] = {**eval_row(result), "wall_s": wall, "pairs_per_s": pps}
        for k, v in launches[name].items():
            total[k] = total.get(k, 0) + v
        log(f"eval: {name} on the card: {result.summary().strip()} | avg matches "
            f"{result.avg_matches:.1f}, {pps:.2f} pairs/s, {wall:.1f} s, launches "
            f"{launches[name]}; {len(pairs)} pairs' kernel-2 matches equal plain match_pair")

    card = vit_row(DEVICE)
    cpu_thread.join()
    if "error" in cpu_out:
        raise cpu_out["error"]
    cpu = cpu_out["row"]
    log(f"eval: vit on {EVAL_CPU_PAIRS} pairs, card {card} vs cpu {cpu}")
    check(card["keypoints"] == cpu["keypoints"],
          f"eval: vit keypoint counts card {card['keypoints']} vs cpu {cpu['keypoints']}")
    check(abs(card["avg_matches"] - cpu["avg_matches"])
          <= max(2.0, EVAL_CPU_MATCHES * cpu["avg_matches"])
          and abs(card["mma"][3.0] - cpu["mma"][3.0]) <= EVAL_CPU_MMA,
          f"eval: vit card vs cpu out of bounds: {card} vs {cpu}")
    return {"rows": rows, "launches": total, "by_extractor": launches,
            "vit_card_cpu": {"card": card, "cpu": cpu}}


def bakeoff_run(work: Path, weights: Path) -> dict:
    """(b) The bake-off with training on the cut tree, its launch counts
    cleared before and read after (kernels 1 and 2 and no other); every row
    in QUALITY.json and QUALITY.md, and the trained row loaded from the
    checkpoint this run trained (its heads, the --weights backbone)."""
    import torch

    import scripts.torch_quality_bakeoff as tbake
    from vit_colmap_tpu_torch.features import trainable_vit_extractor as ttve
    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.training.checkpoint import load_checkpoint
    from vit_colmap_tpu_torch.utils import metrics as metrics_mod

    out = work / "bakeoff"
    argv = ["--work-dir", str(out), "--extractors", "sift,vit,trainable_vit", "--train",
            "--backbone", "vitb14", "--height", str(EVAL_SIZE[0]), "--width",
            str(EVAL_SIZE[1]), "--recon-cams", str(EVAL_RECON_CAMS), "--n-illum", "1",
            "--n-view", "1", "--n-img", str(EVAL_IMAGES), "--epochs", "1",
            "--steps-per-epoch", str(EVAL_TRAIN_STEPS), "--batch-size", str(EVAL_TRAIN_BATCH),
            "--max-keypoints", str(EVAL_KEYPOINTS), "--weights", str(weights),
            "--device", DEVICE]
    loaded, recorded = [], []
    real_load = ttve.TrainableViTExtractor._load_checkpoint
    real_metrics = metrics_mod.MetricsExtractor.extract_all_metrics

    def load(self, path):
        loaded.append(str(path))
        return real_load(self, path)

    def extract_all(self, *a, **kw):
        recorded.append(real_metrics(self, *a, **kw))
        return recorded[-1]

    ttve.TrainableViTExtractor._load_checkpoint = load
    metrics_mod.MetricsExtractor.extract_all_metrics = extract_all
    try:
        sync()
        counts.clear()
        t = time.perf_counter()
        results = tbake.main(argv)
        sync()
        wall = time.perf_counter() - t
        launches = dict(counts)
    finally:
        ttve.TrainableViTExtractor._load_checkpoint = real_load
        metrics_mod.MetricsExtractor.extract_all_metrics = real_metrics
    log(f"bakeoff: {wall:.1f} s, launches {launches}")
    check(launches.get("attention_qkv", 0) > 0 and launches.get("match_topk2_colmax", 0) > 0
          and set(launches) <= {"attention_qkv", "match_topk2_colmax"},
          f"bakeoff: launches {launches}")
    saved = json.loads((out / "QUALITY.json").read_text())
    md = (out / "QUALITY.md").read_text()
    for section in ("hpatches", "hpatches_holdout", "reconstruction"):
        check(list(saved[section]) == list(BAKEOFF_ROWS),
              f"bakeoff: QUALITY.json {section} rows {list(saved[section])}")
    check(all(md.count(f"| {row} |") == 3 for row in BAKEOFF_ROWS),
          f"bakeoff: QUALITY.md rows {[md.count(f'| {r} |') for r in BAKEOFF_ROWS]}")
    trained = out / "checkpoints" / "best_model"  # train_heads' choice
    if not trained.exists():
        trained = out / "checkpoints" / "latest"
    combined = out / "weights_trainable_vit_trained"
    check(str(combined) in loaded, f"bakeoff: trained row loaded {loaded}")
    ours, ref = load_checkpoint(combined), load_checkpoint(trained)
    check(ours["heads"].keys() == ref["heads"].keys()
          and all(torch.equal(ours["heads"][k], ref["heads"][k]) for k in ref["heads"]),
          "bakeoff: the trained row's heads are not the trained checkpoint's")
    backbone = torch.load(weights, map_location="cpu", weights_only=True)
    check(all(torch.equal(ours["backbone"][k], backbone[k]) for k in backbone),
          "bakeoff: the trained row's backbone is not --weights")
    check(len(recorded) == len(BAKEOFF_ROWS), f"bakeoff: {len(recorded)} metrics results")
    for row, res in zip(BAKEOFF_ROWS, recorded):
        res.extractor_type = row
    for section in ("hpatches", "hpatches_holdout"):
        for row, r in saved[section].items():
            log(f"bakeoff: {section} {row}: pairs {r['pairs']}, avg matches "
                f"{r['avg_matches']:.1f}, MMA@1/3/5 {[round(r['mma'][k], 4) for k in r['mma']]}, "
                f"H-acc@1/3/5 {[round(v, 4) for v in r['homography_accuracy'].values()]}")
    for row, r in saved["reconstruction"].items():
        rec, pose = r["reconstruction"] or {}, r.get("pose_vs_gt") or {}
        log(f"bakeoff: reconstruction {row}: registered {rec.get('registered_images', 0)} "
            f"of {EVAL_RECON_CAMS}, points {rec.get('total_3d_points', 0)}, rotation error "
            f"{pose.get('pose_rot_err_deg_mean')} deg over {pose.get('aligned_cameras')} "
            f"aligned cameras, {r['wall_clock_s']:.1f} s")
    return {"wall_s": wall, "launches": launches, "results": saved, "metrics": recorded,
            "loaded": loaded}


def reports_run(work: Path, metrics: list) -> dict:
    """(c) The bake-off's reconstruction rows exported with
    ``export_metrics``, then compared and aggregated; each report must name
    every row."""
    import re

    import scripts.torch_aggregate_results as tagg
    import scripts.torch_compare_metrics as tcmp
    from vit_colmap_tpu_torch.utils.export import export_metrics

    root = work / "eval_metrics"
    for res in metrics:
        export_metrics(res, root)
    t = time.perf_counter()
    tcmp.main(["--results-dir", str(root), "--dataset", "synthetic", "--scene", "scene",
               "--extractors", *BAKEOFF_ROWS, "--output", str(root / "compare.md")])
    tagg.main(["--results-dir", str(root), "--output", str(root / "report.md"),
               "--csv", str(root / "all.csv")])
    wall = time.perf_counter() - t
    compare, report = (root / "compare.md").read_text(), (root / "report.md").read_text()
    check("| Metric | " + " | ".join(BAKEOFF_ROWS) + " |" in compare
          and all(re.search(rf"^{row} ", report, re.M) for row in BAKEOFF_ROWS),
          "eval: a report lacks an extractor")
    log(f"reports: compare.md ({len(compare.splitlines())} lines) and report.md "
        f"({len(report.splitlines())} lines) over {len(metrics)} exported rows in {wall:.2f} s")
    return {"wall_s": wall, "compare_lines": len(compare.splitlines()),
            "report_lines": len(report.splitlines())}


def eval_phase(work: Path, weights: Path) -> dict:
    """The evaluation entry points on the card: (a) the HPatches evaluation
    of each extractor, (b) the bake-off with training, (c) the reports over
    its exported metrics; the seconds of each part, within EVAL_BUDGET_S."""
    t0 = time.perf_counter()
    hp = hpatches_eval(work, weights)
    t1 = time.perf_counter()
    bake = bakeoff_run(work, weights)
    t2 = time.perf_counter()
    reports = reports_run(work, bake["metrics"])
    t3 = time.perf_counter()
    seconds = {"hpatches": t1 - t0, "bakeoff": t2 - t1, "reports": t3 - t2, "total": t3 - t0}
    log(f"eval: seconds {seconds}; launches eval {hp['launches']}, bakeoff {bake['launches']}")
    check(seconds["total"] <= EVAL_BUDGET_S,
          f"eval: the phase took {seconds['total']:.1f} s, over {EVAL_BUDGET_S} s")
    return {"seconds": seconds, "launches": hp["launches"], "bakeoff_launches": bake["launches"],
            "rows": hp["rows"], "vit_card_cpu": hp["vit_card_cpu"], "reports": reports}


# The scripts phase: the port's remaining script entry points on the card,
# each driven with the launch counts cleared before and read after.
# scripts/torch_bench_matching.py at its defaults (64 images x 4,096 random
# unit descriptors, 2,016 pairs in chunks of 16: kernel 2 once a chunk),
# two of its chunks and one chunk of matching descriptors held against the
# plain matcher on the card index for index; torch_bench_trainstep.py at its
# defaults (vitb14, batch 2 at 476 x 644, top-k 256; PyTorch's fused
# attention, no kernel of the port) with TRAINSTEP_STEPS timed steps, and
# its step sequence run again from the same seeds, the two bit for bit;
# torch_bench_serve.py at 480 x 640 and 2,048 SIFT keypoints with
# SERVE_SCENES scenes of SERVE_IMAGES views (kernel 2 once a matching
# chunk); torch_sift_fidelity_table.py on all 8 cases against the committed
# cv2 rows, held to the reference's bars, and its two pinned-zoom rows,
# reported outside the means; the three token visualisers'
# compute functions at vits14 on a rendered VIS_SIZE pair; torch_diag_scene.py
# on the first served scene's database; torch_bisect_geometry.py at 480 x
# 640 with BISECT_IMAGES views and the variants BISECT_VARIANTS (the
# trainable phase's heads and backbone: kernel 1 in every backbone layer,
# kernel 2 once a matching chunk).  The phase within SCRIPTS_BUDGET_S.
SCRIPTS_BUDGET_S = 90.0
BENCH_MATCH = {"images": 64, "keypoints": 4096, "dim": 128, "pair_batch": 16}
TRAINSTEP_STEPS = 10  # the script's default is 20
TRAINSTEP = {"backbone_name": "vitb14", "batch_size": 2, "height": 476, "width": 644,
             "top_k": 256}
SERVE_SCENES = 3
SERVE_IMAGES = 6  # the script's default is 20
SERVE_SIZE = (480, 640)
SERVE_KEYPOINTS = 2048
VIS_SIZE = (476, 644)
BISECT_IMAGES = 6  # the script's default is 50
BISECT_SIZE = (480, 640)
BISECT_VARIANTS = ("asis", "siftloc", "sift")


def bench_matching_run() -> dict:
    """(a) The matching benchmark at its defaults: kernel 2 once a chunk of
    the timed loop; its first and last chunks, and one chunk of noisy
    permuted copies (which match), against the plain matcher."""
    import numpy as np
    import torch

    import scripts.torch_bench_matching as tbm
    from vit_colmap_tpu_torch.kernels import launches as counts
    from vit_colmap_tpu_torch.ops.matching import get_pair_matcher, match_pairs_batched

    out = tbm.bench(**BENCH_MATCH, device=DEVICE, before_timed=counts.clear)
    sync()
    launches = dict(counts)
    chunks = out["chunks"]
    expect_launches(launches, {"match_topk2_colmax": len(chunks)}, "bench_matching")
    desc, valid = tbm.make_descriptors(BENCH_MATCH["images"], BENCH_MATCH["keypoints"],
                                       BENCH_MATCH["dim"], DEVICE)
    for c in (0, len(chunks) - 1):
        ii, jj = (torch.from_numpy(chunks[c][:, k]).to(DEVICE) for k in (0, 1))
        plain = match_pairs_batched(desc[ii], desc[jj], valid[ii], valid[jj])
        check(torch.equal(out["outs"][c], plain),
              f"bench_matching: chunk {c}'s kernel-2 matches differ from the plain matcher")
    rng = np.random.default_rng(1)
    P, K, D = BENCH_MATCH["pair_batch"], BENCH_MATCH["keypoints"], BENCH_MATCH["dim"]
    base = rng.standard_normal((P, K, D)).astype(np.float32)
    noisy = [base + 0.3 * rng.standard_normal((P, K, D)).astype(np.float32) for _ in range(2)]
    d1, d2 = (torch.from_numpy(n / np.linalg.norm(n, axis=-1, keepdims=True)).to(DEVICE)
              for n in (noisy[0], noisy[1][:, rng.permutation(K)]))
    v = torch.ones((P, K), dtype=torch.bool, device=DEVICE)
    kernel, plain = get_pair_matcher()(d1, d2, v, v), match_pairs_batched(d1, d2, v, v)
    check(torch.equal(kernel, plain), "bench_matching: a matching chunk's kernel-2 matches "
          "differ from the plain matcher")
    matched = sum(int((o >= 0).sum()) for o in out["outs"])
    share = float((kernel >= 0).float().mean())
    log(f"bench_matching: {out['value']} pairs/s ({out['num_pairs']} pairs, {out['seconds']} "
        f"s), launches {launches}; chunks 0 and {len(chunks) - 1} ({matched} matches in all "
        f"chunks: random descriptors) and a matching chunk ({share:.1%} of rows matched) "
        f"equal the plain matcher")
    return {"json": {k: v for k, v in out.items() if k not in ("outs", "chunks")},
            "launches": launches, "matching_chunk_share": share}


def bench_trainstep_run() -> dict:
    """(b) The training-step benchmark (no kernel of the port), then its step
    sequence again from the same seeds, which must equal the benchmark's
    bit for bit (losses and heads)."""
    import torch

    import scripts.torch_bench_trainstep as tbt
    from vit_colmap_tpu_torch.kernels import launches as counts

    sync()
    counts.clear()
    out, run = tbt.bench(**TRAINSTEP, steps=TRAINSTEP_STEPS, device=DEVICE)
    sync()
    launches = dict(counts)
    expect_launches(launches, {}, "bench_trainstep")
    losses = run["losses"].tolist()
    check(len(losses) == TRAINSTEP_STEPS + 2 and all(math.isfinite(x) for x in losses),
          f"bench_trainstep: losses {losses}")
    again = tbt.sequence(**TRAINSTEP, steps=TRAINSTEP_STEPS, device=torch.device(DEVICE))
    repro = tbt.compare_runs(run, again)
    check(repro["bit_equal"], f"bench_trainstep: two runs of the step sequence differ: {repro}")
    log(f"bench_trainstep: {out['s_per_step']} s a step, {out['images_per_sec']} img/s, "
        f"first step {out['compile_s']} s, final loss {out['final_loss']:.6f}, launches "
        f"{launches}; its {TRAINSTEP_STEPS + 2} steps again from the same seeds: {repro}")
    return {"json": out, "launches": launches, "repro": repro}


def bench_serve_run(work: Path) -> dict:
    """(c) The serving benchmark at 480 x 640 and 2,048 keypoints (SIFT):
    every job ok and registering, kernel 2 and no other kernel."""
    import scripts.torch_bench_serve as tserve
    from vit_colmap_tpu_torch.kernels import launches as counts

    sync()
    counts.clear()
    out = tserve.main(["--scenes", str(SERVE_SCENES), "--images", str(SERVE_IMAGES),
                       "--height", str(SERVE_SIZE[0]), "--width", str(SERVE_SIZE[1]),
                       "--max-keypoints", str(SERVE_KEYPOINTS), "--work-dir",
                       str(work / "serve_bench"), "--device", DEVICE])
    sync()
    launches = dict(counts)
    check(set(launches) == {"match_topk2_colmax"} and launches["match_topk2_colmax"]
          >= SERVE_SCENES, f"bench_serve: launches {launches}")
    scenes = out["scenes"]
    check(len(scenes) == SERVE_SCENES and all(s["ok"] and s.get("registered_images", 0) >= 2
                                              for s in scenes),
          f"bench_serve: scenes {scenes}")
    log(f"bench_serve: cold {out['cold']} s, warm mean {out['warm_mean']} s, amortization "
        f"{out['amortization_x']}x, per scene (wall, registered, points) "
        f"{[(s['wall_s'], s['registered_images'], s.get('points3d')) for s in scenes]}, "
        f"launches {launches}")
    return {"json": {k: v for k, v in out.items() if k != "scenes"}, "scenes": scenes,
            "launches": launches}


def sift_fidelity_run() -> dict:
    """(d) The fidelity table on every case against the committed cv2 rows
    (each rendered pair's sha1 first), held to the reference's bars, and
    its pinned-zoom rows, reported outside the means."""
    import scripts.torch_sift_fidelity_table as tfid
    from vit_colmap_tpu_torch.kernels import launches as counts

    sync()
    counts.clear()
    out = tfid.run(device=DEVICE)
    launches = dict(counts)
    expect_launches(launches, {}, "sift_fidelity")
    for line in tfid.table(out["rows"], out["pinned_rows"]).splitlines():
        log(f"sift_fidelity: {line}")
    why = tfid.missed(out)
    log(f"sift_fidelity: mean volume ratio {out['value']}, mean MMA@3 ratio "
        f"{out['mma_ratio_mean']} (bars {tfid.VOLUME_BAR}, {tfid.MMA_BAR}); cv2 "
        f"{out['cv2_version']} rows from the fixture")
    check(not why, "sift_fidelity: " + "; ".join(why))
    return {"json": {k: v for k, v in out.items() if k not in ("rows", "pinned_rows")},
            "rows": out["rows"], "pinned_rows": out["pinned_rows"]}


def visualizers_run() -> dict:
    """(e) The three token visualisers' compute functions at vits14 (random
    weights) on a rendered pair; PyTorch's fused attention, no kernel of the
    port."""
    import numpy as np

    import scripts.torch_visualize_hpatches_warping as twarp
    import scripts.torch_visualize_invariant_points as tinv
    import scripts.torch_visualize_training_sampling as tsamp
    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import (
        make_structured_image,
        warp_perspective,
    )
    from vit_colmap_tpu_torch.dataloader.synthetic_homography import (
        SyntheticHomographyConfig,
        generate_random_homography,
    )
    from vit_colmap_tpu_torch.kernels import launches as counts

    rng = np.random.default_rng(9)
    h, w = VIS_SIZE
    img1 = make_structured_image(rng, h, w)
    H = generate_random_homography(w, h, SyntheticHomographyConfig.conservative(), rng)
    img2 = warp_perspective(img1, H, (w, h))
    sync()
    counts.clear()
    feats = tinv.feature_fn("vits14", None, DEVICE)
    inv = tinv.compute(img1, img2, H, feats)
    warp = twarp.compute(img1, img2, H, feats)
    samp = tsamp.compute(img1, img2, H, feats)
    sync()
    launches = dict(counts)
    expect_launches(launches, {}, "visualizers")
    gh, gw = h // 14, w // 14
    check(inv["valid"].sum() > 0 and np.isfinite(inv["sim"]).all(),
          f"visualizers: {int(inv['valid'].sum())} invariant points")
    check(warp["warped"].shape == (gh, gw, 384) and np.isfinite(warp["mean_similarity"])
          and warp["valid"].mean() > 0.5, "visualizers: the warping panels")
    check(samp["hard_xy"].shape == (32, 4, 2) and len(samp["sel"]) == 5
          and np.isfinite(samp["hard_s"]).all(), "visualizers: the sampling panels")
    res = {"invariant_points": int(inv["valid"].sum()),
           "invariant_sim_mean": float(inv["sim"].mean()),
           "warp_mean_similarity": warp["mean_similarity"],
           "warp_valid_share": float(warp["valid"].mean()),
           "sampling_points": int(samp["valid"].sum())}
    log(f"visualizers: at vits14 on a {h}x{w} pair: {res}, launches {launches}")
    return res


def diag_run(db: Path) -> dict:
    """(f) The mapper diagnostic on a served scene's database: a verdict for
    each candidate pair, at least one that initializes."""
    import scripts.torch_diag_scene as tdiag
    from vit_colmap_tpu_torch.kernels import launches as counts

    counts.clear()
    out = tdiag.main(["--db", str(db), "--top", "16", "--device", DEVICE])
    expect_launches(dict(counts), {}, "diag_scene")
    check(out["value"] >= 1 and len(out["rows"]) == sum(out["verdicts"].values()),
          f"diag_scene: {out['verdicts']}")
    log(f"diag_scene: {db.parent.parent.name}: verdicts {out['verdicts']} over "
        f"{len(out['rows'])} pairs")
    return {"verdicts": out["verdicts"], "pairs": len(out["rows"])}


def bisect_run(work: Path, weights: Path) -> dict:
    """(g) The geometry bisection with the trainable phase's checkpoint:
    kernel 1 in every backbone layer of the trainable extractions (asis: the
    images in batches of 2; siftloc: one image at a time), kernel 2 once a
    matching chunk of each variant."""
    import scripts.torch_bisect_geometry as tbis
    from vit_colmap_tpu_torch.kernels import launches as counts

    sync()
    counts.clear()
    out = tbis.main(["--images", str(BISECT_IMAGES), "--height", str(BISECT_SIZE[0]),
                     "--width", str(BISECT_SIZE[1]), "--backbone", "vitb14", "--weights",
                     str(weights), "--variants", ",".join(BISECT_VARIANTS), "--work-dir",
                     str(work / "bisect"), "--device", DEVICE])
    sync()
    launches = dict(counts)
    layers = 12 * (math.ceil(BISECT_IMAGES / IMAGE_BATCH) * ("asis" in BISECT_VARIANTS)
                   + BISECT_IMAGES * ("siftloc" in BISECT_VARIANTS))
    pairs = BISECT_IMAGES * (BISECT_IMAGES - 1) // 2
    expect_launches(launches, {"attention_qkv": layers, "match_topk2_colmax":
                               len(BISECT_VARIANTS) * math.ceil(pairs / 16)}, "bisect")
    rows = out["variants"]
    log(f"bisect: {BISECT_IMAGES} views at {BISECT_SIZE[0]}x{BISECT_SIZE[1]}: "
        + "; ".join(f"{v}: registered {r.get('registered')}, points {r.get('points3d')}, "
                    f"rot err {r.get('rot_err_deg')} deg, reproj {r.get('reproj_px')} px, "
                    f"extract {r['extract_s']} s, dispersion "
                    f"{r['keypoint_dispersion'].get('entropy_norm')}, dispatch "
                    f"{r['dispatch_rt_ms']} ms" for v, r in rows.items())
        + f"; launches {launches}")
    return {"variants": rows, "launches": launches}


def scripts_phase(work: Path, trainable_weights: Path) -> dict:
    """The remaining script entry points on the card, (a) to (g), each
    part's seconds, the phase within SCRIPTS_BUDGET_S."""
    t0 = time.perf_counter()
    seconds, out = {}, {}
    for name, fn in (("bench_matching", bench_matching_run),
                     ("bench_trainstep", bench_trainstep_run),
                     ("bench_serve", lambda: bench_serve_run(work)),
                     ("sift_fidelity", sift_fidelity_run),
                     ("visualizers", visualizers_run),
                     ("diag_scene", lambda: diag_run(work / "serve_bench" / "scene_0" / "out"
                                                     / "database.db")),
                     ("bisect", lambda: bisect_run(work, trainable_weights))):
        t = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t
    seconds["total"] = time.perf_counter() - t0
    log(f"scripts: seconds {seconds}; cuts: bench_trainstep {TRAINSTEP_STEPS} timed steps "
        f"(default 20), bench_serve {SERVE_SCENES} scenes of {SERVE_IMAGES} views (default 3 "
        f"of 20), the visualisers' compute functions only (no figure: no matplotlib here), "
        f"bisect {BISECT_IMAGES} views (default 50) and variants {','.join(BISECT_VARIANTS)} "
        f"(default asis,offsets0,quad,siftloc,sift); bench_matching and sift_fidelity uncut")
    check(seconds["total"] <= SCRIPTS_BUDGET_S,
          f"scripts: the phase took {seconds['total']:.1f} s, over {SCRIPTS_BUDGET_S} s")
    return {"seconds": seconds, **out,
            "launches": {"bench_matching": out["bench_matching"]["launches"],
                         "bench_serve": out["bench_serve"]["launches"],
                         "bisect": out["bisect"]["launches"]}}


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
    build_s, host_build_s = build_phase()
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
        verification = verification_phase()
        mapper = mapper_phase(work)
        card_cpu = card_cpu_phase(work)
        scene_dir, scene_K, render_s = render_phase(work)
        sift_result = sift_phase(scene_dir, work / "images")
        scene = scene_phase(work, scene_dir, scene_K, render_s)
        wire = wire_phase(work, extractor, work / "vitb14_random.pth")
        trainable = trainable_phase(work, extractor)
        vitg14 = vitg14_phase(work)
        registers = registers_phase(work)
        int8 = int8_phase(work, extractor, work / "vitb14_random.pth")
        profile = profile_phase(work, work / "trainable_heads.pt")
        hybrid = hybrid_phase(work, extractor, work / "vitb14_random.pth")
        serve = serve_phase(work, work / "vitb14_random.pth")
        loops = device_loops_phase(work, extractor)
        native = native_io_phase(work, work / "vitb14_random.pth")
        times, rates, split, f32_ms, matcher = times_phase(
            pipeline, work, work / "images", inputs_main, fixedmax_extractor, int8_ops,
            max_mhz, sass["match_topk2_int8"]["main_loop_opcodes"])
        train = train_phase(work, work / "vitb14_random.pth")
        parallel = parallel_phase(work, work / "vitb14_random.pth", extractor,
                                  work / "hpatches", work / "train_frozen" / "best_model")
        evaluation = eval_phase(work, work / "vitb14_random.pth")
        scripts = scripts_phase(work, work / "trainable_heads.pt")
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
    # Launches on the paths of this slice and the earlier ones, by kernel.
    paths = {"main": main_launches, "wire": wire["launches"],
             "trainable": trainable["launches"], "vitg14": vitg14["launches"],
             "registers": registers["launches"], "int8": int8["launches"],
             "train": train["launches"], "hybrid": hybrid["launches"],
             "serve": serve["launches"], "device_loops": loops["launches"],
             "native_io": native["launches"], "native_io_scene": native["scene_launches"],
             "parallel": parallel["launches"], "eval": evaluation["launches"],
             "bakeoff": evaluation["bakeoff_launches"],
             **{f"scripts_{k}": v for k, v in scripts["launches"].items()},
             "fixedmax": fixedmax_launches, **{f"paths_{k}": v for k, v in
                                              path_launches.items()}}
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
            "launches_by_path": {p: n[name] for p, n in paths.items() if n.get(name)},
        })
    log(f"done: build {build_s:.1f} s, host libraries {host_build_s}, database {db_counts}, main-path verification "
        f"{report['verify_s']} s (chunks {report['verify_chunks']}), calibrated "
        f"verification {verification}, mapper {mapper}, card vs CPU {card_cpu}, "
        f"sift {sift_result}, scene-50 {scene}, wire {wire}, "
        f"trainable { {k: v for k, v in trainable.items() if k != 'pipeline'} }, "
        f"vitg14 {vitg14}, registers {registers}, int8 {int8}, profile {profile}, "
        f"train card vs CPU {train['card_cpu']}, "
        f"hybrid { {k: v for k, v in hybrid.items() if k != 'launches'} }, serve {serve}, "
        f"device loops {loops}, "
        f"parallel { {k: v for k, v in parallel.items() if k != 'launches'} }, "
        f"native-io { {k: v for k, v in native.items() if 'launches' not in k} }, "
        f"eval { {k: v for k, v in evaluation.items() if 'launches' not in k} }, "
        f"scripts seconds {scripts['seconds']}, trainer repro "
        f"{scripts['bench_trainstep']['repro']}, "
        f"rates {rates}, "
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
