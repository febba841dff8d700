"""Extraction traffic: a closed loop of one client handing batches of RGB
images to ``ViTExtractor.extract_batch`` and waiting for their keypoints
and descriptors in host memory.

Set-up builds the extractor, copies the seed's weights and PCA into it,
makes the image pool on the card and warms the one batch shape up.  The
window runs batches from the pool in turn.  A sample of the window's
batches, drawn from the seed, is kept and judged against the plain
reference once the program is freed.

Traffic parameters: the extractor's deployment settings (``image_batch``,
``transfer_format``, ``attn_impl``, ``quantize``), ``pool_images``,
``warmup_batches``, ``keep_share`` (the share of batches kept for the
check) and ``keep_max``.
"""

from __future__ import annotations

import gc
import time
import traceback

import numpy as np
import torch

from benchmark.harness import inputs
from benchmark.harness.stats import percentile, window_rate
from benchmark.harness.trace import span
from benchmark.reference import features as ref_features
from benchmark.reference import vit as ref_vit

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MATCH_RADIUS = 0.75  # map cells within which a keypoint counts as found
NEAR_RADIUS = 0.25  # the same count at a radius that refinement's errors pass
OFF_BY = 2  # descriptor steps from which a byte counts as off
FAR_GAP = 0.1  # map cells from which a refined position counts as off
# The numbers this driver reads; a cell's limits file compares some of them.
NUMBERS = ("kp_miss", "kp_miss_quarter", "desc_off_share", "refine_gap_mean",
           "refine_gap_p99", "refine_far_share")


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 variant: str | None = None):
        self.cfg, self.traffic, self.seed = config, traffic, int(seed)
        self.device = device
        self.quantize = {None: traffic["quantize"], "int8": "int8"}[variant]
        self.request_s: list[float] = []
        self.kept: list[tuple[int, tuple]] = []
        self.attempted = self.failed = self.images = 0
        self.errors: list[str] = []

    # ----------------------------------------------------------- set-up
    def setup(self, mark=lambda label: None) -> None:
        from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor

        mark("import_program")
        c, t = self.cfg, self.traffic
        self.ext = ViTExtractor(
            backbone=c["backbone"], max_keypoints=c["max_keypoints"],
            descriptor_dim=c["descriptor_dim"], saliency=c["saliency"],
            nms_radius=c["nms_radius"], nms_mode=c["nms_mode"], refine=c["refine"],
            bin_size=c["bin_size"], k_per_bin=c["k_per_bin"],
            image_batch=t["image_batch"], dtype=DTYPES[c["dtype"]],
            transfer_format=t["transfer_format"], quantize=self.quantize,
            attn_impl=t["attn_impl"], device=self.device,
        )
        mark("extractor")
        dev = self.ext.device
        shapes = {k: tuple(v.shape) for k, v in self.ext.model.state_dict().items()}
        self.weights = inputs.vit_weights(shapes, c["hidden_size"], self.seed, dev)
        self.ext.model.load_state_dict(self.weights)
        self.pca = inputs.pca(c["hidden_size"], c["descriptor_dim"], self.seed, dev)
        self.ext.set_pca(self.pca[0].cpu(), self.pca[1].cpu())
        mark("weights")
        pool = inputs.textures(t["pool_images"], c["image_height"], c["image_width"],
                               self.seed, dev)
        self.pool = pool.cpu().numpy()
        del pool
        b = t["image_batch"]
        self.batches = [np.ascontiguousarray(self.pool[i:i + b])
                        for i in range(0, len(self.pool), b)]
        mark("inputs")
        for i in range(t["warmup_batches"]):
            self.ext.extract_batch(self.batches[i % len(self.batches)])
        mark("warmup")

    # ----------------------------------------------------------- window
    def window(self, seconds: float, traced: bool) -> None:
        ext = self.ext
        if traced:  # the detection span, from this file; the program is not edited
            detect = ext._detect

            def spanned(*a, **k):
                with span("bench.detect", True):
                    return detect(*a, **k)

            ext._detect = spanned
        keep = np.random.default_rng([self.seed, 11])
        b = self.traffic["image_batch"]
        i = 0
        self.t_start = now = time.perf_counter()
        deadline = self.t_start + seconds
        while now < deadline:
            k = i % len(self.batches)
            t_in = time.perf_counter()
            self.attempted += 1
            with span("bench.batch", traced):
                try:
                    out = ext.extract_batch(self.batches[k])
                except Exception:  # a failed request: counted, its trace kept
                    self.failed += 1
                    self.errors.append(traceback.format_exc())
                    out = None
            now = time.perf_counter()
            self.request_s.append(now - t_in)
            if out is not None:
                self.images += b
                if keep.random() < self.traffic["keep_share"] and \
                        len(self.kept) < self.traffic["keep_max"]:
                    self.kept.append((k, out))
            i += 1
        self.t_end = now
        if traced:
            del ext._detect

    def end_to_end(self) -> dict:
        return {
            "extract_img_per_s": window_rate(self.images, self.t_start, self.t_end),
            "extract_batch_ms_p95": 1e3 * percentile(self.request_s, 95),
        }

    def counters(self) -> dict:
        return {"images": self.images, "batches": self.attempted - self.failed}

    def release(self) -> None:
        del self.ext
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def cleanup(self) -> None:
        """Nothing outside the process to remove."""

    # ------------------------------------------------------------ check
    def judge(self) -> dict:
        """The kept batches against the reference of their pool images: each
        number's worst image."""
        c = self.cfg
        dev = self.weights["pos_embed"].device
        comps, mean = self.pca
        refs: dict[int, list] = {}
        worst = dict.fromkeys(NUMBERS, 0.0 if self.kept else float("inf"))
        for k, out in self.kept:
            if k not in refs:
                refs[k] = []
                for img in self.batches[k]:
                    fmap = ref_vit.features(torch.from_numpy(img).to(dev), self.weights, c)
                    refs[k].append((fmap, *ref_features.keypoints(fmap, c)))
            xy, _scores, valid, desc = out[:4]
            for j, (fmap, rxy, rvalid, rcell) in enumerate(refs[k]):
                got = compare(xy[j], valid[j], desc[j], fmap, rxy, rvalid, rcell, comps, mean)
                for name, v in got.items():
                    worst[name] = max(worst[name], v)
        return worst


def compare(xy, valid, desc, fmap, rxy, rvalid, rcell, comps, mean) -> dict:
    """One image's keypoints and descriptors against the reference's.

    ``kp_miss``: the port's keypoints with no reference keypoint within
    MATCH_RADIUS map cells, plus any shortfall in their count, as a share of
    the reference's keypoints (``kp_miss_quarter``: within NEAR_RADIUS).
    ``desc_off_share``: the share of the port's descriptor bytes that differ
    by OFF_BY or more from the reference's descriptor at the port's own
    keypoint (a difference of one is the truncation of a value that lies
    near a step).  Refinement: each port keypoint is paired with the
    reference keypoint chosen on its own map cell (the refined offset stays
    within half a cell of it on each axis), and the gap between the two
    refined positions is read: ``refine_gap_mean``, ``refine_gap_p99`` and
    ``refine_far_share``, the share of pairs farther apart than FAR_GAP."""
    dev = fmap.device
    xy = torch.as_tensor(xy, device=dev)
    valid = torch.as_tensor(valid, device=dev)
    desc = torch.as_tensor(desc, device=dev)
    p, r, rc = xy[valid].float(), rxy[rvalid].float(), rcell[rvalid].float()
    if len(p) == 0 or len(r) == 0:
        return dict.fromkeys(NUMBERS, 1.0)
    dist = torch.cdist(p, r, compute_mode="donot_use_mm_for_euclid_dist")
    near = dist.min(dim=1).values
    short = max(0, len(r) - len(p))
    own_cell = torch.cdist(p, rc, p=float("inf")) <= 0.5 + 1e-4
    gap = torch.where(own_cell, dist, torch.inf).min(dim=1).values
    gap = gap[torch.isfinite(gap)]
    if len(gap) == 0:
        gap = torch.ones(1, device=dev)
    ref_desc = ref_features.describe(fmap, p, comps, mean)
    off = (desc[valid].int() - ref_desc.int()).abs() >= OFF_BY
    return {"kp_miss": (int((near > MATCH_RADIUS).sum()) + short) / len(r),
            "kp_miss_quarter": (int((near > NEAR_RADIUS).sum()) + short) / len(r),
            "desc_off_share": float(off.float().mean()),
            "refine_gap_mean": float(gap.mean()),
            "refine_gap_p99": float(torch.quantile(gap, 0.99)),
            "refine_far_share": float((gap > FAR_GAP).float().mean())}
