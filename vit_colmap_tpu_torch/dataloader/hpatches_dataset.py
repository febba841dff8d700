"""HPatches sequence dataset on the host, in numpy.

Counterpart of ``vit_colmap_tpu/dataloader/hpatches_dataset.py``: ``i_*``
(illumination) and ``v_*`` (viewpoint) sequences of ``1.ppm`` ..
``6.ppm`` with ``H_1_2`` .. ``H_1_6``; splits all / illumination /
viewpoint / train (``i_``) / test (``v_``); pair modes ``reference_only``
(1 <-> 2..6), ``consecutive`` (adds i <-> i+1) and ``all_pairs`` (every
i < j, H_i_j = H_1_j H_1_i^-1); a patch-aligned resize (1200 x 1600 ->
1190 x 1596 by default) with the homography rescaled; synthetic pairs
appended at ``synthetic_ratio``, and a photometric jitter of image 2 with
probability 0.5.  The numpy ``Generator`` is drawn in the reference's
order.

Images are read by ``utils.image_io.imread_rgb`` (PPM and PNG; ``.jpg``
raises) and resized by ``resize_area`` (OpenCV's ``INTER_AREA``, shrinking
or growing).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from vit_colmap_tpu_torch.dataloader.synthetic_homography import (
    SyntheticHomographyConfig,
    adjust_homography_for_resize,
    compose_homographies,
    create_synthetic_pair,
    photometric_jitter,
)
from vit_colmap_tpu_torch.models.dinov2 import PATCH_SIZE
from vit_colmap_tpu_torch.utils.image_io import imread_rgb, resize_area

logger = logging.getLogger(__name__)


def patch_aligned(size: int) -> int:
    return max(size // PATCH_SIZE, 1) * PATCH_SIZE


class HPatchesDataset:
    def __init__(
        self,
        root: str | Path,
        split: str = "all",  # all | illumination | viewpoint | train | test
        pair_mode: str = "reference_only",  # reference_only | consecutive | all_pairs
        target_height: int = 1200,
        target_width: int = 1600,
        synthetic_ratio: float = 0.0,
        synthetic_config: Optional[SyntheticHomographyConfig] = None,
        photometric_strength: float = 0.0,
        seed: int = 0,
    ):
        self.root = Path(root)
        self.pair_mode = pair_mode
        self.th = patch_aligned(target_height)
        self.tw = patch_aligned(target_width)
        self.synthetic_ratio = synthetic_ratio
        self.synthetic_config = synthetic_config or SyntheticHomographyConfig()
        self.photometric_strength = photometric_strength
        self.rng = np.random.default_rng(seed)

        seqs = sorted(
            d for d in self.root.iterdir() if d.is_dir() and d.name[:2] in ("i_", "v_")
        ) if self.root.exists() else []
        if split in ("illumination", "train"):
            seqs = [s for s in seqs if s.name.startswith("i_")]
        elif split in ("viewpoint", "test"):
            seqs = [s for s in seqs if s.name.startswith("v_")]
        self.sequences = seqs

        self.samples: list[dict] = []
        for seq in seqs:
            self.samples.extend(self._pairs_for_sequence(seq))
        n_real = len(self.samples)
        if synthetic_ratio > 0 and n_real:
            for _ in range(int(n_real * synthetic_ratio)):
                base = self.samples[int(self.rng.integers(0, n_real))]
                self.samples.append({"seq": base["seq"], "idx1": base["idx1"], "idx2": -1,
                                     "H": None, "synthetic": True})
        logger.info("HPatches: %d sequences, %d samples (%d synthetic)",
                    len(seqs), len(self.samples), len(self.samples) - n_real)

    # ------------------------------------------------------------- indexing
    def _pairs_for_sequence(self, seq: Path) -> list[dict]:
        imgs = sorted(seq.glob("[0-9].ppm")) + sorted(seq.glob("[0-9].png"))
        n = len({p.stem for p in imgs})
        if n < 2:
            return []
        H1 = {1: np.eye(3)}
        for j in range(2, n + 1):
            hf = seq / f"H_1_{j}"
            if hf.exists():
                H1[j] = np.loadtxt(hf).reshape(3, 3)
        pairs = []

        def add(i, j):
            if i in H1 and j in H1:
                pairs.append({"seq": seq, "idx1": i, "idx2": j,
                              "H": compose_homographies(H1[i], H1[j]), "synthetic": False})

        if self.pair_mode == "reference_only":
            for j in range(2, n + 1):
                add(1, j)
        elif self.pair_mode == "consecutive":
            for j in range(2, n + 1):
                add(1, j)
            for i in range(2, n):
                add(i, i + 1)
        elif self.pair_mode == "all_pairs":
            for i in range(1, n + 1):
                for j in range(i + 1, n + 1):
                    add(i, j)
        else:
            raise ValueError(f"Unknown pair_mode {self.pair_mode!r}")
        return pairs

    def __len__(self) -> int:
        return len(self.samples)

    # -------------------------------------------------------------- loading
    def _load_image(self, seq: Path, idx: int) -> Optional[np.ndarray]:
        for ext in (".ppm", ".png", ".jpg"):
            p = seq / f"{idx}{ext}"
            if p.exists():
                return imread_rgb(p)
        return None

    def _resize(self, img: np.ndarray) -> tuple[np.ndarray, tuple[int, int]]:
        oh, ow = img.shape[:2]
        return resize_area(img, self.tw, self.th), (ow, oh)

    def __getitem__(self, k: int) -> dict:
        s = self.samples[k]
        img1 = self._load_image(s["seq"], s["idx1"])
        if img1 is None:
            raise FileNotFoundError(f"{s['seq']}/{s['idx1']}")
        if s["synthetic"]:
            img2, H = create_synthetic_pair(img1, self.synthetic_config, self.rng)
            size2 = (img1.shape[1], img1.shape[0])
        else:
            img2 = self._load_image(s["seq"], s["idx2"])
            if img2 is None:
                raise FileNotFoundError(f"{s['seq']}/{s['idx2']}")
            H = s["H"]
            size2 = (img2.shape[1], img2.shape[0])

        size1 = (img1.shape[1], img1.shape[0])
        img1r, _ = self._resize(img1)
        img2r, _ = self._resize(img2)
        if self.photometric_strength > 0 and self.rng.random() < 0.5:
            img2r = photometric_jitter(img2r, self.rng, self.photometric_strength)
        Hr = adjust_homography_for_resize(H, size1, (self.tw, self.th), size2,
                                          (self.tw, self.th))
        return {
            "image1": img1r,
            "image2": img2r,
            "H": Hr.astype(np.float32),
            "seq_name": s["seq"].name,
            "pair_idx": (s["idx1"], s["idx2"]),
            "is_synthetic": s["synthetic"],
        }

    # --------------------------------------------------------------- batches
    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = False) -> Iterator[dict]:
        """Fixed-size numpy batch dicts (the last batch padded by repeating
        its last sample)."""
        order = np.arange(len(self.samples))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s in range(0, len(order), batch_size):
            idxs = order[s : s + batch_size]
            if len(idxs) < batch_size:
                if drop_last:
                    return
                idxs = np.concatenate([idxs, np.repeat(idxs[-1:], batch_size - len(idxs))])
            yield stack_items([self[int(i)] for i in idxs])


def stack_items(items: list[dict]) -> dict:
    """Samples -> a batch dict {image1, image2, H} of stacked arrays."""
    return {k: np.stack([it[k] for it in items]) for k in ("image1", "image2", "H")}


def train_val_split(dataset: HPatchesDataset, val_fraction: float = 0.1,
                    seed: int = 0) -> tuple[list[int], list[int]]:
    """Random index split, ``val_fraction`` for validation (at least one
    sample when there are any)."""
    n = len(dataset)
    order = np.random.default_rng(seed).permutation(n)
    n_val = max(1, int(n * val_fraction)) if n else 0
    return list(order[n_val:]), list(order[:n_val])
