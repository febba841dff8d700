"""Training-loss plotting.

The port's copy of ``vit_colmap_tpu/utils/plot_training.py``: it reads the
``scalars.jsonl`` the trainer writes (``training/train.py``'s
``ScalarLogger``, the JAX package's format), a checkpoint directory holding
one, or a reference-style text log through a regex.  matplotlib is
imported when a figure is drawn (``plot_metrics.pyplot``), not with the
module; where it is missing a plot raises ``ImportError`` saying so.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import Optional

import numpy as np

from vit_colmap_tpu_torch.utils.plot_metrics import pyplot

logger = logging.getLogger(__name__)

# Reference-style log lines, e.g.:
#   "epoch 3 step 120 loss 0.5123 (det 0.2 desc 0.3)"
_LOG_RE = re.compile(
    r"epoch\s+(\d+)\s+step\s+(\d+)\s+loss\s+([\d.eE+-]+)"
    r"(?:\s+\(det\s+([\d.eE+-]+)\s+desc\s+([\d.eE+-]+)\))?"
)

COMPONENTS = [
    "total_loss",
    "detector_loss",
    "descriptor_loss",
    "score_loss",
    "orient_loss",
    "positive_loss",
    "triplet_loss",
]


class TrainingLossPlotter:
    def __init__(self, source: Path | str):
        """source: a ``scalars.jsonl`` file, a checkpoint dir containing one,
        or a reference-style text log."""
        self.source = Path(source)
        self.train_events: list[dict] = []
        self.val_events: list[dict] = []
        self._load()

    def _load(self) -> None:
        path = self.source
        if path.is_dir():
            path = path / "scalars.jsonl"
        if not path.exists():
            logger.warning("No training log found at %s", path)
            return
        if path.suffix == ".jsonl":
            for line in open(path):
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                (self.val_events if ev.get("event") == "val" else self.train_events
                 ).append(ev)
        else:
            # Legacy regex fallback (reference log format).
            for line in open(path, errors="replace"):
                m = _LOG_RE.search(line)
                if m:
                    ev = {
                        "epoch": int(m.group(1)),
                        "step": int(m.group(2)),
                        "total_loss": float(m.group(3)),
                    }
                    if m.group(4):
                        ev["detector_loss"] = float(m.group(4))
                        ev["descriptor_loss"] = float(m.group(5))
                    self.train_events.append(ev)
        logger.info(
            "Loaded %d train / %d val events from %s",
            len(self.train_events), len(self.val_events), path,
        )

    def epoch_means(self, key: str = "total_loss", events=None) -> tuple[np.ndarray, np.ndarray]:
        events = self.train_events if events is None else events
        by_epoch: dict[int, list[float]] = {}
        for ev in events:
            if key in ev and "epoch" in ev:
                by_epoch.setdefault(int(ev["epoch"]), []).append(float(ev[key]))
        epochs = sorted(by_epoch)
        return np.array(epochs), np.array(
            [np.mean(by_epoch[e]) for e in epochs]
        )

    def plot_total_loss(self, save_path: Path | str) -> Optional[Path]:
        plt = pyplot()

        ep, tr = self.epoch_means("total_loss")
        if len(ep) == 0:
            return None
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.plot(ep, tr, "o-", label="train")
        vep, vl = self.epoch_means("total_loss", self.val_events)
        if len(vep):
            ax.plot(vep, vl, "s--", label="val")
        ax.set_xlabel("epoch")
        ax.set_ylabel("total loss")
        ax.legend()
        ax.grid(alpha=0.3)
        save_path = Path(save_path)
        save_path.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path

    def plot_components(self, save_path: Path | str) -> Optional[Path]:
        plt = pyplot()

        present = [
            k for k in COMPONENTS
            if any(k in ev for ev in self.train_events)
        ]
        if not present:
            return None
        n = len(present)
        cols = 3
        rows = (n + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 3.5 * rows))
        axes = np.atleast_1d(axes).ravel()
        for ax, key in zip(axes, present):
            ep, vals = self.epoch_means(key)
            ax.plot(ep, vals, "o-")
            ax.set_title(key)
            ax.set_xlabel("epoch")
            ax.grid(alpha=0.3)
        for ax in axes[n:]:
            ax.axis("off")
        fig.tight_layout()
        save_path = Path(save_path)
        save_path.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
