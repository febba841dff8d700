#!/usr/bin/env python
"""Plot training loss curves from the PyTorch port's trainer output
(``scalars.jsonl``, a checkpoint directory or a text log).

Counterpart of ``scripts/plot_training_losses.py``, over
``vit_colmap_tpu_torch.utils.plot_training.TrainingLossPlotter``: writes
``total_loss.png`` and ``loss_components.png`` into ``--output-dir``
(default ``<source dir>/plots``).  Drawing needs matplotlib, which the
card's machine lacks: copy ``scalars.jsonl`` off it and plot elsewhere.

    python3 scripts/torch_plot_training_losses.py ck/scalars.jsonl
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("source", type=Path,
                    help="scalars.jsonl, checkpoint dir, or text log")
    ap.add_argument("--output-dir", type=Path, default=None)
    args = ap.parse_args(argv)

    from vit_colmap_tpu_torch.utils.plot_training import TrainingLossPlotter

    out_dir = args.output_dir or (
        args.source if args.source.is_dir() else args.source.parent
    ) / "plots"
    plotter = TrainingLossPlotter(args.source)
    p1 = plotter.plot_total_loss(out_dir / "total_loss.png")
    p2 = plotter.plot_components(out_dir / "loss_components.png")
    for p in (p1, p2):
        if p:
            print(f"Wrote {p}")


if __name__ == "__main__":
    main()
