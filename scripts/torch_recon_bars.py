#!/usr/bin/env python
"""The JAX package's reading of the rendered 50-view scene, from which
``chip_smoke.py``'s scene-50 bars (``SCENE_BARS``) are set.

The views are the port's own (``vit_colmap_tpu_torch``'s numpy renderer,
``chip_smoke.py``'s SCENE_* settings: 50 views at 480 x 640, seed 7, focal
0.94 x the longer side), the images the card's run sees; the JAX package
runs its whole pipeline on them on the CPU (SIFT, 2048 keypoints, a
PINHOLE camera at the renderer's K, matching, verification,
reconstruction) and the script prints, as one JSON line, the quality
fields of ``chip_smoke.scene_quality`` against the renderer's poses and
the stage seconds.

    python3 scripts/torch_recon_bars.py    # about 10 min on the CPU
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from vit_colmap_tpu.pipeline.run_pipeline import Pipeline
    from vit_colmap_tpu.utils.config import Config
    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import render_multiview_scene

    work = Path(tempfile.mkdtemp(prefix="recon_bars_"))
    scene_dir = work / "scene50"
    _, K = render_multiview_scene(scene_dir, n_cams=chip_smoke.SCENE_VIEWS,
                                  size=chip_smoke.SCENE_SIZE, focal=chip_smoke.SCENE_FOCAL,
                                  seed=chip_smoke.SCENE_SEED)
    config = Config()
    config.extractor.extractor_type = "sift"
    config.extractor.max_keypoints = chip_smoke.SCENE_KEYPOINTS
    config.camera.model = "PINHOLE"
    config.camera.params = [float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])]
    pipeline = Pipeline(config)
    t = time.perf_counter()
    pipeline.run(scene_dir, work / "out", work / "db.db")
    seconds = time.perf_counter() - t
    quality = chip_smoke.scene_quality(pipeline, scene_dir)
    print(json.dumps({"reference": "vit_colmap_tpu Pipeline.run, CPU, on the port's "
                                   "rendered views", "views": chip_smoke.SCENE_VIEWS,
                      "seconds_with_compile": seconds, "quality": quality,
                      "missed_bars": chip_smoke.scene_missed(quality)}))


if __name__ == "__main__":
    main()
