"""Fixtures of the benchmark's CPU tests: cells of BENCHMARK.json cut to a
size the CPU runs in a second (ViT-S/14 widths on 56 x 84 images, six
views of 128 descriptors), for driving whole runs without a card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import env  # noqa: E402

env.prepare(ROOT)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_cell():
    """``tiny_cell(workload, dtype="float32")``: the cell from BENCHMARK.json
    with its configuration and traffic cut for the CPU."""
    from benchmark.harness import manifest

    def make(workload: str, dtype: str = "float32"):
        cell = manifest.resolve(manifest.load(), workload)
        c = cell.config
        c.update(backbone="vits14", hidden_size=384, num_hidden_layers=12, num_heads=6,
                 head_dim=64, intermediate_size=1536, image_height=56, image_width=84,
                 max_keypoints=16, dtype=dtype)
        if cell.driver == "extract":
            cell.traffic.update(pool_images=4, warmup_batches=1, keep_share=1.0)
        else:
            cell.traffic.update(views=6, keypoints=128, scene_points=96, overlap_views=3,
                                warmup_jobs=1)
            cell.traffic["matching"]["pair_batch"] = 4
        return cell

    return make


def run_tiny(cell, seed: int = 2**33 + 7, seconds: float = 0.5, trace: bool = False,
             variant=None) -> dict:
    import time

    from benchmark.harness.runner import run_cell

    return run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(), variant)
