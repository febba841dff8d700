"""Nothing under benchmark/ imports JAX, its runtime, flax or the JAX
package, judged by top-level module name; a whole run loads none of them."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import env

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax(path):
    bad = [m for m in _imports(path) if env.top_level(m) in env.FORBIDDEN_MODULES]
    assert not bad, bad


def test_the_port_is_not_taken_for_the_jax_package():
    names = ["vit_colmap_tpu_torch", "vit_colmap_tpu_torch.ops", "jaxtyping", "flax_like"]
    assert env.forbidden_loaded(names) == []
    assert env.forbidden_loaded(["jax.numpy", "vit_colmap_tpu.ops", "jaxlib"]) == [
        "jax.numpy", "jaxlib", "vit_colmap_tpu.ops"]


def test_a_whole_run_loads_no_jax_module(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {str(BENCH.parent)!r})
sys.path.insert(0, {str(BENCH / 'tests')!r})
import conftest, torch
from benchmark.harness import env, manifest
cell = manifest.resolve(manifest.load(), "vitb14.match")
cell.traffic["matching"]["pair_batch"] = 4
cell.traffic.update(views=4, keypoints=128, scene_points=96, overlap_views=3, warmup_jobs=1)
r = conftest.run_tiny(cell, seconds=0.3)
assert r["correct"], r
print("FOUND", env.forbidden_loaded())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def test_a_run_without_enough_cards_prints_nothing_and_caches_bytecode_inside(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark, with every
    card hidden: a non-zero exit and no result line; the bytecode it compiled lies
    under the checkout's cache."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    env_vars = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "vitb14.match",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env=env_vars)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert list((tmp_path / ".bench_cache" / "pycache").rglob("manifest*.pyc"))
    assert not (tmp_path / "benchmark" / "harness" / "__pycache__").exists()
