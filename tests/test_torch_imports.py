"""Import guard: the PyTorch port, its entry-point scripts, chip_smoke.py and
the GPU test file import nothing of JAX, flax, OpenCV, PIL, pycolmap, pandas
or the JAX package, so they run on a machine that has none of them; and
none imports matplotlib at module level (only a function that draws
does)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL", "pycolmap",
             "pandas", "vit_colmap_tpu"}
# The port's entry-point scripts (the comparison scripts that run the JAX
# package on the CPU, torch_recon_bars.py, torch_verify_bars.py and
# torch_verify_uniforms.py, are not among them, nor the fixture writer
# torch_sift_fidelity_fixtures.py, which runs OpenCV where it exists).
SCRIPTS = ["torch_eval_hpatches.py", "torch_quality_bakeoff.py", "torch_compare_metrics.py",
           "torch_aggregate_results.py", "torch_visualize_matches.py",
           "torch_plot_training_losses.py", "torch_bench_matching.py",
           "torch_bench_trainstep.py", "torch_bench_serve.py", "torch_sift_fidelity_table.py",
           "torch_visualize_invariant_points.py", "torch_visualize_hpatches_warping.py",
           "torch_visualize_training_sampling.py", "torch_diag_scene.py",
           "torch_bisect_geometry.py"]
SOURCES = sorted((ROOT / "vit_colmap_tpu_torch").rglob("*.py")) + [
    ROOT / "scripts" / name for name in SCRIPTS] + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_has_sources():
    assert len(SOURCES) > 10


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _module_level_roots(path: Path) -> set[str]:
    """Roots imported outside any function or class body."""
    roots = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_matplotlib_only_inside_functions(path):
    assert "matplotlib" not in _module_level_roots(path)


def test_guard_catches_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import matplotlib\n"
                 "def f():\n    from vit_colmap_tpu.ops import matching\n    import cv2\n"
                 "    import pandas\n")
    assert _imported_roots(f) & FORBIDDEN == {"vit_colmap_tpu", "cv2", "pandas"}
    assert _module_level_roots(f) == {"matplotlib"}
