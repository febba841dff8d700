"""Import guard: the PyTorch port, chip_smoke.py and the GPU test file import
nothing of JAX, flax, OpenCV, PIL, pycolmap or the JAX package, so they run
on a machine that has none of them."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL", "pycolmap",
             "vit_colmap_tpu"}
SOURCES = sorted((ROOT / "vit_colmap_tpu_torch").rglob("*.py")) + [
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


def test_guard_catches_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def f():\n    from vit_colmap_tpu.ops import matching\n    import cv2\n")
    assert _imported_roots(f) & FORBIDDEN == {"vit_colmap_tpu", "cv2"}
