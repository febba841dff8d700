"""chip_smoke.py refuses to run, and prints no result, without a GPU or
outside a checkout of the repository."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SCRIPT = Path(__file__).resolve().parent.parent / "chip_smoke.py"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a GPU is present: the script would run for real")
    script = SCRIPT
    if alone:
        script = tmp_path / "chip_smoke.py"
        shutil.copy(SCRIPT, script)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, cwd=script.parent, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
