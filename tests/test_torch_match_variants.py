"""scripts/torch_match_variants.py off the card: every variant's text
substitutions still match the kernel sources once (the script stops on the
card otherwise), and the exact integer-to-float conversion its
``int8_bias_trick`` variant puts into kernel 5 is exact where the kernel
would use it (|acc| <= 128^2 x 128 = 2^21) and up to 2^22."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "torch_match_variants.py"
CSRC = Path(__file__).resolve().parent.parent / "vit_colmap_tpu_torch" / "csrc"


def _script():
    spec = importlib.util.spec_from_file_location("torch_match_variants", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


VARIANTS = _script().VARIANTS


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_substitutions_match_once(name):
    source, subs = VARIANTS[name]
    text = (CSRC / source).read_text()
    for old, new in subs:
        assert text.count(old) == 1, f"{name}: {old!r}"
        text = text.replace(old, new)


def _bias_float(acc: np.ndarray, script) -> np.ndarray:
    bits = (acc.astype(np.int64) + script.BIAS_BITS).astype(np.uint32)
    return bits.view(np.float32) - np.float32(script.BIAS)


def test_bias_trick_exact_up_to_2_pow_22():
    script = _script()
    acc = np.arange(-(2**22), 2**22 + 1, dtype=np.int32)
    assert np.array_equal(_bias_float(acc, script), acc.astype(np.float32))


def test_bias_trick_wrong_just_outside():
    script = _script()
    acc = np.array([-(2**22) - 1, 2**22 + 1, 2**22 + 3], dtype=np.int32)
    assert not np.any(_bias_float(acc, script) == acc.astype(np.float32))
