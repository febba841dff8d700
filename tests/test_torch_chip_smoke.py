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


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_checks", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _listing(body: list[str], loop: list[str]) -> list[tuple[int, str]]:
    """A SASS listing as (address, text): ``body`` before a loop of ``loop``
    closed by a backward branch, then EXIT."""
    ins = [(16 * i, x) for i, x in enumerate(body)]
    start = 16 * len(ins)
    ins += [(start + 16 * i, x) for i, x in enumerate(loop)]
    ins.append((16 * len(ins), f"@P0 BRA {hex(start)} ;"))
    ins.append((16 * len(ins), "EXIT ;"))
    return ins


PROLOGUE = ["UTMALDG.3D [UR8], [UR4] ;", "SYNCS.ARRIVE.TRANS64 RZ, [UR6] ;"]
MMA_LOOP = ["WARPGROUP.ARRIVE ;", "IGMMA.64x128x32.S8.S8 R24, gdesc[UR16], RZ, !UPT, gsb0 ;",
            "WARPGROUP.DEPBAR.LE gsb0, 0x0 ;", "I2FP.F32.S32 R3, R24 ;", "FMUL R3, R3, R8 ;",
            "FADD R4, R9, R10 ;", "FMNMX R5, R5, R3, !PT ;", "FSETP.GT.AND P1, PT, R3, R6, PT ;",
            "SEL R7, R7, 0x3, !P1 ;", "LDS.128 R12, [R2] ;"]
PTXAS = {"registers": 168, "spill_bytes": 0}


def test_int8_sass_check_accepts_igmma_loop():
    smoke = _smoke()
    out = smoke.int8_body_check("k5", _listing(PROLOGUE, MMA_LOOP), PTXAS)
    assert out["main_loop"]["IGMMA"] == 1 and out["main_loop"]["IDP4A"] == 0
    assert out["body"]["UTMALDG"] == 1
    assert out["main_loop_opcodes"]["FMNMX"] == 1 and out["main_loop_opcodes"]["BRA"] == 1


@pytest.mark.parametrize("fault", ["idp4a_loop", "idp4a_beside", "no_copy", "spills",
                                   "no_ptxas"])
def test_int8_sass_check_refuses(fault):
    """The SIMT dot product (an IDP4A loop with no tensor-core product), an
    IDP4A anywhere, a body without asynchronous copies, and spills all fail."""
    smoke = _smoke()
    body, loop, ptxas = PROLOGUE, MMA_LOOP, PTXAS
    if fault == "idp4a_loop":
        loop = ["LDS.128 R12, [R2] ;", "IDP4A.S8.S8 R20, R12, R16, R20 ;"]
    elif fault == "idp4a_beside":
        body = PROLOGUE + ["IDP4A.S8.S8 R20, R12, R16, R20 ;"]
    elif fault == "no_copy":
        body = ["LDG.E.128 R12, [R2.64] ;"]
    elif fault == "spills":
        ptxas = {"registers": 168, "spill_bytes": 8}
    else:
        ptxas = {}
    with pytest.raises(AssertionError):
        smoke.int8_body_check("k5", _listing(body, loop), ptxas)


def test_epilogue_floor_from_loop_counts():
    """A trip of 2 tiles (8 IGMMA k32 steps at D = 128) is 128 similarities
    a thread: 1,920 instructions are 15 per similarity, which at 128 dispatch
    slots an SM and clock bound the time; the FP32 and ALU pipes follow
    from their own counts and rates (I2FP, the conversion, on the ALU)."""
    smoke = _smoke()
    ops = {"IGMMA": 8, "I2FP": 128, "FADD": 512, "FMUL": 384, "FMNMX": 384,
           "FSETP": 128, "SEL": 128, "BRA": 248}
    sims = 28 * 4096 * 4096
    out = smoke.epilogue_floor(ops, sims, 1980.0)
    assert out["per_similarity"]["dispatch"] == pytest.approx(1920 / 128)
    assert out["per_similarity"]["fp32"] == pytest.approx(7.0)
    assert out["per_similarity"]["alu"] == pytest.approx(6.0)
    clocks = smoke.SMS * 1980e6
    assert out["ms"]["dispatch"] == pytest.approx(sims * 15 / 128 / clocks * 1e3)
    assert out["ms"]["alu"] == pytest.approx(sims * 6 / 64 / clocks * 1e3)
    assert out["bound_by"] == "dispatch"
    assert out["floor_ms"] == pytest.approx(0.2106, abs=1e-3)


@pytest.mark.parametrize("encoding", ["signed", "unsigned"])
def test_contracted_int8_epilogue_invisible_at_encoding_coefficients(encoding):
    """At the encodings' (alpha, beta, gamma) every operation before
    "* inv1" is exact integer arithmetic below 2^24, so contracting alpha *
    acc + beta * (s1 + s2) into one FMA changes no bit: a check at those
    coefficients could not catch a contraction."""
    from vit_colmap_tpu_torch.kernels import match

    smoke = _smoke()
    smoke.DEVICE = "cpu"
    ops = smoke.int8_operands(*smoke.u8_inputs(2, 256, 256, seed=7), encoding)
    wrong = smoke.contracted_int8_plain(*ops)
    for a, b in zip(wrong, match.topk2_int8_plain(*ops)):
        assert torch.equal(a, b)


def test_contracted_int8_epilogue_differs_at_odd_coefficients():
    """With coefficients that are not powers of two (those chip_smoke.py
    uses) the contraction changes best / second values."""
    from vit_colmap_tpu_torch.kernels import match

    smoke = _smoke()
    smoke.DEVICE = "cpu"
    a1, a2, s1, s2, i1, i2, _ = smoke.int8_operands(*smoke.u8_inputs(2, 256, 256, seed=7))
    coef = torch.tensor(smoke.ODD_COEF)
    ops = (a1, a2, s1, s2, i1, i2, coef)
    wrong = smoke.contracted_int8_plain(*ops)
    ref = match.topk2_int8_plain(*ops)
    assert sum(int((a != b).sum()) for a, b in zip(wrong[:2], ref[:2])) > 0
