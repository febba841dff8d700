#!/usr/bin/env python3
"""Where the port's matching kernels (kernels 2, 4 and 5) spend their time.

    python3 scripts/torch_match_variants.py [--rounds 2]

Builds diagnostic variants of ``vit_colmap_tpu_torch/csrc/match_topk2.cu``
and ``match_topk2_int8.cu`` side by side (text substitutions on the source,
one ``nvcc`` each, all started together), binds each with ctypes and times
kernel 2
(``match_topk2_colmax``) and kernel 4 (``match_topk2``) with CUDA events at
the main path's shape (28 pairs of 4096 x 4096 random unit descriptors of
width 128, about 10% of rows and columns invalid), in turns with
``torch.bmm`` (PyTorch's full-fp32 product, the practical FMA ceiling of
the card) on the same descriptors.  Variants:

* ``base``: the kernels as they are;
* ``fma_only``: each tile's top-2 and column-partial epilogue replaced by
  a sum of its similarities into the row state (so the compiler keeps the
  products): the FMA loop, the copies and the barriers alone.  Its results
  are wrong on purpose, and its difference from the plain version is
  printed so that no one mistakes it for the kernel;
* ``stages2``: a ring of 2 stages instead of 4;
* ``no_lds``: every step of a chunk reads the same shared addresses, so the
  compiler loads each operand once a chunk (shared loads nearly gone);
* ``no_copy``: the ring is filled once and never refilled (no copies in
  the loop);
* ``no_barrier``: without the block barrier of each chunk;
* ``mask_early``: each column tile's validity mask loaded at the tile's
  start, so that the loads land during the products, instead of in its
  epilogue;
* kernel 5 (``match_topk2_int8``) on the same pairs as uint8 descriptors
  (signed encoding), its time split: ``int8_base``, as it is;
  ``int8_mma_only``, the epilogue replaced by a sum of the accumulators'
  bits into the row state, and no wait on the column tables, which nothing
  reads then (the products and the ring's copies alone);
  ``int8_epilogue_only``, no products (the accumulators keep the values
  they were given at the start, 0, which the compiler cannot see through):
  the epilogue, the copies and the waits alone; ``int8_bias_trick``, acc
  converted on the full-rate pipes as float(acc + BIAS_BITS as bits) -
  BIAS instead of by I2F (exact for |acc| <= 2^22, as
  ``tests/test_torch_match_variants.py`` checks; bit-equal here);
  ``int8_stages2``, a ring of 2 K slices instead of 4; ``int8_runtime_dim``,
  width 128 taken at run time, as every other width is.  Beside them
  ``torch._int_mm`` per pair alone, the product's yardstick: it writes the
  1.9 GB of int32 similarities that the kernel keeps on chip.

``no_lds``, ``no_copy``, ``no_barrier``, ``int8_mma_only`` and
``int8_epilogue_only`` give wrong results on purpose; each says what the
part it drops or keeps costs.

Each is timed two ways (``chip_smoke.cuda_ms``, the median of per-call
CUDA-event timings, which count the wrapper's host work before each
launch, and ``chip_smoke.back_to_back_ms``, the mean over calls run back
to back, where that host work overlaps the card's).

Then it runs kernels 2 and 5 back to back for about two seconds each and
samples the SM clock and the power draw with nvidia-smi (``chip_smoke.sustained``; the
timing helpers are chip_smoke's too).  It prints one JSON object last.
Needs one CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# The exact integer-to-float conversion of int8_bias_trick: the f32 whose
# bits are BIAS_BITS + acc is BIAS + acc for |acc| <= 2^22 (its ulp is 1 on
# [2^23, 2^24]), so subtracting BIAS gives float(acc) exactly.
BIAS_BITS = 0x4B400000
BIAS = 12582912.0  # 1.5 * 2^23, the f32 of BIAS_BITS
P, N, D = 28, 4096, 128

CHECKSUM = '''
__device__ __forceinline__ void checksum(const float (&acc)[8][8], float (&rb)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) rb[i] += acc[i][j];
}

template <bool kColmax>
__global__ void'''

COPY = "    if (it + kStages - 1 < total) load_next(it + kStages - 1);\n"

# name -> (source in csrc/, substitutions)
VARIANTS = {
    "base": ("match_topk2.cu", []),
    "fma_only": ("match_topk2.cu", [
        ("\ntemplate <bool kColmax>\n__global__ void", CHECKSUM),
        ("      tile_epilogue<kColmax>(acc,",
         "      checksum(acc, rb);\n      if (n < 0) tile_epilogue<kColmax>(acc,")]),
    "stages2": ("match_topk2.cu", [("constexpr int kStages = 4;",
                                    "constexpr int kStages = 2;")]),
    "no_lds": ("match_topk2.cu", [("4 * (q ^ sa)", "4 * sa"), ("4 * (q ^ sb)", "4 * sb")]),
    "no_copy": ("match_topk2.cu", [(COPY, "")]),
    "no_barrier": ("match_topk2.cu", [("    __syncthreads();  // everyone's copies landed",
                                       "    // ")]),
    "mask_early": ("match_topk2.cu", [
        ("      const unsigned cols_valid = column_mask(v2, tile * kTile, col_in, m);\n", ""),
        ("  int tile = 0, k = 0;\n", "  int tile = 0, k = 0;\n  unsigned cols_valid = 0;\n"),
        (COPY, "    if (k == 0) cols_valid = column_mask(v2, tile * kTile, col_in, m);\n"
         + COPY)]),
    "int8_base": ("match_topk2_int8.cu", []),
    "int8_mma_only": ("match_topk2_int8.cu", [
        ("            const float f = __int2float_rn(",
         "            rb[h] = __fadd_rn(rb[h], __uint_as_float(acc[4 * c + 2 * h + e]));\n"
         "            continue;\n"
         "            const float f = __int2float_rn("),
        ("        mbar_wait(empty_col(s), ((j / kColStages) & 1) ^ 1);\n", ""),
        ("      mbar_wait(full_col(cs), (j / kColStages) & 1);\n", "")]),
    "int8_epilogue_only": ("match_topk2_int8.cu", [
        ("          wgmma_s8(acc, da + 2 * kk, db + 2 * kk, kk > 0 ? 1 : keep);", "")]),
    "int8_bias_trick": ("match_topk2_int8.cu", [
        ("__int2float_rn(static_cast<int>(acc[4 * c + 2 * h + e]))",
         f"__fsub_rn(__uint_as_float(acc[4 * c + 2 * h + e] + {BIAS_BITS:#x}u), "
         f"{BIAS:.1f}f)")]),
    "int8_stages2": ("match_topk2_int8.cu", [("constexpr int kStages = 4;",
                                              "constexpr int kStages = 2;")]),
    "int8_runtime_dim": ("match_topk2_int8.cu", [("launch<128>(", "launch<0>(")]),
}


def build_variants(out: Path, nvcc: str, flags: list[str], include: Path) -> dict:
    procs = {}
    for name, (source, subs) in VARIANTS.items():
        text = (include / source).read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} not once in the source")
            text = text.replace(old, new)
        src = out / f"{name}.cu"
        src.write_text(text)
        cmd = [nvcc, *flags, "-I", str(include), "-Xptxas", "-v", "-shared",
               "-o", str(out / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        spills = [x.strip() for x in log.splitlines() if "spill" in x or "registers" in x]
        print(f"{name}: ptxas {spills}", flush=True)
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chip_smoke import back_to_back_ms, cuda_ms, nvidia_smi, sustained
    from vit_colmap_tpu_torch.kernels import build, match
    from vit_colmap_tpu_torch.ops.matching import prepare_int8_descriptors

    with tempfile.TemporaryDirectory(prefix="match_variants_") as tmp:
        libs = build_variants(Path(tmp), build.find_nvcc(), build.NVCC_FLAGS,
                              build.CSRC_DIR)
        for variant, lib in libs.items():
            names = (("match_topk2_int8_launch",) if variant.startswith("int8")
                     else ("match_topk2_colmax_launch", "match_topk2_launch"))
            for name in names:
                fn = getattr(lib, name)
                fn.argtypes = build.SIGNATURES[name]
                fn.restype = ctypes.c_int

        g = torch.Generator(device="cuda").manual_seed(3)
        d1, d2 = (torch.nn.functional.normalize(
            torch.randn(P, N, D, generator=g, device="cuda"), dim=-1) for _ in range(2))
        v1, v2 = (torch.rand(P, N, generator=g, device="cuda") < 0.9 for _ in range(2))
        ref = match.topk2_plain(d1, d2, v2)
        # Kernel 5's operands: the same shape as signed uint8 descriptors.
        q1, q2 = (torch.randint(0, 256, (P, N, D), generator=g, device="cuda")
                  .to(torch.uint8) for _ in range(2))
        a1, s1, i1, coef = prepare_int8_descriptors(q1, v1, "signed")
        a2, s2, i2, _ = prepare_int8_descriptors(q2, v2, "signed")
        ops = (a1, a2, s1, s2, i1, i2, coef)
        ref_int8 = match.topk2_int8_plain(*ops)

        kernels = {
            "k2": lambda: match.match_topk2_colmax(d1, d2, v1, v2),
            "k4": lambda: match.match_topk2(d1, d2, v2),
        }
        errors, times, b2b = {}, {"bmm": []}, {}
        def int_mm():  # the int8 products alone, one pair at a time
            for p in range(P):
                torch._int_mm(a1[p], a2[p].T)

        times["int_mm"] = []
        for rnd in range(args.rounds):
            times["bmm"].append(cuda_ms(lambda: torch.bmm(d1, d2.transpose(1, 2)), 10))
            times["int_mm"].append(cuda_ms(int_mm, 10))
            for name, lib in libs.items():
                build.library = lambda lib=lib: lib  # this variant's launcher
                if name.startswith("int8"):
                    runs = {"k5": lambda: match.match_topk2_int8(*ops)}
                    check, plain = "k5", ref_int8
                else:
                    runs, check, plain = kernels, "k4", ref
                for k, fn in runs.items():
                    times.setdefault(f"{name} {k}", []).append(cuda_ms(fn, 10))
                    b2b.setdefault(f"{name} {k}", []).append(back_to_back_ms(fn, 10))
                if rnd == 0:
                    out = runs[check]()
                    errors[name] = {
                        "best_max_abs_diff": (out[0] - plain[0]).abs().max().item(),
                        "best_idx_differ": int((out[2] != plain[2]).sum()),
                    }
        for name, t in times.items():
            err = f", vs plain {errors[name.split()[0]]}" if name.split()[0] in errors else ""
            both = f"; back to back {' / '.join(f'{x:.3f}' for x in b2b[name])}" \
                if name in b2b else ""
            print(f"{name}: {' / '.join(f'{x:.3f}' for x in t)}{both} ms{err}", flush=True)

        held = {}
        for variant, name, fn in (("base", "kernel 2", kernels["k2"]),
                                  ("int8_base", "kernel 5",
                                   lambda: match.match_topk2_int8(*ops))):
            build.library = lambda lib=libs[variant]: lib
            held[name] = sustained(fn)
            print(f"sustained {variant} {name}: SM clock {held[name]['mhz']} MHz, "
                  f"power {held[name]['watts']} W", flush=True)

    card = nvidia_smi("name,power.limit")
    print(card)
    print(json.dumps({"card": card, "shape": [P, N, N, D], "ms": times, "b2b_ms": b2b,
                      "errors": errors, "sustained": held}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
