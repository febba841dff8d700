#!/usr/bin/env python3
"""Where the port's bf16 fixed-max attention kernel spends its time.

    python3 scripts/torch_attention_variants.py [--rounds 2]

Builds diagnostic variants of ``vit_colmap_tpu_torch/csrc/fixed_max_attention.cu``
side by side (text substitutions on the source, one ``nvcc`` each, all
started together), binds each with ctypes and times kernel 1
(``attention_qkv``) with CUDA events at the main path's shape (2 images,
9,691 tokens, 12 heads of 64, bf16), in turns with PyTorch's
``scaled_dot_product_attention``.  Variants that drop work give wrong
results on purpose; their error against the plain version is printed so
that no one mistakes them for the kernel:

* ``base``: the kernel as it is;
* ``exp2f``: the full-range ``exp2f`` in place of the flush-to-zero SFU exp2;
* ``no_pingpong``: without the named barriers that make the two consumer
  warpgroups take turns issuing their products;
* ``no_exp2``: p = min(s, 100) without the exp2 (tensor cores, loads and
  the rest of the softmax only);
* ``no_mma``: without the wgmma products (the softmax, loads and barriers
  only);
* ``stages2`` / ``stages3``: a k/v ring of 2 or 3 stages instead of 4.

Then it runs the base kernel back to back for about two seconds and samples
the SM clock and the power draw with nvidia-smi (``chip_smoke.sustained``;
the timing helpers are chip_smoke's too).  It prints one JSON object last.
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
B, N, HEADS = 2, 9691, 12

VARIANTS = {
    "base": [],
    "exp2f": [("exp2_ftz(fminf(s[i], kClamp))", "exp2f(fminf(s[i], kClamp))"),
              ("exp2_ftz(fminf(s[i + 1], kClamp))", "exp2f(fminf(s[i + 1], kClamp))")],
    "no_pingpong": [("bar_sync(kBarSched + w, 256);", ""),
                    ("bar_arrive(kBarSched + (1 - w), 256);", ""),
                    ("if (w == 1) bar_arrive(kBarSched + 0, 256);", ""),
                    ("if (w == 0) bar_arrive(kBarSched + 1, 256);", "")],
    "no_exp2": [("exp2_ftz(fminf(s[i], kClamp))", "fminf(s[i], kClamp)"),
                ("exp2_ftz(fminf(s[i + 1], kClamp))", "fminf(s[i + 1], kClamp)")],
    "no_mma": [("        wgmma_qk(s, q_desc", "        if (n < 0) wgmma_qk(s, q_desc"),
               ("        wgmma_pv(o, pa", "        if (n < 0) wgmma_pv(o, pa"),
               ("        wgmma_rowsum(l, pa", "        if (n < 0) wgmma_rowsum(l, pa")],
    "stages2": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
    "stages3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
}


def build_variants(out: Path, source: str, nvcc: str, flags: list[str]) -> dict:
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        src = out / f"{name}.cu"
        src.write_text(text)
        cmd = [nvcc, *flags, "-shared", "-o", str(out / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chip_smoke import cuda_ms, nvidia_smi, sustained
    from vit_colmap_tpu_torch.kernels import attention, build

    source = (build.CSRC_DIR / "fixed_max_attention.cu").read_text()
    with tempfile.TemporaryDirectory(prefix="attention_variants_") as tmp:
        libs = build_variants(Path(tmp), source, build.find_nvcc(), build.NVCC_FLAGS)
        for lib in libs.values():
            fn = lib.fixed_max_attention_launch
            fn.argtypes = build.SIGNATURES["fixed_max_attention_launch"]
            fn.restype = ctypes.c_int

        g = torch.Generator(device="cuda").manual_seed(7)
        qkv = torch.randn(B, N, 3 * 64 * HEADS, generator=g, device="cuda").to(torch.bfloat16)
        ref = attention.attention_qkv_plain(qkv, HEADS, 64**-0.5).float()
        q, k, v = (t.contiguous() for t in
                   qkv.reshape(B, N, 3, HEADS, 64).permute(2, 0, 3, 1, 4))

        def kernel():
            return attention.attention_qkv(qkv, HEADS, 64**-0.5)

        errors, times = {}, {"sdpa": []}
        for rnd in range(args.rounds):
            times["sdpa"].append(cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20))
            for name, lib in libs.items():
                build.library = lambda lib=lib: lib  # this variant's launcher
                times.setdefault(name, []).append(cuda_ms(kernel, 20))
                if rnd == 0:
                    errors[name] = (kernel().float() - ref).abs().max().item()
        for name, t in times.items():
            err = f", max |out - plain| {errors[name]:.3g}" if name in errors else ""
            print(f"{name}: {' / '.join(f'{x:.3f}' for x in t)} ms{err}", flush=True)

        build.library = lambda: libs["base"]
        held = sustained(kernel)
        print(f"sustained base kernel: SM clock {held['mhz']} MHz, "
              f"power {held['watts']} W", flush=True)

    card = nvidia_smi("name,power.limit")
    print(card)
    print(json.dumps({"card": card, "shape": [B, N, HEADS, 64], "ms": times,
                      "max_abs_err": errors,
                      "err_bound": 4 * 2**-8 * ref.abs().max().item(),
                      "sustained": held}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
