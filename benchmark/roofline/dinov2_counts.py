"""Operations and bytes of a DINOv2 forward with either MLP form and
register tokens, from the configuration's shapes; least times through
``counts.least_s``.  ``counts.vit_forward_flops`` counts a GELU MLP and
the cls token alone; these count SwiGLU's three products and every extra
token too, and agree with it on a GELU model without registers."""

from __future__ import annotations

from benchmark.roofline import counts


def tokens(cfg: dict) -> int:
    """The sequence a block sees: patches, cls and registers."""
    return counts.vit_tokens(cfg["image_height"], cfg["image_width"], cfg["patch_size"],
                             1 + cfg["num_register_tokens"])


def mlp_products(cfg: dict) -> int:
    """Width-by-hidden products of one token through one MLP: fc1 and fc2
    for GELU; w12's two halves and w3 for SwiGLU."""
    return 3 if cfg["mlp"] == "swiglu" else 2


def mlp_flops(batch: int, cfg: dict) -> float:
    """2 * B * N * products * d * h: one block's MLP over a batch."""
    return (2.0 * batch * tokens(cfg) * mlp_products(cfg) * cfg["hidden_size"]
            * cfg["intermediate_size"])


def mlp_bytes(batch: int, cfg: dict, elem: int = 2) -> float:
    """One block's MLP over a batch: its input read, the first product's
    output (the hidden width, twice it for SwiGLU's two halves) written and
    read back, its output written, and its weights read once."""
    n, d, h = batch * tokens(cfg), cfg["hidden_size"], cfg["intermediate_size"]
    first = (mlp_products(cfg) - 1) * h
    return elem * (n * d + 2 * n * first + n * d + mlp_products(cfg) * d * h)


def mlp_least_s(batch: int, cfg: dict, dtype: str = "bf16") -> float:
    elem = 4 if dtype == "fp32" else 2
    return counts.least_s(mlp_flops(batch, cfg), mlp_bytes(batch, cfg, elem), dtype)


def forward_flops(cfg: dict) -> float:
    """Model FLOPs of one image at the configuration's size through the
    backbone at its published widths: qkv and proj (8 * N * d^2 a block),
    attention (4 * N^2 * d a block), the MLP, and the patch embedding."""
    d, depth, p = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["patch_size"]
    n = tokens(cfg)
    patches = (cfg["image_height"] // p) * (cfg["image_width"] // p)
    block = 8.0 * n * d * d + 4.0 * n * n * d + mlp_flops(1, cfg)
    return depth * block + 2.0 * 3 * p * p * d * patches
