"""The operation, byte and least-time counters against the bounds the
kernels were already held to on the card (PERF.md's table of kernels)."""

import pytest

from benchmark.roofline import counts


def test_kernel1_vitb14_batch2():
    tokens = counts.vit_tokens(1190, 1596, 14)
    assert tokens == 9691
    assert counts.attention_least_s(2, tokens, 768) * 1e3 == pytest.approx(0.583, abs=5e-4)


def test_kernel1_24_heads_of_64_batch2():
    least = counts.attention_least_s(2, 9691, 24 * 64)
    assert least * 1e3 == pytest.approx(1.167, abs=5e-4)


def test_kernel2_28_pairs_of_4096():
    least = counts.match_least_s(28, 4096, 4096, 128, "fp32")
    assert least * 1e3 == pytest.approx(1.795, abs=5e-4)


def test_kernel5_int8_at_the_same_shape():
    least = counts.match_least_s(28, 4096, 4096, 128, "int8")
    assert least * 1e3 == pytest.approx(0.061, abs=5e-4)


@pytest.mark.parametrize("cfg,tflop", [
    (dict(hidden_size=768, num_hidden_layers=12, intermediate_size=3072, patch_size=14), 5.12),
    (dict(hidden_size=1024, num_hidden_layers=24, intermediate_size=4096, patch_size=14), 15.1),
])
def test_vit_forward_flops(cfg, tflop):
    assert counts.vit_forward_flops(cfg, 1190, 1596) / 1e12 == pytest.approx(tflop, rel=0.01)


def test_shares_never_pass_the_peak():
    # A least time is a floor: a kernel time at the floor reads 100%.
    least = counts.attention_least_s(2, 9691, 768)
    assert 100.0 * least / least == 100.0
    assert counts.least_s(1.0, 1e30, "bf16") == pytest.approx(1e30 / 3.35e12)
