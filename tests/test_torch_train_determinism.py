"""The two backward passes that make the port's training step bit-reproducible
on the card (``models/feature_model.resize_bilinear``,
``ops/interpolate.bilinear_sample``), on the CPU.

On the card PyTorch's backward of ``F.interpolate(mode="bilinear")`` and of
``torch.gather`` add with float atomics in no fixed order, so two runs of
one step differed (``scripts/torch_bench_trainstep.py --check-repro``).  The
heads' resize now applies its transposed weights as two products, and the
sampler reads its corners by indexing, whose gradient accumulates in sorted
order.  Held here: both forwards bit for bit the previous ones, both
gradients within 2e-6 of PyTorch's (f32 rounding of another summation
order), the resize's weights as PyTorch computes them, and the step twice
bit for bit through ``scripts/torch_bench_trainstep.py`` (as on the card).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vit_colmap_tpu_torch.models.feature_model import bilinear_weights, resize_bilinear
from vit_colmap_tpu_torch.ops.interpolate import bilinear_sample


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def accumulated_weights(n_in, n_out):
    """The resize's weights as index adds of both neighbours' shares, the
    way PyTorch's CPU kernel spreads them."""
    src = torch.clamp_min(torch.tensor(n_in / n_out, dtype=torch.float32)
                          * (torch.arange(n_out, dtype=torch.float32) + 0.5) - 0.5, 0.0)
    i0 = src.long()
    lam = src - i0.float()
    rows = torch.arange(n_out)
    w = torch.zeros(n_out, n_in)
    w.index_put_((rows, i0), 1.0 - lam, accumulate=True)
    w.index_put_((rows, torch.clamp_max(i0 + 1, n_in - 1)), lam, accumulate=True)
    return w


@pytest.mark.parametrize("shape", [(136, 184, 119, 161), (20, 24, 17, 21), (8, 8, 8, 8),
                                   (5, 7, 9, 11)], ids=str)
def test_resize_equals_interpolate_forward_and_backward(shape):
    h, w, oh, ow = shape
    g = torch.Generator().manual_seed(h)
    x = torch.randn(2, 3, h, w, generator=g, requires_grad=True)
    ref = F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False,
                        antialias=False)
    grad_out = torch.randn(ref.shape, generator=g)
    (ref_grad,) = torch.autograd.grad(ref, x, grad_out)
    x2 = x.detach().clone().requires_grad_(True)
    out = resize_bilinear(x2, (oh, ow))
    assert torch.equal(out, ref)
    (grad,) = torch.autograd.grad(out, x2, grad_out)
    assert (grad - ref_grad).abs().max() <= 2e-6
    # The weights are the forward's own: applied to x they give it.
    wy, wx = bilinear_weights(h, oh), bilinear_weights(w, ow)
    assert torch.equal(wy, accumulated_weights(h, oh))
    assert torch.equal(wx, accumulated_weights(w, ow))
    # Built once a shape and device: the second backward makes no new weights.
    misses = bilinear_weights.cache_info().misses
    torch.autograd.grad(resize_bilinear(x2, (oh, ow)), x2, grad_out)
    assert bilinear_weights.cache_info().misses == misses
    assert torch.allclose(wy.sum(1), torch.ones(oh)) and torch.allclose(wx.sum(1), torch.ones(ow))
    assert (wy @ x.detach() @ wx.T - ref).abs().max() <= 2e-6


def gather_sample(fmap, xy):
    """The sampler as it read its corners before: ``torch.gather``."""
    B, H, W, C = fmap.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.0)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = torch.clamp_max(x0 + 1, W - 1), torch.clamp_max(y0 + 1, H - 1)
    wx, wy = (x - x0.to(x.dtype))[..., None], (y - y0.to(y.dtype))[..., None]
    flat = fmap.reshape(B, H * W, C)

    def g(yy, xx):
        return torch.gather(flat, 1, (yy * W + xx)[..., None].expand(-1, -1, C))

    top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def test_bilinear_sample_equals_gather_forward_and_backward():
    g = torch.Generator().manual_seed(0)
    fmap = torch.randn(2, 9, 11, 16, generator=g, requires_grad=True)
    # Many samples share corners (duplicates accumulate), some off the map.
    xy = torch.rand(2, 300, 2, generator=g) * torch.tensor([12.0, 10.0]) - 0.5
    ref = gather_sample(fmap, xy)
    grad_out = torch.randn(ref.shape, generator=g)
    (ref_grad,) = torch.autograd.grad(ref, fmap, grad_out)
    f2 = fmap.detach().clone().requires_grad_(True)
    out = bilinear_sample(f2, xy)
    assert torch.equal(out, ref)
    (grad,) = torch.autograd.grad(out, f2, grad_out)
    assert (grad - ref_grad).abs().max() <= 2e-6


def test_two_runs_of_the_step_are_bit_equal():
    import scripts.torch_bench_trainstep as tbt

    args = dict(backbone_name="vits14", batch_size=2, height=56, width=70, steps=1, top_k=16,
                device=torch.device("cpu"))
    a, b = tbt.sequence(**args), tbt.sequence(**args)
    rep = tbt.compare_runs(a, b)
    assert rep["bit_equal"] and rep["max_abs_param_diff"] == 0.0
    assert np.isfinite(a["losses"].numpy()).all()
