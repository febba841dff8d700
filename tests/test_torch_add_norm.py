"""The backbone's block boundaries (``models/dinov2._add_norm``) on the CPU:
the add-and-norm kernel's plain version against the ops it replaced, the
rewired ``DinoV2`` forward against the forward before it (bit for bit, also
its gradients), which forwards take the kernel's wrapper, and the checks by
which the wrapper refuses what the kernel does not take.  The kernel itself
is held to the plain version on the card in ``tests/test_torch_gpu.py``."""

import pytest
import torch
import torch.nn.functional as F

from vit_colmap_tpu_torch.kernels import add_norm
from vit_colmap_tpu_torch.models import dinov2

TINY = dict(embed_dim=64, depth=2, num_heads=2, mlp_ratio=4.0)
VARIANTS = {
    "vit": {},
    "swiglu-registers": dict(swiglu=True, num_register_tokens=4),
    "int8": dict(quantize="int8"),
    "f32": dict(dtype=torch.float32),
}


def _ops_before(x, branch, gamma, norm, dtype):
    """The boundary as separate ops, as the backbone ran it before the
    kernel: LayerScale, the residual add, LayerNorm on an f32 copy, the
    cast back."""
    if branch is not None:
        x = x + branch * gamma.to(branch.dtype)
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return x, y.to(dtype)


def _forward_before(model, x):
    """``DinoV2.forward`` as it was before the boundaries were rewired: each
    block ``x + ls1(attn(norm1(x)))`` then ``x + ls2(mlp(norm2(x)))``, the
    final norm in f32.  The tokens come from the model's own embedding,
    caught at the first block."""
    caught = {}

    def stop(module, args):
        caught["t"] = args[0]
        raise StopIteration

    handle = model.blocks[0].register_forward_pre_hook(stop)
    try:
        model(x)
    except StopIteration:
        pass
    finally:
        handle.remove()
    t, dt = caught["t"], model.cfg.dtype
    for blk in model.blocks:
        _, h = _ops_before(t, None, None, blk.norm1, dt)
        t = t + blk.attn(h) * blk.ls1.gamma.to(dt)
        _, h = _ops_before(t, None, None, blk.norm2, dt)
        t = t + blk.mlp(h) * blk.ls2.gamma.to(dt)
    t = F.layer_norm(t.float(), model.norm.normalized_shape, model.norm.weight,
                     model.norm.bias, model.norm.eps)
    regs = model.cfg.num_register_tokens
    return {"x_norm_clstoken": t[:, 0], "x_norm_patchtokens": t[:, 1 + regs:]}


def _model(variant: dict, seed: int = 0):
    cfg = dinov2.ViTConfig(**{**TINY, **variant})
    model = dinov2.DinoV2(cfg, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # visible LayerScales and LayerNorm affines
        for name, p in model.named_parameters():
            if name.endswith(("ls1.gamma", "ls2.gamma")):
                p.copy_(0.3 * torch.randn(p.shape, generator=g))
            elif ".norm" in name or name.startswith("norm."):
                p.add_(0.2 * torch.randn(p.shape, generator=g))
    return model


def _images(seed: int = 2, hw=(56, 70)):
    return torch.randn(2, *hw, 3, generator=torch.Generator().manual_seed(seed))


def _boundary_inputs(dtype, seed: int = 3, T: int = 37, D: int = 96):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(T, D, generator=g) * 2 + 0.5).to(dtype)
    branch = (torch.randn(T, D, generator=g) * 4).to(dtype)
    gamma = 0.1 * torch.randn(D, generator=g)
    norm = torch.nn.LayerNorm(D, eps=1e-6)
    with torch.no_grad():
        norm.weight.add_(0.2 * torch.randn(D, generator=g))
        norm.bias.add_(0.2 * torch.randn(D, generator=g))
    return x, branch, gamma, norm


@pytest.mark.parametrize("with_branch", [True, False], ids=["branch", "no-branch"])
@pytest.mark.parametrize("dtype,out_dtype", [(torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32),
                                             (torch.float32, torch.float32)])
def test_plain_add_norm_is_the_ops_it_replaced(with_branch, dtype, out_dtype):
    x, branch, gamma, norm = _boundary_inputs(dtype)
    if not with_branch:
        branch, gamma = None, None
    args = (x, branch, gamma, norm.weight, norm.bias, norm.eps, out_dtype)
    with torch.no_grad():
        x_new, y = add_norm.add_norm_plain(*args)
        ref_x, ref_y = _ops_before(x, branch, gamma, norm, out_dtype)
        # On the CPU a block boundary is the plain version.
        ls = None
        if with_branch:
            ls = dinov2.LayerScale(x.shape[-1])
            ls.gamma.copy_(gamma)
        w_x, w_y = dinov2._add_norm(x, branch, ls, norm, out_dtype)
    assert x_new.dtype == dtype and y.dtype == out_dtype
    assert torch.equal(x_new, ref_x) and torch.equal(y, ref_y)
    assert torch.equal(w_x, ref_x) and torch.equal(w_y, ref_y)
    if not with_branch:
        assert x_new is x


@pytest.mark.parametrize("variant", list(VARIANTS), ids=list(VARIANTS))
def test_rewired_forward_equals_the_forward_before(variant):
    model = _model(VARIANTS[variant]).eval()
    x = _images()
    with torch.no_grad():
        out = model(x)
        ref = _forward_before(model, x)
    for key in ("x_norm_clstoken", "x_norm_patchtokens"):
        assert out[key].dtype == torch.float32
        assert torch.equal(out[key], ref[key]), key


class _OnCard:
    """A CPU tensor that ``add_norm.takes_kernel`` reads as one on the card."""

    is_cuda = True

    def __init__(self, t: torch.Tensor):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _counting(monkeypatch):
    """The out dtypes of the boundaries that call the kernel's wrapper, on
    the CPU: the program's rule with the stream read as on the card, the
    plain version standing in for the kernel."""
    calls = []
    rule = add_norm.takes_kernel

    def counted(*args):
        calls.append(args[6])
        return add_norm.add_norm_plain(*args)

    monkeypatch.setattr(add_norm, "takes_kernel", lambda x, *params: rule(_OnCard(x), *params))
    monkeypatch.setattr(add_norm, "add_norm", counted)
    return calls


@pytest.mark.parametrize("name,depth", [("vitb14", 12), ("vitl14", 24), ("vitg14_reg", 40)])
def test_a_forward_takes_the_kernel_at_every_boundary(name, depth, monkeypatch):
    """1 + 2 * depth calls of the kernel's wrapper a forward (25, 49, 81),
    the last into the final norm's f32; the published depths and register
    counts at a small width."""
    table = dinov2.VIT_CONFIGS[name]
    assert table["depth"] == depth
    cfg = dinov2.ViTConfig(**{**table, "embed_dim": 32, "num_heads": 2})
    model = dinov2.DinoV2(cfg, generator=torch.Generator().manual_seed(0))
    calls = _counting(monkeypatch)
    with torch.no_grad():
        model(_images(hw=(28, 42)))
    assert len(calls) == 1 + 2 * depth
    assert calls[:-1] == [torch.bfloat16] * (2 * depth) and calls[-1] == torch.float32


def test_a_frozen_backbone_takes_the_kernel_with_grad_mode_on(monkeypatch):
    """The trainer's frozen backbone (``requires_grad_(False)``) records no
    gradient even outside ``no_grad``."""
    model = _model({}).requires_grad_(False)
    calls = _counting(monkeypatch)
    model(_images())
    assert len(calls) == 1 + 2 * TINY["depth"]


@pytest.mark.parametrize("case", ["f32", "trainable-backbone", "input-requires-grad"])
def test_f32_and_grad_recording_forwards_take_the_plain_version(case, monkeypatch):
    model = _model(VARIANTS["f32"] if case == "f32" else {})
    x = _images()
    if case == "input-requires-grad":
        model.requires_grad_(False)
        x.requires_grad_(True)
    calls = _counting(monkeypatch)
    with torch.no_grad() if case == "f32" else torch.enable_grad():
        model(x)
    assert calls == []


def test_gradients_equal_the_forward_befores():
    """A forward that records gradients (``--train-backbone``) runs the
    same ops in the same order as before: every parameter's gradient and
    the input's bit for bit."""
    model = _model(VARIANTS["swiglu-registers"])
    x = _images().requires_grad_(True)

    def grads(forward):
        model.zero_grad()
        x.grad = None
        out = forward(x)
        (out["x_norm_patchtokens"].square().mean() + out["x_norm_clstoken"].sum()).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}, x.grad.clone()

    got, got_x = grads(model)
    ref, ref_x = grads(lambda t: _forward_before(model, t))
    assert got.keys() == ref.keys()
    for name in got:
        assert torch.equal(got[name], ref[name]), name
    assert torch.equal(got_x, ref_x)
    assert got["blocks.1.ls2.gamma"].abs().sum() > 0


def _refused(**change):
    x, branch, gamma, norm = _boundary_inputs(torch.bfloat16, T=4, D=64)
    args = dict(x=x, branch=branch, gamma=gamma, weight=norm.weight.detach(),
                bias=norm.bias.detach(), out_dtype=torch.bfloat16)
    args.update(change)
    return args


@pytest.mark.parametrize("change,match", [
    (dict(x=torch.zeros(4, 64, dtype=torch.float16)), "bf16"),
    (dict(x=torch.zeros(64, 4, dtype=torch.bfloat16).t()), "contiguous"),
    (dict(x=torch.zeros(4, 60, dtype=torch.bfloat16)), "multiples of 8"),
    (dict(x=torch.zeros(4, 2056, dtype=torch.bfloat16)), "multiples of 8"),
    (dict(out_dtype=torch.float16), "bf16 or f32"),
    (dict(gamma=None), "together"),
    (dict(branch=torch.zeros(4, 64, dtype=torch.float32)), "branch"),
    (dict(gamma=torch.zeros(64, dtype=torch.bfloat16)), "f32"),
    (dict(bias=torch.zeros(32)), "f32"),
    (dict(weight=torch.ones(64, requires_grad=True)), "inference only"),
], ids=["f16", "strided", "width-60", "width-2056", "out-f16", "gamma-missing",
        "branch-dtype", "gamma-bf16", "bias-shape", "grad"])
def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take(change, match):
    """The checks the wrapper makes before a launch (on CPU tensors here;
    the card's test launches)."""
    a = _refused(**change)
    with pytest.raises(ValueError, match=match):
        add_norm._check(a["x"], a["branch"], a["gamma"], a["weight"], a["bias"],
                        a["out_dtype"])


def test_the_kernel_wrapper_accepts_the_backbone_widths():
    for name, table in dinov2.VIT_CONFIGS.items():
        x, branch, gamma, norm = _boundary_inputs(torch.bfloat16, T=3, D=table["embed_dim"])
        with torch.no_grad():
            add_norm._check(x, branch, gamma, norm.weight, norm.bias, torch.float32)


@pytest.mark.parametrize("case,takes", [
    ("bf16", True), ("f16", False), ("f32", False), ("grad-weight", False),
    ("grad-x", False), ("grad-weight-no-grad-mode", True), ("no-branch", True),
])
def test_takes_kernel_is_a_bf16_stream_that_records_no_gradient(case, takes):
    """The rule by which a boundary takes the kernel, with the stream read
    as on the card; a CPU stream never takes it."""
    x, branch, gamma, norm = _boundary_inputs(torch.bfloat16, T=4, D=64)
    weight, bias = norm.weight.detach(), norm.bias.detach()
    if case in ("f16", "f32"):
        x = x.to(getattr(torch, "float16" if case == "f16" else "float32"))
        branch = branch.to(x.dtype)
    elif case.startswith("grad-weight"):
        weight = weight.clone().requires_grad_(True)
    elif case == "grad-x":
        x = x.clone().requires_grad_(True)
    elif case == "no-branch":
        branch = gamma = None
    with torch.no_grad() if case.endswith("no-grad-mode") else torch.enable_grad():
        assert add_norm.takes_kernel(_OnCard(x), branch, gamma, weight, bias) is takes
        assert add_norm.takes_kernel(x, branch, gamma, weight, bias) is False


def test_the_kernel_wrapper_refuses_cpu_tensors():
    x, branch, gamma, norm = _boundary_inputs(torch.bfloat16, T=4, D=64)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        add_norm.add_norm(x, branch, gamma, norm.weight, norm.bias, norm.eps, torch.bfloat16)
