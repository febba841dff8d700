"""The port's training losses (``losses/feature_losses.py``) against the
JAX package's, on the same numpy inputs from a seed.

Values within 1e-5 relative (f32 on both sides), gradients with respect to
every differentiable input within 1e-4 of the largest gradient; the
detached parts (the confidence weight, the telemetry scalars) carry no
gradient, as ``stop_gradient`` does in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_colmap_tpu.losses import feature_losses as jl
from vit_colmap_tpu_torch.losses import feature_losses as tl

@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Small tensor operations on 1 intra-op thread: test workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


VALUE_RTOL = 1e-5
GRAD_TOL = 1e-4  # of the largest gradient


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _inputs(seed=0, B=2, K=12, N=10, D=16, H=9, W=11):
    rng = np.random.default_rng(seed)
    f = np.float32
    yy, xx = np.mgrid[0:H, 0:W]
    target = np.exp(-((xx - 4.3) ** 2 + (yy - 5.1) ** 2) / 2.0)[None].repeat(B, 0)
    outputs = {
        "score_logits": (2 * rng.standard_normal((B, H, W))).astype(f),
        "orient_pred": rng.uniform(-np.pi, np.pi, (B, K)).astype(f),
        "desc1": _unit(rng.standard_normal((B, K, D))).astype(f),
        "desc2": _unit(rng.standard_normal((B, K, D))).astype(f),
        "negatives": _unit(rng.standard_normal((B, K, N, D))).astype(f),
        "score_at_kp": rng.standard_normal((B, K)).astype(f),
    }
    targets = {
        "score_target": target.astype(f),
        "orient_target": rng.uniform(-np.pi, np.pi, (B, K)).astype(f),
        "kp_mask": (rng.random((B, K)) > 0.25).astype(f),
    }
    return outputs, targets


def _close(a, b, rtol=VALUE_RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=1e-6)


def test_elementwise_losses_match_jax():
    rng = np.random.default_rng(1)
    x = (4 * rng.standard_normal(200)).astype(np.float32)
    t = rng.random(200).astype(np.float32)
    _close(tl.bce_with_logits(torch.from_numpy(x), torch.from_numpy(t)),
           jl.bce_with_logits(jnp.asarray(x), jnp.asarray(t)))
    p = rng.uniform(-7, 7, 200).astype(np.float32)
    _close(tl.circular_l2(torch.from_numpy(p), torch.from_numpy(x)),
           jl.circular_l2(jnp.asarray(p), jnp.asarray(x)))
    # The wrap: pi - 0.1 against -pi + 0.1 is 0.2 apart.
    d = tl.circular_l2(torch.tensor([np.pi - 0.1]), torch.tensor([-np.pi + 0.1]))
    assert abs(float(d) - 0.04) < 1e-5


@pytest.mark.parametrize("pos_weight,masked", [(None, True), (None, False), (5.0, True)])
def test_detector_loss_matches_jax(pos_weight, masked):
    o, t = _inputs(2)
    args = [o["score_logits"], t["score_target"], o["orient_pred"], t["orient_target"],
            t["kp_mask"] if masked else None]
    jt, jparts = jl.detector_loss(*[None if a is None else jnp.asarray(a) for a in args],
                                  0.32, pos_weight=pos_weight)
    tt, tparts = tl.detector_loss(*[None if a is None else torch.from_numpy(a) for a in args],
                                  0.32, pos_weight=pos_weight)
    _close(tt, jt)
    assert set(tparts) == set(jparts)
    for k in jparts:
        _close(tparts[k], jparts[k])


@pytest.mark.parametrize("hardest,weighted", [(True, True), (False, True), (True, False)])
def test_descriptor_loss_matches_jax(hardest, weighted):
    o, t = _inputs(3)
    w = (np.random.default_rng(4).random(t["kp_mask"].shape).astype(np.float32)
         if weighted else None)
    keys = ("desc1", "desc2", "negatives")
    jt, jparts = jl.descriptor_loss(*[jnp.asarray(o[k]) for k in keys],
                                    weights=None if w is None else jnp.asarray(w),
                                    hardest=hardest)
    tt, tparts = tl.descriptor_loss(*[torch.from_numpy(o[k]) for k in keys],
                                    weights=None if w is None else torch.from_numpy(w),
                                    hardest=hardest)
    _close(tt, jt)
    assert set(tparts) == set(jparts)
    for k in jparts:
        _close(tparts[k], jparts[k])


def _grads_close(tg: dict, jg: dict):
    for k in tg:
        g = np.asarray(jg[k])
        scale = max(np.abs(g).max(), 1e-12)
        assert np.abs(tg[k] - g).max() <= GRAD_TOL * scale, k


@pytest.mark.parametrize("pos_weight", [None, 3.0])
def test_total_loss_values_and_gradients_match_jax(pos_weight):
    o, t = _inputs(5)
    kw = dict(lambda_det=0.7, lambda_desc=1.3, alpha_orient=0.32, margin=0.5,
              temperature=0.1, lambda_nce=0.9, lambda_var=1.1, pos_weight=pos_weight)

    def jloss(outs):
        out = jl.total_loss(outs, {k: jnp.asarray(v) for k, v in t.items()}, **kw)
        return out.total, out.components

    (jtotal, jparts), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in o.items()})
    touts = {k: torch.from_numpy(v).requires_grad_() for k, v in o.items()}
    res = tl.total_loss(touts, {k: torch.from_numpy(v) for k, v in t.items()}, **kw)
    res.total.backward()
    _close(res.total.detach(), jtotal)
    assert set(res.components) == set(jparts)
    for k in jparts:
        _close(res.components[k].detach(), jparts[k])
    # The confidence weight is detached: no gradient reaches score_at_kp.
    assert not np.asarray(jgrads["score_at_kp"]).any()
    assert touts.pop("score_at_kp").grad is None
    _grads_close({k: v.grad.numpy() for k, v in touts.items()}, jgrads)
    for k in ("score_peak", "desc_std"):
        assert not res.components[k].requires_grad
