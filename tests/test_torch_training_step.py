"""The port's optimizer and training step (``training/train_step.py``)
against optax and the JAX package's ``make_train_step``.

* The schedule over 120 steps (warmup 20, total 100: warmup, cosine and
  the floor after it) against ``optax.warmup_cosine_decay_schedule``,
  through the port's ``LambdaLR``: within 1e-5 relative (optax computes
  in f32, and 1 + cos cancels near the end of the cosine).
* Five AdamW steps on the same random gradients, the clip active (max
  norm 0.05) and inactive (1e9), frozen and fine-tune (two groups): the
  parameters within 1e-6 relative plus 1e-9 of optax's.
* One whole step (``process_batch`` on the tiny models of
  ``test_torch_training_batch.py``, the loss, the gradients, the clip and
  AdamW) from the same parameters, batch and draws: the loss within 1e-5
  relative; every parameter's change at most the step's rate, and within
  2% of the rate of optax's where optax moved it by at least 0.98 of the
  rate (AdamW's first step moves a parameter by rate * g / (|g| + eps):
  where |g| is within a few eps the change is rounding noise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_training_batch import (
    BATCH_KW,
    Draws,
    jax_draws,
    tiny_batch,
    tiny_models,
)
from vit_colmap_tpu.training import train_step as jts
from vit_colmap_tpu_torch.models.convert import jax_dinov2_to_torch, jax_feature_heads_to_torch
from vit_colmap_tpu_torch.training import train_step as tts

@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Small tensor operations on 1 intra-op thread: test workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LR = 1e-3


def _optax_schedule(lr, warmup, total):
    return optax.warmup_cosine_decay_schedule(lr * 0.1, lr, warmup, max(total, warmup + 1),
                                              lr / 100.0)


@pytest.mark.parametrize("finetune", [False, True])
def test_schedule_matches_optax_over_120_steps(finetune):
    p = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.zeros(3))})
    if finetune:
        module = torch.nn.ModuleDict({"heads": p, "backbone": torch.nn.ParameterDict(
            {"w": torch.nn.Parameter(torch.zeros(2))})})
        recipe = tts.make_finetune_optimizer(LR, 1e-4, 100, 20, 1.0, backbone_lr_scale=0.25)
        peaks = (LR, LR * 0.25)
    else:
        module = p
        recipe = tts.make_optimizer(LR, 1e-4, 100, 20, 1.0)
        peaks = (LR,)
    opt, sched = recipe.init(module)
    wants = [np.asarray(jax.jit(_optax_schedule(peak, 20, 100))(jnp.arange(120)))
             for peak in peaks]
    for step in range(120):
        for group, want in zip(opt.param_groups, (w[step] for w in wants)):
            want = float(want)
            assert abs(group["lr"] - want) <= 1e-5 * want, (step, group["lr"], want)
        opt.step()
        sched.step()


def _tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


HEAD_SHAPES = {"w": (4, 3), "b": (3,)}
BB_SHAPES = {"w": (3, 5)}


@pytest.mark.parametrize("finetune", [False, True])
@pytest.mark.parametrize("clip", [0.05, 1e9])
def test_adamw_steps_match_optax(finetune, clip):
    heads = _tree(0, HEAD_SHAPES)
    params = {"heads": heads, "backbone": _tree(1, BB_SHAPES)} if finetune else heads
    if finetune:
        jopt = jts.make_finetune_optimizer(LR, 1e-2, 50, 3, clip, backbone_lr_scale=0.3)
        topt = tts.make_finetune_optimizer(LR, 1e-2, 50, 3, clip, backbone_lr_scale=0.3)
        module = torch.nn.ModuleDict({k: torch.nn.ParameterDict(
            {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in d.items()})
            for k, d in params.items()})
    else:
        jopt = jts.make_optimizer(LR, 1e-2, 50, 3, clip)
        topt = tts.make_optimizer(LR, 1e-2, 50, 3, clip)
        module = torch.nn.ParameterDict(
            {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, v in params.items()})
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    opt, sched = topt.init(module)
    named = dict(module.named_parameters())
    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda v, k=step: np.random.default_rng(10 + k).standard_normal(v.shape)
            .astype(np.float32) * (1 + 10 * k), params)
        updates, jstate = jupdate(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        flat = {".".join(str(getattr(p, "key", p)) for p in path): g
                for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
        for name, p in named.items():
            p.grad = torch.from_numpy(flat[name].copy())
        norm = tts.clip_by_global_norm_(list(named.values()), topt.grad_clip)
        assert (float(norm) >= clip) == (clip < 1)
        opt.step()
        sched.step()
        jflat = {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
                 for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
        for name, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), jflat[name], rtol=1e-6, atol=1e-9,
                                       err_msg=f"step {step} {name}")


@pytest.mark.parametrize("train_backbone", [False, True])
def test_train_step_matches_jax(train_backbone):
    (jbb, bparams, jheads, hparams), (tbb, theads) = tiny_models(seed=3)
    batch = tiny_batch(seed=4)
    key = jax.random.key(11)
    kw = dict(learning_rate=LR, weight_decay=1e-4, total_steps=10, warmup_steps=2)
    if train_backbone:
        jopt = jts.make_finetune_optimizer(**kw, backbone_lr_scale=0.5)
        topt = tts.make_finetune_optimizer(**kw, backbone_lr_scale=0.5)
        jtrain = {"heads": hparams, "backbone": bparams}
        ttrain = torch.nn.ModuleDict({"heads": theads, "backbone": tbb})
    else:
        jopt = jts.make_optimizer(**kw)
        topt = tts.make_optimizer(**kw)
        jtrain, ttrain = hparams, theads
        tbb.requires_grad_(False)
    jstep, _ = jts.make_train_step(jbb.apply, jheads.apply, jopt, batch_kwargs=BATCH_KW,
                                   train_backbone=train_backbone)
    jstate, jm = jstep(jts.init_train_state(jtrain, jopt),
                       None if train_backbone else bparams,
                       {k: jnp.asarray(v) for k, v in batch.items()}, key)
    tstep, _ = tts.make_train_step(tbb, theads, topt, batch_kwargs=BATCH_KW,
                                   train_backbone=train_backbone)
    before = {k: v.detach().clone() for k, v in ttrain.state_dict().items()}
    draws = Draws(jax_draws(key, 2, BATCH_KW["top_k"],
                            token=(2, 256) if train_backbone else None))
    tstate, tm = tstep(tts.init_train_state(ttrain, topt), {k: torch.from_numpy(np.array(v))
                                                            for k, v in batch.items()}, draws)
    assert tstate.step == int(jstate.step) == 1
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tm["total_loss"]), float(jm["total_loss"]), rtol=1e-5)

    rate = LR * 0.1  # the schedule at step 0
    new = jstate.heads_params
    pairs = [("", theads, jax_feature_heads_to_torch(new["heads"] if train_backbone else new),
              jax_feature_heads_to_torch(hparams))]
    if train_backbone:
        pairs.append(("", tbb, jax_dinov2_to_torch(new["backbone"]), jax_dinov2_to_torch(bparams)))
    prefix = {id(theads): "heads." if train_backbone else "", id(tbb): "backbone."}
    moved = 0
    for _, module, jnew, jold in pairs:
        for name, p in module.named_parameters():
            old = before[prefix[id(module)] + name].numpy()
            np.testing.assert_array_equal(old, jold[name].numpy())
            jdelta = jnew[name].numpy() - old
            tdelta = p.detach().numpy() - old
            # AdamW's first step: |delta| <= rate (plus the decay).
            assert np.abs(tdelta).max() <= 1.01 * rate + 1e-7, name
            big = np.abs(jdelta) > 0.98 * rate  # gradients above 50 x eps
            assert np.abs(tdelta - jdelta)[big].max(initial=0) <= 0.02 * rate, name
            moved += int(big.sum())
    assert moved > 0
