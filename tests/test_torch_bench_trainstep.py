"""The port's training-step benchmark (``scripts/torch_bench_trainstep.py``)
against the JAX script's step (``scripts/bench_trainstep.py``) on the CPU.

* The batch is the JAX script's: ``default_rng(0)`` uint8 pairs, identity H.
* One step of the benchmark's ``make_step`` (``make_optimizer(3e-4,
  total_steps=1000)``, ``top_k`` from the flag) on the two-layer narrow
  models of ``tests/test_torch_training_batch.py`` (f32, the JAX parameters
  carried across with ``models/convert``) and the JAX package's uniforms:
  the loss within 1e-5 relative of the JAX ``make_train_step``'s, and each
  head gradient (after the step's global-norm clip) within 1e-3 of the
  tensor's largest gradient of JAX's, clipped the optax way: the bounds of
  ``tests/test_torch_training_*.py``.
* ``main`` prints the JAX script's keys at a tiny size on the CPU, and
  ``--check-repro`` adds its report (two CPU runs of the same sequence are
  bit-equal).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import scripts.torch_bench_trainstep as tbt
from tests.test_torch_training_batch import GRAD_TOL, Draws, jax_draws, tiny_models
from vit_colmap_tpu.dataloader import training_batch as jb
from vit_colmap_tpu.losses.feature_losses import total_loss as jtotal
from vit_colmap_tpu.training import train_step as jts
from vit_colmap_tpu_torch.models.convert import jax_feature_heads_to_torch


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


TOP_K = 12
JAX_KEYS = {"metric", "value", "unit", "s_per_step", "images_per_sec", "batch_size",
            "image_size", "backbone", "compile_s", "final_loss", "device"}


def test_batch_is_the_jax_scripts():
    b = tbt.make_batch(2, 14, 28)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(b["image1"], rng.integers(0, 256, (2, 14, 28, 3),
                                                            dtype=np.uint8))
    np.testing.assert_array_equal(b["image2"], rng.integers(0, 256, (2, 14, 28, 3),
                                                            dtype=np.uint8))
    np.testing.assert_array_equal(b["H"], np.stack([np.eye(3, dtype=np.float32)] * 2))


def test_one_step_loss_and_head_gradients_match_jax():
    (jbb, bparams, jheads, hparams), (tbb, theads) = tiny_models(seed=3)
    batch = tbt.make_batch(2, 70, 84)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(1)

    jopt = jts.make_optimizer(tbt.LEARNING_RATE, total_steps=tbt.TOTAL_STEPS)
    jstep, _ = jts.make_train_step(jbb.apply, jheads.apply, jopt,
                                   batch_kwargs=dict(top_k=TOP_K))
    _, jm = jstep(jts.init_train_state(hparams, jopt), bparams, jbatch, key)

    def jloss(hp):
        outs, tgts = jb.process_batch(jbb.apply, bparams, jheads.apply, hp, jbatch, key,
                                      top_k=TOP_K)
        return jtotal(outs, tgts).total

    jgrads = jax.jit(jax.grad(jloss))(hparams)
    jgrads, _ = optax.clip_by_global_norm(1.0).update(jgrads, None)

    state, step = tbt.make_step(tbb, theads, TOP_K)
    draws = Draws(jax_draws(key, 2, TOP_K))
    state, tm = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, draws)
    assert not draws.arrays and state.step == 1
    assert not any(p.requires_grad for p in tbb.parameters())
    np.testing.assert_allclose(float(tm["total_loss"]), float(jm["total_loss"]), rtol=1e-5)

    ref = jax_feature_heads_to_torch(jgrads)
    for name, p in theads.named_parameters():
        g = ref[name].numpy()
        assert np.abs(p.grad.numpy() - g).max() <= GRAD_TOL * max(np.abs(g).max(), 1e-12), name


ARGS = ["--backbone", "vits14", "--height", "56", "--width", "70", "--steps", "2",
        "--top-k", "16", "--device", "cpu"]


def test_main_prints_the_jax_keys(capsys):
    out = tbt.main(ARGS)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == JAX_KEYS and line == out
    assert line["metric"] == "train_steps_per_sec" and line["device"] == "cpu"
    assert line["image_size"] == [56, 70] and line["images_per_sec"] > 0
    assert np.isfinite(line["final_loss"])


def test_repro_report(capsys):
    out = tbt.main(ARGS + ["--steps", "1", "--check-repro"])
    assert set(out) == JAX_KEYS | {"repro"}
    assert out["repro"]["bit_equal"] and out["repro"]["max_abs_param_diff"] == 0.0
    assert out["repro"]["params_differing"] == []


def test_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbt.main(ARGS[:-2])
