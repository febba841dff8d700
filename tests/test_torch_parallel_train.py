"""The trainer's data parallelism (``training/data_parallel.py``) on CPU
slots.

* The choice of slots: the first ``gcd(batch, devices)`` devices, as the
  JAX trainer takes them (``vit_colmap_tpu/training/train.py:231-245``).
* One training step of a two-layer narrow backbone (embed 128, 2 heads)
  and narrow heads in f32 on a batch of 4, over 2 slots and over 1, from
  the same parameters, batch and generator: every loss component within
  ``LOSS_RTOL`` relative (plus ``LOSS_ATOL``) and every head gradient (and,
  fine-tuning, every backbone gradient) within ``GRAD_TOL`` of its tensor's
  largest, after the step's clip.  The split changes only which rows each
  forward pass holds, so the bounds are f32 rounding.  The second slot is
  on the first's device (the master modules on both threads) or on
  ``cpu:0``, which ``torch`` counts as another device: the path of a
  second card, through a replica with the trainable parameters copied
  differentiably at each call and the frozen ones copied once.
* The known-wrong data parallelism, DDP's: each slot's loss over its own
  share (its own roll of the cross-image negatives, its own ``pos_weight``
  and variance), averaged over the slots.  It must miss the loss bound.
"""

import copy

import numpy as np
import pytest
import torch

from tests.test_torch_training_batch import BATCH_KW, SMALL, TINY, tiny_batch
from vit_colmap_tpu_torch.dataloader.training_batch import process_batch
from vit_colmap_tpu_torch.losses.feature_losses import total_loss
from vit_colmap_tpu_torch.models import dinov2 as tdino
from vit_colmap_tpu_torch.models import feature_model as tfm
from vit_colmap_tpu_torch.training import train_step as tts
from vit_colmap_tpu_torch.training.data_parallel import SlotForward, data_slots


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Small tensor operations on 1 intra-op thread: test workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LOSS_RTOL = 1e-5
LOSS_ATOL = 1e-6
GRAD_TOL = 1e-4  # of each tensor's largest gradient
BATCH = 4


@pytest.mark.parametrize("batch,n_dev,want", [(2, 4, 2), (4, 4, 4), (6, 4, 2), (3, 8, 1),
                                              (8, 8, 8)])
def test_trainer_takes_the_first_gcd_slots(batch, n_dev, want):
    devices = [torch.device("cpu", i) for i in range(n_dev)]
    assert data_slots(batch, devices) == devices[:want]


def _models(seed=0):
    g = torch.Generator().manual_seed(seed)
    bb = tdino.DinoV2(tdino.ViTConfig(**TINY, dtype=torch.float32), generator=g)
    heads = tfm.FeatureHeads(tfm.FeatureModelConfig(**SMALL, dtype=torch.float32), 128)
    tfm.reset_heads(heads, g)
    with torch.no_grad():  # LayerNorms and biases off their constant init
        for p in list(bb.parameters()) + list(heads.parameters()):
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    return bb, heads


@pytest.fixture(scope="module")
def batch():
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tiny_batch(seed=3, B=BATCH).items()}


def _step(batch, devices, train_backbone):
    bb, heads = _models()
    bb.requires_grad_(train_backbone)
    if train_backbone:
        recipe = tts.make_finetune_optimizer(1e-3, 1e-4, 10, 2, 1.0)
        trainable = torch.nn.ModuleDict({"heads": heads, "backbone": bb})
    else:
        recipe = tts.make_optimizer(1e-3, 1e-4, 10, 2, 1.0)
        trainable = heads
    step, _ = tts.make_train_step(bb, heads, recipe, batch_kwargs=BATCH_KW,
                                  train_backbone=train_backbone,
                                  devices=[torch.device(d) for d in devices])
    state = tts.init_train_state(trainable, recipe)
    _, metrics = step(state, batch, torch.Generator().manual_seed(11))
    grads = {f"{m}.{n}": p.grad.clone() for m, mod in (("heads", heads), ("backbone", bb))
             for n, p in mod.named_parameters() if p.grad is not None}
    return {k: float(v) for k, v in metrics.items()}, grads


def _loss_misses(got: dict, ref: dict) -> list:
    return [k for k in ref if abs(got[k] - ref[k]) > LOSS_RTOL * abs(ref[k]) + LOSS_ATOL]


@pytest.mark.parametrize("second", ["cpu", "cpu:0"])
@pytest.mark.parametrize("train_backbone", [False, True])
def test_two_slot_step_equals_one_slot(batch, train_backbone, second):
    ref, ref_grads = _step(batch, ["cpu"], train_backbone)
    got, grads = _step(batch, ["cpu", second], train_backbone)
    assert set(got) == set(ref)
    assert not _loss_misses(got, ref), (got, ref)
    assert set(grads) == set(ref_grads)
    assert any(k.startswith("backbone") for k in grads) == train_backbone
    for k, g in ref_grads.items():
        assert (grads[k] - g).abs().max() <= GRAD_TOL * max(float(g.abs().max()), 1e-12), k


def _per_slot_loss(batch, n_slots):
    """DDP's loss: each slot's share through the whole batch function and
    the loss on its own, the components averaged over the slots."""
    bb, heads = _models()
    bb.requires_grad_(False)
    g = torch.Generator().manual_seed(11)
    parts = []
    for i in range(n_slots):
        share = {k: v.chunk(n_slots)[i] for k, v in batch.items()}
        with torch.no_grad():
            out = total_loss(*process_batch(bb, heads, share, g, **BATCH_KW))
        parts.append({"total_loss": float(out.total),
                      **{k: float(v) for k, v in out.components.items()}})
    return {k: float(np.mean([p[k] for p in parts])) for k in parts[0]}


def test_per_slot_loss_misses_the_bound(batch):
    ref, _ = _step(batch, ["cpu"], False)
    wrong = _per_slot_loss(batch, 2)
    missed = _loss_misses(wrong, ref)
    assert "total_loss" in missed and "descriptor_loss" in missed, (wrong, ref)


@pytest.mark.parametrize("devices", [["cpu"] * 3, ["cpu", "cpu:0", "cpu:0"]])
def test_slot_forward_gathers_in_batch_order(devices):
    """Outputs in batch order and the master's gradients, through the
    master module on its own device and through a replica elsewhere (two
    slots sharing it); the replica's frozen parameters are copied once and
    its trainable ones never take a gradient."""
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    net[0].requires_grad_(False)
    x = torch.randn(6, 3)
    fwd = SlotForward(net, [torch.device(d) for d in devices])
    want = copy.deepcopy(net)
    want(x).sum().backward()
    for _ in range(2):
        net.zero_grad(set_to_none=True)
        out = fwd(x)
        torch.testing.assert_close(out, torch.cat([net(s) for s in x.split(2)]), rtol=0, atol=0)
        out.sum().backward()
        torch.testing.assert_close(net[1].weight.grad, want[1].weight.grad)
        assert net[0].weight.grad is None
    replicas = fwd._replicas
    assert (replicas[1] is net) == (devices[1] == "cpu")
    if devices[1] != "cpu":
        assert replicas[1] is replicas[2]
        frozen = replicas[1][0].weight
        assert frozen.data_ptr() != net[0].weight.data_ptr()
        fwd(x)
        assert replicas[1][0].weight is frozen
        assert replicas[1][1].weight.grad is None
    with pytest.raises(ValueError):
        fwd(torch.randn(4, 3))
