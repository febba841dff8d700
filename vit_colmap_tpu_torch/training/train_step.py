"""The training step: gradients of the heads (and, when fine-tuning, of
the backbone), clipped and applied by AdamW on a warmup-cosine schedule.

Counterpart of ``vit_colmap_tpu/training/train_step.py``, with optax's
semantics held by hand:

* **clip**: ``optax.clip_by_global_norm`` -- every gradient scaled by
  ``max_norm / norm`` when the global norm is not below ``max_norm``, left
  as it is otherwise (``torch.nn.utils.clip_grad_norm_`` divides by
  ``norm + 1e-6`` instead);
* **schedule**: ``optax.warmup_cosine_decay_schedule`` from ``lr * 0.1``
  at step 0 to ``lr`` at ``warmup_steps``, then cosine to ``lr / 100`` at
  ``total_steps``; step ``k`` of the optimizer takes the value at ``k``;
* **AdamW**: ``torch.optim.AdamW`` at optax's defaults (b1 0.9, b2 0.999,
  eps 1e-8) with the decoupled decay on every parameter;
* **fine-tuning**: two parameter groups, the heads at ``lr`` and the
  backbone at ``lr * backbone_lr_scale`` (each its own schedule: the
  schedule is proportional to its peak), under one global-norm clip.

Data parallelism (``devices``): the forward passes of the backbone and
the heads run over the slots (``training/data_parallel.SlotForward``) and
the rest of the step over the global batch on the first slot, so the loss
is the one-device loss.

Modules hold the parameters: :func:`make_optimizer` returns a recipe whose
``init`` builds the optimizer over a module, as an optax transformation's
``init`` builds its state over a pytree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from vit_colmap_tpu_torch.dataloader.training_batch import process_batch
from vit_colmap_tpu_torch.losses.feature_losses import total_loss
from vit_colmap_tpu_torch.training.data_parallel import SlotForward


def warmup_cosine_decay(step: int, init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float) -> float:
    """``optax.warmup_cosine_decay_schedule`` at ``step``."""
    if step < warmup_steps:  # optax's linear schedule, in its form
        return (init_value - peak_value) * (1.0 - step / warmup_steps) + peak_value
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    t = min(step - warmup_steps, decay_steps - warmup_steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / (decay_steps - warmup_steps)))
    return peak_value * ((1.0 - alpha) * cosine + alpha)


@dataclass(frozen=True)
class OptimizerRecipe:
    """AdamW + warmup-cosine + global-norm clip; ``backbone_lr_scale`` set
    means the fine-tuning pair of groups."""

    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    total_steps: int = 10000
    warmup_steps: int = 100
    grad_clip: float = 1.0
    backbone_lr_scale: Optional[float] = None

    def lr_factor(self, step: int) -> float:
        """The schedule at ``step`` over its peak (every group's factor)."""
        return warmup_cosine_decay(step, 0.1, 1.0, self.warmup_steps,
                                   max(self.total_steps, self.warmup_steps + 1), 0.01)

    def init(self, trainable: nn.Module):
        """(AdamW, its LambdaLR) over ``trainable``: the heads module, or
        for fine-tuning a module with ``heads`` and ``backbone``."""
        if self.backbone_lr_scale is None:
            groups = [{"params": list(trainable.parameters()), "lr": self.learning_rate}]
        else:
            groups = [
                {"params": list(trainable.heads.parameters()), "lr": self.learning_rate},
                {"params": list(trainable.backbone.parameters()),
                 "lr": self.learning_rate * self.backbone_lr_scale},
            ]
        opt = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.weight_decay)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, self.lr_factor)


def make_optimizer(
    learning_rate: float = 1e-4,
    weight_decay: float = 1e-4,
    total_steps: int = 10000,
    warmup_steps: int = 100,
    grad_clip: float = 1.0,
) -> OptimizerRecipe:
    """AdamW + cosine decay to lr/100 + global-norm clip 1.0."""
    return OptimizerRecipe(learning_rate, weight_decay, total_steps, warmup_steps, grad_clip)


def make_finetune_optimizer(
    learning_rate: float = 1e-4,
    weight_decay: float = 1e-4,
    total_steps: int = 10000,
    warmup_steps: int = 100,
    grad_clip: float = 1.0,
    backbone_lr_scale: float = 0.1,
) -> OptimizerRecipe:
    """The heads at full rate and the backbone at ``backbone_lr_scale``
    times it, one global-norm clip over both."""
    return OptimizerRecipe(learning_rate, weight_decay, total_steps, warmup_steps, grad_clip,
                           backbone_lr_scale)


@dataclass
class TrainState:
    """The step count, the trainable module (the heads, or ``heads`` and
    ``backbone`` when fine-tuning), its optimizer and schedule."""

    step: int
    heads_params: nn.Module
    opt_state: torch.optim.Optimizer
    schedule: torch.optim.lr_scheduler.LambdaLR

    def state_dict(self) -> dict:
        return {"step": self.step, "optimizer": self.opt_state.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Step and optimizer state of a checkpoint; the schedule resumes at
        the step."""
        self.step = int(state["step"])
        self.opt_state.load_state_dict(state["optimizer"])
        self.schedule.last_epoch = self.step
        for group, base in zip(self.opt_state.param_groups, self.schedule.base_lrs):
            group["lr"] = base * self.schedule.lr_lambdas[0](self.step)


def init_train_state(heads_params: nn.Module, optimizer: OptimizerRecipe) -> TrainState:
    opt, schedule = optimizer.init(heads_params)
    return TrainState(0, heads_params, opt, schedule)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's clip in place: every gradient divided by the global norm and
    multiplied by max_norm when the norm is not below max_norm (no host
    sync: below it, both factors are 1).  Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm


def make_train_step(
    backbone: nn.Module,
    heads: nn.Module,
    optimizer: OptimizerRecipe,
    loss_kwargs: Optional[dict] = None,
    batch_kwargs: Optional[dict] = None,
    train_backbone: bool = False,
    devices=None,
):
    """(step, eval_step): ``step(state, batch, generator) -> (state,
    metrics)`` and ``eval_step(state, batch, generator) -> metrics``, the
    metrics detached tensors (the total loss and every component).  With
    ``train_backbone`` the dense token loss joins the total with weight
    ``loss_kwargs["lambda_token"]`` (default 1).  ``devices``: the data
    slots their forward passes are split over, the batch's device first,
    where ``backbone`` and ``heads`` live (default: that device alone)."""
    devices = list(devices or [next(heads.parameters()).device])
    backbone, heads = SlotForward(backbone, devices), SlotForward(heads, devices)
    loss_kwargs = dict(loss_kwargs or {})
    batch_kwargs = dict(batch_kwargs or {})
    lambda_token = loss_kwargs.pop("lambda_token", 1.0)

    def loss_fn(batch, generator):
        outputs, targets = process_batch(backbone, heads, batch, generator,
                                         train_backbone=train_backbone, **batch_kwargs)
        token_loss = outputs.pop("token_loss", None)
        token_pos_sim = outputs.pop("token_pos_sim", None)
        out = total_loss(outputs, targets, **loss_kwargs)
        total = out.total
        components = dict(out.components)
        if token_loss is not None:
            total = total + lambda_token * token_loss
            components["token_loss"] = token_loss
            components["token_pos_sim"] = token_pos_sim
        return total, components

    def metrics_of(loss, components):
        return {"total_loss": loss.detach(), **{k: v.detach() for k, v in components.items()}}

    def step(state: TrainState, batch, generator):
        state.opt_state.zero_grad(set_to_none=True)
        loss, components = loss_fn(batch, generator)
        loss.backward()
        params = [p for g in state.opt_state.param_groups for p in g["params"]]
        clip_by_global_norm_(params, optimizer.grad_clip)
        state.opt_state.step()
        state.schedule.step()
        state.step += 1
        return state, metrics_of(loss, components)

    @torch.no_grad()
    def eval_step(state: TrainState, batch, generator):
        return metrics_of(*loss_fn(batch, generator))

    return step, eval_step
