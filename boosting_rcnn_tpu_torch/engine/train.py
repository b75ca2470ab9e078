"""Train step: learning-rate schedule, optimizer, one SGD step (PyTorch port
of ``boosting_rcnn_tpu/engine/train.py``).

The optimizer is the JAX package's optax chain in the same order: clip the
gradients to a global norm of 35, add the weight decay ``1e-4 * p``, then
SGD with momentum 0.9; the learning rate comes from the schedule at the
step count of the updates done so far.  Here that is ``clip_grad_norm_``
over the trainable parameters, then ``torch.optim.SGD(weight_decay,
momentum)`` with the group's learning rate set before each step: the same
arithmetic, except that ``clip_grad_norm_`` scales by ``35 / (norm +
1e-6)`` where optax divides by the norm alone, a relative difference of
``1e-6 / norm`` in the clipped gradients (below 3e-8 whenever the clip
acts).  Frozen parameters (``requires_grad=False``: the frozen backbone
stages) get no gradient and are not in the optimizer, so they never move,
as the JAX package's zeroed updates leave them.

``make_train_step`` returns ``train_step(batch, sample=None, generator=None)
-> metrics``.  Without a ``sample`` it computes the proposals and samples
the RoIs inside the step (the JAX step's ``"fused"`` mode); with one it
trains on that ``RoISample`` (its ``"external"`` mode).  Metrics carry the
JAX names: ``loss``, each loss, and ``grad_norm`` (the norm before
clipping).  The step runs on the detector's device.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["step_lr_schedule", "Optimizer", "make_optimizer", "make_train_step"]


def step_lr_schedule(
    base_lr: float,
    steps_per_epoch: int,
    decay_epochs: Sequence[int] = (8, 11),
    gamma: float = 0.1,
    warmup_iters: int = 500,
    warmup_ratio: float = 0.001,
) -> Callable[[int], float]:
    """Linear warmup, then step decay at epoch boundaries (``lr_config``
    of schedule_1x).  Evaluated in float32, as the JAX schedule is."""
    f32 = np.float32

    def sched(step: int) -> float:
        s = f32(step)
        epoch = s / f32(steps_per_epoch)
        decay = f32(1.0)
        for e in decay_epochs:
            decay = decay * (f32(gamma) if epoch >= e else f32(1.0))
        warm_frac = min(s / f32(max(warmup_iters, 1)), f32(1.0))
        warm = f32(warmup_ratio) + (f32(1.0) - f32(warmup_ratio)) * warm_frac
        return float(f32(base_lr) * decay * warm)

    return sched


class Optimizer:
    """Global-norm clip, then SGD with weight decay and momentum, with the
    learning rate from ``lr_schedule(step)``."""

    def __init__(self, params: Sequence[torch.nn.Parameter], lr_schedule: Callable[[int], float],
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 grad_clip_norm: float = 35.0):
        self.params = [p for p in params if p.requires_grad]
        self.lr_schedule = lr_schedule
        self.grad_clip_norm = grad_clip_norm
        self.step_count = 0
        self.sgd = torch.optim.SGD(self.params, lr=lr_schedule(0), momentum=momentum,
                                   weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, update, count.  Returns the gradient norm before the clip.
        A trainable parameter without a gradient gets a zero one, so that
        weight decay and momentum move it as optax would."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = torch.nn.utils.clip_grad_norm_(self.params, self.grad_clip_norm)
        lr = self.lr_schedule(self.step_count)
        for group in self.sgd.param_groups:
            group["lr"] = lr
        self.sgd.step()
        self.step_count += 1
        return norm


def make_optimizer(
    params: Sequence[torch.nn.Parameter],
    lr_schedule: Callable[[int], float],
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    grad_clip_norm: float = 35.0,
) -> Optimizer:
    """SGD with momentum, L2 weight decay and a global-norm clip (the
    reference's ``optimizer_config``: ``grad_clip`` max_norm 35), over the
    parameters that require a gradient."""
    return Optimizer(params, lr_schedule, momentum, weight_decay, grad_clip_norm)


def make_train_step(
    detector,
    anchors: torch.Tensor,
    num_level_anchors: Sequence[int],
    optimizer: Optimizer,
):
    """The train step of ``detector`` with ``optimizer``:
    ``train_step(batch, sample=None, generator=None)`` trains on ``sample``
    (a ``RoISample`` from ``detector.train_sample``) when one is given, else
    computes proposals and samples RoIs inside, with ``generator`` driving
    the sampler."""

    def train_step(batch, sample=None, generator: Optional[torch.Generator] = None):
        optimizer.zero_grad()
        losses = detector.loss(batch, anchors, num_level_anchors, generator=generator,
                               sample=sample)
        total = sum(v.sum() for v in losses.values())
        total.backward()
        grad_norm = optimizer.step()
        metrics = {"loss": total.detach(), **{k: v.detach().sum() for k, v in losses.items()}}
        metrics["grad_norm"] = grad_norm.detach()
        return metrics

    return train_step
