"""Train step: learning-rate schedule, optimizer, one SGD step (PyTorch port
of ``boosting_rcnn_tpu/engine/train.py``).

The optimizer is the JAX package's optax chain in the same order: clip the
gradients to a global norm of 35 (none where the config's ``grad_clip`` is
None, as Mask R-CNN's), add the weight decay ``1e-4 * p``, then
SGD with momentum 0.9; the learning rate comes from the schedule at the
step count of the updates done so far.  Here that is optax's
``clip_by_global_norm`` arithmetic over the trainable parameters (the
global norm ``sqrt(sum of squares)``; where it is at least 35 each
gradient becomes ``(g / norm) * 35``, else it is left as it is), then
``torch.optim.SGD(weight_decay, momentum)`` with the group's learning rate
set before each step.  The clip is a device-side select: no host sync.
Frozen parameters (``requires_grad=False``: the frozen backbone stages)
get no gradient and are not in the optimizer, so they never move, as the
JAX package's zeroed updates leave them.

``make_train_step`` returns ``train_step(batch, sample=None, generator=None,
rpn_uniforms=None, roi_uniforms=None) -> metrics``.  Without a ``sample``
it computes the proposals and samples the RoIs inside the step (the JAX
step's ``"fused"`` mode, the only one of a cascade); with one it trains on
that ``RoISample`` (its ``"external"`` mode).  The batch goes to
``detector.loss`` as it is (the mask heads' ``gt_mask_crops`` and HTC's
``gt_semantic_seg`` with it); ``rpn_uniforms`` too, a cascade's per-stage
``roi_uniforms`` and HTC's per-stage ``mask_uniforms`` (Dynamic R-CNN's
``roi_uniforms`` is one ``(B, 2, G + P)`` array).  After the update the
step calls ``detector.update_state()``: Dynamic R-CNN records the step's
statistics in its box head's buffers there, as the JAX step threads its
``batch_stats`` (so the state is in the model's ``state_dict`` and in
every checkpoint).  Metrics carry the JAX names: ``loss``, each loss, and
``grad_norm`` (the norm before clipping).  The step runs on the detector's device, in the detector's
compute dtype; the parameters and their gradients stay float32.

The step is bitwise repeatable on the GPU, as the JAX step is on the TPU:
it pins cuDNN to deterministic algorithms (``cudnn.deterministic`` on,
``cudnn.benchmark`` off) for its own duration, and the port's train path
uses no other nondeterministic op (its gathers with a gradient are one-hot
products or, in the deformable convolution, advanced indexing, whose
gradient sums in sorted order; the RoIAlign gradient adds in a fixed
order).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["step_lr_schedule", "Optimizer", "make_optimizer", "deterministic_cudnn",
           "live_norms", "make_train_step"]


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
                 grad_clip_norm: Optional[float] = 35.0):
        self.params = [p for p in params if p.requires_grad]
        self.lr_schedule = lr_schedule
        self.grad_clip_norm = grad_clip_norm
        self.step_count = 0
        self.sgd = torch.optim.SGD(self.params, lr=lr_schedule(0), momentum=momentum,
                                   weight_decay=weight_decay)

    def state_dict(self) -> dict:
        """The step count and the SGD state (its momentum buffers)."""
        return {"step_count": self.step_count, "sgd": self.sgd.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step_count = int(state["step_count"])
        self.sgd.load_state_dict(state["sgd"])

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip, update, count.  Returns the gradient norm before the clip.
        A trainable parameter without a gradient gets a zero one, so that
        weight decay and momentum move it as optax would."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))  # leaf by leaf, as optax
        if self.grad_clip_norm is not None:
            clip = norm >= self.grad_clip_norm
            # (g / norm) * max_norm where the clip acts, (g / 1) * 1 == g elsewhere
            torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
            torch._foreach_mul_(grads, torch.where(clip, self.grad_clip_norm, 1.0))
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
    grad_clip_norm: Optional[float] = 35.0,
) -> Optimizer:
    """SGD with momentum, L2 weight decay and a global-norm clip (the
    reference's ``optimizer_config``: ``grad_clip`` max_norm 35; None
    clips nothing), over the parameters that require a gradient."""
    return Optimizer(params, lr_schedule, momentum, weight_decay, grad_clip_norm)


@contextlib.contextmanager
def deterministic_cudnn(on: bool = True):
    """cuDNN pinned to deterministic algorithms (and no autotuning) inside
    the block when ``on``; the previous settings after it."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    if on:
        cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


@contextlib.contextmanager
def live_norms(net: torch.nn.Module):
    """``net`` in ``train()`` mode inside the block (its ``LiveBatchNorm``
    layers on batch statistics, moving their running averages), back in
    ``eval()`` mode after it."""
    net.train()
    try:
        yield
    finally:
        net.eval()


def make_train_step(
    detector,
    anchors: torch.Tensor,
    num_level_anchors: Sequence[int],
    optimizer: Optimizer,
    deterministic: bool = True,
):
    """The train step of ``detector`` with ``optimizer``:
    ``train_step(batch, sample=None, generator=None)`` trains on ``sample``
    (a ``RoISample`` from ``detector.train_sample``) when one is given, else
    computes proposals and samples RoIs inside, with ``generator`` driving
    the samplers; ``rpn_uniforms`` rank the plain RPN's anchors instead
    (``detector.loss``), a cascade's ``roi_uniforms`` its stages'
    samplers and HTC's ``mask_uniforms`` its stages' mask samplers.  Each
    step runs under
    ``deterministic_cudnn(deterministic)``: the pin is on unless the caller
    turns it off (to time its cost)."""

    @deterministic_cudnn(deterministic)
    def train_step(batch, sample=None, generator: Optional[torch.Generator] = None,
                   rpn_uniforms=None, roi_uniforms=None, mask_uniforms=None):
        optimizer.zero_grad()
        kw = {k: v for k, v in (("roi_uniforms", roi_uniforms),
                                ("mask_uniforms", mask_uniforms)) if v is not None}
        with live_norms(detector.net):
            losses = detector.loss(batch, anchors, num_level_anchors, generator=generator,
                                   sample=sample, rpn_uniforms=rpn_uniforms, **kw)
        total = sum(v.sum() for v in losses.values())
        total.backward()
        grad_norm = optimizer.step()
        detector.update_state()
        metrics = {"loss": total.detach(), **{k: v.detach().sum() for k, v in losses.items()}}
        metrics["grad_norm"] = grad_norm.detach()
        return metrics

    return train_step
