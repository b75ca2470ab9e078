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

``opt_type="adamw"`` (the Swin configs' ``optimizer=dict(type="adamw")``,
JAX ``make_optimizer(opt_type="adamw")``) replaces the weight decay and SGD
by optax's ``adamw``: b1 0.9, b2 0.999, eps 1e-8 outside the square root,
the bias-corrected moments, then the decoupled decay ``weight_decay * p``
added to every trainable parameter's update (no mask), then the update
times ``-lr``; its arithmetic is optax's, op by op, over ``torch._foreach``
lists (float32 scalars as optax casts them), and its moments and count are
in ``state_dict()``.

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

Under data-parallel training (``parallel/mesh.py``) each rank runs the
step on its slice of the global batch: the loss's batch normalisers are
the global ones, the gradients are averaged over the ranks before the
clip (one all-reduce over a flat buffer), so the clip sees the global
gradient as the JAX step's does, and the metrics are the ranks' means
(the global batch's losses).

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

from ..parallel.mesh import average_gradients, reduce_metrics

__all__ = ["step_lr_schedule", "AdamW", "Optimizer", "make_optimizer", "aux_parameters",
           "deterministic_cudnn", "live_norms", "make_train_step"]


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


AUX_LR = 1e-3  # the DG classifiers' Adam (JAX engine/train.py:151-166)
AUX_CLIP = 0.1
AUX_HEADS = ("domain_head", "jig_head")


def _sq_norm(grads) -> torch.Tensor:
    return sum(torch.sum(g * g) for g in grads)  # leaf by leaf, as optax


def _clip_(grads, norm: torch.Tensor, max_norm: float) -> None:
    """optax ``clip_by_global_norm``: ``(g / norm) * max_norm`` where
    ``norm >= max_norm``, ``(g / 1) * 1 == g`` elsewhere; no host sync."""
    clip = norm >= max_norm
    torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
    torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0))


def aux_parameters(net: torch.nn.Module):
    """The parameters of the DG detectors' classifiers (``domain_head``,
    ``jig_head``), which train in the optimizer's auxiliary group."""
    return [p for name in AUX_HEADS if getattr(net, name, None) is not None
            for p in getattr(net, name).parameters()]


OPT_TYPES = ("sgd", "adamw")
ADAMW_B1, ADAMW_B2, ADAMW_EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults


class AdamW:
    """optax ``adamw(lr, b1, b2, eps, eps_root=0, weight_decay)`` on
    ``params``: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
    ``u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p`` (the
    bias corrections in float32), ``p += -lr * u``."""

    def __init__(self, params: Sequence[torch.nn.Parameter], weight_decay: float):
        self.params, self.weight_decay = list(params), weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.mu = [t.to(p.device).clone() for t, p in zip(state["mu"], self.params)]
        self.nu = [t.to(p.device).clone() for t, p in zip(state["nu"], self.params)]

    @torch.no_grad()
    def step(self, lr: float) -> None:
        grads = [p.grad for p in self.params]
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(ADAMW_B1) ** f32(self.count))
        bc2 = float(f32(1) - f32(ADAMW_B2) ** f32(self.count))
        mu = torch._foreach_mul(grads, 1 - ADAMW_B1)
        torch._foreach_add_(mu, torch._foreach_mul(self.mu, ADAMW_B1))
        nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - ADAMW_B2)
        torch._foreach_add_(nu, torch._foreach_mul(self.nu, ADAMW_B2))
        self.mu, self.nu = mu, nu
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, ADAMW_EPS)
        update = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_add_(update, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(self.params, update)


class Optimizer:
    """Global-norm clip, then SGD with weight decay and momentum (or, with
    ``opt_type="adamw"``, ``AdamW``), with the learning rate from
    ``lr_schedule(step)``.  ``aux_params`` (the DG
    classifiers', ``aux_parameters``) form a group of their own, as the JAX
    package's ``optax.multi_transform`` routes them: a global-norm clip at
    0.1 over their gradients alone, then Adam at 1e-3 without weight decay;
    the main clip, weight decay and SGD see only the other parameters."""

    def __init__(self, params: Sequence[torch.nn.Parameter], lr_schedule: Callable[[int], float],
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 grad_clip_norm: Optional[float] = 35.0,
                 aux_params: Sequence[torch.nn.Parameter] = (), opt_type: str = "sgd"):
        if opt_type not in OPT_TYPES:
            raise NotImplementedError(f"optimizer type {opt_type!r} is not ported "
                                      f"(the port takes {', '.join(OPT_TYPES)})")
        self.aux_params = [p for p in aux_params if p.requires_grad]
        aux = {id(p) for p in self.aux_params}
        self.params = [p for p in params if p.requires_grad and id(p) not in aux]
        self.lr_schedule = lr_schedule
        self.grad_clip_norm = grad_clip_norm
        self.opt_type = opt_type
        self.step_count = 0
        self.sgd = self.adamw = None
        if opt_type == "adamw":
            self.adamw = AdamW(self.params, weight_decay)
        else:
            self.sgd = torch.optim.SGD(self.params, lr=lr_schedule(0), momentum=momentum,
                                       weight_decay=weight_decay)
        self.adam = torch.optim.Adam(self.aux_params, lr=AUX_LR) if self.aux_params else None

    def state_dict(self) -> dict:
        """The step count and the SGD state (its momentum buffers) or the
        AdamW moments, and the auxiliary group's Adam state where there is
        one."""
        state = {"step_count": self.step_count}
        if self.sgd is not None:
            state["sgd"] = self.sgd.state_dict()
        else:
            state["adamw"] = self.adamw.state_dict()
        if self.adam is not None:
            state["adam"] = self.adam.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        self.step_count = int(state["step_count"])
        if self.sgd is not None:
            self.sgd.load_state_dict(state["sgd"])
        else:
            self.adamw.load_state_dict(state["adamw"])
        if self.adam is not None:
            self.adam.load_state_dict(state["adam"])

    def zero_grad(self) -> None:
        for p in self.params + self.aux_params:
            p.grad = None

    def step(self) -> torch.Tensor:
        """Clip, update, count.  Returns the gradient norm before the clip,
        over every trainable parameter's gradient (the auxiliary group's
        too).  A trainable parameter without a gradient gets a zero one, so
        that weight decay and momentum move it as optax would."""
        for p in self.params + self.aux_params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        sq = _sq_norm(grads)
        norm = torch.sqrt(sq)
        if self.grad_clip_norm is not None:
            _clip_(grads, norm, self.grad_clip_norm)
        lr = self.lr_schedule(self.step_count)
        if self.sgd is not None:
            for group in self.sgd.param_groups:
                group["lr"] = lr
            self.sgd.step()
        else:
            self.adamw.step(lr)
        if self.adam is not None:
            aux_grads = [p.grad for p in self.aux_params]
            aux_sq = _sq_norm(aux_grads)
            _clip_(aux_grads, torch.sqrt(aux_sq), AUX_CLIP)
            self.adam.step()
            norm = torch.sqrt(sq + aux_sq)
        self.step_count += 1
        return norm


def make_optimizer(
    params: Sequence[torch.nn.Parameter],
    lr_schedule: Callable[[int], float],
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    grad_clip_norm: Optional[float] = 35.0,
    aux_params: Sequence[torch.nn.Parameter] = (),
    opt_type: str = "sgd",
) -> Optimizer:
    """SGD with momentum and L2 weight decay, or AdamW (``opt_type``), and
    a global-norm clip (the reference's ``optimizer_config``: ``grad_clip``
    max_norm 35; None clips nothing), over the parameters that require a
    gradient but ``aux_params``, which train in the auxiliary group
    (``Optimizer``)."""
    return Optimizer(params, lr_schedule, momentum, weight_decay, grad_clip_norm, aux_params,
                     opt_type)


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
    samplers, HTC's ``mask_uniforms`` its stages' mask samplers and
    PointRend's ``point_uniforms`` its training points.  Each
    step runs under
    ``deterministic_cudnn(deterministic)``: the pin is on unless the caller
    turns it off (to time its cost)."""

    @deterministic_cudnn(deterministic)
    def train_step(batch, sample=None, generator: Optional[torch.Generator] = None,
                   rpn_uniforms=None, roi_uniforms=None, mask_uniforms=None,
                   point_uniforms=None):
        optimizer.zero_grad()
        kw = {k: v for k, v in (("roi_uniforms", roi_uniforms),
                                ("mask_uniforms", mask_uniforms),
                                ("point_uniforms", point_uniforms)) if v is not None}
        with live_norms(detector.net):
            losses = detector.loss(batch, anchors, num_level_anchors, generator=generator,
                                   sample=sample, rpn_uniforms=rpn_uniforms, **kw)
        total = sum(v.sum() for v in losses.values())
        total.backward()
        average_gradients(optimizer.params + optimizer.aux_params)  # before the clip
        grad_norm = optimizer.step()
        detector.update_state()
        metrics = {"loss": total.detach(), **{k: v.detach().sum() for k, v in losses.items()}}
        metrics["grad_norm"] = grad_norm.detach()
        return reduce_metrics(metrics)

    return train_step
