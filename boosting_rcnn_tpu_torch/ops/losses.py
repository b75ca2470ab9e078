"""The losses of the flagship, in the mmdet reduction protocol (PyTorch port).

Counterpart of ``boosting_rcnn_tpu/ops/losses.py``, only what the ported
models call: sigmoid focal loss (RPN objectness), IoU loss and MSE (RPN
boxes), binary cross entropy on logits (the ATSS RPN's IoU branch, the
plain RPN's objectness, the mask head), smooth L1 (the plain RPN's boxes),
softmax cross entropy and L1 (R-CNN head).  Every loss goes through ``weight_reduce_loss``:
elementwise loss times an optional weight, then ``mean`` / ``sum`` /
``none``, or the sum divided by an explicit ``avg_factor``.  Each loss
computes in its prediction's dtype, with the target cast to it, until a
float32 weight or normaliser promotes it, as the JAX losses do
(``boosting_rcnn_tpu/ops/losses.py:83``, ``:193``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .box_ops import bbox_overlaps_aligned

__all__ = [
    "weight_reduce_loss",
    "sigmoid_focal_loss",
    "cross_entropy_loss",
    "binary_cross_entropy_loss",
    "l1_loss",
    "smooth_l1_loss",
    "mse_loss",
    "iou_loss",
]


def weight_reduce_loss(loss, weight=None, reduction="mean", avg_factor=None):
    """The mmdet reduction protocol (``losses/utils.py:29``)."""
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        if reduction == "mean":
            return loss.mean()
        if reduction == "sum":
            return loss.sum()
        return loss
    if reduction == "mean":
        return loss.sum() / avg_factor
    if reduction == "none":
        return loss
    raise ValueError('avg_factor can not be used with reduction="sum"')


class _Sigmoid(torch.autograd.Function):
    """``jax.nn.sigmoid`` in the input's dtype, rounded where JAX rounds:
    ``1 / (1 + exp(-x))`` op by op, and the gradient ``g * (p * (1 - p))``
    (the JVP of ``lax.logistic``).  ``torch.sigmoid`` rounds once, which in
    bfloat16 moves about a third of the values by an ulp."""

    @staticmethod
    def forward(ctx, x):
        p = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return g * (p * (1 - p))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic function with JAX's roundings (``_Sigmoid``)."""
    return _Sigmoid.apply(x)


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax`` over the last axis, op by op in ``x``'s dtype
    (the max detached, the exponentials summed in float32 and rounded
    once); ``torch.log_softmax`` rounds once, which in bfloat16 moves about
    a sixth of the values by an ulp."""
    shifted = x - x.max(dim=-1, keepdim=True).values.detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _bce_with_logits(pred, target):
    """Elementwise binary cross entropy on logits, in the stable form
    ``max(x, 0) - x * t + log1p(exp(-|x|))``."""
    return torch.clamp(pred, min=0) - pred * target + torch.log1p(torch.exp(-pred.abs()))


def sigmoid_focal_loss(pred, target, weight=None, gamma: float = 2.0,
                       alpha: float = 0.25, reduction: str = "mean", avg_factor=None):
    """Focal loss on ``(N, C)`` logits against ``(N, C)`` 0/1 targets
    (``py_sigmoid_focal_loss``); an ``(N,)`` weight broadcasts over C."""
    p = sigmoid(pred)
    target = target.to(pred.dtype)
    pt = (1 - p) * target + p * (1 - target)
    focal_weight = (alpha * target + (1 - alpha) * (1 - target)) * pt ** gamma
    loss = _bce_with_logits(pred, target) * focal_weight
    if weight is not None and weight.ndim == 1 and loss.ndim == 2:
        weight = weight[:, None]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def cross_entropy_loss(pred, label, weight=None, reduction: str = "mean",
                       avg_factor=None):
    """Softmax cross entropy of ``(N, C)`` logits against int labels, in
    the logits' dtype.  The label's column is picked with a one-hot product
    (exact: one term is nonzero), whose gradient is elementwise; a
    ``gather``'s is a scatter-add with float atomics on the GPU, which
    differs from run to run."""
    logp = log_softmax(pred)
    loss = -(logp * F.one_hot(label.long(), pred.shape[-1]).to(logp.dtype)).sum(-1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def binary_cross_entropy_loss(pred, target, weight=None, reduction: str = "mean",
                              avg_factor=None):
    """BCE with logits (mmdet ``CrossEntropyLoss(use_sigmoid=True)``)."""
    loss = _bce_with_logits(pred, target.to(pred.dtype))
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def l1_loss(pred, target, weight=None, reduction="mean", avg_factor=None):
    return weight_reduce_loss((pred - target).abs(), weight, reduction, avg_factor)


def smooth_l1_loss(pred, target, weight=None, beta: float = 1.0, reduction="mean",
                   avg_factor=None):
    """``0.5 * d**2 / beta`` where ``d = |pred - target| < beta``, else
    ``d - 0.5 * beta`` (mmdet ``smooth_l1_loss``)."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def mse_loss(pred, target, weight=None, reduction="mean", avg_factor=None):
    return weight_reduce_loss((pred - target) ** 2, weight, reduction, avg_factor)


def iou_loss(pred, target, weight=None, eps=1e-6, reduction="mean", avg_factor=None):
    """``-log(max(iou, eps))`` of aligned ``(N, 4)`` boxes; ``(N, 4)``
    weights are averaged over the last axis, as mmdet does."""
    loss = -torch.log(torch.clamp(bbox_overlaps_aligned(pred, target, eps=eps), min=eps))
    if weight is not None and weight.ndim == loss.ndim + 1:
        weight = weight.mean(dim=-1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)
