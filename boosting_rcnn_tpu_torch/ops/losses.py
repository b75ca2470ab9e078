"""The losses of the flagship, in the mmdet reduction protocol (PyTorch port).

Counterpart of ``boosting_rcnn_tpu/ops/losses.py``, only what the ported
models call: sigmoid focal and varifocal losses (RPN objectness), the IoU
family (IoU, GIoU, DIoU, CIoU, EIoU, Focal-EIoU; the ATSS RPN's boxes and
the R-CNN head's decoded boxes), the bounded IoU loss (the R-CNN head's
decoded boxes, elementwise ``(N, 4)``) and MSE (RPN boxes, the MaskIoU
head), binary cross entropy on logits (the ATSS RPN's IoU branch, the
plain RPN's objectness, the mask head), smooth L1 (the plain RPN's boxes),
softmax cross entropy, the Seesaw loss and L1 (R-CNN head).  Every loss goes through ``weight_reduce_loss``:
elementwise loss times an optional weight, then ``mean`` / ``sum`` /
``none``, or the sum divided by an explicit ``avg_factor``.  Each loss
computes in its prediction's dtype, with the target cast to it, until a
float32 weight or normaliser promotes it, as the JAX losses do
(``boosting_rcnn_tpu/ops/losses.py:83``, ``:193``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

import math

from .box_ops import bbox_center_wh, bbox_overlaps_aligned

__all__ = [
    "weight_reduce_loss",
    "sigmoid_focal_loss",
    "cross_entropy_loss",
    "binary_cross_entropy_loss",
    "l1_loss",
    "smooth_l1_loss",
    "mse_loss",
    "iou_loss",
    "giou_loss",
    "diou_loss",
    "ciou_loss",
    "eiou_loss",
    "focal_eiou_loss",
    "bounded_iou_loss",
    "varifocal_loss",
    "seesaw_loss",
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


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis in ``x``'s dtype: the
    exponentials of ``x`` less its (detached) max, over their sum taken in
    float32 and rounded once."""
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values.detach())
    return e / e.float().sum(dim=-1, keepdim=True).to(x.dtype)


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


def varifocal_loss(pred, target, weight=None, alpha: float = 0.75, gamma: float = 2.0,
                   iou_weighted: bool = True, reduction: str = "mean", avg_factor=None):
    """Varifocal loss (JAX ``varifocal_loss``, mmdet ``varifocal_loss.py``)
    on ``(N, C)`` logits against soft IoU targets, 0 off the gt class: the
    binary cross entropy weighted by the target where it is positive
    (1 without ``iou_weighted``) and by ``alpha * |p - t|**gamma``
    elsewhere, the weight not detached; an ``(N,)`` weight broadcasts over
    C."""
    p = sigmoid(pred)
    target = target.to(pred.dtype)
    pos = (target > 0.0).to(pred.dtype)
    neg = alpha * (p - target).abs() ** gamma * (target <= 0.0).to(pred.dtype)
    focal_weight = (target * pos if iou_weighted else pos) + neg
    loss = _bce_with_logits(pred, target) * focal_weight
    if weight is not None and weight.ndim == 1 and loss.ndim == 2:
        weight = weight[:, None]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def _one_hot(labels: torch.Tensor, c: int, dtype) -> torch.Tensor:
    return F.one_hot(labels.long(), c).to(dtype)


def seesaw_loss(pred, labels, cum_counts, weight=None, p: float = 0.8, q: float = 2.0,
                eps: float = 1e-2, reduction: str = "mean", avg_factor=None):
    """The Seesaw loss (JAX ``seesaw_loss``, reference ``seesaw_loss.py``)
    of ``(N, C)`` logits against int labels with the classes' cumulative
    counts ``(C,)``: each negative logit ``j`` of a sample of class ``i``
    gets the weight ``(N_j / N_i)**p`` where class ``j`` is rarer
    (mitigation) times ``(p_j / max(p_i, eps))**q`` where ``p_j > p_i``
    (compensation), added as ``log`` of the weight before the softmax cross
    entropy.  Everything in the logits' dtype, the counts (at least 1)
    cast to it; the compensation's probabilities are not detached (the
    JAX package's; mmdet detaches them).  The label's columns are picked
    with one-hot products, whose gradient is elementwise."""
    c = pred.shape[-1]
    onehot = _one_hot(labels, c, pred.dtype)
    counts = torch.clamp(cum_counts.to(pred.dtype), min=1.0)
    ratio = counts[None, :] / counts[:, None]  # (C, C): N_j / N_i
    mitigation = torch.where(ratio < 1.0, ratio ** p, torch.ones_like(ratio))
    m = mitigation[labels.long()]  # (N, C); the counts carry no gradient
    probs = softmax(pred)
    p_at = (probs * onehot).sum(-1, keepdim=True)
    comp = torch.where(probs > p_at, (probs / torch.clamp(p_at, min=eps)) ** q,
                       torch.ones_like(probs))
    sw = torch.where(onehot > 0, torch.ones_like(probs), m * comp)
    logp = log_softmax(pred + torch.log(torch.clamp(sw, min=1e-12)))
    loss = -(logp * onehot).sum(-1)
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


def giou_loss(pred, target, weight=None, eps=1e-7, reduction="mean", avg_factor=None):
    """``1 - giou`` of aligned ``(N, 4)`` boxes (JAX ``giou_loss``, eps
    1e-7); ``(N, 4)`` weights are averaged over the last axis."""
    loss = 1.0 - bbox_overlaps_aligned(pred, target, eps=eps, mode="giou")
    if weight is not None and weight.ndim == loss.ndim + 1:
        weight = weight.mean(dim=-1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def _diou_term(pred, target, eps):
    """The IoU, the DIoU distance term (squared centre distance over the
    squared diagonal of the enclosing box, ``+ eps``) and the widths and
    heights of both (JAX ``losses.py:272-281``)."""
    ious = bbox_overlaps_aligned(pred, target, eps=eps)
    px, py, pw, ph = bbox_center_wh(pred)
    tx, ty, tw, th = bbox_center_wh(target)
    center_dist = (px - tx) ** 2 + (py - ty) ** 2
    enc_lt = torch.minimum(pred[..., :2], target[..., :2])
    enc_rb = torch.maximum(pred[..., 2:], target[..., 2:])
    enc_wh = torch.clamp(enc_rb - enc_lt, min=0.0)
    diag = enc_wh[..., 0] ** 2 + enc_wh[..., 1] ** 2 + eps
    return ious, center_dist / diag, (pw, ph, tw, th)


def ciou_loss(pred, target, weight=None, eps=1e-7, reduction="mean", avg_factor=None):
    """CIoU loss ``1 - iou + dist + alpha * v`` of aligned ``(N, 4)`` boxes,
    ``v = 4 / pi**2 * (atan(tw / (th + eps)) - atan(pw / (ph + eps)))**2``
    with ``alpha = v / (1 - iou + v + eps)`` detached (JAX ``ciou_loss``,
    its ``stop_gradient``).  Widths and heights are not clamped: the
    encoded-delta RPN feeds it deltas read as boxes.  ``(N, 4)`` weights
    are averaged over the last axis."""
    ious, dist_term, (pw, ph, tw, th) = _diou_term(pred, target, eps)
    v = (4.0 / math.pi ** 2) * (torch.atan(tw / (th + eps)) - torch.atan(pw / (ph + eps))) ** 2
    alpha = (v / (1.0 - ious + v + eps)).detach()
    loss = 1.0 - ious + dist_term + alpha * v
    if weight is not None and weight.ndim == loss.ndim + 1:
        weight = weight.mean(dim=-1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def diou_loss(pred, target, weight=None, eps=1e-7, reduction="mean", avg_factor=None):
    """DIoU loss ``1 - iou + dist`` of aligned ``(N, 4)`` boxes (JAX
    ``diou_loss``); ``(N, 4)`` weights are averaged over the last axis."""
    ious, dist_term, _ = _diou_term(pred, target, eps)
    loss = 1.0 - ious + dist_term
    if weight is not None and weight.ndim == loss.ndim + 1:
        weight = weight.mean(dim=-1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def _max0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)`` with its gradient: half of it at ``x == 0``
    (``torch.clamp`` passes all of it there)."""
    return torch.maximum(x, torch.zeros_like(x))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs`` with its gradient: +1 at 0 (``torch.abs``'s is 0)."""
    return torch.where(x >= 0, x, -x)


def _eiou_terms(pred, target, eps):
    """The detached IoU and the EIoU loss ``1 - iou + rho^2 / c^2 +
    rho_w^2 / c_w^2 + rho_h^2 / c_h^2`` (JAX ``_eiou_terms``, the fork's
    ``iou_loss.py:300-344``): the enclosing box's sides ``+ eps``, the
    widths' and heights' gaps ``+ eps``."""
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = _max0(rb - lt)
    overlap = wh[..., 0] * wh[..., 1]
    ap = (pred[..., 2] - pred[..., 0]) * (pred[..., 3] - pred[..., 1])
    ag = (target[..., 2] - target[..., 0]) * (target[..., 3] - target[..., 1])
    ious = (overlap / (ap + ag - overlap + eps)).detach()
    e_lt = torch.minimum(pred[..., :2], target[..., :2])
    e_rb = torch.maximum(pred[..., 2:], target[..., 2:])
    e_wh = _max0(e_rb - e_lt)
    cw = e_wh[..., 0] + eps
    ch = e_wh[..., 1] + eps
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (((target[..., 0] + target[..., 2]) - (pred[..., 0] + pred[..., 2])) ** 2
            + ((target[..., 1] + target[..., 3]) - (pred[..., 1] + pred[..., 3])) ** 2) / 4.0
    w1, h1 = pred[..., 2] - pred[..., 0], pred[..., 3] - pred[..., 1]
    w2, h2 = target[..., 2] - target[..., 0], target[..., 3] - target[..., 1]
    rhow = (_abs(w2 - w1) + eps) ** 2
    rhoh = (_abs(h2 - h1) + eps) ** 2
    return ious, 1.0 - ious + rho2 / c2 + rhow / cw ** 2 + rhoh / ch ** 2


def eiou_loss(pred, target, weight=None, eps=1e-7, reduction="mean", avg_factor=None):
    """EIoU loss of aligned ``(N, 4)`` boxes (JAX ``eiou_loss``);
    ``(N, 4)`` weights are averaged over the last axis."""
    _, loss = _eiou_terms(pred, target, eps)
    if weight is not None and weight.ndim == loss.ndim + 1:
        weight = weight.mean(dim=-1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def focal_eiou_loss(pred, target, weight=None, gamma=0.5, eps=1e-7, reduction="mean",
                    avg_factor=None):
    """Focal-EIoU: the EIoU loss times the detached ``iou**gamma`` (JAX
    ``focal_eiou_loss``); ``(N, 4)`` weights are averaged over the last
    axis."""
    ious, base = _eiou_terms(pred, target, eps)
    loss = base * ious ** gamma
    if weight is not None and weight.ndim == loss.ndim + 1:
        weight = weight.mean(dim=-1)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def bounded_iou_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 0.2,
                     eps: float = 1e-3) -> torch.Tensor:
    """The bounded IoU loss of ``(N, 4)`` boxes, elementwise ``(N, 4)``
    (JAX ``guided_anchor_head.py::bounded_iou_loss``, reference
    ``iou_loss.py::bounded_iou_loss``): per centre coordinate ``1 -
    max((t_w - 2|d|) / (t_w + 2|d| + eps), 0)``, per side ``1 - min(t / (p
    + eps), p / (t + eps))``, each smooth-L1'd at ``beta``; the target
    detached.  The JAX package fixes ``beta`` 0.2 and ``eps`` 1e-3.  Its
    ties take JAX's gradients (``_max0``, ``_abs``)."""
    pcx, pcy = (pred[:, 0] + pred[:, 2]) * 0.5, (pred[:, 1] + pred[:, 3]) * 0.5
    pw, ph = pred[:, 2] - pred[:, 0], pred[:, 3] - pred[:, 1]
    t = target.detach()
    tcx, tcy = (t[:, 0] + t[:, 2]) * 0.5, (t[:, 1] + t[:, 3]) * 0.5
    tw, th = t[:, 2] - t[:, 0], t[:, 3] - t[:, 1]
    dx, dy = tcx - pcx, tcy - pcy
    lx = 1 - _max0((tw - 2 * _abs(dx)) / (tw + 2 * _abs(dx) + eps))
    ly = 1 - _max0((th - 2 * _abs(dy)) / (th + 2 * _abs(dy) + eps))
    lw = 1 - torch.minimum(tw / (pw + eps), pw / (tw + eps))
    lh = 1 - torch.minimum(th / (ph + eps), ph / (th + eps))
    comb = torch.stack([lx, ly, lw, lh], dim=-1)
    return torch.where(comb < beta, 0.5 * comb * comb / beta, comb - 0.5 * beta)
