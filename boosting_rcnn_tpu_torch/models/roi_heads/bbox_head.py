"""R-CNN box head, inference (PyTorch port of
``boosting_rcnn_tpu/models/roi_heads/bbox_head.py``).

``ConvFCBBoxHead`` with the flagship's Shared2FC layout: the pooled
``(N, 7, 7, C)`` RoI features are flattened in (H, W, C) order, as in the
JAX package, so the first FC takes the JAX kernel with no column
permutation.  The box deltas are class-wise, ``(N, 4K)``, or with
``reg_class_agnostic`` one set for every class, ``(N, 4)`` (Cascade
R-CNN's stage heads).  ``bbox_head_decode`` decodes the deltas and runs
multiclass NMS for one image.  ``bbox_targets`` and ``bbox_head_loss`` are
the train side: softmax cross entropy, and L1 or smooth L1 on the encoded
deltas; other loss types raise ``NotImplementedError``.
The head computes in the compute dtype of its ``Linear`` layers, and cls
and reg come out in it (JAX ``roi_heads/bbox_head.py:143-157``); the
losses compute in the predictions' dtype until a float32 weight promotes
them.

Dynamic R-CNN (``dynamic=True``): the head carries the working assigner
IoU threshold and smooth-L1 beta as float32 buffers, ``dyn_iou_thr`` and
``dyn_beta``, with a ring of the last ``dyn_interval`` batch statistics
(``dyn_iou_hist``, ``dyn_beta_hist``) and the count of steps recorded
(``dyn_count``, int32), as the JAX head's ``batch_stats``; they live in
the ``state_dict``, so a checkpoint carries them.  ``update_dynamic``
replays the reference's ``update_hyperparameters`` (JAX
``bbox_head.py:60-95``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops
from ...ops import losses as L
from ...ops.nms import multiclass_nms_padded
from ..layers import make_linear


class ConvFCBBoxHead(nn.Module):
    """``(N, 7, 7, C)`` pooled features -> (cls logits ``(N, K+1)``, deltas
    ``(N, 4K)``, or ``(N, 4)`` with ``reg_class_agnostic``)."""

    def __init__(self, gen: torch.Generator, num_classes: int, in_channels: int = 256,
                 num_shared_fcs: int = 2, fc_out_channels: int = 1024,
                 roi_feat_size: int = 7, reg_class_agnostic: bool = False,
                 dynamic: bool = False, dyn_initial_iou: float = 0.4,
                 dyn_initial_beta: float = 1.0, dyn_interval: int = 100):
        super().__init__()
        self.num_shared_fcs = num_shared_fcs
        cin = in_channels * roi_feat_size * roi_feat_size
        for i in range(num_shared_fcs):
            self.add_module(f"shared_fc_{i}", make_linear(cin, fc_out_channels, gen))
            cin = fc_out_channels
        self.fc_cls = make_linear(cin, num_classes + 1, gen)
        self.fc_reg = make_linear(cin, 4 if reg_class_agnostic else 4 * num_classes, gen)
        self.dynamic = dynamic
        if dynamic:
            self.dyn_initial_iou, self.dyn_initial_beta = dyn_initial_iou, dyn_initial_beta
            self.register_buffer("dyn_iou_thr", torch.tensor(dyn_initial_iou))
            self.register_buffer("dyn_beta", torch.tensor(dyn_initial_beta))
            self.register_buffer("dyn_iou_hist", torch.zeros(dyn_interval))
            self.register_buffer("dyn_beta_hist", torch.zeros(dyn_interval))
            self.register_buffer("dyn_count", torch.tensor(0, dtype=torch.int32))

    @torch.no_grad()
    def update_dynamic(self, batch_iou: torch.Tensor, batch_beta: torch.Tensor):
        """Record a step's statistics in the ring and, at every
        ``dyn_interval``-th step, set ``iou_thr = max(initial_iou,
        mean(iou_hist))`` and ``beta = min(initial_beta, median(beta_hist))``
        (beta kept where the median is below 1e-15; the median of an even
        count the mean of the two middle values, as ``jnp.median``).  A NaN
        statistic is recorded as the current working value.  Stays on the
        device: no value is read to the host."""
        iou, beta = self.dyn_iou_thr, self.dyn_beta
        batch_iou = torch.where(torch.isnan(batch_iou), iou, batch_iou.float())
        batch_beta = torch.where(torch.isnan(batch_beta), beta, batch_beta.float())
        k = self.dyn_iou_hist.shape[0]
        idx = (self.dyn_count.long() % k).reshape(1)
        self.dyn_iou_hist.index_copy_(0, idx, batch_iou.reshape(1))
        self.dyn_beta_hist.index_copy_(0, idx, batch_beta.reshape(1))
        self.dyn_count += 1
        boundary = self.dyn_count % k == 0
        cand_iou = torch.clamp(self.dyn_iou_hist.mean(), min=self.dyn_initial_iou)
        ordered = self.dyn_beta_hist.sort().values
        med = (ordered[(k - 1) // 2] + ordered[k // 2]) * 0.5
        cand_beta = torch.where(med < 1e-15, beta, torch.clamp(med, max=self.dyn_initial_beta))
        self.dyn_iou_thr.copy_(torch.where(boundary, cand_iou, iou))
        self.dyn_beta.copy_(torch.where(boundary, cand_beta, beta))

    def forward(self, x: torch.Tensor):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_shared_fcs):
            x = F.relu(getattr(self, f"shared_fc_{i}")(x))
        return self.fc_cls(x), self.fc_reg(x)


@dataclasses.dataclass(frozen=True)
class BBoxHeadCfg:
    """The JAX ``BBoxHeadCfg``, as far as the ported configs set it."""

    num_classes: int = 4
    target_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    reg_class_agnostic: bool = False
    reg_decoded_bbox: bool = False
    loss_cls_weight: float = 2.0
    loss_bbox_weight: float = 2.0
    loss_bbox_type: str = "l1"  # "l1" or "smooth_l1"
    smooth_l1_beta: float = 1.0
    loss_cls_type: str = "ce"


def _check_train_cfg(cfg: BBoxHeadCfg) -> None:
    for what, value, ported in (("reg_decoded_bbox", cfg.reg_decoded_bbox, (False,)),
                                ("loss_bbox_type", cfg.loss_bbox_type, ("l1", "smooth_l1")),
                                ("loss_cls_type", cfg.loss_cls_type, ("ce",))):
        if value not in ported:
            raise NotImplementedError(f"bbox head {what}={value!r} is not ported")


def bbox_targets(cfg: BBoxHeadCfg, sampled_boxes: torch.Tensor, is_pos: torch.Tensor,
                 valid: torch.Tensor, matched_gt_boxes: torch.Tensor,
                 matched_gt_labels: torch.Tensor):
    """Targets of ``(R,)`` sampled RoIs: labels (background =
    ``num_classes``), unit label weights on valid slots, encoded box
    targets and unit box weights on positives."""
    _check_train_cfg(cfg)
    labels = torch.where(is_pos, matched_gt_labels.long(),
                         torch.full_like(matched_gt_labels.long(), cfg.num_classes))
    label_weights = valid.float()
    t = box_ops.bbox2delta(sampled_boxes, matched_gt_boxes, cfg.target_means,
                           cfg.target_stds, eps=1e-6)
    t = torch.where(is_pos[:, None], t, torch.zeros_like(t))
    bbox_weights = is_pos[:, None].float().expand(-1, 4)
    return labels, label_weights, t, bbox_weights


def bbox_head_loss(cfg: BBoxHeadCfg, cls_score: torch.Tensor, bbox_pred: torch.Tensor,
                   rois: torch.Tensor, labels: torch.Tensor, label_weights: torch.Tensor,
                   bbox_t: torch.Tensor, bbox_w: torch.Tensor,
                   reduction_override: Optional[str] = None,
                   beta_override: Optional[torch.Tensor] = None):
    """The head loss on ``(R, K+1)`` logits and ``(R, 4K)`` deltas (``(R,
    4)`` class-agnostic).  With ``reduction_override='none'`` the
    elementwise losses come back, for the boosting renormalisation; else
    cls is averaged over the weighted slots and the box loss over all
    ``R``.  ``beta_override``, a float32 scalar tensor (Dynamic R-CNN's
    working beta), replaces the smooth-L1 beta."""
    _check_train_cfg(cfg)
    r = cls_score.shape[0]
    c = cfg.num_classes
    pos = (labels >= 0) & (labels < c)
    if cfg.reg_class_agnostic:
        pred4 = bbox_pred.reshape(r, 4)
    else:
        safe_lab = torch.clamp(labels, 0, c - 1)
        # the label's deltas by a one-hot product, exact, with an elementwise
        # gradient (a gather's is a scatter-add with float atomics on the GPU)
        onehot = F.one_hot(safe_lab.long(), c).to(bbox_pred.dtype)
        pred4 = (bbox_pred.reshape(r, c, 4) * onehot[:, :, None]).sum(1)
    d = (pred4 - bbox_t).abs()
    if cfg.loss_bbox_type == "smooth_l1":
        b = cfg.smooth_l1_beta if beta_override is None else beta_override
        d = torch.where(d < b, 0.5 * d * d / b, d - 0.5 * b)
    elem = d * bbox_w * pos.float()[:, None] * cfg.loss_bbox_weight
    ce = L.cross_entropy_loss(cls_score, labels, reduction="none")
    ce = ce * label_weights * cfg.loss_cls_weight
    if reduction_override == "none":
        return {"loss_cls": ce, "loss_bbox": elem, "pos": pos}
    avg_cls = torch.clamp((label_weights > 0).float().sum(), min=1.0)
    return {"loss_cls": ce.sum() / avg_cls, "loss_bbox": elem.sum() / max(r, 1), "pos": pos}


def bbox_head_decode(
    cfg: BBoxHeadCfg,
    rois: torch.Tensor,
    scores: torch.Tensor,
    bbox_pred: torch.Tensor,
    img_shape: torch.Tensor,
    scale_factor: torch.Tensor,
    rescale: bool,
    score_thr: float,
    nms_iou_thr: float,
    max_per_img: int,
    roi_valid: torch.Tensor,
    pre_nms_top_k: int = 2048,
    **nms_kw,
):
    """Decode + multiclass NMS for one image: ``rois`` ``(R, 4)``, ``scores``
    ``(R, K+1)`` already fused, ``bbox_pred`` ``(R, 4K)`` (or ``(R, 4)``,
    one box for every class) -> ``(dets (max, 5), labels (max,), valid
    (max,))``; ``nms_kw`` (``nms_type`` and the ``soft_*`` options) go to
    ``multiclass_nms_padded``."""
    r = rois.shape[0]
    c = cfg.num_classes
    boxes = box_ops.delta2bbox(
        rois, bbox_pred, cfg.target_means, cfg.target_stds, max_shape=img_shape
    ).reshape(r, -1, 4).expand(r, c, 4)
    if rescale:
        boxes = boxes / scale_factor.reshape(1, 1, 4)
    return multiclass_nms_padded(
        boxes, scores[:, :c], score_thr=score_thr, iou_threshold=nms_iou_thr,
        max_per_img=max_per_img, valid=roi_valid, pre_nms_top_k=pre_nms_top_k, **nms_kw,
    )
