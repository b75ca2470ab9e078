"""R-CNN box head, inference (PyTorch port of
``boosting_rcnn_tpu/models/roi_heads/bbox_head.py``).

``ConvFCBBoxHead`` with the flagship's Shared2FC layout, or with
``num_shared_convs`` 3x3 ConvModules (ReLU, a ``conv_cfg`` and a
``norm_cfg``; ``Shared4Conv1FCBBoxHead``: 4 convs and 1 FC) before the FCs
(JAX ``bbox_head.py:140-148``): the pooled (or convolved) ``(N, 7, 7, C)``
RoI features are flattened in (H, W, C) order, as in the JAX package, so
the first FC takes the JAX kernel with no column permutation.  The box deltas are class-wise, ``(N, 4K)``, or with
``reg_class_agnostic`` one set for every class, ``(N, 4)`` (Cascade
R-CNN's stage heads).  ``bbox_head_decode`` decodes the deltas and runs
multiclass NMS for one image.  ``bbox_targets`` and ``bbox_head_loss`` are
the train side: softmax cross entropy or the Seesaw loss, and L1 or smooth
L1 on the encoded deltas or, with ``reg_decoded_bbox``, an IoU-family loss
on the decoded boxes (JAX ``bbox_head.py:242-255``): the IoU, GIoU, CIoU,
EIoU or Focal-EIoU loss of each slot spread over its four coordinates
(a quarter each), or the bounded IoU loss elementwise; other loss types
raise ``NotImplementedError``.
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

Seesaw (``seesaw=True``): the head carries the classes' cumulative counts
of sampled targets, ``seesaw_counts`` ``(K+1,)`` float32 (background
last), the reference ``SeesawLoss.cum_samples`` (JAX ``bbox_head.py:97-117``),
in the ``state_dict`` and so in every checkpoint.  ``next_seesaw_counts``
gives a step's counts without moving the buffer; the detector's loss reads
them and its ``update_state`` stores them.  The JAX package applies the
Seesaw weights over this head's K+1 softmax, where mmdet's Seesaw head has
K+2 logits with an objectness pair; the port copies it.
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
from ..layers import ConvModule, make_linear


class ConvFCBBoxHead(nn.Module):
    """``(N, 7, 7, C)`` pooled features -> (cls logits ``(N, K+1)``, deltas
    ``(N, 4K)``, or ``(N, 4)`` with ``reg_class_agnostic``)."""

    def __init__(self, gen: torch.Generator, num_classes: int, in_channels: int = 256,
                 num_shared_fcs: int = 2, fc_out_channels: int = 1024,
                 roi_feat_size: int = 7, reg_class_agnostic: bool = False,
                 dynamic: bool = False, dyn_initial_iou: float = 0.4,
                 dyn_initial_beta: float = 1.0, dyn_interval: int = 100,
                 num_shared_convs: int = 0, conv_out_channels: int = 256,
                 conv_cfg: Optional[dict] = None, norm_cfg: Optional[dict] = None,
                 seesaw: bool = False):
        super().__init__()
        self.num_shared_fcs = num_shared_fcs
        self.num_shared_convs = num_shared_convs
        cin = in_channels
        for i in range(num_shared_convs):
            self.add_module(f"shared_conv_{i}", ConvModule(
                cin, conv_out_channels, 3, gen, norm_cfg=norm_cfg, act="relu",
                conv_cfg=conv_cfg))
            cin = conv_out_channels
        cin = cin * roi_feat_size * roi_feat_size
        for i in range(num_shared_fcs):
            self.add_module(f"shared_fc_{i}", make_linear(cin, fc_out_channels, gen))
            cin = fc_out_channels
        self.fc_cls = make_linear(cin, num_classes + 1, gen)
        self.fc_reg = make_linear(cin, 4 if reg_class_agnostic else 4 * num_classes, gen)
        self.num_classes = num_classes
        self.seesaw = seesaw
        if seesaw:
            self.register_buffer("seesaw_counts", torch.zeros(num_classes + 1))
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

    @torch.no_grad()
    def next_seesaw_counts(self, labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """The cumulative counts after a step whose sampled slots have
        ``labels`` ``(R,)`` (background ``num_classes``) and ``weights``
        ``(R,)``: ``seesaw_counts`` plus the weighted one-hot sum (JAX
        ``update_seesaw_counts``); the buffer is left as it is."""
        onehot = F.one_hot(labels.long(), self.num_classes + 1).float()
        return self.seesaw_counts + (onehot * weights.float()[:, None]).sum(0)

    def forward(self, x: torch.Tensor):
        if self.num_shared_convs:
            x = x.permute(0, 3, 1, 2)
            for i in range(self.num_shared_convs):
                x = getattr(self, f"shared_conv_{i}")(x)
            x = x.permute(0, 2, 3, 1)
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
    loss_bbox_type: str = "l1"  # an ENCODED_LOSSES or, reg_decoded_bbox, a DECODED_LOSSES
    smooth_l1_beta: float = 1.0
    loss_cls_type: str = "ce"  # "ce" or "seesaw"
    seesaw_p: float = 0.8
    seesaw_q: float = 2.0


ENCODED_LOSSES = ("l1", "smooth_l1")
# the IoU-family losses of the decoded boxes (JAX bbox_head.py:248-255)
_DECODED = {"iou": L.iou_loss, "giou": L.giou_loss, "ciou": L.ciou_loss, "eiou": L.eiou_loss,
            "focal_eiou": L.focal_eiou_loss}
DECODED_LOSSES = (*_DECODED, "bounded_iou")


def _check_train_cfg(cfg: BBoxHeadCfg) -> None:
    box = DECODED_LOSSES if cfg.reg_decoded_bbox else ENCODED_LOSSES
    for what, value, ported in (("loss_bbox_type", cfg.loss_bbox_type, box),
                                ("loss_cls_type", cfg.loss_cls_type, ("ce", "seesaw"))):
        if value not in ported:
            raise NotImplementedError(f"bbox head {what}={value!r} is not ported with "
                                      f"reg_decoded_bbox={cfg.reg_decoded_bbox}")


def bbox_targets(cfg: BBoxHeadCfg, sampled_boxes: torch.Tensor, is_pos: torch.Tensor,
                 valid: torch.Tensor, matched_gt_boxes: torch.Tensor,
                 matched_gt_labels: torch.Tensor):
    """Targets of ``(R,)`` sampled RoIs: labels (background =
    ``num_classes``), unit label weights on valid slots, encoded box
    targets (the matched gt boxes themselves with ``reg_decoded_bbox``) and
    unit box weights on positives."""
    _check_train_cfg(cfg)
    labels = torch.where(is_pos, matched_gt_labels.long(),
                         torch.full_like(matched_gt_labels.long(), cfg.num_classes))
    label_weights = valid.float()
    t = (matched_gt_boxes if cfg.reg_decoded_bbox else
         box_ops.bbox2delta(sampled_boxes, matched_gt_boxes, cfg.target_means,
                            cfg.target_stds, eps=1e-6))
    t = torch.where(is_pos[:, None], t, torch.zeros_like(t))
    bbox_weights = is_pos[:, None].float().expand(-1, 4)
    return labels, label_weights, t, bbox_weights


def bbox_head_loss(cfg: BBoxHeadCfg, cls_score: torch.Tensor, bbox_pred: torch.Tensor,
                   rois: torch.Tensor, labels: torch.Tensor, label_weights: torch.Tensor,
                   bbox_t: torch.Tensor, bbox_w: torch.Tensor,
                   reduction_override: Optional[str] = None,
                   beta_override: Optional[torch.Tensor] = None,
                   seesaw_counts: Optional[torch.Tensor] = None):
    """The head loss on ``(R, K+1)`` logits and ``(R, 4K)`` deltas (``(R,
    4)`` class-agnostic).  With ``reduction_override='none'`` the
    elementwise losses come back, ``(R,)`` and ``(R, 4)``, for the boosting
    renormalisation; else cls is averaged over the weighted slots and the
    box loss over all ``R``.  ``beta_override``, a float32 scalar tensor
    (Dynamic R-CNN's working beta), replaces the smooth-L1 beta;
    ``seesaw_counts`` ``(K+1,)`` are the Seesaw loss's cumulative counts.
    With ``reg_decoded_bbox`` the deltas are decoded on the RoIs and a
    non-positive slot's target is its own decoded box, so that its (zero
    weighted) loss and gradient stay finite."""
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
    if cfg.reg_decoded_bbox:
        pred_boxes = box_ops.delta2bbox(rois, pred4, cfg.target_means, cfg.target_stds)
        safe_t = torch.where(pos[:, None], bbox_t.to(pred_boxes.dtype), pred_boxes)
        if cfg.loss_bbox_type == "bounded_iou":
            d = L.bounded_iou_loss(pred_boxes, safe_t)
        else:
            d = (_DECODED[cfg.loss_bbox_type](pred_boxes, safe_t, reduction="none")[:, None]
                 * torch.ones((1, 4), device=pred_boxes.device) / 4.0)
    else:
        d = (pred4 - bbox_t).abs()
        if cfg.loss_bbox_type == "smooth_l1":
            b = cfg.smooth_l1_beta if beta_override is None else beta_override
            d = torch.where(d < b, 0.5 * d * d / b, d - 0.5 * b)
    elem = d * bbox_w * pos.float()[:, None] * cfg.loss_bbox_weight
    if cfg.loss_cls_type == "seesaw":
        if seesaw_counts is None:
            raise ValueError("the Seesaw loss needs the cumulative class counts")
        ce = L.seesaw_loss(cls_score, labels, seesaw_counts, p=cfg.seesaw_p, q=cfg.seesaw_q,
                           reduction="none")
    else:
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
