"""ATSSRPNHead, inference (PyTorch port of
``boosting_rcnn_tpu/models/dense_heads/atss_rpn_head.py``).

``ATSSRPNConvs``: a GN(32) + ReLU conv tower shared by the five FPN levels,
then ``rpn_cls`` (A objectness logits), ``rpn_reg`` (A*4 deltas through a
per-level learnable ``Scale``) and ``rpn_iou`` (A IoU logits).
``atss_rpn_proposals``: fused score ``sqrt(sigmoid(cls) * sigmoid(iou))``,
per-level exact top-``nms_pre``, decode, level-aware NMS, keep
``max_per_img``.  The train-time targets and losses are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from ...ops import box_ops
from ...ops.nms import batched_nms_padded
from ...ops.topk import select_topk
from ..layers import ConvModule, Scale, make_conv

PRIOR_BIAS = -4.595  # rpn_cls bias init: prior probability 0.01


class ATSSRPNConvs(nn.Module):
    """Per-level NCHW features -> per-level (cls, reg, iou) NCHW maps."""

    def __init__(self, gen: torch.Generator, in_channels: int = 256,
                 num_anchors: int = 9, feat_channels: int = 256,
                 stacked_convs: int = 4, num_levels: int = 5):
        super().__init__()
        self.stacked_convs = stacked_convs
        self.num_levels = num_levels
        cin = in_channels
        for i in range(stacked_convs):
            self.add_module(f"rpn_conv_{i}", ConvModule(
                cin, feat_channels, 3, gen, num_groups=32, act="relu"))
            cin = feat_channels
        self.rpn_cls = make_conv(cin, num_anchors, 3, 1, 1, True, gen, PRIOR_BIAS)
        self.rpn_reg = make_conv(cin, num_anchors * 4, 3, 1, 1, True, gen)
        self.rpn_iou = make_conv(cin, num_anchors, 3, 1, 1, True, gen)
        for lvl in range(num_levels):
            self.add_module(f"scale_{lvl}", Scale())

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_out, reg_out, iou_out = [], [], []
        for lvl, x in enumerate(feats):
            for i in range(self.stacked_convs):
                x = getattr(self, f"rpn_conv_{i}")(x)
            cls_out.append(self.rpn_cls(x))
            reg_out.append(getattr(self, f"scale_{lvl}")(self.rpn_reg(x)))
            iou_out.append(self.rpn_iou(x))
        return cls_out, reg_out, iou_out


def flatten_levels(per_level: Sequence[torch.Tensor], last_dim: int) -> torch.Tensor:
    """Per-level NCHW ``(B, A*D, H, W)`` -> ``(B, sum HWA, D)`` in (H, W, A)
    order within a level, level-major, matching ``flat_anchors``."""
    b = per_level[0].shape[0]
    return torch.cat(
        [x.permute(0, 2, 3, 1).reshape(b, -1, last_dim) for x in per_level], dim=1)


@dataclasses.dataclass(frozen=True)
class ATSSRPNCfg:
    """The inference part of the JAX ``ATSSRPNCfg``: the box coder."""

    target_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)


def _decode(cfg: ATSSRPNCfg, anchors, deltas, max_shape=None):
    return box_ops.delta2bbox(anchors, deltas, cfg.target_means, cfg.target_stds,
                              max_shape=max_shape)


def atss_rpn_proposals(
    cfg: ATSSRPNCfg,
    cls_logits: torch.Tensor,
    bbox_preds: torch.Tensor,
    iou_logits: torch.Tensor,
    anchors: torch.Tensor,
    num_level_anchors: Sequence[int],
    img_shapes: torch.Tensor,
    nms_pre: int = 1000,
    max_per_img: int = 256,
    nms_iou_thr: float = 0.7,
    min_bbox_size: float = 0.0,
):
    """Proposals for a batch: ``cls_logits``/``iou_logits`` ``(B, A)``,
    ``bbox_preds`` ``(B, A, 4)``, ``anchors`` ``(A, 4)``, ``img_shapes``
    ``(B, 2)``.  Returns ``(boxes (B, max, 4), scores (B, max), valid)``;
    the score is the fused prior ``sqrt(sigmoid(cls) * sigmoid(iou))``."""
    fused = torch.sqrt(torch.sigmoid(cls_logits.float()) * torch.sigmoid(iou_logits.float()))
    sel_scores, sel_deltas, sel_anchors, sel_ids = [], [], [], []
    start = 0
    for lvl, na in enumerate(num_level_anchors):
        k = min(nms_pre, na) if nms_pre > 0 else na
        top_s, top_i = select_topk(fused[:, start:start + na], k)
        idx = top_i + start
        sel_scores.append(top_s)
        sel_deltas.append(torch.gather(bbox_preds, 1, idx[..., None].expand(-1, -1, 4)))
        sel_anchors.append(anchors[idx])
        sel_ids.append(torch.full_like(top_i, lvl))
        start += na
    scores = torch.cat(sel_scores, dim=1)
    deltas = torch.cat(sel_deltas, dim=1)
    ancs = torch.cat(sel_anchors, dim=1)
    ids = torch.cat(sel_ids, dim=1)

    proposals = _decode(cfg, ancs, deltas, max_shape=img_shapes)
    w = proposals[..., 2] - proposals[..., 0]
    h = proposals[..., 3] - proposals[..., 1]
    ok = (w > min_bbox_size) & (h > min_bbox_size)

    out_boxes, out_scores, out_valid = [], [], []
    for i in range(proposals.shape[0]):
        boxes, sc, valid, _ = batched_nms_padded(
            proposals[i], scores[i], ids[i], nms_iou_thr, max_per_img, valid=ok[i])
        out_boxes.append(boxes)
        out_scores.append(torch.where(valid, sc, torch.zeros_like(sc)))
        out_valid.append(valid)
    return torch.stack(out_boxes), torch.stack(out_scores), torch.stack(out_valid)
