"""PointRend (PyTorch port of ``boosting_rcnn_tpu/models/detectors/point_rend_det.py``;
reference ``detectors/point_rend.py`` with a ``PointRendRoIHead``).

A Mask R-CNN whose mask head is ``CoarseMaskHead`` (7 x 7 logits from the
14 x 14 RoIAlign) and which refines the mask at points with
``MaskPointHead``: each point's fine feature is ``point_sample`` of the
finest neck level (P2, stride 4) at the point's place in the padded image,
concatenated with the coarse logits sampled there.

Training (``loss``): the losses of the Mask R-CNN, the mask loss on the 7
x 7 coarse logits against 7 x 7 targets (the generic mask path), and
``loss_point``: the binary cross entropy of the point head's logit of each
positive slot's label at its ``num_points`` training points
(``get_train_points`` on its coarse logits), against the gt crop sampled
there and binarised at 0.5, summed over the valid positives and divided by
``max(positives, 1) * num_points``.  ``loss(..., point_uniforms=)`` takes
the points' two uniform draws ``((B*R, 3 P, 2), (B*R, P - 0.75 P, 2))``
(the JAX package draws them from ``fold_in(rng, 7)``), else they come from
``generator`` after the samplers' draws.

Inference (``predict``): the coarse logit map of each detection's label,
``subdivision_steps`` rounds of ``subdivision_refine`` (2x bilinear
upsampling, the ``subdivision_num_points`` most uncertain cells
re-predicted), then the sigmoid: masks ``(B, D, 224, 224)`` float32 at the
default five steps from 7 x 7.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ...ops import losses as L
from ...ops.point_sample import point_sample, rel_roi_point_to_rel_img_point
from ..roi_heads.point_rend import (
    PointRendCfg,
    get_train_points,
    label_column,
    sample_gt_mask_at_points,
    subdivision_refine,
)
from .two_stage import TwoStageDetector

__all__ = ["PointRendDetector"]


class PointRendDetector(TwoStageDetector):
    """A two-stage detector with PointRend's coarse mask head and point head."""

    def __init__(self, *args, point_cfg: PointRendCfg = PointRendCfg(), **kwargs):
        super().__init__(*args, **kwargs)
        if self.net.point_head is None:
            raise ValueError("PointRend needs a point head")
        self.point_cfg = point_cfg

    def _point_logits(self, feats, rois: torch.Tensor, rel_pts: torch.Tensor,
                      coarse_pts: torch.Tensor, canvas_hw) -> torch.Tensor:
        """``rois`` ``(B, R, 4)`` in the padded image's frame, ``rel_pts``
        ``(B, R, P, 2)`` RoI-relative, ``coarse_pts`` ``(B, R, P, K)`` ->
        the point head's ``(B, R, P, K)`` logits, the fine features sampled
        from ``feats[0]`` (JAX ``_point_logits``)."""
        b, r, p, c = coarse_pts.shape
        img_pts = rel_roi_point_to_rel_img_point(rois.float(), rel_pts, canvas_hw)
        fine = point_sample(feats[0], img_pts.reshape(b, r * p, 2))
        out = self.net.point_out(fine.reshape(b * r * p, -1), coarse_pts.reshape(b * r * p, c))
        return out.reshape(b, r, p, c)

    def loss(self, batch, anchors, num_level_anchors,
             generator: Optional[torch.Generator] = None, sample=None, rpn_uniforms=None,
             point_uniforms=None) -> Dict[str, torch.Tensor]:
        """``TwoStageDetector.loss`` plus ``loss_point`` (with
        ``gt_mask_crops`` in the batch; without them there is no mask loss
        and no point loss, as in the JAX package)."""
        losses, feats, sample, coarse = self._losses(batch, anchors, num_level_anchors,
                                                     generator, sample, rpn_uniforms)
        if coarse is None:
            return losses
        b, r = sample.boxes.shape[:2]
        c = coarse.shape[-1]
        labels = torch.clamp(sample.matched_label.long().reshape(-1), 0, c - 1)
        pts = get_train_points(self.point_cfg, coarse.detach(), labels, point_uniforms, generator)
        p = pts.shape[1]
        coarse_at = point_sample(coarse, pts)  # (B*R, P, K)
        canvas = tuple(int(s) for s in batch["images"].shape[1:3])
        boxes = sample.boxes.float()
        logits = self._point_logits(feats, boxes, pts.reshape(b, r, p, 2),
                                    coarse_at.reshape(b, r, p, c), canvas)
        sel = label_column(logits.reshape(b * r, p, c), labels)
        crops = self._tensor(batch["gt_mask_crops"], torch.uint8)
        gt_bboxes = self._tensor(batch["gt_bboxes"])
        g = crops.shape[1]
        gidx = (sample.gt_idx.long()
                + g * torch.arange(b, device=self.device)[:, None]).reshape(-1)
        targets = sample_gt_mask_at_points(crops.reshape(b * g, *crops.shape[2:])[gidx],
                                           gt_bboxes.reshape(b * g, 4)[gidx],
                                           boxes.reshape(-1, 4), pts)
        elem = L.binary_cross_entropy_loss(sel, targets, reduction="none")
        posf = (sample.valid.bool() & sample.is_pos.bool()).reshape(-1).float()
        num = torch.clamp(posf.sum(), min=1.0)
        losses["loss_point"] = (elem * posf[:, None]).sum() / (num * p)
        return losses

    @torch.inference_mode()
    def mask_predict(self, feats, dets, labels, valid, scale_factor, rescale: bool = True,
                     canvas_hw=None):
        """The masks ``(B, D, S 2^steps, S 2^steps)`` float32 of the
        detections: the coarse logits of each one's label, refined by
        ``subdivision_refine`` with the point head, then the sigmoid (JAX
        ``PointRendDetector.predict``); ``canvas_hw``, the padded images'
        ``(H, W)``, normalises the points for the fine features."""
        if canvas_hw is None:
            raise ValueError("PointRend's mask_predict needs the padded images' canvas_hw")
        b, d = labels.shape
        boxes = dets[..., :4]
        if rescale:
            boxes = boxes * scale_factor[:, None, :]
        coarse = self.net.mask_out(feats, boxes, valid)  # (B*D, s, s, K)
        c = coarse.shape[-1]
        flat_labels = torch.clamp(labels.reshape(-1), 0, c - 1)
        label_map = label_column(coarse.reshape(b * d, -1, c), flat_labels).reshape(
            coarse.shape[:3])

        def point_fn(pts):  # (B*D, k, 2) -> (B*D, k)
            k = pts.shape[1]
            coarse_at = point_sample(coarse, pts)
            lg = self._point_logits(feats, boxes, pts.reshape(b, d, k, 2),
                                    coarse_at.reshape(b, d, k, c), canvas_hw)
            return label_column(lg.reshape(b * d, k, c), flat_labels)

        refined = subdivision_refine(self.point_cfg, label_map, point_fn)
        m = refined.shape[-1]
        return (torch.sigmoid(refined.float()).reshape(b, d, m, m),)
