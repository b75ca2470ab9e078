"""Cascade R-CNN detector, plain and with ProbCascade fusion (PyTorch port
of ``boosting_rcnn_tpu/models/detectors/cascade.py``).

The reference is mmdet's ``CascadeRoIHead`` and the fork's
``ProbCascadeRoIHead`` (``prob_roi_head.py:627-881``).  ``CascadeNet``
holds one box head per stage; each stage pools its RoIs through the
port's batched multi-level RoIAlign, the CUDA forward kernel on the GPU
and its gradient kernel in training (the JAX package's cascade pools with
the XLA ``multilevel_roi_align_fast``, the same function).

``CascadeDetector.loss``: the RPN losses and the train proposals, then per
stage: assign and sample at the stage's IoU threshold, the stage's head,
its two losses, and the *sampled* boxes refined into the next stage's
candidates, each carrying its prior back as its score (``prior`` for a
positive, ``1 - prior`` for a negative); ``_train_stages`` hands each
stage's candidates out too, which HTC's mask branch samples again
(``htc.py``).  A gt-added slot leaves the
candidates by the JAX package's rule, a positive whose prior is 0.  With
Seesaw box heads each stage's loss reads its own head's counts (JAX
``cascade.py:84-97``), which ``update_state`` stores.
``predict``: every stage refines all proposals; the stages' logits are
averaged, then the softmax; ProbCascade fuses the foreground columns as
``sqrt(p * prior)`` and the background as ``sqrt(p_bg * (1 - prior))``;
the last stage's deltas, at its coder stds, give the boxes.  Each stage's
outputs are float32 from there, as in the JAX package.

Deviations of the JAX package from the reference that the port copies
(ROADMAP C.4): the stds ladder over the stage configs' own stds, stage
0's ``BBoxHeadCfg`` for every stage, the ``prior == 0`` gt-slot rule, and
the boosting weights applied with a plain weighted mean (the reference's
``_bbox_forward_train_boost`` calls ``loss`` on the ``ModuleList``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..roi_heads.bbox_head import bbox_head_decode
from ..roi_heads.cascade_roi_head import (
    CascadeCfg,
    cascade_stage_loss,
    refine_boxes,
    stage_head_cfg,
)
from ..roi_heads.prob_roi_head import RoISample
from .two_stage import TwoStageDetector, TwoStageNet


_NO_SAMPLE = ("a cascade samples each stage on the stage before it inside its loss: it takes "
              "no external RoISample (nor does the JAX package's)")


class CascadeNet(TwoStageNet):
    """Backbone, neck, RPN and ``bbox_heads``, one per stage."""

    def __init__(self, backbone: nn.Module, neck: nn.Module, rpn: nn.Module,
                 bbox_heads: Sequence[nn.Module], **roi_kw):
        super().__init__(backbone, neck, rpn, None, **roi_kw)
        self.bbox_heads = nn.ModuleList(bbox_heads)

    def roi_out(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                roi_valid: torch.Tensor, stage: int = 0):
        """``feats`` L x ``(B, H, W, C)``, ``rois`` ``(B, R, 4)`` -> stage
        ``stage``'s (cls ``(B*R, K+1)``, reg ``(B*R, 4)`` or ``(B*R, 4K)``)."""
        return self.bbox_heads[stage](self._pool(feats, rois, roi_valid, self.roi_out_size))


class CascadeDetector(TwoStageDetector):
    """Anchors, configs and the device around a ``CascadeNet``."""

    def __init__(self, *args, cascade_cfg: CascadeCfg = CascadeCfg(), **kwargs):
        super().__init__(*args, **kwargs)
        self.cascade_cfg = cascade_cfg

    def train_sample(self, *args, **kwargs):
        raise NotImplementedError(_NO_SAMPLE)

    def _stage_cfg(self, stage: int):
        """The RoI config of ``stage``: assigned at its IoU threshold (as
        ``pos_iou_thr``, ``neg_iou_thr`` and ``min_pos_iou``)."""
        thr = self.cascade_cfg.stage_pos_iou[stage]
        return dataclasses.replace(self.roi_cfg, pos_iou_thr=thr, neg_iou_thr=thr,
                                   min_pos_iou=thr)

    def _train_stages(self, feats, rpn_outs, batch, anchors, num_level_anchors,
                      generator: Optional[torch.Generator] = None, roi_uniforms=None,
                      **roi_kw):
        """Per stage, its sample (fields ``(B, R, ...)``), its head's outputs
        on it and its next candidates: the train proposals of the detached
        RPN outputs, then each stage assigned and sampled at its IoU
        threshold, and its sampled boxes refined (without gradient) into
        the candidates ``(boxes, scores, valid)`` of the stage after it
        (the last stage's too, which HTC's mask branch samples).
        ``roi_kw`` goes to ``net.roi_out``."""
        img_shape = self._tensor(batch["img_shape"])
        with torch.no_grad():
            cls, reg, iou = (None if x is None else x.detach() for x in rpn_outs)
            boxes, scores, valid = self._proposals(cls, reg, iou, anchors, num_level_anchors,
                                                   img_shape, self.train_proposal_cfg)
        for stage in range(self.cascade_cfg.num_stages):
            with torch.no_grad():
                s = self._vmap_sample(boxes, scores, valid, batch, generator,
                                      self._stage_cfg(stage),
                                      None if roi_uniforms is None else roi_uniforms[stage])
            cls_s, reg_s = self.net.roi_out(feats, s.boxes, s.valid, stage, **roi_kw)
            b, r = s.boxes.shape[:2]
            with torch.no_grad():
                boxes = refine_boxes(stage_head_cfg(self.bbox_cfg, stage), s.boxes,
                                     cls_s.detach().reshape(b, r, -1),
                                     reg_s.detach().reshape(b, r, -1), img_shape)
                scores = torch.where(s.is_pos, s.prior, 1.0 - s.prior)
                valid = s.valid & ~(s.is_pos & (s.prior == 0.0))
            yield s, cls_s, reg_s, (boxes, scores, valid)

    def loss(self, batch, anchors, num_level_anchors,
             generator: Optional[torch.Generator] = None,
             sample: Optional[RoISample] = None,
             rpn_uniforms=None, roi_uniforms=None) -> Dict[str, torch.Tensor]:
        """Forward and losses of a padded batch (``TwoStageDetector.loss``'s
        batch): the RPN's losses and each stage's ``s{i}.loss_cls`` and
        ``s{i}.loss_bbox``.  ``generator`` drives the samplers; given
        ``rpn_uniforms`` ``(B, 2, A)`` rank the plain RPN's anchors, given
        ``roi_uniforms`` (per stage ``(B, 2, G + P_s)``, ``P_s`` the stage's
        candidates: the train proposals, then the slots sampled before)
        rank each stage's candidates, instead of draws."""
        if sample is not None:
            raise NotImplementedError(_NO_SAMPLE)
        feats, rpn_outs, losses = self._rpn_losses(batch, anchors, num_level_anchors, generator,
                                                   rpn_uniforms)
        stages = self._train_stages(feats, rpn_outs, batch, anchors, num_level_anchors,
                                    generator, roi_uniforms)
        for stage, (s, cls_s, reg_s, _) in enumerate(stages):
            flat = RoISample(*(x.reshape((-1,) + tuple(x.shape[2:])) for x in s))
            losses.update(cascade_stage_loss(
                self.cascade_cfg, self.bbox_cfg, stage, cls_s, reg_s, flat,
                seesaw_counts=self._seesaw_counts(f"bbox_heads.{stage}", flat)))
        return losses

    @torch.no_grad()
    def stage_samples(self, batch, anchors, num_level_anchors,
                      generator: Optional[torch.Generator] = None,
                      roi_uniforms=None) -> List[RoISample]:
        """Each stage's ``RoISample`` (fields ``(B, R, ...)``) as ``loss``
        draws them, without gradient (the RPN's loss and sampler do not
        run)."""
        feats = self.net.features(self._tensor(batch["images"]))
        stages = self._train_stages(feats, self._rpn_flat(feats), batch, anchors,
                                    num_level_anchors, generator, roi_uniforms)
        return [s for s, *_ in stages]

    @torch.inference_mode()
    def roi_predict(self, feats, prop_boxes, prop_scores, prop_valid, img_shape,
                    scale_factor, rescale: bool = True, **roi_kw):
        """Every stage on the proposals ``(B, R, 4)``, each refining them for
        the next; the stages' averaged logits, fused with the priors for
        ProbCascade, and the last stage's boxes, then NMS per image.
        ``roi_kw`` goes to ``net.roi_out``."""
        b, r = prop_boxes.shape[:2]
        cc = self.cascade_cfg
        rois, logits = prop_boxes, []
        for stage in range(cc.num_stages):
            cls_s, reg_s = self.net.roi_out(feats, rois, prop_valid, stage, **roi_kw)
            cls_s = cls_s.reshape(b, r, -1).float()
            reg_s = reg_s.reshape(b, r, -1).float()
            logits.append(cls_s)
            if stage < cc.num_stages - 1:
                rois = refine_boxes(stage_head_cfg(self.bbox_cfg, stage), rois, cls_s, reg_s,
                                    img_shape)
        probs = torch.softmax(sum(logits) / float(len(logits)), dim=-1)
        if cc.prob:
            prior = prop_scores[..., None]
            fused = torch.cat([probs[..., :-1] * prior, probs[..., -1:] * (1.0 - prior)], -1)
            probs = torch.sqrt(torch.clamp(fused, min=0.0))
        tc = self.rcnn_test_cfg
        hc_last = stage_head_cfg(self.bbox_cfg, cc.num_stages - 1)
        outs = [
            bbox_head_decode(
                hc_last, rois[i], probs[i], reg_s[i], img_shape[i], scale_factor[i], rescale,
                tc.score_thr, tc.nms_iou_thr, tc.max_per_img, roi_valid=prop_valid[i],
                pre_nms_top_k=tc.pre_nms_top_k, nms_type=tc.nms_type, soft_sigma=tc.soft_sigma,
                soft_min_score=tc.soft_min_score, soft_method=tc.soft_method,
            )
            for i in range(b)
        ]
        dets, labels, valid = (torch.stack(x) for x in zip(*outs))
        return dets, labels, valid
