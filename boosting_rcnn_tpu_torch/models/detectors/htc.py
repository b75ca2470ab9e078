"""Cascade Mask R-CNN and Hybrid Task Cascade (PyTorch port of
``boosting_rcnn_tpu/models/detectors/htc.py``).

The reference is mmdet's ``HybridTaskCascade`` with its
``HybridTaskCascadeRoIHead`` (``htc_roi_head.py``), and ``CascadeRCNN``
with a mask head (``cascade_roi_head.py``), which the JAX package builds
as the same detector with HTC's two additions switched off.  On top of
the box cascade (``cascade.py``):

  * per-stage mask heads on a 14 x 14 RoIAlign, each stage's mask loss
    weighted by the stage's loss weight;
  * interleaved execution (HTC): each stage's mask branch trains on the
    stage's sampled boxes refined by its own box head, assigned and
    sampled again at the stage's IoU threshold (``htc_roi_head.py:296-313``);
    Cascade Mask R-CNN trains it on the stage's own sample;
  * mask information flow (HTC): stage ``s``'s mask head adds the running
    feature of heads ``0..s-1`` run on the same pooled features
    (``HTCMaskHead.conv_res``), so that the gradient of stage ``s``'s mask
    loss reaches those heads;
  * an optional semantic branch (``FusedSemanticHead``): a stuff-map cross
    entropy weighted 0.2, and its embedding pooled on one route level (the
    semantic map at stride 8) and added to the box and mask branches'
    pooled features.

Every pooling runs through the port's batched multi-level RoIAlign: the
CUDA forward kernel on the GPU and its gradient kernel in training, at 7
and 14, on the pyramid's four route levels and on the single semantic
level.  ``predict``: the box cascade of ``CascadeDetector.roi_predict``
(the mean of the stages' logits, then the softmax; no prior fusion), then
every stage's mask head on the detections with information flow, their
sigmoids averaged, the label's channel -> ``(B, max_per_img, 28, 28)``.

Deviations of the JAX package from the reference that the port copies
(ROADMAP C.4): besides the box cascade's, the stuff map is resized to the
logit grid and the neck levels to the fusion level by nearest neighbour
(mmdet: bilinear for the fusion), and the semantic level is pooled in a
24-cell window like the pyramid's levels, so that a RoI wider than 23
cells at stride 8 samples clamped to the window's edge.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ...ops.roi_align_kernel import batched_multilevel_roi_align
from ..roi_heads.cascade_roi_head import cascade_stage_loss
from ..roi_heads.mask_head import resize_nearest, semantic_seg_loss
from ..roi_heads.prob_roi_head import RoISample
from .cascade import _NO_SAMPLE, CascadeDetector, CascadeNet


class HTCNet(CascadeNet):
    """Backbone, neck, RPN, ``bbox_heads`` and ``mask_heads``, one per
    stage, and an optional ``semantic_head``."""

    def __init__(self, backbone: nn.Module, neck: nn.Module, rpn: nn.Module,
                 bbox_heads: Sequence[nn.Module], mask_heads: Sequence[nn.Module],
                 semantic_head: Optional[nn.Module] = None, mask_info_flow: bool = True,
                 semantic_stride: int = 8, **roi_kw):
        super().__init__(backbone, neck, rpn, bbox_heads, **roi_kw)
        self.mask_heads = nn.ModuleList(mask_heads)
        self.semantic_head = semantic_head
        self.mask_info_flow = mask_info_flow
        self.semantic_stride = semantic_stride

    def semantic_out(self, feats: Sequence[torch.Tensor]):
        """Neck levels -> (stuff logits ``(B, h, w, K)`` float32, embedding
        ``(B, h, w, C)``) at the semantic stride."""
        return self.semantic_head(feats)

    def _pool_semantic(self, sem_feat: torch.Tensor, rois: torch.Tensor,
                       roi_valid: torch.Tensor, out_size: int) -> torch.Tensor:
        """``(B*R, out, out, C)``: the embedding ``(B, h, w, C)`` pooled as
        one route level at ``semantic_stride`` (every RoI routes to it)."""
        b, r, _ = rois.shape
        pooled = batched_multilevel_roi_align(
            [sem_feat], rois, roi_valid, (self.semantic_stride,), out_size=out_size,
            sample_num=self.roi_sample_num, finest_scale=self.roi_finest_scale,
            num_route_levels=1,
        )
        return pooled.reshape(b * r, out_size, out_size, -1)

    def _fused_pool(self, feats, rois, roi_valid, out_size: int, sem_feat=None):
        pooled = self._pool(feats, rois, roi_valid, out_size)
        if sem_feat is not None:
            pooled = pooled + self._pool_semantic(sem_feat, rois, roi_valid, out_size)
        return pooled

    def roi_out(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                roi_valid: torch.Tensor, stage: int = 0, sem_feat=None):
        """Stage ``stage``'s (cls, reg) on the pyramid's pooled features,
        plus the semantic embedding's where given."""
        return self.bbox_heads[stage](
            self._fused_pool(feats, rois, roi_valid, self.roi_out_size, sem_feat))

    def mask_out(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 roi_valid: torch.Tensor, stage: int = 0, sem_feat=None) -> torch.Tensor:
        """Stage ``stage``'s mask logits ``(B*R, 28, 28, K)`` float32: one
        pooling at ``mask_roi_out_size``; with information flow, heads
        ``0..stage-1`` run on the same pooled features first and hand their
        running feature on."""
        pooled = self._fused_pool(feats, rois, roi_valid, self.mask_roi_out_size, sem_feat)
        last = None
        if self.mask_info_flow:
            for i in range(stage):
                last = self.mask_heads[i](pooled, last, return_logits=False, return_feat=True)
        return self.mask_heads[stage](pooled, last, return_logits=True, return_feat=False)

    def mask_out_all_stages(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                            roi_valid: torch.Tensor, sem_feat=None) -> List[torch.Tensor]:
        """Every stage's mask logits on the same RoIs (one pooling), the
        running feature handed on under information flow."""
        return self.mask_heads_out(
            self._fused_pool(feats, rois, roi_valid, self.mask_roi_out_size, sem_feat))

    def mask_heads_out(self, pooled: torch.Tensor) -> List[torch.Tensor]:
        """Every stage's mask logits on the pooled features ``(N, 14, 14,
        C)``, the running feature handed on under information flow."""
        outs, last = [], None
        for head in self.mask_heads:
            logits, feat = head(pooled, last, return_logits=True, return_feat=True)
            last = feat if self.mask_info_flow else None
            outs.append(logits)
        return outs


class HTCDetector(CascadeDetector):
    """The box cascade with per-stage mask training (interleaved for HTC)
    and information-flow mask inference, and the optional semantic
    branch."""

    def _semantic(self, feats, batch, losses=None):
        """The semantic embedding (None without a semantic head); in
        training (``losses`` given) also ``loss_semantic_seg``, 0.2 x the
        cross entropy against ``batch["gt_semantic_seg"]`` ``(B, h, w)``,
        nearest-resized to the logit grid where its size differs."""
        if self.net.semantic_head is None:
            return None
        seg_logits, sem_feat = self.net.semantic_out(feats)
        if losses is not None:
            if "gt_semantic_seg" not in batch:
                raise KeyError("HTC with a semantic head needs 'gt_semantic_seg' in the batch "
                               "(COCO-stuff maps); use the without_semantic config otherwise")
            gt = self._tensor(batch["gt_semantic_seg"], torch.int64)
            if tuple(gt.shape[1:3]) != tuple(seg_logits.shape[1:3]):
                gt = resize_nearest(gt, seg_logits.shape[1:3])
            losses["loss_semantic_seg"] = 0.2 * semantic_seg_loss(seg_logits, gt)
        return sem_feat

    def loss(self, batch, anchors, num_level_anchors,
             generator: Optional[torch.Generator] = None,
             sample: Optional[RoISample] = None,
             rpn_uniforms=None, roi_uniforms=None,
             mask_uniforms=None) -> Dict[str, torch.Tensor]:
        """``CascadeDetector.loss`` plus ``loss_semantic_seg`` with a
        semantic head and, where the batch carries ``gt_mask_crops``,
        each stage's ``s{i}.loss_mask``.  HTC samples each stage's mask
        RoIs again from the stage's refined boxes: ``mask_uniforms`` (per
        stage ``(B, 2, G + R)``, ``R`` the stage's sampled slots) rank them
        instead of draws."""
        if sample is not None:
            raise NotImplementedError(_NO_SAMPLE)
        feats, rpn_outs, losses = self._rpn_losses(batch, anchors, num_level_anchors, generator,
                                                   rpn_uniforms)
        sem_feat = self._semantic(feats, batch, losses)
        with_mask = "gt_mask_crops" in batch and len(self.net.mask_heads) > 0
        gt_bboxes = self._tensor(batch["gt_bboxes"])
        cc = self.cascade_cfg
        stages = self._train_stages(feats, rpn_outs, batch, anchors, num_level_anchors,
                                    generator, roi_uniforms, sem_feat=sem_feat)
        for stage, (s, cls_s, reg_s, candidates) in enumerate(stages):
            flat = RoISample(*(x.reshape((-1,) + tuple(x.shape[2:])) for x in s))
            losses.update(cascade_stage_loss(
                cc, self.bbox_cfg, stage, cls_s, reg_s, flat,
                seesaw_counts=self._seesaw_counts(f"bbox_heads.{stage}", flat)))
            if not with_mask:
                continue
            ms = self._mask_sample(stage, s, candidates, batch, generator, mask_uniforms)
            logits = self.net.mask_out(feats, ms.boxes, ms.valid & ms.is_pos, stage, sem_feat)
            losses[f"s{stage}.loss_mask"] = cc.stage_loss_weights[stage] * self._mask_loss(
                logits, batch, ms, gt_bboxes)
        return losses

    def _mask_sample(self, stage: int, s: RoISample, candidates, batch,
                     generator: Optional[torch.Generator], mask_uniforms) -> RoISample:
        """The RoIs of stage ``stage``'s mask branch: HTC's (interleaved)
        the stage's refined boxes assigned and sampled again, Cascade Mask
        R-CNN's the stage's own sample."""
        if not self.cascade_cfg.interleaved:
            return s
        with torch.no_grad():
            return self._vmap_sample(*candidates, batch, generator, self._stage_cfg(stage),
                                     None if mask_uniforms is None else mask_uniforms[stage])

    @torch.no_grad()
    def mask_samples(self, batch, anchors, num_level_anchors,
                     generator: Optional[torch.Generator] = None, roi_uniforms=None,
                     mask_uniforms=None) -> List[RoISample]:
        """Each stage's mask-branch ``RoISample`` as ``loss`` draws them
        (HTC: the refined boxes sampled again; else the stage's sample),
        without gradient."""
        feats = self.net.features(self._tensor(batch["images"]))
        sem_feat = self._semantic(feats, batch)
        stages = self._train_stages(feats, self._rpn_flat(feats), batch, anchors,
                                    num_level_anchors, generator, roi_uniforms,
                                    sem_feat=sem_feat)
        return [self._mask_sample(stage, s, cand, batch, generator, mask_uniforms)
                for stage, (s, _, _, cand) in enumerate(stages)]

    @torch.no_grad()
    def stage_samples(self, batch, anchors, num_level_anchors,
                      generator: Optional[torch.Generator] = None,
                      roi_uniforms=None) -> List[RoISample]:
        """Each stage's box ``RoISample`` as ``loss`` draws them (the
        semantic embedding joins the box heads' features)."""
        feats = self.net.features(self._tensor(batch["images"]))
        stages = self._train_stages(feats, self._rpn_flat(feats), batch, anchors,
                                    num_level_anchors, generator, roi_uniforms,
                                    sem_feat=self._semantic(feats, batch))
        return [s for s, *_ in stages]

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor], anchors: torch.Tensor,
                num_level_anchors: Sequence[int], rescale: bool = True):
        """``(dets, labels, valid, masks)``: the box cascade's detections
        and each detection's ``(28, 28)`` float32 mask of its label, the
        mean of the stages' sigmoids (``TwoStageDetector.predict``'s
        layout)."""
        img_shape = self._tensor(batch["img_shape"])
        scale_factor = self._tensor(batch["scale_factor"])
        feats, boxes, scores, valid = self.proposals(batch["images"], img_shape, anchors,
                                                     num_level_anchors)
        sem_feat = self._semantic(feats, batch)
        dets, labels, dvalid = self.roi_predict(feats, boxes, scores, valid, img_shape,
                                                scale_factor, rescale, sem_feat=sem_feat)
        if not len(self.net.mask_heads):
            return dets, labels, dvalid
        b, d = labels.shape
        det_boxes = dets[..., :4]
        if rescale:
            det_boxes = det_boxes * scale_factor[:, None, :]
        stage_logits = self.net.mask_out_all_stages(feats, det_boxes, dvalid, sem_feat)
        m, c = stage_logits[0].shape[1], stage_logits[0].shape[-1]
        idx = torch.clamp(labels, 0, c - 1).reshape(b * d, 1, 1, 1).expand(-1, m, m, 1)
        # the label's channel of each stage's sigmoid, summed in stage order
        total = sum(torch.sigmoid(torch.gather(x, -1, idx)[..., 0]) for x in stage_logits)
        return dets, labels, dvalid, (total / float(len(stage_logits))).reshape(b, d, m, m)
