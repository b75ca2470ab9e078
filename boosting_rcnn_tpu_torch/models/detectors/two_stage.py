"""Two-stage detector (PyTorch port of
``boosting_rcnn_tpu/models/detectors/two_stage.py``).

``TwoStageNet`` holds the networks; ``TwoStageDetector`` owns the anchors,
the configs and the device, and runs ``predict`` (``FasterRCNN.simple_test``
+ ``ProbRoIHead.simple_test``): features, RPN proposals, multi-level
RoIAlign (the CUDA kernel on the GPU), the Shared2FC head, prior fusion and
per-image multiclass NMS.  ``loss`` is the train forward
(``forward_train``): the RPN runs once, its outputs give the RPN losses and,
detached, the train-config proposals, which are assigned and sampled
without gradient; the sampled RoIs go through RoIAlign (forward and
gradient kernels on the GPU) and the head into the boosting R-CNN loss.

Layouts at the public functions are the JAX package's: images
``(B, H, W, 3)``, pyramid levels ``(B, H, W, C)``, pooled RoI features
``(B, R, 7, 7, C)``.  The convolutions run on NCHW views of the same
tensors (channels-last memory).

Dtypes follow the JAX package's cast points: ``features``, the RPN's cls
and iou maps, the pooled RoI features and the head's cls and reg are in
the compute dtype (``builder.build_detector(dtype=)``); the RPN's reg is
float32 after its ``Scale``; the proposals' scores, the softmax of the
R-CNN scores and the prior fusion are float32 (JAX ``two_stage.py:793``,
``prob_roi_head.py:209``); the decoders take the deltas in their own
dtype, as ``delta2bbox`` does there; ``loss`` returns float32 losses.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...ops.anchors import AnchorGenerator
from ...ops.roi_align_kernel import batched_multilevel_roi_align
from ..dense_heads.atss_rpn_head import (
    ATSSRPNCfg,
    atss_rpn_loss,
    atss_rpn_proposals,
    flatten_levels,
)
from ..roi_heads.bbox_head import BBoxHeadCfg, bbox_head_decode
from ..roi_heads.prob_roi_head import (
    ProbRoICfg,
    RoISample,
    prob_fuse_scores,
    prob_roi_loss,
    sample_rois,
)


@dataclasses.dataclass(frozen=True)
class ProposalCfg:
    nms_pre: int = 1000
    max_per_img: int = 256
    nms_iou_thr: float = 0.7
    min_bbox_size: float = 0.0


@dataclasses.dataclass(frozen=True)
class RCNNTestCfg:
    score_thr: float = 0.05
    nms_iou_thr: float = 0.7
    max_per_img: int = 100
    # static cap on score-passing candidates entering NMS (a documented
    # deviation of the JAX package, kept by the port)
    pre_nms_top_k: int = 2048


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class TwoStageNet(nn.Module):
    """All networks of the two-stage detector."""

    def __init__(self, backbone: nn.Module, neck: nn.Module, rpn: nn.Module,
                 bbox_head: nn.Module, roi_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 roi_out_size: int = 7, roi_sample_num: int = 2,
                 roi_finest_scale: int = 56):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn = rpn
        self.bbox_head = bbox_head
        self.roi_strides = tuple(roi_strides)
        self.roi_out_size = roi_out_size
        self.roi_sample_num = roi_sample_num
        self.roi_finest_scale = roi_finest_scale

    def features(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``(B, H, W, 3)`` images -> neck levels, each ``(B, H, W, C)``."""
        outs = self.neck(self.backbone(_nchw(images)))
        return tuple(_nhwc(x) for x in outs)

    def rpn_out(self, feats: Sequence[torch.Tensor]):
        """Per-level ``(B, H, W, C)`` features -> per-level NCHW
        (cls, reg, iou) maps."""
        return self.rpn([_nchw(f) for f in feats])

    def roi_out(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                roi_valid: torch.Tensor):
        """``feats`` L x ``(B, H, W, C)``, ``rois`` ``(B, R, 4)`` -> (cls
        ``(B*R, K+1)``, reg ``(B*R, 4K)``), one RoIAlign over all B*R RoIs."""
        b, r, _ = rois.shape
        pooled = batched_multilevel_roi_align(
            feats, rois, roi_valid, self.roi_strides, out_size=self.roi_out_size,
            sample_num=self.roi_sample_num, finest_scale=self.roi_finest_scale,
            num_route_levels=len(self.roi_strides),
        )
        pooled = pooled.reshape(b * r, self.roi_out_size, self.roi_out_size, -1)
        return self.bbox_head(pooled)


class TwoStageDetector:
    """Anchors, configs and the device around a ``TwoStageNet``."""

    def __init__(self, net: TwoStageNet, anchor_generator: AnchorGenerator,
                 rpn_cfg: ATSSRPNCfg, roi_cfg: ProbRoICfg, bbox_cfg: BBoxHeadCfg,
                 device: torch.device,
                 train_proposal_cfg: ProposalCfg = ProposalCfg(4000, 2000),
                 test_proposal_cfg: ProposalCfg = ProposalCfg(),
                 rcnn_test_cfg: RCNNTestCfg = RCNNTestCfg()):
        # eval mode throughout: the flagship has only frozen BN and
        # GroupNorm, which compute the same in both modes
        self.net = net.to(device).eval()
        self.anchor_generator = anchor_generator
        self.rpn_cfg = rpn_cfg
        self.roi_cfg = roi_cfg
        self.bbox_cfg = bbox_cfg
        self.device = torch.device(device)
        self.train_proposal_cfg = train_proposal_cfg
        self.test_proposal_cfg = test_proposal_cfg
        self.rcnn_test_cfg = rcnn_test_cfg

    def featmap_sizes(self, canvas_hw: Tuple[int, int]):
        return [
            (math.ceil(canvas_hw[0] / s[1]), math.ceil(canvas_hw[1] / s[0]))
            for s in self.anchor_generator.strides
        ]

    def anchors_for(self, canvas_hw: Tuple[int, int]):
        """Flat anchors ``(A, 4)`` on the detector's device and the anchor
        count of each level."""
        per_level = self.anchor_generator.grid_anchors(self.featmap_sizes(canvas_hw))
        flat = torch.from_numpy(np.concatenate(per_level)).to(self.device)
        return flat, tuple(a.shape[0] for a in per_level)

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _rpn_flat(self, feats):
        """Flat RPN outputs: cls and iou logits ``(B, A)``, deltas
        ``(B, A, 4)``."""
        cls_l, reg_l, iou_l = self.net.rpn_out(feats)
        return (flatten_levels(cls_l, 1)[..., 0], flatten_levels(reg_l, 4),
                flatten_levels(iou_l, 1)[..., 0])

    def _proposals(self, cls, reg, iou, anchors, num_level_anchors, img_shape,
                   pc: ProposalCfg):
        return atss_rpn_proposals(
            self.rpn_cfg, cls, reg, iou, self._tensor(anchors), num_level_anchors,
            self._tensor(img_shape), nms_pre=pc.nms_pre, max_per_img=pc.max_per_img,
            nms_iou_thr=pc.nms_iou_thr, min_bbox_size=pc.min_bbox_size)

    # ---------- training ----------
    def _gt(self, batch):
        return (self._tensor(batch["gt_bboxes"]), self._tensor(batch["gt_mask"], torch.bool),
                self._tensor(batch["gt_labels"], torch.int64))

    def _vmap_sample(self, prop_boxes, prop_scores, prop_valid, batch,
                     generator: Optional[torch.Generator] = None) -> RoISample:
        """Assign and sample each image's RoIs; fields ``(B, R, ...)``."""
        gt_bboxes, gt_mask, gt_labels = self._gt(batch)
        per_image = [
            sample_rois(self.roi_cfg, prop_boxes[i], prop_scores[i], prop_valid[i],
                        gt_bboxes[i], gt_mask[i], gt_labels[i], generator=generator)
            for i in range(prop_boxes.shape[0])
        ]
        return RoISample(*(torch.stack(x) for x in zip(*per_image)))

    @torch.no_grad()
    def sample_from_rpn_outs(self, rpn_outs, batch, anchors, num_level_anchors,
                             generator: Optional[torch.Generator] = None) -> RoISample:
        """Train-config proposals from flat RPN outputs ``(cls, reg, iou)``,
        then RoI sampling; no gradient."""
        cls, reg, iou = (x.detach() for x in rpn_outs)
        boxes, scores, valid = self._proposals(
            cls, reg, iou, anchors, num_level_anchors, batch["img_shape"],
            self.train_proposal_cfg)
        return self._vmap_sample(boxes, scores, valid, batch, generator)

    @torch.no_grad()
    def train_sample(self, batch, anchors, num_level_anchors,
                     generator: Optional[torch.Generator] = None) -> RoISample:
        """A forward without gradient to the train ``RoISample``, for the
        ``external`` train step."""
        feats = self.net.features(self._tensor(batch["images"]))
        return self.sample_from_rpn_outs(self._rpn_flat(feats), batch, anchors,
                                         num_level_anchors, generator)

    def loss(self, batch, anchors, num_level_anchors,
             generator: Optional[torch.Generator] = None,
             sample: Optional[RoISample] = None) -> Dict[str, torch.Tensor]:
        """Forward and losses of a padded batch on the detector's device.

        ``batch``: ``images`` ``(B, H, W, 3)``, ``gt_bboxes`` ``(B, G, 4)``,
        ``gt_labels`` ``(B, G)``, ``gt_mask`` ``(B, G)``, ``img_shape``
        ``(B, 2)``; tensors or numpy arrays.  ``generator`` drives the RoI
        sampler.  A given ``sample`` (fields ``(B, R, ...)``) skips the
        proposals and the sampling.  Returns the five losses."""
        images = self._tensor(batch["images"])
        gt_bboxes, gt_mask, _ = self._gt(batch)
        anchors = self._tensor(anchors)
        feats = self.net.features(images)
        cls, reg, iou = self._rpn_flat(feats)
        valid = torch.ones(cls.shape, dtype=torch.bool, device=self.device)
        losses = atss_rpn_loss(self.rpn_cfg, cls, reg, iou, anchors, valid,
                               gt_bboxes, gt_mask)
        if sample is None:
            sample = self.sample_from_rpn_outs((cls, reg, iou), batch, anchors,
                                               num_level_anchors, generator)
        else:
            sample = RoISample(*(torch.as_tensor(x, device=self.device) for x in sample))
        cls_s, reg_s = self.net.roi_out(feats, sample.boxes.float(), sample.valid.bool())
        flat = RoISample(*(x.reshape((-1,) + tuple(x.shape[2:])) for x in sample))
        flat = flat._replace(matched_label=flat.matched_label.long(),
                             is_pos=flat.is_pos.bool(), valid=flat.valid.bool())
        losses.update(prob_roi_loss(self.roi_cfg, self.bbox_cfg, cls_s, reg_s, flat))
        return losses

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor], anchors: torch.Tensor,
                num_level_anchors: Sequence[int], rescale: bool = True):
        """Batched inference on the detector's device.

        ``batch``: ``images`` ``(B, H, W, 3)``, ``img_shape`` ``(B, 2)``
        valid (H, W), ``scale_factor`` ``(B, 4)``; tensors or numpy arrays.
        Returns ``(dets (B, max, 5), labels (B, max), valid (B, max))``.
        """
        img_shape = self._tensor(batch["img_shape"])
        feats, boxes, scores, valid = self.proposals(
            batch["images"], img_shape, anchors, num_level_anchors)
        return self.roi_predict(feats, boxes, scores, valid, img_shape,
                                self._tensor(batch["scale_factor"]), rescale)

    @torch.inference_mode()
    def proposals(self, images, img_shape, anchors: torch.Tensor,
                  num_level_anchors: Sequence[int]):
        """The first stage of ``predict``: neck levels ``(B, H, W, C)`` and
        the test-cfg proposals ``(B, R, 4)`` with their prior scores and
        validity."""
        feats = self.net.features(self._tensor(images))
        cls, reg, iou = self._rpn_flat(feats)
        boxes, scores, valid = self._proposals(cls, reg, iou, anchors, num_level_anchors,
                                               img_shape, self.test_proposal_cfg)
        return feats, boxes, scores, valid

    @torch.inference_mode()
    def roi_predict(self, feats, prop_boxes, prop_scores, prop_valid, img_shape,
                    scale_factor, rescale: bool = True):
        """The RoI stage of ``predict`` on given proposals ``(B, R, 4)``,
        their prior scores and validity."""
        b, r = prop_boxes.shape[:2]
        cls_s, reg_s = self.net.roi_out(feats, prop_boxes, prop_valid)
        cls_s = cls_s.reshape(b, r, -1)
        reg_s = reg_s.reshape(b, r, -1)
        if self.roi_cfg.prob:
            fused = prob_fuse_scores(cls_s, prop_scores)
        else:
            fused = torch.softmax(cls_s.float(), dim=-1)
        tc = self.rcnn_test_cfg
        outs = [
            bbox_head_decode(
                self.bbox_cfg, prop_boxes[i], fused[i], reg_s[i], img_shape[i],
                scale_factor[i], rescale, tc.score_thr, tc.nms_iou_thr,
                tc.max_per_img, roi_valid=prop_valid[i],
                pre_nms_top_k=tc.pre_nms_top_k,
            )
            for i in range(b)
        ]
        dets, labels, valid = (torch.stack(x) for x in zip(*outs))
        return dets, labels, valid
