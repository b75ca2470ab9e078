"""Two-stage detector, inference (PyTorch port of
``boosting_rcnn_tpu/models/detectors/two_stage.py``).

``TwoStageNet`` holds the networks; ``TwoStageDetector`` owns the anchors,
the configs and the device, and runs ``predict`` (``FasterRCNN.simple_test``
+ ``ProbRoIHead.simple_test``): features, RPN proposals, multi-level
RoIAlign (the CUDA kernel on the GPU), the Shared2FC head, prior fusion and
per-image multiclass NMS.

Layouts at the public functions are the JAX package's: images
``(B, H, W, 3)``, pyramid levels ``(B, H, W, C)``, pooled RoI features
``(B, R, 7, 7, C)``.  The convolutions run on NCHW views of the same
tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...ops.anchors import AnchorGenerator
from ...ops.roi_align_kernel import batched_multilevel_roi_align
from ..dense_heads.atss_rpn_head import ATSSRPNCfg, atss_rpn_proposals, flatten_levels
from ..roi_heads.bbox_head import BBoxHeadCfg, bbox_head_decode
from ..roi_heads.prob_roi_head import ProbRoICfg, prob_fuse_scores


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
                 device: torch.device, test_proposal_cfg: ProposalCfg = ProposalCfg(),
                 rcnn_test_cfg: RCNNTestCfg = RCNNTestCfg()):
        self.net = net.to(device).eval()
        self.anchor_generator = anchor_generator
        self.rpn_cfg = rpn_cfg
        self.roi_cfg = roi_cfg
        self.bbox_cfg = bbox_cfg
        self.device = torch.device(device)
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

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

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
        cls_l, reg_l, iou_l = self.net.rpn_out(feats)
        pc = self.test_proposal_cfg
        boxes, scores, valid = atss_rpn_proposals(
            self.rpn_cfg, flatten_levels(cls_l, 1)[..., 0], flatten_levels(reg_l, 4),
            flatten_levels(iou_l, 1)[..., 0], self._tensor(anchors),
            num_level_anchors, self._tensor(img_shape), nms_pre=pc.nms_pre,
            max_per_img=pc.max_per_img, nms_iou_thr=pc.nms_iou_thr,
            min_bbox_size=pc.min_bbox_size,
        )
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
