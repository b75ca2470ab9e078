"""Two-stage detector (PyTorch port of
``boosting_rcnn_tpu/models/detectors/two_stage.py``).

``TwoStageNet`` holds the networks; ``TwoStageDetector`` owns the anchors,
the configs and the device, and runs ``predict`` (``FasterRCNN.simple_test``
+ ``ProbRoIHead.simple_test``): features, RPN proposals, multi-level
RoIAlign (the CUDA kernel on the GPU), the Shared2FC head, prior fusion
(or the plain softmax of ``StandardRoIHead``) and per-image multiclass
NMS; with a mask head, the 14 x 14 RoIAlign of the detections and the FCN
head give each detection's 28 x 28 mask of its class.  ``loss`` is the
train forward (``forward_train``): the RPN runs once, its outputs give the
RPN losses and, detached, the train-config proposals, which are assigned
and sampled without gradient; the sampled RoIs go through RoIAlign
(forward and gradient kernels on the GPU) and the head into the R-CNN
loss, and the positive ones through the mask branch into the mask loss.

``rpn_type`` picks the RPN: ``"atss_rpn"`` (the flagship's ATSS RPN head,
with its IoU branch) or ``"rpn"`` (the plain RPN head of Faster and Mask
R-CNN, no IoU branch).

Layouts at the public functions are the JAX package's: images
``(B, H, W, 3)``, pyramid levels ``(B, H, W, C)``, pooled RoI features
``(B, R, k, k, C)``, mask logits ``(B*R, 28, 28, K)``.  The convolutions
run on NCHW views of the same tensors (channels-last memory).

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
from ..dense_heads.rpn_head import RPNCfg, rpn_loss, rpn_proposals
from ..roi_heads.mask_head import mask_loss, resample_mask_targets
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
                 roi_finest_scale: int = 56, mask_head: Optional[nn.Module] = None,
                 mask_roi_out_size: int = 14):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn = rpn
        self.bbox_head = bbox_head
        self.mask_head = mask_head
        self.roi_strides = tuple(roi_strides)
        self.roi_out_size = roi_out_size
        self.mask_roi_out_size = mask_roi_out_size
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
        return self.bbox_head(self._pool(feats, rois, roi_valid, self.roi_out_size))

    def mask_out(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 roi_valid: torch.Tensor) -> torch.Tensor:
        """``feats`` L x ``(B, H, W, C)``, ``rois`` ``(B, R, 4)`` -> mask
        logits ``(B*R, 28, 28, K)`` float32: one RoIAlign at
        ``mask_roi_out_size`` over all B*R RoIs (zeros for the invalid ones),
        then the FCN head (JAX ``TwoStageNet.mask_out``, the extractor of
        the box branch)."""
        return self.mask_head(self._pool(feats, rois, roi_valid, self.mask_roi_out_size))

    def _pool(self, feats, rois, roi_valid, out_size: int) -> torch.Tensor:
        """``(B*R, out, out, C)`` pooled RoI features over the route levels
        of ``roi_strides`` (the levels past them feed only the RPN)."""
        b, r, _ = rois.shape
        pooled = batched_multilevel_roi_align(
            feats, rois, roi_valid, self.roi_strides, out_size=out_size,
            sample_num=self.roi_sample_num, finest_scale=self.roi_finest_scale,
            num_route_levels=len(self.roi_strides),
        )
        return pooled.reshape(b * r, out_size, out_size, -1)


class TwoStageDetector:
    """Anchors, configs and the device around a ``TwoStageNet``."""

    def __init__(self, net: TwoStageNet, anchor_generator: AnchorGenerator,
                 rpn_cfg: ATSSRPNCfg | RPNCfg, roi_cfg: ProbRoICfg, bbox_cfg: BBoxHeadCfg,
                 device: torch.device,
                 train_proposal_cfg: ProposalCfg = ProposalCfg(4000, 2000),
                 test_proposal_cfg: ProposalCfg = ProposalCfg(),
                 rcnn_test_cfg: RCNNTestCfg = RCNNTestCfg(),
                 rpn_type: str = "atss_rpn"):
        if rpn_type not in ("atss_rpn", "rpn"):
            raise NotImplementedError(f"rpn_type={rpn_type!r} is not ported")
        self.rpn_type = rpn_type
        # eval mode throughout: the ported models have only frozen BN and
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
        """Flat RPN outputs: cls logits ``(B, A)``, deltas ``(B, A, 4)``
        and the iou logits ``(B, A)`` (None for the plain RPN)."""
        cls_l, reg_l, iou_l = self.net.rpn_out(feats)
        iou = None if iou_l is None else flatten_levels(iou_l, 1)[..., 0]
        return flatten_levels(cls_l, 1)[..., 0], flatten_levels(reg_l, 4), iou

    def _proposals(self, cls, reg, iou, anchors, num_level_anchors, img_shape,
                   pc: ProposalCfg):
        kw = dict(nms_pre=pc.nms_pre, max_per_img=pc.max_per_img,
                  nms_iou_thr=pc.nms_iou_thr, min_bbox_size=pc.min_bbox_size)
        anchors, img_shape = self._tensor(anchors), self._tensor(img_shape)
        if self.rpn_type == "rpn":
            return rpn_proposals(self.rpn_cfg, cls, reg, anchors, num_level_anchors, img_shape,
                                 **kw)
        return atss_rpn_proposals(self.rpn_cfg, cls, reg, iou, anchors, num_level_anchors,
                                  img_shape, **kw)

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
        cls, reg, iou = (None if x is None else x.detach() for x in rpn_outs)
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
             sample: Optional[RoISample] = None,
             rpn_uniforms=None) -> Dict[str, torch.Tensor]:
        """Forward and losses of a padded batch on the detector's device.

        ``batch``: ``images`` ``(B, H, W, 3)``, ``gt_bboxes`` ``(B, G, 4)``,
        ``gt_labels`` ``(B, G)``, ``gt_mask`` ``(B, G)``, ``img_shape``
        ``(B, 2)``, and for a mask head ``gt_mask_crops`` ``(B, G, S, S)``
        (each gt's mask relative to its box; without them, as in the JAX
        package, there is no mask loss); tensors or numpy arrays.
        ``generator`` drives the samplers (the plain RPN's anchor sampler,
        then the RoI sampler).  A given ``sample`` (fields ``(B, R, ...)``)
        skips the proposals and the RoI sampling; given ``rpn_uniforms``
        ``(B, 2, A)`` rank the plain RPN's anchors instead of draws.
        Returns the five losses (ATSS RPN: ``loss_rpn_cls``,
        ``loss_rpn_bbox``, ``loss_rpn_iou``, ``loss_cls``, ``loss_bbox``;
        plain RPN: the first two, the R-CNN's two and ``loss_mask``)."""
        images = self._tensor(batch["images"])
        gt_bboxes, gt_mask, _ = self._gt(batch)
        anchors = self._tensor(anchors)
        feats = self.net.features(images)
        cls, reg, iou = self._rpn_flat(feats)
        valid = torch.ones(cls.shape, dtype=torch.bool, device=self.device)
        if self.rpn_type == "rpn":
            losses = rpn_loss(self.rpn_cfg, cls, reg, anchors, valid, gt_bboxes, gt_mask,
                              generator=generator,
                              uniforms=None if rpn_uniforms is None
                              else self._tensor(rpn_uniforms))
        else:
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
        if self.net.mask_head is not None and "gt_mask_crops" in batch:
            losses["loss_mask"] = self._mask_loss(feats, batch, sample, flat, gt_bboxes)
        return losses

    def _mask_loss(self, feats, batch, sample: RoISample, flat: RoISample,
                   gt_bboxes: torch.Tensor) -> torch.Tensor:
        """The mask branch on all ``B*R`` sampled slots, the positive ones
        valid (JAX ``two_stage.py:687-715``), against the targets resampled
        from each image's ``gt_mask_crops``."""
        b = sample.boxes.shape[0]
        boxes = sample.boxes.float()
        logits = self.net.mask_out(feats, boxes, sample.valid.bool() & sample.is_pos.bool())
        crops = self._tensor(batch["gt_mask_crops"], torch.uint8)
        g = crops.shape[1]
        # every image's gts in one table: image i's gt j is row i * G + j
        gt_idx = (sample.gt_idx.long()
                  + g * torch.arange(b, device=self.device)[:, None]).reshape(-1)
        targets = resample_mask_targets(crops.reshape(b * g, *crops.shape[2:]),
                                        gt_bboxes.reshape(b * g, 4), boxes.reshape(-1, 4),
                                        gt_idx, out_size=logits.shape[1])
        labels = torch.where(flat.is_pos, flat.matched_label, torch.zeros_like(flat.matched_label))
        return mask_loss(logits, targets, labels, flat.is_pos & flat.valid)

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor], anchors: torch.Tensor,
                num_level_anchors: Sequence[int], rescale: bool = True):
        """Batched inference on the detector's device.

        ``batch``: ``images`` ``(B, H, W, 3)``, ``img_shape`` ``(B, 2)``
        valid (H, W), ``scale_factor`` ``(B, 4)``; tensors or numpy arrays.
        Returns ``(dets (B, max, 5), labels (B, max), valid (B, max))``,
        and with a mask head ``masks`` ``(B, max, 28, 28)`` float32 too: the
        sigmoid of each detection's logits of its class, in its box, not
        pasted into the image (as the JAX package's ``predict``).
        """
        img_shape = self._tensor(batch["img_shape"])
        scale_factor = self._tensor(batch["scale_factor"])
        feats, boxes, scores, valid = self.proposals(
            batch["images"], img_shape, anchors, num_level_anchors)
        out = self.roi_predict(feats, boxes, scores, valid, img_shape, scale_factor, rescale)
        if self.net.mask_head is None:
            return out
        return (*out, self.mask_predict(feats, *out, scale_factor, rescale))

    @torch.inference_mode()
    def mask_predict(self, feats, dets, labels, valid, scale_factor, rescale: bool = True):
        """The mask branch of ``predict`` (JAX ``two_stage.py:806-826``) on
        detections ``(B, D, 5)`` of ``labels`` and ``valid`` ``(B, D)``:
        the boxes back in the padded image's frame, one RoIAlign at
        ``mask_roi_out_size`` and the FCN head, then the sigmoid of each
        detection's class channel -> ``(B, D, 28, 28)`` float32."""
        b, d = labels.shape
        boxes = dets[..., :4]
        if rescale:
            boxes = boxes * scale_factor[:, None, :]
        logits = self.net.mask_out(feats, boxes, valid)
        m, c = logits.shape[1], logits.shape[-1]
        idx = torch.clamp(labels, 0, c - 1).reshape(b * d, 1, 1, 1).expand(-1, m, m, 1)
        sel = torch.gather(logits, -1, idx)[..., 0]
        return torch.sigmoid(sel.float()).reshape(b, d, m, m)

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
