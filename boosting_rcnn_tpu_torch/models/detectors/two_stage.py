"""Two-stage detector (PyTorch port of
``boosting_rcnn_tpu/models/detectors/two_stage.py``).

``TwoStageNet`` holds the networks; ``TwoStageDetector`` owns the anchors,
the configs and the device, and runs ``predict`` (``FasterRCNN.simple_test``
+ ``ProbRoIHead.simple_test``): features, RPN proposals, multi-level
RoIAlign (the CUDA kernel on the GPU), the Shared2FC head, prior fusion
(or the plain softmax of ``StandardRoIHead``) and per-image multiclass
NMS, hard or soft (``RCNNTestCfg.nms_type``); with a mask head, the
14 x 14 RoIAlign of the detections and the FCN head give each
detection's 28 x 28 mask of its class.  ``loss`` is the
train forward (``forward_train``): the RPN runs once, its outputs give the
RPN losses and, detached, the train-config proposals, which are assigned
and sampled without gradient; the sampled RoIs go through RoIAlign
(forward and gradient kernels on the GPU) and the head into the R-CNN
loss, and the positive ones through the mask branch into the mask loss.

``rpn_type`` picks the RPN: ``"atss_rpn"`` (the flagship's ATSS RPN head,
with its IoU branch) or ``"rpn"`` (the plain RPN head of Faster and Mask
R-CNN, no IoU branch).

``aug_predict`` and ``aug_predict_multi`` are the flip and multi-scale
test-time augmentation (JAX ``two_stage.py:851-989``, the reference's
``MultiScaleFlipAug`` and ``merge_augs``): each view's proposals in the
original image's frame, merged by one NMS, each view's R-CNN scores and
decoded boxes on the merged proposals, averaged, and one multiclass NMS.

``DynamicRCNNDetector`` (Dynamic R-CNN, JAX ``two_stage.py:1131-1224``)
samples at the box head's working IoU threshold and takes its box loss at
the working beta; after the step's optimizer update the train step calls
``update_state``, which records the step's statistics in the head's
buffers (every detector has the method; only this one has a state).

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
from ...ops.box_ops import bbox_overlaps, clip_boxes, delta2bbox, hflip_boxes
from ...ops.nms import multiclass_nms_padded, nms_padded
from ...ops.roi_align_kernel import batched_multilevel_roi_align
from ..dense_heads.atss_rpn_head import (
    ATSSRPNCfg,
    atss_rpn_loss,
    atss_rpn_proposals,
    flatten_levels,
)
from ..dense_heads.rpn_head import RPNCfg, rpn_loss, rpn_proposals
from ..roi_heads.mask_head import mask_loss, resample_mask_targets
from ..roi_heads.bbox_head import BBoxHeadCfg, bbox_head_decode, bbox_targets
from ..roi_heads.prob_roi_head import (
    ProbRoICfg,
    RoISample,
    dynamic_rcnn_batch_stats,
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
    # "nms" or "soft_nms" (test_cfg.rcnn.nms.type), with soft-NMS's decay
    # ("linear" or "gaussian"), its sigma and the score a pick must pass
    nms_type: str = "nms"
    soft_sigma: float = 0.5
    soft_min_score: float = 1e-3
    soft_method: str = "linear"


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
        # eval mode (running BN averages) but inside the train step's loss
        # forward (engine/train.py::live_norms)
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
                     generator: Optional[torch.Generator] = None,
                     roi_cfg: Optional[ProbRoICfg] = None, uniforms=None) -> RoISample:
        """Assign and sample each image's RoIs (by ``roi_cfg``, the
        detector's when None); fields ``(B, R, ...)``.  Given ``uniforms``
        ``(B, 2, G + P)`` rank the candidates instead of draws."""
        gt_bboxes, gt_mask, gt_labels = self._gt(batch)
        if uniforms is not None:
            uniforms = self._tensor(uniforms)
        per_image = [
            sample_rois(roi_cfg or self.roi_cfg, prop_boxes[i], prop_scores[i], prop_valid[i],
                        gt_bboxes[i], gt_mask[i], gt_labels[i], generator=generator,
                        uniforms=None if uniforms is None else tuple(uniforms[i]))
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

    def _rpn_losses(self, batch, anchors, num_level_anchors,
                    generator: Optional[torch.Generator] = None, rpn_uniforms=None):
        """The features, the flat RPN outputs ``(cls, reg, iou)`` and the RPN
        losses of a batch (``loss``'s first part)."""
        gt_bboxes, gt_mask, _ = self._gt(batch)
        anchors = self._tensor(anchors)
        feats = self.net.features(self._tensor(batch["images"]))
        cls, reg, iou = self._rpn_flat(feats)
        valid = torch.ones(cls.shape, dtype=torch.bool, device=self.device)
        if self.rpn_type == "rpn":
            losses = rpn_loss(self.rpn_cfg, cls, reg, anchors, valid, gt_bboxes, gt_mask,
                              generator=generator,
                              uniforms=None if rpn_uniforms is None
                              else self._tensor(rpn_uniforms))
        else:
            losses = atss_rpn_loss(self.rpn_cfg, cls, reg, iou, anchors, valid,
                                   gt_bboxes, gt_mask, num_level_anchors)
        return feats, (cls, reg, iou), losses

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
        feats, (cls, reg, iou), losses = self._rpn_losses(batch, anchors, num_level_anchors,
                                                          generator, rpn_uniforms)
        gt_bboxes = self._tensor(batch["gt_bboxes"])
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
            logits = self.net.mask_out(feats, sample.boxes.float(),
                                       sample.valid.bool() & sample.is_pos.bool())
            losses["loss_mask"] = self._mask_loss(logits, batch, sample, gt_bboxes)
        return losses

    def update_state(self) -> None:
        """Carry the detector's adaptive state past a train step; the
        train step calls it after its update.  Only Dynamic R-CNN has a
        state."""

    def _mask_loss(self, logits: torch.Tensor, batch, sample: RoISample,
                   gt_bboxes: torch.Tensor) -> torch.Tensor:
        """The mask loss of the logits ``(B*R, m, m, K)`` of all ``B*R``
        sampled slots, the positive ones valid (JAX
        ``two_stage.py:687-715``), against the targets resampled from each
        image's ``gt_mask_crops``."""
        b = sample.boxes.shape[0]
        boxes = sample.boxes.float()
        crops = self._tensor(batch["gt_mask_crops"], torch.uint8)
        g = crops.shape[1]
        # every image's gts in one table: image i's gt j is row i * G + j
        gt_idx = (sample.gt_idx.long()
                  + g * torch.arange(b, device=self.device)[:, None]).reshape(-1)
        targets = resample_mask_targets(crops.reshape(b * g, *crops.shape[2:]),
                                        gt_bboxes.reshape(b * g, 4), boxes.reshape(-1, 4),
                                        gt_idx, out_size=logits.shape[1])
        is_pos = sample.is_pos.bool().reshape(-1)
        label = sample.matched_label.long().reshape(-1)
        labels = torch.where(is_pos, label, torch.zeros_like(label))
        return mask_loss(logits, targets, labels, is_pos & sample.valid.bool().reshape(-1))

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
                pre_nms_top_k=tc.pre_nms_top_k, nms_type=tc.nms_type, soft_sigma=tc.soft_sigma,
                soft_min_score=tc.soft_min_score, soft_method=tc.soft_method,
            )
            for i in range(b)
        ]
        dets, labels, valid = (torch.stack(x) for x in zip(*outs))
        return dets, labels, valid


def check_tta(detector) -> None:
    """Raise ``NotImplementedError`` where test-time augmentation cannot
    serve ``detector``: a cascade or HTC, whose net's ``roi_out`` takes a
    stage (JAX ``cascade.py:56``), so that the JAX ``aug_predict_multi``
    cannot serve it either."""
    if getattr(detector, "cascade_cfg", None) is not None:
        raise NotImplementedError(
            f"test-time augmentation is not ported for {type(detector).__name__}: a cascade's "
            f"roi_out takes a stage, and the JAX package's aug_predict_multi, which calls it "
            f"without one, cannot serve a cascade or HTC either")


def aug_predict(detector: TwoStageDetector, batch, anchors, num_level_anchors,
                rescale: bool = True):
    """Horizontal-flip test-time augmentation: ``aug_predict_multi`` over
    the batch and its mirror."""
    views = [(batch, anchors, num_level_anchors, False), (batch, anchors, num_level_anchors, True)]
    return aug_predict_multi(detector, views, rescale=rescale)


@torch.inference_mode()
def aug_proposals(detector: TwoStageDetector, views):
    """Steps 1-2 of ``aug_predict_multi``: each view's features and frame
    ``(feats, img_shape, scale_factor, mirror width or None)``, and the
    merged proposals ``(B, R, 4)`` in the original images' frame with their
    scores (zero in empty slots) and validity."""
    det = detector
    tc = det.test_proposal_cfg
    seen, props = [], []
    for batch, anchors, nla, flip in views:
        images = det._tensor(batch["images"])
        img_shape, scale = det._tensor(batch["img_shape"]), det._tensor(batch["scale_factor"])
        b, h, w = images.shape[:3]
        feats = det.net.features(images.flip(2) if flip else images)
        cls, reg, iou = det._rpn_flat(feats)
        canvas = img_shape.new_tensor([float(h), float(w)]).expand(b, 2)
        boxes, scores, valid = det._proposals(cls, reg, iou, anchors, nla,
                                              canvas if flip else img_shape, tc)
        if flip:
            boxes = clip_boxes(hflip_boxes(boxes, float(w)), img_shape)
        props.append((boxes / scale[:, None, :], scores, valid))
        seen.append((feats, img_shape, scale, float(w) if flip else None))
    merged = [torch.cat(x, dim=1) for x in zip(*props)]
    kept = [nms_padded(merged[0][i], merged[1][i], tc.nms_iou_thr, tc.max_per_img,
                       valid=merged[2][i]) for i in range(merged[0].shape[0])]
    boxes, scores, valid = (torch.stack(x) for x in list(zip(*kept))[:3])
    return seen, boxes, torch.where(valid, scores, torch.zeros_like(scores)), valid


def view_rois(boxes: torch.Tensor, scale_factor: torch.Tensor, flip_w) -> torch.Tensor:
    """Boxes ``(B, R, 4)`` of the original frame in a view's frame: times
    its ``scale_factor`` ``(B, 4)``, mirrored by the canvas width
    ``flip_w`` where it is not None."""
    rois = boxes * scale_factor[:, None, :]
    return rois if flip_w is None else hflip_boxes(rois, flip_w)


@torch.inference_mode()
def aug_predict_multi(detector: TwoStageDetector, views, rescale: bool = True):
    """Multi-scale and flip test-time augmentation of ``detector`` (JAX
    ``aug_predict_multi``): ``views`` is a list of ``(batch, anchors,
    num_level_anchors, flip)``, one for each (scale, flip), each batch the
    same images resized to its own canvas (``images``, ``img_shape``,
    ``scale_factor``, as ``predict`` takes them).

    1. per view: the features of the images, mirrored along the width for
       a flipped view, and the test-config proposals; a flipped view's are
       clipped to the canvas, mirrored back by the canvas width and clipped
       to ``img_shape``; every view's are divided by ``scale_factor``;
    2. one NMS over all views' proposals (``test_proposal_cfg``'s
       threshold and ``max_per_img``), the scores of empty slots zeroed
       (``aug_proposals``);
    3. per view: the merged proposals back in its frame, RoIAlign and the
       box head (``roi_out``), prior fusion or the float32 softmax, the
       deltas decoded and clipped to its ``img_shape``, mirrored back and
       divided by ``scale_factor``;
    4. the scores and boxes averaged over the views, one multiclass NMS
       (hard or soft, ``rcnn_test_cfg``).

    Returns ``(dets (B, max, 5), labels (B, max), valid (B, max))`` in the
    original images' frame (``rescale=False`` raises: the views merge
    there).  A mask head is not run: the result is boxes only, as the JAX
    package's.  Each view launches the RoIAlign forward once."""
    check_tta(detector)
    if not rescale:
        raise ValueError("aug_predict_multi merges its views in the original images' frame: "
                         "rescale=False is not supported")
    det = detector
    seen, boxes, scores, valid = aug_proposals(det, views)
    b, r = boxes.shape[:2]
    cfg = det.bbox_cfg
    fused_sum, boxes_sum = 0.0, 0.0
    for feats, img_shape, scale, flip_w in seen:
        rois = view_rois(boxes, scale, flip_w)
        cls_s, reg_s = det.net.roi_out(feats, rois, valid)
        cls_s, reg_s = cls_s.reshape(b, r, -1), reg_s.reshape(b, r, -1)
        fused_sum = fused_sum + (prob_fuse_scores(cls_s, scores) if det.roi_cfg.prob
                                 else torch.softmax(cls_s.float(), dim=-1))
        dec = delta2bbox(rois, reg_s, cfg.target_means, cfg.target_stds,
                         max_shape=img_shape).reshape(b, r, -1, 4)
        if flip_w is not None:
            dec = hflip_boxes(dec, flip_w)
        boxes_sum = boxes_sum + dec / scale[:, None, None, :]
    fused = fused_sum / len(views)
    c = cfg.num_classes
    dec = (boxes_sum / len(views)).expand(b, r, c, 4)
    t = det.rcnn_test_cfg
    outs = [multiclass_nms_padded(
        dec[i], fused[i, :, :c], score_thr=t.score_thr, iou_threshold=t.nms_iou_thr,
        max_per_img=t.max_per_img, valid=valid[i], pre_nms_top_k=t.pre_nms_top_k,
        nms_type=t.nms_type, soft_sigma=t.soft_sigma, soft_min_score=t.soft_min_score,
        soft_method=t.soft_method) for i in range(b)]
    return tuple(torch.stack(x) for x in zip(*outs))


_DYN_NO_SAMPLE = ("Dynamic R-CNN samples at the working IoU threshold of its state inside its "
                  "loss: it takes no external RoISample (the JAX package's raises too)")


class DynamicRCNNDetector(TwoStageDetector):
    """Dynamic R-CNN (reference ``roi_heads/dynamic_roi_head.py``,
    ``configs/dynamic_rcnn``): a two-stage detector whose RoI assigner IoU
    threshold and smooth-L1 beta adapt to the training statistics, held in
    the box head's buffers (``ConvFCBBoxHead(dynamic=True)``).

    ``loss`` samples the train proposals with all three assigner
    thresholds at the state's ``dyn_iou_thr`` and takes the box loss at
    its ``dyn_beta``, both as they stood at the start of the step, and
    keeps the step's statistics (``dynamic_rcnn_batch_stats``: the IoU
    one over *all* the proposals' max IoUs, not only the sampled ones; a
    beta statistic below 1e-15 counts as none); ``update_state`` then
    records them (``update_dynamic``), without gradient.  A ``loss`` call
    alone leaves the state as it was.  There is no external ``RoISample``
    (``train_sample`` and ``loss(sample=)`` raise): the sampler reads the
    state."""

    def __init__(self, *args, dyn_iou_topk: int = 75, dyn_beta_topk: int = 10, **kwargs):
        super().__init__(*args, **kwargs)
        if not getattr(self.net.bbox_head, "dynamic", False):
            raise ValueError("Dynamic R-CNN needs a box head with the dynamic state")
        self.dyn_iou_topk = dyn_iou_topk
        self.dyn_beta_topk = dyn_beta_topk
        self._dyn_stats = None

    def train_sample(self, *args, **kwargs):
        raise NotImplementedError(_DYN_NO_SAMPLE)

    def loss(self, batch, anchors, num_level_anchors,
             generator: Optional[torch.Generator] = None,
             sample: Optional[RoISample] = None,
             rpn_uniforms=None, roi_uniforms=None) -> Dict[str, torch.Tensor]:
        """``TwoStageDetector.loss`` (no mask branch) at the working
        threshold and beta; ``roi_uniforms`` ``(B, 2, G + P)`` rank the RoI
        sampler's candidates (the gt boxes, then the ``P`` train proposals)
        instead of draws."""
        if sample is not None:
            raise NotImplementedError(_DYN_NO_SAMPLE)
        feats, rpn_outs, losses = self._rpn_losses(batch, anchors, num_level_anchors,
                                                   generator, rpn_uniforms)
        head = self.net.bbox_head
        iou_thr, beta = head.dyn_iou_thr.clone(), head.dyn_beta.clone()
        with torch.no_grad():
            cls, reg, iou = (None if x is None else x.detach() for x in rpn_outs)
            boxes, scores, valid = self._proposals(cls, reg, iou, anchors, num_level_anchors,
                                                   batch["img_shape"], self.train_proposal_cfg)
            roi_cfg = dataclasses.replace(self.roi_cfg, pos_iou_thr=iou_thr,
                                          neg_iou_thr=iou_thr, min_pos_iou=iou_thr)
            sample = self._vmap_sample(boxes, scores, valid, batch, generator, roi_cfg,
                                       roi_uniforms)
            gt_bboxes, gt_mask, _ = self._gt(batch)
            overlaps = torch.where(gt_mask[:, None, :], bbox_overlaps(boxes, gt_bboxes),
                                   boxes.new_zeros(()))
            max_overlaps = torch.where(valid, overlaps.max(-1).values, boxes.new_zeros(()))
        cls_s, reg_s = self.net.roi_out(feats, sample.boxes, sample.valid)
        flat = RoISample(*(x.reshape((-1,) + tuple(x.shape[2:])) for x in sample))
        losses.update(prob_roi_loss(self.roi_cfg, self.bbox_cfg, cls_s, reg_s, flat,
                                    beta_override=beta))
        with torch.no_grad():
            labels = torch.where(flat.is_pos, flat.matched_label,
                                 torch.full_like(flat.matched_label, self.bbox_cfg.num_classes))
            _, _, targets, _ = bbox_targets(self.bbox_cfg, flat.boxes, flat.is_pos, flat.valid,
                                            flat.matched_gt, labels)
            batch_iou, batch_beta = dynamic_rcnn_batch_stats(
                max_overlaps, valid, targets, flat.is_pos & flat.valid,
                iou_topk=self.dyn_iou_topk, beta_topk=self.dyn_beta_topk)
            batch_beta = torch.where(batch_beta < 1e-15, batch_beta.new_full((), torch.nan),
                                     batch_beta)
        self._dyn_stats = (batch_iou, batch_beta)
        return losses

    def update_state(self) -> None:
        """Record the last ``loss``'s statistics in the head's state."""
        if self._dyn_stats is not None:
            self.net.bbox_head.update_dynamic(*self._dyn_stats)
            self._dyn_stats = None
