"""Build a two-stage detector from a model config (PyTorch port of the
two-stage branch of ``boosting_rcnn_tpu/builder.py::build_detector``).

Ported types: ``FasterRCNN`` and ``MaskRCNN`` with ``ResNet`` (depth 18 or
50, pytorch style, frozen BN, ``frozen_stages``); the neck ``PAFPN``
(extra convs on output) or ``FPN`` (extra levels by max pool); the RPN
``ATSSRPNHead`` (max-IoU assignment, focal / IoU / MSE / BCE losses) or
``RPNHead`` (one 3x3 conv, BCE and smooth L1, a random anchor sampler);
the RoI head ``ProbRoIHead`` (boosting loss, prior fusion) or
``StandardRoIHead`` (plain cross entropy, softmax scores), each with a
random sampler and a Shared2FC box head with cross entropy and L1; and an
``FCNMaskHead`` on a 14 x 14 ``RoIAlign`` (Mask R-CNN).  The ``train_cfg``
is read as the JAX builder reads it.  Any type or value the port does not
implement raises ``NotImplementedError`` naming it.

Weights are seeded random (flax-default initialisers drawn from a
``torch.Generator``); ``weights.from_jax_params`` loads the JAX package's.
``dtype`` is the compute dtype, float32 or bfloat16, as the JAX builder's
``dtype``: the parameters are float32 in both (``models/layers.py`` casts
them at each call), so one state dict serves both.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .models.backbones.resnet import ResNet
from .models.dense_heads.atss_rpn_head import ATSSRPNCfg, ATSSRPNConvs
from .models.dense_heads.rpn_head import RPNCfg, RPNConvs
from .models.detectors.two_stage import (
    ProposalCfg,
    RCNNTestCfg,
    TwoStageDetector,
    TwoStageNet,
)
from .models.layers import set_compute_dtype
from .models.necks.fpn import FPN, PAFPN
from .models.roi_heads.bbox_head import BBoxHeadCfg, ConvFCBBoxHead
from .models.roi_heads.mask_head import FCNMaskHead
from .models.roi_heads.prob_roi_head import ProbRoICfg
from .ops.anchors import AnchorGenerator

__all__ = ["COMPUTE_DTYPES", "build_detector", "resolve_device"]

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the GPU; with no GPU and no ``device`` the
    call raises instead of running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def _unported(what: str, value) -> NotImplementedError:
    return NotImplementedError(f"{what}={value!r} is not ported to PyTorch yet")


def _check(cfg: Dict[str, Any], key: str, allowed, default=None) -> None:
    value = cfg.get(key, default)
    if value not in allowed:
        raise _unported(key, value)


def _build_backbone(cfg: Dict[str, Any], gen: torch.Generator) -> ResNet:
    _check(cfg, "type", ("ResNet",))
    for key in ("dcn", "plugins", "conv_cfg", "norm_cfg"):
        _check(cfg, key, (None,))
    _check(cfg, "style", ("pytorch",), "pytorch")
    _check(cfg, "deep_stem", (False,), False)
    _check(cfg, "norm_eval", (True,), True)
    _check(cfg, "num_stages", (4,), 4)
    for key, value in (("dilations", (1, 1, 1, 1)), ("strides", (1, 2, 2, 2)),
                       ("out_indices", (0, 1, 2, 3))):
        _check({key: tuple(cfg.get(key, value))}, key, (value,))
    return ResNet(gen, depth=cfg.get("depth", 50),
                  base_channels=cfg.get("base_channels", 64),
                  frozen_stages=cfg.get("frozen_stages", -1))


def _build_neck(cfg: Dict[str, Any], gen: torch.Generator):
    _check(cfg, "type", ("PAFPN", "FPN"))
    if cfg["type"] == "FPN":
        # the one FPN of the ported configs (Mask R-CNN's): no norm, extra
        # levels by max pool, every backbone stage used
        for key, value in (("add_extra_convs", False), ("norm_cfg", None), ("conv_cfg", None),
                           ("act", None), ("start_level", 0), ("end_level", -1)):
            if cfg.get(key, value) != value:
                raise _unported(f"FPN {key}", cfg[key])
        return FPN(gen, in_channels=cfg["in_channels"],
                   out_channels=cfg.get("out_channels", 256), num_outs=cfg.get("num_outs", 5))
    _check(cfg, "norm_cfg", (None,))
    _check(cfg, "no_norm_on_lateral", (False,), False)
    _check(cfg, "add_extra_convs", ("on_output",), False)
    _check(cfg, "relu_before_extra_convs", (False,), False)
    return PAFPN(
        gen,
        in_channels=cfg["in_channels"],
        out_channels=cfg.get("out_channels", 256),
        num_outs=cfg.get("num_outs", 5),
        start_level=cfg.get("start_level", 0),
        end_level=cfg.get("end_level", -1),
    )


def _coder(cfg: Dict[str, Any], stds):
    coder = cfg.get("bbox_coder", {})
    return (tuple(coder.get("target_means", (0.0,) * 4)),
            tuple(coder.get("target_stds", stds)))


def _only(cfg: Dict[str, Any], what: str, keys) -> None:
    """Raise on keys of ``cfg`` that the port does not read."""
    extra = sorted(set(cfg) - set(keys))
    if extra:
        raise NotImplementedError(f"{what}: {extra} not ported to PyTorch yet")


_LOSS_KEYS = {
    "FocalLoss": ("type", "use_sigmoid", "gamma", "alpha", "loss_weight"),
    "IoULoss": ("type", "linear", "mode", "loss_weight"),
    "CrossEntropyLoss": ("type", "use_sigmoid", "use_mask", "class_weight", "loss_weight"),
    "MSELoss": ("type", "loss_weight"),
    "L1Loss": ("type", "loss_weight"),
    "SmoothL1Loss": ("type", "beta", "loss_weight"),
}


def _loss(cfg: Dict[str, Any], key: str, types, default=None) -> Dict[str, Any]:
    """The loss config ``cfg[key]``, its type checked against ``types``."""
    loss = cfg.get(key) or dict(default or {})
    if loss.get("type") not in types:
        raise _unported(f"{key}.type", loss.get("type"))
    _only(loss, key, _LOSS_KEYS[loss["type"]])
    return loss


def _max_iou_assigner(cfg: Dict[str, Any], defaults) -> Dict[str, Any]:
    """The fields of a ``MaxIoUAssigner`` config, with ``defaults`` for
    the thresholds; values the port does not implement raise."""
    _only(cfg, "assigner", ("type", "pos_iou_thr", "neg_iou_thr", "min_pos_iou",
                            "match_low_quality", "gt_max_assign_all", "ignore_iof_thr",
                            "ignore_wrt_candidates", "iou_calculator"))
    _check(cfg, "type", ("MaxIoUAssigner",), "MaxIoUAssigner")
    _check(cfg, "gt_max_assign_all", (True,), True)
    _check(cfg, "ignore_iof_thr", (-1,), -1)
    _check(cfg, "ignore_wrt_candidates", (True,), True)
    _check(cfg, "iou_calculator", ({"type": "BboxOverlaps2D"},), {"type": "BboxOverlaps2D"})
    pos, neg, min_pos, low = defaults
    return dict(pos_iou_thr=cfg.get("pos_iou_thr", pos), neg_iou_thr=cfg.get("neg_iou_thr", neg),
                min_pos_iou=cfg.get("min_pos_iou", min_pos),
                match_low_quality=cfg.get("match_low_quality", low))


def _rpn_cfg(rpn: Dict[str, Any], train_rpn: Dict[str, Any]) -> ATSSRPNCfg:
    """The ATSS RPN's coder, losses and train assigner (JAX
    ``build_rpn``)."""
    _check(rpn, "atss", (False,), False)
    _check(rpn, "reg_decoded_bbox", (True,), True)
    loss_cls = _loss(rpn, "loss_cls", ("FocalLoss",), {"type": "FocalLoss"})
    _check(loss_cls, "use_sigmoid", (True,), True)
    loss_bbox = _loss(rpn, "loss_bbox", ("IoULoss",), {"type": "IoULoss"})
    _check(loss_bbox, "linear", (False,), False)
    _check(loss_bbox, "mode", ("log",), "log")
    loss_iou = _loss(rpn, "loss_centerness", ("CrossEntropyLoss",),
                     {"type": "CrossEntropyLoss", "use_sigmoid": True})
    _check(loss_iou, "use_sigmoid", (True,), False)
    aug = _loss(rpn, "aug_reg_loss", ("MSELoss",))
    _only(train_rpn, "train_cfg.rpn", ("assigner", "sampler", "allowed_border", "pos_weight",
                                       "debug"))
    _check(train_rpn, "sampler", ({"type": "PseudoSampler"},), {"type": "PseudoSampler"})
    _check(train_rpn, "allowed_border", (-1,), -1)
    _check(train_rpn, "pos_weight", (-1,), -1)
    _check(train_rpn, "debug", (False,), False)
    means, stds = _coder(rpn, (1.0,) * 4)
    return ATSSRPNCfg(
        gamma=rpn.get("gamma", 1.0), atss=False, reg_decoded_bbox=True,
        target_means=means, target_stds=stds,
        focal_gamma=loss_cls.get("gamma", 2.0), focal_alpha=loss_cls.get("alpha", 0.25),
        loss_cls_weight=loss_cls.get("loss_weight", 1.0),
        loss_bbox_weight=loss_bbox.get("loss_weight", 1.0),
        loss_iou_weight=loss_iou.get("loss_weight", 1.0),
        aug_loss_weight=aug.get("loss_weight", 1.0),
        **_max_iou_assigner(train_rpn.get("assigner", {}), (0.5, 0.5, 0.0, True)),
    )


def _plain_rpn_cfg(rpn: Dict[str, Any], train_rpn: Dict[str, Any]) -> RPNCfg:
    """The plain RPN's coder, losses, train assigner and sampler (JAX
    ``build_rpn``'s ``RPNHead`` case)."""
    _only(rpn, "rpn_head", ("type", "in_channels", "feat_channels", "num_convs",
                            "anchor_generator", "bbox_coder", "loss_cls", "loss_bbox"))
    _check(rpn, "num_convs", (1,), 1)
    loss_cls = _loss(rpn, "loss_cls", ("CrossEntropyLoss",),
                     {"type": "CrossEntropyLoss", "use_sigmoid": True})
    _check(loss_cls, "use_sigmoid", (True,), False)
    _check(loss_cls, "use_mask", (False,), False)
    _check(loss_cls, "class_weight", (None,))
    loss_bbox = _loss(rpn, "loss_bbox", ("SmoothL1Loss",), {"type": "SmoothL1Loss"})
    _only(train_rpn, "train_cfg.rpn", ("assigner", "sampler", "allowed_border", "pos_weight",
                                       "debug"))
    sampler = train_rpn.get("sampler", {})
    _only(sampler, "train_cfg.rpn.sampler", ("type", "num", "pos_fraction", "neg_pos_ub",
                                             "add_gt_as_proposals"))
    _check(sampler, "type", ("RandomSampler",), "RandomSampler")
    _check(sampler, "neg_pos_ub", (-1,), -1)
    _check(sampler, "add_gt_as_proposals", (False,), False)
    _check(train_rpn, "allowed_border", (-1,), -1)
    _check(train_rpn, "pos_weight", (-1,), -1)
    _check(train_rpn, "debug", (False,), False)
    assigner = _max_iou_assigner(train_rpn.get("assigner", {}), (0.7, 0.3, 0.3, True))
    _check(assigner, "match_low_quality", (True,))  # rpn_loss matches low quality always
    means, stds = _coder(rpn, (1.0,) * 4)
    return RPNCfg(
        target_means=means, target_stds=stds, pos_iou_thr=assigner["pos_iou_thr"],
        neg_iou_thr=assigner["neg_iou_thr"], min_pos_iou=assigner["min_pos_iou"],
        num_samples=sampler.get("num", 256), pos_fraction=sampler.get("pos_fraction", 0.5),
        smooth_l1_beta=loss_bbox.get("beta", 1.0 / 9.0),
        loss_cls_weight=loss_cls.get("loss_weight", 1.0),
        loss_bbox_weight=loss_bbox.get("loss_weight", 1.0),
    )


def _build_rpn(rpn: Dict[str, Any], train_rpn: Dict[str, Any], channels: int,
               gen: torch.Generator):
    """The RPN module, its config, its ``rpn_type`` and the anchor
    generator."""
    _check(rpn, "type", ("ATSSRPNHead", "RPNHead"))
    ag_cfg = dict(rpn["anchor_generator"])
    ag_cfg.pop("type", None)
    ag = AnchorGenerator(**ag_cfg)
    if rpn["type"] == "RPNHead":
        module = RPNConvs(gen, in_channels=channels, num_anchors=ag.num_base_anchors[0],
                          feat_channels=rpn.get("feat_channels", 256))
        return module, _plain_rpn_cfg(rpn, train_rpn), "rpn", ag
    _check(rpn, "last_conv", ("norm",), "norm")
    _check(rpn, "bridge", (False,), False)
    module = ATSSRPNConvs(
        gen, in_channels=channels, num_anchors=ag.num_base_anchors[0],
        feat_channels=rpn.get("feat_channels", 256),
        stacked_convs=rpn.get("stacked_convs", 4), num_levels=ag.num_levels,
    )
    return module, _rpn_cfg(rpn, train_rpn), "atss_rpn", ag


def _build_mask_head(roi: Dict[str, Any], strides, channels: int, num_classes: int,
                     train_rcnn: Dict[str, Any], gen: torch.Generator):
    """The FCN mask head and the mask RoIAlign's pooled size (JAX
    ``build_detector``'s ``FCNMaskHead`` case)."""
    mh = roi["mask_head"]
    _only(mh, "mask_head", ("type", "num_convs", "in_channels", "conv_out_channels",
                            "num_classes", "roi_feat_size", "conv_kernel_size",
                            "class_agnostic", "upsample_cfg", "norm_cfg", "conv_cfg",
                            "predictor_cfg", "loss_mask"))
    _check(mh, "type", ("FCNMaskHead",))
    _check(mh, "conv_kernel_size", (3,), 3)
    _check(mh, "class_agnostic", (False,), False)
    _check(mh, "upsample_cfg", ({"type": "deconv", "scale_factor": 2},),
           {"type": "deconv", "scale_factor": 2})
    for key in ("norm_cfg", "conv_cfg"):
        _check(mh, key, (None,))
    _check(mh, "predictor_cfg", (None, {"type": "Conv"}))
    loss_mask = _loss(mh, "loss_mask", ("CrossEntropyLoss",),
                      {"type": "CrossEntropyLoss", "use_mask": True})
    _check(loss_mask, "use_mask", (True,), False)
    _check(loss_mask, "class_weight", (None,))
    _check(loss_mask, "loss_weight", (1.0,), 1.0)  # the JAX package's mask_loss weight
    extractor = roi.get("mask_roi_extractor")
    if not extractor:
        raise _unported("mask_roi_extractor", extractor)  # C4: the shared res5 head
    _check(extractor, "type", ("SingleRoIExtractor", None))
    layer = extractor.get("roi_layer", {})
    _check(layer, "type", ("RoIAlign",), "RoIAlign")
    out_size = layer.get("output_size", 14)
    _check({"mask_roi_extractor.roi_layer.output_size": out_size},
           "mask_roi_extractor.roi_layer.output_size", (14,))
    _check({"mask_roi_extractor.featmap_strides": tuple(extractor.get("featmap_strides",
                                                                      strides))},
           "mask_roi_extractor.featmap_strides", (tuple(strides),))
    _check(train_rcnn, "mask_size", (2 * out_size,), 2 * out_size)
    for key in ("mask_iou_head", "semantic_head"):
        _check(roi, key, (None,))
    module = FCNMaskHead(gen, num_classes=mh.get("num_classes", num_classes),
                         in_channels=mh.get("in_channels", channels),
                         num_convs=mh.get("num_convs", 4),
                         conv_channels=mh.get("conv_out_channels", 256))
    return module, out_size


def _bbox_cfg(head: Dict[str, Any]) -> BBoxHeadCfg:
    """The Shared2FC head's coder and losses (JAX ``build_bbox_head``)."""
    _check(head, "reg_decoded_bbox", (False,), False)
    _check(head, "focal_reg", (False,), False)
    loss_cls = _loss(head, "loss_cls", ("CrossEntropyLoss",), {"type": "CrossEntropyLoss"})
    for key in ("use_sigmoid", "use_mask"):
        _check(loss_cls, key, (False,), False)
    _check(loss_cls, "class_weight", (None,))
    loss_bbox = _loss(head, "loss_bbox", ("L1Loss",), {"type": "L1Loss"})
    means, stds = _coder(head, (1.0,) * 4)
    return BBoxHeadCfg(
        num_classes=head.get("num_classes", 80), target_means=means, target_stds=stds,
        loss_cls_weight=loss_cls.get("loss_weight", 1.0),
        loss_bbox_weight=loss_bbox.get("loss_weight", 1.0),
    )


def _roi_cfg(roi: Dict[str, Any], train_rcnn: Dict[str, Any]) -> ProbRoICfg:
    """The RoI head's boosting options (on by default for ``ProbRoIHead``,
    off for ``StandardRoIHead``) and its train sampler and assigner (JAX
    ``build_detector``, two-stage branch)."""
    _check(roi, "quality", (False,), False)
    _check(roi, "alpha", (0,), 0)
    _check(roi, "reg_norm", ("bbox_num",), "bbox_num")
    _only(train_rcnn, "train_cfg.rcnn", ("assigner", "sampler", "pos_weight", "debug",
                                         "mask_size"))
    sampler = train_rcnn.get("sampler", {})
    _only(sampler, "train_cfg.rcnn.sampler", ("type", "num", "pos_fraction", "neg_pos_ub",
                                              "add_gt_as_proposals"))
    _check(sampler, "type", ("RandomSampler",), "RandomSampler")
    _check(sampler, "add_gt_as_proposals", (True,), True)
    _check(train_rcnn, "pos_weight", (-1,), -1)
    _check(train_rcnn, "debug", (False,), False)
    prob_head = roi["type"] == "ProbRoIHead"
    return ProbRoICfg(
        gamma=roi.get("gamma", 0.1), boost=roi.get("boost", prob_head),
        prob=roi.get("prob", prob_head),
        num_samples=sampler.get("num", 512), pos_fraction=sampler.get("pos_fraction", 0.25),
        neg_pos_ub=sampler.get("neg_pos_ub", -1),
        **_max_iou_assigner(train_rcnn.get("assigner", {}), (0.5, 0.5, 0.5, False)),
    )


def _proposal_cfg(cfg: Dict[str, Any], nms_pre: int, max_per_img: int) -> ProposalCfg:
    _only(cfg, "proposal cfg", ("nms_pre", "max_per_img", "nms", "min_bbox_size"))
    _only(cfg.get("nms", {}), "proposal nms", ("type", "iou_threshold"))
    _check(cfg.get("nms", {}), "type", ("nms",), "nms")
    return ProposalCfg(
        nms_pre=cfg.get("nms_pre", nms_pre), max_per_img=cfg.get("max_per_img", max_per_img),
        nms_iou_thr=cfg.get("nms", {}).get("iou_threshold", 0.7),
        min_bbox_size=cfg.get("min_bbox_size", 0),
    )


def build_detector(model_cfg: Dict[str, Any], device=None, seed: int = 0,
                   dtype: torch.dtype = torch.float32) -> TwoStageDetector:
    """Two-stage detector with seeded random float32 weights on ``device``
    (the GPU when ``device`` is None; raises without one), computing in
    ``dtype`` (float32 or bfloat16; anything else raises ``ValueError``)."""
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {dtype} is not supported; the port computes in "
                         f"{' or '.join(map(str, COMPUTE_DTYPES))}")
    device = resolve_device(device)
    _check(model_cfg, "type", ("FasterRCNN", "MaskRCNN"))
    gen = torch.Generator().manual_seed(seed)
    train_cfg = model_cfg.get("train_cfg") or {}
    _only(train_cfg, "train_cfg", ("rpn", "rpn_proposal", "rcnn"))
    test_cfg = model_cfg.get("test_cfg") or {}

    backbone = _build_backbone(model_cfg["backbone"], gen)
    neck_cfg = model_cfg["neck"]
    neck = _build_neck(neck_cfg, gen)
    channels = neck_cfg.get("out_channels", 256)
    rpn_module, rpn_cfg, rpn_type, ag = _build_rpn(model_cfg["rpn_head"],
                                                   train_cfg.get("rpn") or {}, channels, gen)

    roi = model_cfg["roi_head"]
    _check(roi, "type", ("ProbRoIHead", "StandardRoIHead"))
    _check(roi, "shared_head", (None,))
    head = roi["bbox_head"]
    _check(head, "type", ("ProbConvFCBBoxHead", "Shared2FCBBoxHead", "ConvFCBBoxHead"))
    _check(head, "num_shared_convs", (0, None))
    _check(head, "reg_class_agnostic", (False,), False)
    extractor = roi.get("bbox_roi_extractor", {})
    _check(extractor, "type", ("SingleRoIExtractor", None))
    roi_layer = extractor.get("roi_layer", {})
    _check(roi_layer, "type", ("RoIAlign",), "RoIAlign")
    out_size = roi_layer.get("output_size", 7)
    strides = tuple(extractor.get("featmap_strides", (8, 16, 32, 64, 128)))
    num_classes = head.get("num_classes", 80)
    bbox_module = ConvFCBBoxHead(
        gen, num_classes=num_classes, in_channels=channels,
        num_shared_fcs=head.get("num_shared_fcs", 2),
        fc_out_channels=head.get("fc_out_channels", 1024),
        roi_feat_size=out_size,
    )
    bbox_cfg = _bbox_cfg(head)
    train_rcnn = train_cfg.get("rcnn") or {}
    roi_cfg = _roi_cfg(roi, train_rcnn)
    mask_module, mask_out_size = None, 14
    if roi.get("mask_head"):
        mask_module, mask_out_size = _build_mask_head(roi, strides, channels, num_classes,
                                                      train_rcnn, gen)
    else:
        _check(train_rcnn, "mask_size", (None,))

    net = TwoStageNet(
        backbone, neck, rpn_module, bbox_module, roi_strides=strides,
        roi_out_size=out_size, roi_finest_scale=extractor.get("finest_scale", 56),
        mask_head=mask_module, mask_roi_out_size=mask_out_size,
    )
    set_compute_dtype(net, dtype)
    rcnn_test = test_cfg.get("rcnn", {})
    _check(rcnn_test.get("nms", {}), "type", ("nms",), "nms")
    return TwoStageDetector(
        net, ag, rpn_cfg=rpn_cfg, roi_cfg=roi_cfg, bbox_cfg=bbox_cfg, device=device,
        train_proposal_cfg=_proposal_cfg(train_cfg.get("rpn_proposal") or {}, 4000, 2000),
        test_proposal_cfg=_proposal_cfg(test_cfg.get("rpn") or {}, 1000, 256),
        rcnn_test_cfg=RCNNTestCfg(
            score_thr=rcnn_test.get("score_thr", 0.05),
            nms_iou_thr=rcnn_test.get("nms", {}).get("iou_threshold", 0.5),
            max_per_img=rcnn_test.get("max_per_img", 100),
            pre_nms_top_k=rcnn_test.get("pre_nms_top_k", 2048),
        ),
        rpn_type=rpn_type,
    )
