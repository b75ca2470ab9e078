"""Build a two-stage detector from a model config (PyTorch port of the
two-stage branch of ``boosting_rcnn_tpu/builder.py::build_detector``).

Ported types: ``FasterRCNN`` and ``MaskRCNN`` with the backbone ``ResNet``
(depths 18, 34, 50, 101, 152, pytorch or caffe style, frozen BN or, with
``norm_eval=False``, BN that trains on batch statistics, GN,
weight-standardised convs, GCNet's ``ContextBlock`` and
``GeneralizedAttention`` plugins, ``frozen_stages``, DCN / DCNv2 stages),
``ResNeXt`` (grouped 3x3s, either style, the same norms, convs and
plugins; its BN frozen) or ``Res2Net`` (deep stem,
hierarchical splits, DCN / DCNv2 stages); the neck ``PAFPN`` (extra convs
on output) or ``FPN`` (``start_level`` / ``end_level``, extra levels by max
pool or by convs on the input, lateral or output; GN or frozen BN and
ConvWS); the RPN
``ATSSRPNHead`` (max-IoU or ATSS assignment, focal / IoU / GIoU / CIoU /
MSE / BCE losses, on decoded boxes or on encoded deltas) or ``RPNHead``
(one or more 3x3 convs, BCE or focal objectness and smooth L1, a random
anchor sampler); the RoI head ``ProbRoIHead`` (boosting loss, prior
fusion, ``reg_norm``), ``BoostRoIHead`` (prior fusion, boosting only where
its config says ``boost``), ``StandardRoIHead`` (plain cross entropy,
softmax scores) or ``DynamicRoIHead`` (Dynamic R-CNN: the standard head
with an IoU threshold and smooth-L1 beta adapted from
``train_cfg.rcnn.dynamic_rcnn``, the ``DynamicRCNNDetector``), each with a
random sampler and a Shared2FC or Shared4Conv1FC box head (class-wise or
class-agnostic deltas) with cross entropy and L1 or smooth L1, and hard or
soft NMS at test; and an ``FCNMaskHead`` (GN or not) on a 14 x 14
``RoIAlign`` (Mask R-CNN).
``CascadeRCNN`` (box only) builds its ``CascadeRoIHead`` or the fork's
``ProbCascadeRoIHead`` as the JAX ``build_cascade`` does, one Shared2FC
head per stage; ``HybridTaskCascade`` and a ``CascadeRCNN`` with a
``mask_head`` (Cascade Mask R-CNN) build the HTC detector as the JAX
``build_htc`` does: the box cascade, one FCN or HTC mask head per stage
(``conv_res`` under information flow) and HTC's ``FusedSemanticHead``.
The ``train_cfg`` is read as the JAX builder reads it.
Any type or value the port does not implement raises
``NotImplementedError`` naming it.

Weights are seeded random (flax-default initialisers drawn from a
``torch.Generator``); ``weights.from_jax_params`` loads the JAX package's.
``dtype`` is the compute dtype, float32 or bfloat16, as the JAX builder's
``dtype``: the parameters are float32 in both (``models/layers.py`` casts
them at each call), so one state dict serves both.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .models.backbones.res2net import Res2Net
from .models.backbones.resnet import ResNet
from .models.dense_heads.atss_rpn_head import ATSSRPNCfg, ATSSRPNConvs
from .models.dense_heads.rpn_head import RPNCfg, RPNConvs
from .models.detectors.cascade import CascadeDetector, CascadeNet
from .models.detectors.htc import HTCDetector, HTCNet
from .models.detectors.two_stage import (
    DynamicRCNNDetector,
    ProposalCfg,
    RCNNTestCfg,
    TwoStageDetector,
    TwoStageNet,
)
from .models.layers import set_compute_dtype
from .models.necks.fpn import FPN, PAFPN
from .models.roi_heads.bbox_head import BBoxHeadCfg, ConvFCBBoxHead
from .models.roi_heads.cascade_roi_head import CascadeCfg
from .models.roi_heads.mask_head import FCNMaskHead, FusedSemanticHead, HTCMaskHead
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


def _dcn(cfg: Dict[str, Any]):
    """The backbone's ``dcn`` dict and ``stage_with_dcn`` (JAX ``Bottleneck``
    and ``Bottle2neck`` read ``type`` and ``deform_groups``)."""
    dcn = cfg.get("dcn")
    stages = tuple(cfg.get("stage_with_dcn", (False,) * 4))
    if dcn is None:
        return None, stages
    _only(dcn, "backbone.dcn", ("type", "deform_groups", "fallback_on_stride"))
    _check(dcn, "type", ("DCN", "DCNv2"))
    _check(dcn, "fallback_on_stride", (False,), False)
    return dcn, stages


_NORM_TYPES = ("BN", "SyncBN", "FrozenBN", "GN")


def _norm_cfg(cfg: Dict[str, Any], what: str):
    """``cfg["norm_cfg"]``: None, or BN / SyncBN / FrozenBN / GN (the JAX
    package reads ``type`` and GN's ``num_groups``, and trains every norm's
    parameters)."""
    norm = cfg.get("norm_cfg")
    if norm is None:
        return None
    key = f"{what}.norm_cfg"
    _only(norm, key, ("type", "num_groups", "requires_grad"))
    _check({f"{key}.type": norm.get("type")}, f"{key}.type", _NORM_TYPES)
    _check({f"{key}.requires_grad": norm.get("requires_grad", True)}, f"{key}.requires_grad",
           (True,))
    return norm


def _conv_cfg(cfg: Dict[str, Any], what: str):
    """``cfg["conv_cfg"]``: None, or ``dict(type="ConvWS")``."""
    conv = cfg.get("conv_cfg")
    if conv is not None:
        key = f"{what}.conv_cfg"
        _only(conv, key, ("type",))
        _check({f"{key}.type": conv.get("type")}, f"{key}.type", ("ConvWS",))
    return conv


def _build_backbone(cfg: Dict[str, Any], gen: torch.Generator):
    """``ResNet``, ``ResNeXt`` (JAX ``build_resnext``'s defaults: depth 101,
    32 groups of base width 4) or ``Res2Net`` (depth 101, 4 scales of base
    width 26).  ResNet and ResNeXt take ``plugins``, ``conv_cfg`` (ConvWS)
    and ``norm_cfg`` (BN / SyncBN / GN); ResNet also ``norm_eval`` (False:
    live BN), which the JAX ``build_resnext`` does not read, so a ResNeXt's
    BN stays frozen whatever it says (JAX ``builder.py:68-122``)."""
    _check(cfg, "type", ("ResNet", "ResNeXt", "Res2Net"))
    if cfg["type"] == "Res2Net":
        for key in ("plugins", "conv_cfg", "norm_cfg"):
            _check(cfg, key, (None,))
        _check(cfg, "norm_eval", (True,), True)
    elif cfg["type"] == "ResNet":
        _check(cfg, "norm_eval", (True, False), True)
    # the caffe style moves a bottleneck's stride to its first 1x1 (JAX
    # build_resnet and build_resnext read it; build_res2net does not)
    _check(cfg, "style", ("pytorch",) if cfg["type"] == "Res2Net" else ("pytorch", "caffe"),
           "pytorch")
    _check(cfg, "deep_stem", (False,), False)
    _check(cfg, "num_stages", (4,), 4)
    for key, value in (("dilations", (1, 1, 1, 1)), ("strides", (1, 2, 2, 2)),
                       ("out_indices", (0, 1, 2, 3))):
        _check({key: tuple(cfg.get(key, value))}, key, (value,))
    dcn, stage_with_dcn = _dcn(cfg)
    common = dict(base_channels=cfg.get("base_channels", 64),
                  frozen_stages=cfg.get("frozen_stages", -1), dcn=dcn,
                  stage_with_dcn=stage_with_dcn)
    if cfg["type"] == "Res2Net":
        return Res2Net(gen, depth=cfg.get("depth", 101), scales=cfg.get("scales", 4),
                       base_width=cfg.get("base_width", 26), **common)
    common.update(style=cfg.get("style", "pytorch"), plugins=cfg.get("plugins") or None,
                  conv_cfg=_conv_cfg(cfg, "backbone"), norm_cfg=_norm_cfg(cfg, "backbone"))
    if cfg["type"] == "ResNeXt":
        return ResNet(gen, depth=cfg.get("depth", 101), groups=cfg.get("groups", 32),
                      base_width=cfg.get("base_width", 4), **common)
    for key in ("groups", "base_width", "scales"):  # the JAX build_resnet reads none
        _check(cfg, key, (None,))
    return ResNet(gen, depth=cfg.get("depth", 50), norm_eval=cfg.get("norm_eval", True),
                  **common)


def _build_neck(cfg: Dict[str, Any], gen: torch.Generator):
    _check(cfg, "type", ("PAFPN", "FPN"))
    if cfg["type"] == "FPN":
        # no activation, as every ported config's FPN; norms and ConvWS as the
        # JAX FPN takes them
        _check({"FPN act": cfg.get("act")}, "FPN act", (None,))
        _check(cfg, "add_extra_convs", (False, True, "on_input", "on_lateral", "on_output"),
               False)
        return FPN(gen, in_channels=cfg["in_channels"],
                   out_channels=cfg.get("out_channels", 256), num_outs=cfg.get("num_outs", 5),
                   start_level=cfg.get("start_level", 0), end_level=cfg.get("end_level", -1),
                   add_extra_convs=cfg.get("add_extra_convs", False),
                   relu_before_extra_convs=cfg.get("relu_before_extra_convs", False),
                   norm_cfg=_norm_cfg(cfg, "neck"), conv_cfg=_conv_cfg(cfg, "neck"),
                   no_norm_on_lateral=cfg.get("no_norm_on_lateral", False))
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
    "CIoULoss": ("type", "eps", "loss_weight"),
    "GIoULoss": ("type", "eps", "loss_weight"),
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


# the ATSS RPN's box losses by config type (JAX builder.py:53-64)
_RPN_BOX_LOSSES = {"IoULoss": "iou", "GIoULoss": "giou", "CIoULoss": "ciou"}


def _rpn_cfg(rpn: Dict[str, Any], train_rpn: Dict[str, Any]) -> ATSSRPNCfg:
    """The ATSS RPN's coder, losses and train assigner (JAX
    ``build_rpn``).  With ``atss=True`` the ATSS assignment takes every
    anchor and reads nothing of ``train_cfg.rpn`` (the ensemble configs
    inherit a random sampler there from the Cascade R-CNN base, which the
    JAX package does not read either); with an ``aug_reg_loss`` the
    decoded-box branch adds the MSE term (``with_aug_loss``)."""
    _check(rpn, "atss", (False, True), False)
    atss = rpn.get("atss", False)
    _check(rpn, "reg_decoded_bbox", (True, False), True)
    loss_cls = _loss(rpn, "loss_cls", ("FocalLoss",), {"type": "FocalLoss"})
    _check(loss_cls, "use_sigmoid", (True,), True)
    loss_bbox = _loss(rpn, "loss_bbox", tuple(_RPN_BOX_LOSSES), {"type": "IoULoss"})
    _check(loss_bbox, "linear", (False,), False)
    _check(loss_bbox, "mode", ("log",), "log")
    _check(loss_bbox, "eps", (1e-7,), 1e-7)  # the JAX RPN calls ciou_loss at its default
    loss_iou = _loss(rpn, "loss_centerness", ("CrossEntropyLoss",),
                     {"type": "CrossEntropyLoss", "use_sigmoid": True})
    _check(loss_iou, "use_sigmoid", (True,), False)
    # read on both branches; the encoded-delta one adds no MSE term (JAX
    # atss_rpn_head.py:348-372)
    with_aug = rpn.get("aug_reg_loss") is not None
    aug = _loss(rpn, "aug_reg_loss", ("MSELoss",)) if with_aug else {}
    _only(train_rpn, "train_cfg.rpn", ("assigner", "sampler", "allowed_border", "pos_weight",
                                       "debug"))
    if not atss:
        _check(train_rpn, "sampler", ({"type": "PseudoSampler"},), {"type": "PseudoSampler"})
        _check(train_rpn, "allowed_border", (-1,), -1)
    _check(train_rpn, "pos_weight", (-1,), -1)
    _check(train_rpn, "debug", (False,), False)
    means, stds = _coder(rpn, (1.0,) * 4)
    return ATSSRPNCfg(
        gamma=rpn.get("gamma", 1.0), atss=atss,
        reg_decoded_bbox=rpn.get("reg_decoded_bbox", True),
        loss_bbox_type=_RPN_BOX_LOSSES[loss_bbox["type"]],
        target_means=means, target_stds=stds,
        focal_gamma=loss_cls.get("gamma", 2.0), focal_alpha=loss_cls.get("alpha", 0.25),
        loss_cls_weight=loss_cls.get("loss_weight", 1.0),
        loss_bbox_weight=loss_bbox.get("loss_weight", 1.0),
        loss_iou_weight=loss_iou.get("loss_weight", 1.0),
        with_aug_loss=with_aug, aug_loss_weight=aug.get("loss_weight", 1.0),
        **_max_iou_assigner(train_rpn.get("assigner", {}), (0.5, 0.5, 0.0, True)),
    )


def _plain_rpn_cfg(rpn: Dict[str, Any], train_rpn: Dict[str, Any]) -> RPNCfg:
    """The plain RPN's coder, losses, train assigner and sampler (JAX
    ``build_rpn``'s ``RPNHead`` case): BCE or focal objectness; the box
    loss smooth L1 at the config's ``beta`` (1/9 by default) for an
    ``L1Loss`` too, as the JAX builder reads it."""
    _only(rpn, "rpn_head", ("type", "in_channels", "feat_channels", "num_convs",
                            "anchor_generator", "bbox_coder", "loss_cls", "loss_bbox"))
    loss_cls = _loss(rpn, "loss_cls", ("CrossEntropyLoss", "FocalLoss"),
                     {"type": "CrossEntropyLoss", "use_sigmoid": True})
    focal = loss_cls["type"] == "FocalLoss"
    _check(loss_cls, "use_sigmoid", (True,), focal)
    _check(loss_cls, "use_mask", (False,), False)
    _check(loss_cls, "class_weight", (None,))
    loss_bbox = _loss(rpn, "loss_bbox", ("SmoothL1Loss", "L1Loss"), {"type": "SmoothL1Loss"})
    _only(train_rpn, "train_cfg.rpn", ("assigner", "sampler", "allowed_border", "pos_weight",
                                       "debug"))
    sampler = train_rpn.get("sampler", {})
    _only(sampler, "train_cfg.rpn.sampler", ("type", "num", "pos_fraction", "neg_pos_ub",
                                             "add_gt_as_proposals"))
    _check(sampler, "type", ("RandomSampler",), "RandomSampler")
    _check(sampler, "neg_pos_ub", (-1,), -1)
    _check(sampler, "add_gt_as_proposals", (False,), False)
    # the JAX package reads no allowed_border: every anchor counts, as at -1
    _check(train_rpn, "allowed_border", (-1, 0), -1)
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
        loss_cls_type="focal" if focal else "bce", focal_gamma=loss_cls.get("gamma", 2.0),
        focal_alpha=loss_cls.get("alpha", 0.25),
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
                          feat_channels=rpn.get("feat_channels", 256),
                          num_convs=rpn.get("num_convs", 1))
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
    _check_mask_head(mh, ("FCNMaskHead",), norm=True)
    out_size = _mask_extractor(roi, strides)
    _check(train_rcnn, "mask_size", (2 * out_size,), 2 * out_size)
    for key in ("mask_iou_head", "semantic_head"):
        _check(roi, key, (None,))
    module = FCNMaskHead(gen, num_classes=mh.get("num_classes", num_classes),
                         in_channels=mh.get("in_channels", channels),
                         num_convs=mh.get("num_convs", 4),
                         conv_channels=mh.get("conv_out_channels", 256),
                         norm_cfg=_norm_cfg(mh, "mask_head"))
    return module, out_size


def _check_mask_head(mh: Dict[str, Any], types, norm: bool = False) -> None:
    """An FCN-style mask head of ``types`` as the port has it: 3x3 convs
    (with a ``norm_cfg`` where ``norm``: Mask R-CNN's ``FCNMaskHead``; the
    JAX ``FCNMaskHead`` reads no ``conv_cfg``, so a ConvWS one leaves its
    convs plain), a 2x deconvolution, a plain 1x1 predictor, per-class
    masks, the binary cross entropy at weight 1."""
    _only(mh, "mask_head", ("type", "num_convs", "in_channels", "conv_out_channels",
                            "num_classes", "roi_feat_size", "conv_kernel_size",
                            "class_agnostic", "upsample_cfg", "norm_cfg", "conv_cfg",
                            "predictor_cfg", "loss_mask", "with_conv_res"))
    _check(mh, "type", types)
    _check(mh, "conv_kernel_size", (3,), 3)
    _check(mh, "class_agnostic", (False,), False)
    _check(mh, "upsample_cfg", ({"type": "deconv", "scale_factor": 2},),
           {"type": "deconv", "scale_factor": 2})
    if norm:
        _norm_cfg(mh, "mask_head")
        _conv_cfg(mh, "mask_head")
    else:
        for key in ("norm_cfg", "conv_cfg"):
            _check(mh, key, (None,))
    _check(mh, "predictor_cfg", (None, {"type": "Conv"}))
    loss_mask = _loss(mh, "loss_mask", ("CrossEntropyLoss",),
                      {"type": "CrossEntropyLoss", "use_mask": True})
    _check(loss_mask, "use_mask", (True,), False)
    _check(loss_mask, "class_weight", (None,))
    _check(loss_mask, "loss_weight", (1.0,), 1.0)  # the JAX package's mask_loss weight


def _mask_extractor(roi: Dict[str, Any], strides) -> int:
    """The mask RoIAlign's pooled size (14), on the box branch's levels."""
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
    return out_size


# the R-CNN head's box losses by config type (JAX builder.py:55-66)
_BOX_LOSSES = {"L1Loss": "l1", "SmoothL1Loss": "smooth_l1"}


# the box heads' (shared convs, shared FCs) by type (JAX ``_std_convfc_head``)
_HEAD_PRESETS = {"Shared4Conv1FCBBoxHead": (4, 1)}


def _bbox_head(head: Dict[str, Any], channels: int, out_size: int, gen: torch.Generator,
               types=("ProbConvFCBBoxHead", "Shared2FCBBoxHead", "ConvFCBBoxHead",
                      "Shared4Conv1FCBBoxHead"),
               **head_kw):
    """A ConvFC box head module of ``types`` (JAX ``_std_convfc_head``:
    Shared2FC, or Shared4Conv1FC's 3x3 convs with their ``conv_cfg`` and
    ``norm_cfg`` and one FC) and its coder and losses (``build_bbox_head``);
    ``head_kw`` (Dynamic R-CNN's state options) go to the module."""
    _check(head, "type", types)
    convs, fcs = _HEAD_PRESETS.get(head.get("type"), (0, 2))
    module = ConvFCBBoxHead(
        gen, num_classes=head.get("num_classes", 80), in_channels=channels,
        num_shared_fcs=head.get("num_shared_fcs", fcs),
        fc_out_channels=head.get("fc_out_channels", 1024), roi_feat_size=out_size,
        reg_class_agnostic=head.get("reg_class_agnostic", False),
        num_shared_convs=head.get("num_shared_convs", convs),
        conv_out_channels=head.get("conv_out_channels", 256),
        conv_cfg=_conv_cfg(head, "bbox_head"), norm_cfg=_norm_cfg(head, "bbox_head"), **head_kw,
    )
    return module, _bbox_cfg(head)


def _bbox_cfg(head: Dict[str, Any]) -> BBoxHeadCfg:
    """The Shared2FC head's coder and losses (JAX ``build_bbox_head``)."""
    _check(head, "reg_decoded_bbox", (False,), False)
    _check(head, "focal_reg", (False,), False)
    loss_cls = _loss(head, "loss_cls", ("CrossEntropyLoss",), {"type": "CrossEntropyLoss"})
    for key in ("use_sigmoid", "use_mask"):
        _check(loss_cls, key, (False,), False)
    _check(loss_cls, "class_weight", (None,))
    loss_bbox = _loss(head, "loss_bbox", tuple(_BOX_LOSSES), {"type": "L1Loss"})
    means, stds = _coder(head, (1.0,) * 4)
    return BBoxHeadCfg(
        num_classes=head.get("num_classes", 80), target_means=means, target_stds=stds,
        reg_class_agnostic=head.get("reg_class_agnostic", False),
        loss_cls_weight=loss_cls.get("loss_weight", 1.0),
        loss_bbox_weight=loss_bbox.get("loss_weight", 1.0),
        loss_bbox_type=_BOX_LOSSES[loss_bbox["type"]],
        smooth_l1_beta=loss_bbox.get("beta", 1.0),
    )


def _roi_cfg(roi: Dict[str, Any], train_rcnn: Dict[str, Any]) -> ProbRoICfg:
    """The RoI head's boosting options (boosting on by default for
    ``ProbRoIHead`` only, prior fusion for ``ProbRoIHead`` and
    ``BoostRoIHead``) and its train sampler and assigner (JAX
    ``build_detector``, two-stage branch)."""
    _check(roi, "quality", (False,), False)
    _check(roi, "alpha", (0,), 0)
    _check(roi, "reg_norm", ("bbox_num", "mean"), "bbox_num")
    _only(train_rcnn, "train_cfg.rcnn", ("assigner", "sampler", "pos_weight", "debug",
                                         "mask_size")
          + (("dynamic_rcnn",) if roi["type"] == "DynamicRoIHead" else ()))
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
        prob=roi.get("prob", roi["type"] in ("ProbRoIHead", "BoostRoIHead")),
        reg_norm=roi.get("reg_norm", "bbox_num"),
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


def _rcnn_test_cfg(rcnn_test: Dict[str, Any]) -> RCNNTestCfg:
    """``test_cfg.rcnn``: the score threshold, the detections kept and the
    NMS, hard (``type``, ``iou_threshold``) or soft (also ``min_score``,
    ``sigma`` and ``method``, mmcv ``soft_nms``'s defaults 1e-3, 0.5 and
    ``"linear"``)."""
    nms = rcnn_test.get("nms", {})
    _check(nms, "type", ("nms", "soft_nms"), "nms")
    soft = nms.get("type") == "soft_nms"
    _only(nms, "test_cfg.rcnn.nms", ("type", "iou_threshold")
          + (("min_score", "sigma", "method") if soft else ()))
    _check(nms, "method", ("linear", "gaussian"), "linear")
    return RCNNTestCfg(
        score_thr=rcnn_test.get("score_thr", 0.05),
        nms_iou_thr=nms.get("iou_threshold", 0.5),
        max_per_img=rcnn_test.get("max_per_img", 100),
        pre_nms_top_k=rcnn_test.get("pre_nms_top_k", 2048),
        nms_type=nms.get("type", "nms"), soft_sigma=nms.get("sigma", 0.5),
        soft_min_score=nms.get("min_score", 1e-3), soft_method=nms.get("method", "linear"),
    )


def _extractor(roi: Dict[str, Any]):
    """The box RoIAlign's pooled size, route strides and finest scale."""
    extractor = roi.get("bbox_roi_extractor", {})
    _check(extractor, "type", ("SingleRoIExtractor", None))
    roi_layer = extractor.get("roi_layer", {})
    _check(roi_layer, "type", ("RoIAlign",), "RoIAlign")
    return (roi_layer.get("output_size", 7),
            tuple(extractor.get("featmap_strides", (8, 16, 32, 64, 128))),
            extractor.get("finest_scale", 56))


def build_detector(model_cfg: Dict[str, Any], device=None, seed: int = 0,
                   dtype: torch.dtype = torch.float32) -> TwoStageDetector:
    """Two-stage detector with seeded random float32 weights on ``device``
    (the GPU when ``device`` is None; raises without one), computing in
    ``dtype`` (float32 or bfloat16; anything else raises ``ValueError``)."""
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {dtype} is not supported; the port computes in "
                         f"{' or '.join(map(str, COMPUTE_DTYPES))}")
    device = resolve_device(device)
    _check(model_cfg, "type", ("FasterRCNN", "MaskRCNN", "CascadeRCNN") + _HTC_TYPES)
    roi = model_cfg["roi_head"]
    # the JAX builder sends HTC and a CascadeRCNN with a mask head (Cascade
    # Mask R-CNN) to build_htc
    htc = model_cfg["type"] in _HTC_TYPES or (model_cfg["type"] == "CascadeRCNN"
                                              and bool(roi.get("mask_head")))
    cascade = htc or model_cfg["type"] == "CascadeRCNN"
    gen = torch.Generator().manual_seed(seed)
    train_cfg = model_cfg.get("train_cfg") or {}
    _only(train_cfg, "train_cfg", ("rpn", "rpn_proposal", "rcnn"))
    test_cfg = model_cfg.get("test_cfg") or {}

    backbone = _build_backbone(model_cfg["backbone"], gen)
    neck_cfg = model_cfg["neck"]
    if isinstance(neck_cfg, list):
        raise _unported("neck (stacked necks)", [n.get("type") for n in neck_cfg])
    neck = _build_neck(neck_cfg, gen)
    channels = neck_cfg.get("out_channels", 256)
    rpn_module, rpn_cfg, rpn_type, ag = _build_rpn(model_cfg["rpn_head"],
                                                   train_cfg.get("rpn") or {}, channels, gen)
    out_size, strides, finest_scale = _extractor(roi)
    roi_kw = dict(roi_strides=strides, roi_out_size=out_size, roi_finest_scale=finest_scale)
    rcnn_test = _rcnn_test_cfg(test_cfg.get("rcnn", {}))
    if cascade:
        heads, bbox_cfg, roi_cfg, cascade_cfg, train_pc, test_pc = _cascade_parts(
            model_cfg, channels, out_size, gen, htc)
        if htc:
            mask_heads, semantic, net_kw, interleaved = _htc_parts(
                model_cfg, strides, channels, neck_cfg.get("num_outs", 5),
                bbox_cfg.num_classes, gen)
            net = HTCNet(backbone, neck, rpn_module, heads, mask_heads, semantic, **net_kw,
                         **roi_kw)
            cascade_cfg = dataclasses.replace(cascade_cfg, interleaved=interleaved)
        else:
            net = CascadeNet(backbone, neck, rpn_module, heads, **roi_kw)
        set_compute_dtype(net, dtype)
        return (HTCDetector if htc else CascadeDetector)(
            net, ag, rpn_cfg=rpn_cfg, roi_cfg=roi_cfg, bbox_cfg=bbox_cfg, device=device,
            train_proposal_cfg=train_pc, test_proposal_cfg=test_pc, rcnn_test_cfg=rcnn_test,
            rpn_type=rpn_type, cascade_cfg=cascade_cfg)

    _check(roi, "type", ("ProbRoIHead", "StandardRoIHead", "BoostRoIHead", "DynamicRoIHead"))
    _check(roi, "shared_head", (None,))
    train_rcnn = train_cfg.get("rcnn") or {}
    dynamic = roi["type"] == "DynamicRoIHead"
    head_kw, det_kw = _dynamic_rcnn(train_rcnn, roi) if dynamic else ({}, {})
    bbox_module, bbox_cfg = _bbox_head(roi["bbox_head"], channels, out_size, gen, **head_kw)
    roi_cfg = _roi_cfg(roi, train_rcnn)
    mask_module, mask_out_size = None, 14
    if roi.get("mask_head"):
        mask_module, mask_out_size = _build_mask_head(roi, strides, channels,
                                                      bbox_cfg.num_classes, train_rcnn, gen)
    else:
        _check(train_rcnn, "mask_size", (None,))

    net = TwoStageNet(backbone, neck, rpn_module, bbox_module, mask_head=mask_module,
                      mask_roi_out_size=mask_out_size, **roi_kw)
    set_compute_dtype(net, dtype)
    return (DynamicRCNNDetector if dynamic else TwoStageDetector)(
        net, ag, rpn_cfg=rpn_cfg, roi_cfg=roi_cfg, bbox_cfg=bbox_cfg, device=device,
        train_proposal_cfg=_proposal_cfg(train_cfg.get("rpn_proposal") or {}, 4000, 2000),
        test_proposal_cfg=_proposal_cfg(test_cfg.get("rpn") or {}, 1000, 256),
        rcnn_test_cfg=rcnn_test,
        rpn_type=rpn_type, **det_kw,
    )


# Dynamic R-CNN's train_cfg.rcnn.dynamic_rcnn with the JAX builder's defaults
# (builder.py:2294-2302, :2504-2511)
_DYN_DEFAULTS = {"iou_topk": 75, "beta_topk": 10, "update_iter_interval": 100,
                 "initial_iou": 0.4, "initial_beta": 1.0}


def _dynamic_rcnn(train_rcnn: Dict[str, Any], roi: Dict[str, Any]):
    """A ``DynamicRoIHead``'s ``train_cfg.rcnn.dynamic_rcnn``: the box
    head's state options and the detector's statistics options."""
    cfg = train_rcnn.get("dynamic_rcnn") or {}
    _only(cfg, "train_cfg.rcnn.dynamic_rcnn", tuple(_DYN_DEFAULTS))
    if roi.get("mask_head"):
        raise _unported("DynamicRoIHead mask_head", roi["mask_head"].get("type"))
    v = {k: cfg.get(k, d) for k, d in _DYN_DEFAULTS.items()}
    return (dict(dynamic=True, dyn_interval=v["update_iter_interval"],
                 dyn_initial_iou=v["initial_iou"], dyn_initial_beta=v["initial_beta"]),
            dict(dyn_iou_topk=v["iou_topk"], dyn_beta_topk=v["beta_topk"]))


# the stage heads' types: the JAX builder gives any type but its SABL and
# Double heads the Shared2FC preset (``_std_convfc_head``); a stage given
# as only ``{"num_classes": K}`` (a merged config's list) has no type
_CASCADE_HEADS = (None, "Shared2FCBBoxHead", "ProbShared2FCBBoxHead", "ConvFCBBoxHead",
                  "ProbConvFCBBoxHead", "Shared4Conv1FCBBoxHead")


def _cascade_rcnn_cfgs(train_cfg: Dict[str, Any], num_stages: int):
    """Each stage's ``train_cfg.rcnn`` entry and IoU threshold: the
    ``pos_iou_thr`` of its assigner, default ``min(0.5 + 0.1 i, 0.9)``; the
    JAX cascade assigns at that one threshold (as ``neg_iou_thr`` and
    ``min_pos_iou`` too) and samples every stage with stage 0's sampler, so
    other values raise."""
    rcnn = train_cfg.get("rcnn") or []
    rcnn = [rcnn] if isinstance(rcnn, dict) else list(rcnn)
    thrs = []
    for i in range(num_stages):
        rc = rcnn[i] if i < len(rcnn) else {}
        where = f"train_cfg.rcnn[{i}]"
        _only(rc, where, ("assigner", "sampler", "pos_weight", "debug"))
        _check(rc, "pos_weight", (-1,), -1)
        _check(rc, "debug", (False,), False)
        thr = min(0.5 + 0.1 * i, 0.9)
        a = _max_iou_assigner(rc.get("assigner", {}), (thr, thr, thr, False))
        thr = a["pos_iou_thr"]
        for key in ("neg_iou_thr", "min_pos_iou"):
            if a[key] != thr:
                raise _unported(f"{where}.assigner.{key} (the JAX cascade's is pos_iou_thr)",
                                a[key])
        _check(a, "match_low_quality", (False,))
        if i and rc.get("sampler", {}) != rcnn[0].get("sampler", {}):
            raise _unported(f"{where}.sampler (the JAX cascade samples with stage 0's)",
                            rc.get("sampler"))
        thrs.append(thr)
    return (rcnn[0] if rcnn else {}), tuple(thrs)


def _cascade_parts(model_cfg: Dict[str, Any], channels: int, out_size: int,
                   gen: torch.Generator, htc: bool = False):
    """``CascadeRCNN``'s stage heads, their ``BBoxHeadCfg`` (stage 0's),
    RoI and cascade configs and train and test proposal configs (JAX
    ``build_cascade``, and the same parts of ``build_htc`` where ``htc``):
    ``bbox_head`` a list of the stages' heads or one dict repeated
    ``num_stages`` times; ``boost`` (off by default) and ``gamma`` (0.1)
    of the RoI head; the sampler of ``train_cfg.rcnn[0]``."""
    roi = model_cfg["roi_head"]
    _only(roi, "roi_head", ("type", "num_stages", "stage_loss_weights", "bbox_roi_extractor",
                            "bbox_head", "boost", "gamma") + (_HTC_ROI_KEYS if htc else ()))
    _check(roi, "type", ("CascadeRoIHead", "HybridTaskCascadeRoIHead") if htc
           else ("CascadeRoIHead", "ProbCascadeRoIHead"))
    num_stages = roi.get("num_stages", 3)
    heads = roi["bbox_head"]
    heads = [heads] * num_stages if isinstance(heads, dict) else list(heads)
    if len(heads) != num_stages:
        raise ValueError(f"roi_head.bbox_head has {len(heads)} heads for {num_stages} stages")
    weights = tuple(float(w) for w in roi.get("stage_loss_weights", (1.0, 0.5, 0.25)))
    if len(weights) < num_stages:
        raise ValueError(f"roi_head.stage_loss_weights has {len(weights)} weights for "
                         f"{num_stages} stages")
    modules, cfgs = zip(*(_bbox_head(h, channels, out_size, gen, _CASCADE_HEADS)
                          for h in heads))
    for i, c in enumerate(cfgs[1:], 1):
        if dataclasses.replace(c, target_stds=cfgs[0].target_stds) != cfgs[0]:
            raise _unported(f"roi_head.bbox_head[{i}] unlike stage 0's (the JAX cascade "
                            "decodes and takes every stage's loss with stage 0's)", heads[i])
    train_cfg = model_cfg.get("train_cfg") or {}
    rcnn0, stage_pos = _cascade_rcnn_cfgs(train_cfg, num_stages)
    sampler = rcnn0.get("sampler", {})
    _only(sampler, "train_cfg.rcnn[0].sampler", ("type", "num", "pos_fraction", "neg_pos_ub",
                                                 "add_gt_as_proposals"))
    _check(sampler, "type", ("RandomSampler",), "RandomSampler")
    _check(sampler, "neg_pos_ub", (-1,), -1)
    _check(sampler, "add_gt_as_proposals", (True,), True)
    prob = roi["type"] == "ProbCascadeRoIHead"
    boost, gamma = roi.get("boost", False), roi.get("gamma", 0.1)
    roi_cfg = ProbRoICfg(gamma=gamma, boost=boost, prob=prob,
                         num_samples=sampler.get("num", 512),
                         pos_fraction=sampler.get("pos_fraction", 0.25))
    cascade_cfg = CascadeCfg(num_stages=num_stages, stage_loss_weights=weights,
                             stage_pos_iou=stage_pos, prob=prob, boost=boost, gamma=gamma)
    test_cfg = model_cfg.get("test_cfg") or {}
    proposal_cfgs = []
    for key, cfg, nms_pre in (("train_cfg.rpn_proposal", train_cfg.get("rpn_proposal") or {},
                               2000), ("test_cfg.rpn", test_cfg.get("rpn") or {}, 1000)):
        # the JAX cascade reads no min_bbox_size (its proposals keep every size)
        _check({f"{key}.min_bbox_size": cfg.get("min_bbox_size", 0)}, f"{key}.min_bbox_size",
               (0,))
        proposal_cfgs.append(_proposal_cfg(cfg, nms_pre, 1000))
    return modules, cfgs[0], roi_cfg, cascade_cfg, *proposal_cfgs


_HTC_TYPES = ("HybridTaskCascade", "HTC")
# the roi_head keys of Cascade Mask R-CNN and HTC beyond the box cascade's
_HTC_ROI_KEYS = ("mask_roi_extractor", "mask_head", "interleaved", "mask_info_flow",
                 "semantic_roi_extractor", "semantic_head")


def _htc_parts(model_cfg: Dict[str, Any], strides, channels: int, num_levels: int,
               num_classes: int, gen: torch.Generator):
    """Cascade Mask R-CNN's and HTC's mask heads, semantic head, the
    ``HTCNet`` options and whether the mask branch is interleaved (JAX
    ``build_htc``): ``interleaved`` and ``mask_info_flow`` on by default
    for ``HybridTaskCascade`` only; ``mask_head`` a list of the stages'
    heads or one dict for every stage; a ``conv_res`` in the heads after
    the first for ``HTCMaskHead`` under information flow (from the running
    feature of the head before); the heads pool the neck's channels (the
    JAX package reads no ``in_channels``); ``semantic_head`` a
    ``FusedSemanticHead`` on every neck level, its embedding pooled at
    ``semantic_roi_extractor.featmap_strides[0]``."""
    roi = model_cfg["roi_head"]
    is_htc = model_cfg["type"] in _HTC_TYPES
    interleaved = roi.get("interleaved", is_htc)
    info_flow = roi.get("mask_info_flow", is_htc)
    num_stages = roi.get("num_stages", 3)
    heads = roi["mask_head"]
    heads = [heads] * num_stages if isinstance(heads, dict) else list(heads)
    if len(heads) != num_stages:
        raise ValueError(f"roi_head.mask_head has {len(heads)} heads for {num_stages} stages")
    _mask_extractor(roi, strides)
    modules, res_channels = [], None
    for i, mh in enumerate(heads):
        _check_mask_head(mh, ("FCNMaskHead", "HTCMaskHead"))
        conv_res = (mh.get("with_conv_res", True) and info_flow
                    and mh["type"] == "HTCMaskHead")
        if i and info_flow and not conv_res:
            raise ValueError(f"roi_head.mask_head[{i}] has no conv_res for the information flow "
                             "(the JAX HTCMaskHead asserts one)")
        num_convs, conv_channels = mh.get("num_convs", 4), mh.get("conv_out_channels", 256)
        modules.append(HTCMaskHead(gen, num_classes=mh.get("num_classes", num_classes),
                                   in_channels=channels, num_convs=num_convs,
                                   conv_channels=conv_channels,
                                   res_channels=res_channels if i and conv_res else None))
        res_channels = conv_channels if num_convs else channels
    semantic, semantic_stride = None, 8
    sem = roi.get("semantic_head")
    if sem:
        _only(sem, "semantic_head", ("type", "num_ins", "fusion_level", "num_convs",
                                     "in_channels", "conv_out_channels", "num_classes",
                                     "loss_seg", "conv_cfg", "norm_cfg"))
        _check(sem, "type", ("FusedSemanticHead",))
        for key in ("conv_cfg", "norm_cfg"):
            _check(sem, key, (None,))
        _check(sem, "num_ins", (num_levels,), num_levels)
        # the JAX package's fixed loss: 0.2 x the cross entropy, 255 ignored
        seg = dict(sem.get("loss_seg") or {"type": "CrossEntropyLoss"})
        _check(seg, "ignore_index", (255,), 255)
        seg.pop("ignore_index", None)
        seg = _loss({"loss_seg": seg}, "loss_seg", ("CrossEntropyLoss",))
        for key in ("use_sigmoid", "use_mask"):
            _check(seg, key, (False,), False)
        _check(seg, "class_weight", (None,))
        _check(seg, "loss_weight", (0.2,), 0.2)
        width = sem.get("conv_out_channels", 256)
        if width != channels:
            raise ValueError(f"semantic_head.conv_out_channels={width}: its embedding is added "
                             f"to the {channels}-channel pooled features")
        semantic = FusedSemanticHead(gen, num_ins=num_levels, in_channels=channels,
                                     num_classes=sem.get("num_classes", 183),
                                     fusion_level=sem.get("fusion_level", 1),
                                     num_convs=sem.get("num_convs", 4), channels=width)
        extractor = roi.get("semantic_roi_extractor") or {}
        _only(extractor, "semantic_roi_extractor", ("type", "roi_layer", "out_channels",
                                                    "featmap_strides"))
        _check(extractor, "type", ("SingleRoIExtractor", None))
        _check(extractor.get("roi_layer", {}), "type", ("RoIAlign",), "RoIAlign")
        featmap_strides = tuple(extractor.get("featmap_strides", (8,)))
        if len(featmap_strides) != 1:
            raise _unported("semantic_roi_extractor.featmap_strides", featmap_strides)
        semantic_stride = featmap_strides[0]
    else:
        _check(roi, "semantic_roi_extractor", (None,))
    net_kw = dict(mask_info_flow=info_flow, semantic_stride=semantic_stride,
                  mask_roi_out_size=14)
    return modules, semantic, net_kw, interleaved
