"""Build the flagship detector from a model config (PyTorch port of the
FasterRCNN branch of ``boosting_rcnn_tpu/builder.py::build_detector``).

Ported types: ``FasterRCNN`` with ``ResNet`` (depth 18 or 50, pytorch
style, frozen BN), ``PAFPN`` (extra convs on output), ``ATSSRPNHead``,
``ProbRoIHead`` and a Shared2FC ``ProbConvFCBBoxHead``.  Anything else
raises ``NotImplementedError`` naming what is missing.

Weights are seeded random (flax-default initialisers drawn from a
``torch.Generator``); ``weights.from_jax_params`` loads the JAX package's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .models.backbones.resnet import ResNet
from .models.dense_heads.atss_rpn_head import ATSSRPNCfg, ATSSRPNConvs
from .models.detectors.two_stage import (
    ProposalCfg,
    RCNNTestCfg,
    TwoStageDetector,
    TwoStageNet,
)
from .models.necks.fpn import PAFPN
from .models.roi_heads.bbox_head import BBoxHeadCfg, ConvFCBBoxHead
from .models.roi_heads.prob_roi_head import ProbRoICfg
from .ops.anchors import AnchorGenerator

__all__ = ["build_detector", "resolve_device"]


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
                  base_channels=cfg.get("base_channels", 64))


def _build_neck(cfg: Dict[str, Any], gen: torch.Generator) -> PAFPN:
    _check(cfg, "type", ("PAFPN",))
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


def build_detector(model_cfg: Dict[str, Any], device=None, seed: int = 0) -> TwoStageDetector:
    """Flagship detector with seeded random weights on ``device`` (the GPU
    when ``device`` is None; raises without one)."""
    device = resolve_device(device)
    _check(model_cfg, "type", ("FasterRCNN",))
    gen = torch.Generator().manual_seed(seed)
    test_cfg = model_cfg.get("test_cfg") or {}

    backbone = _build_backbone(model_cfg["backbone"], gen)
    neck_cfg = model_cfg["neck"]
    neck = _build_neck(neck_cfg, gen)
    channels = neck_cfg.get("out_channels", 256)

    rpn = model_cfg["rpn_head"]
    _check(rpn, "type", ("ATSSRPNHead",))
    _check(rpn, "last_conv", ("norm",), "norm")
    _check(rpn, "bridge", (False,), False)
    ag_cfg = dict(rpn["anchor_generator"])
    ag_cfg.pop("type", None)
    ag = AnchorGenerator(**ag_cfg)
    rpn_module = ATSSRPNConvs(
        gen, in_channels=channels, num_anchors=ag.num_base_anchors[0],
        feat_channels=rpn.get("feat_channels", 256),
        stacked_convs=rpn.get("stacked_convs", 4), num_levels=ag.num_levels,
    )
    means, stds = _coder(rpn, (1.0,) * 4)
    rpn_cfg = ATSSRPNCfg(target_means=means, target_stds=stds)

    roi = model_cfg["roi_head"]
    _check(roi, "type", ("ProbRoIHead",))
    for key in ("mask_head", "shared_head"):
        _check(roi, key, (None,))
    head = roi["bbox_head"]
    _check(head, "type", ("ProbConvFCBBoxHead", "Shared2FCBBoxHead", "ConvFCBBoxHead"))
    _check(head, "num_shared_convs", (0, None))
    _check(head, "reg_class_agnostic", (False,), False)
    extractor = roi.get("bbox_roi_extractor", {})
    _check(extractor, "type", ("SingleRoIExtractor", None))
    roi_layer = extractor.get("roi_layer", {})
    _check(roi_layer, "type", ("RoIAlign",), "RoIAlign")
    out_size = roi_layer.get("output_size", 7)
    num_classes = head.get("num_classes", 80)
    bbox_module = ConvFCBBoxHead(
        gen, num_classes=num_classes, in_channels=channels,
        num_shared_fcs=head.get("num_shared_fcs", 2),
        fc_out_channels=head.get("fc_out_channels", 1024),
        roi_feat_size=out_size,
    )
    means, stds = _coder(head, (1.0,) * 4)
    bbox_cfg = BBoxHeadCfg(num_classes=num_classes, target_means=means,
                           target_stds=stds)
    roi_cfg = ProbRoICfg(prob=roi.get("prob", True))

    net = TwoStageNet(
        backbone, neck, rpn_module, bbox_module,
        roi_strides=tuple(extractor.get("featmap_strides", (8, 16, 32, 64, 128))),
        roi_out_size=out_size, roi_finest_scale=extractor.get("finest_scale", 56),
    )
    rpn_test = test_cfg.get("rpn", {})
    rcnn_test = test_cfg.get("rcnn", {})
    _check(rcnn_test.get("nms", {}), "type", ("nms",), "nms")
    return TwoStageDetector(
        net, ag, rpn_cfg=rpn_cfg, roi_cfg=roi_cfg, bbox_cfg=bbox_cfg, device=device,
        test_proposal_cfg=ProposalCfg(
            nms_pre=rpn_test.get("nms_pre", 1000),
            max_per_img=rpn_test.get("max_per_img", 256),
            nms_iou_thr=rpn_test.get("nms", {}).get("iou_threshold", 0.7),
            min_bbox_size=rpn_test.get("min_bbox_size", 0),
        ),
        rcnn_test_cfg=RCNNTestCfg(
            score_thr=rcnn_test.get("score_thr", 0.05),
            nms_iou_thr=rcnn_test.get("nms", {}).get("iou_threshold", 0.5),
            max_per_img=rcnn_test.get("max_per_img", 100),
            pre_nms_top_k=rcnn_test.get("pre_nms_top_k", 2048),
        ),
    )
