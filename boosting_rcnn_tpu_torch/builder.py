"""Build a two-stage detector from a model config (PyTorch port of the
two-stage branch of ``boosting_rcnn_tpu/builder.py::build_detector``).

Ported types: ``FasterRCNN`` and ``MaskRCNN`` with the backbone ``ResNet``
(depths 18, 34, 50, 101, 152, pytorch or caffe style, frozen BN or, with
``norm_eval=False``, BN that trains on batch statistics, GN,
weight-standardised convs, GCNet's ``ContextBlock`` and
``GeneralizedAttention`` plugins, ``frozen_stages``, DCN / DCNv2 stages),
``ResNeXt`` (grouped 3x3s, either style, the same norms, convs and
plugins; its BN frozen), ``Res2Net`` (deep stem,
hierarchical splits, DCN / DCNv2 stages), ``RegNet`` (the RegNetX archs),
``ResNeSt`` (split attention; live BN in the syncbn configs) or ``HRNet``
(W18, W32, W40); the neck ``PAFPN`` (extra convs on output, or by max
pool) or ``FPN`` (``start_level`` / ``end_level``, extra levels by max
pool or by convs on the input, lateral or output; GN or frozen BN and
ConvWS), ``SPPFPN`` (the FPN with SPP laterals), ``FPT`` / ``FPT_lite``
(attention necks) or ``HRFPN``; the RPN
``ATSSRPNHead`` (max-IoU or ATSS assignment, focal or varifocal / IoU /
GIoU / DIoU / CIoU / EIoU / Focal-EIoU / MSE / BCE losses, on decoded boxes
or on encoded deltas) or ``RPNHead``
(one or more 3x3 convs, BCE or focal objectness and smooth L1, a random
anchor sampler); the RoI head ``ProbRoIHead`` (boosting loss, prior
fusion, ``reg_norm``), ``BoostRoIHead`` (prior fusion, boosting only where
its config says ``boost``), ``ProbPISARoIHead`` (PISA's losses, prior
fusion), ``StandardRoIHead`` (plain cross entropy or, with
``train_cfg.rcnn.isr`` / ``carl``, PISA's ISR-P and CARL; softmax scores) or ``DynamicRoIHead`` (Dynamic R-CNN: the standard head
with an IoU threshold and smooth-L1 beta adapted from
``train_cfg.rcnn.dynamic_rcnn``, the ``DynamicRCNNDetector``) or
``MaskScoringRoIHead`` (the standard head and a ``MaskIoUHead``), each with a
random sampler and a Shared2FC or Shared4Conv1FC box head (class-wise or
class-agnostic deltas) with cross entropy or the Seesaw loss (its counts
in the head's buffers) and L1 or smooth L1 on the deltas or, with
``reg_decoded_bbox``, the IoU, GIoU, CIoU, bounded IoU, EIoU or Focal-EIoU
loss on the decoded boxes, and hard or soft NMS at test; and an
``FCNMaskHead`` (GN or not; a plain or ``NormedConv2d`` predictor) on a 14 x
14 ``RoIAlign`` (Mask R-CNN; ``MaskScoringRCNN`` adds its ``MaskIoUHead``
there).
``CascadeRCNN`` (box only) builds its ``CascadeRoIHead`` or the fork's
``ProbCascadeRoIHead`` as the JAX ``build_cascade`` does, one Shared2FC
head per stage; ``HybridTaskCascade`` and a ``CascadeRCNN`` with a
``mask_head`` (Cascade Mask R-CNN) build the HTC detector as the JAX
``build_htc`` does: the box cascade, one FCN or HTC mask head per stage
(``conv_res`` under information flow) and HTC's ``FusedSemanticHead``.
The fork's domain-generalisation types build as Faster R-CNN with their
extra parts (JAX ``builder.py:2397-2427``): ``DGFasterRCNN`` (a domain
classifier; ``num_domains``, ``total_img``), ``JiGENFasterRCNN`` (a
jigsaw classifier; ``jig_classes``), ``DGaugFasterRCNN`` (trains on the
loader's style-transferred view) and ``EMAFasterRCNN`` (an FP-EMAU over
the neck; ``k``), with the backbone ``HiddenMixupResNet`` around a ResNet.
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

from .models.backbones.detectors_resnet import DetectoRSResNet
from .models.backbones.hrnet import HRNet
from .models.backbones.regnet import ARCH_SETTINGS as REGNET_ARCHS
from .models.backbones.regnet import RegNet
from .models.backbones.res2net import Res2Net
from .models.backbones.resnest import ResNeSt
from .models.backbones.resnet import ResNet
from .models.backbones.swin import SwinTransformer
from .models.dense_heads.atss_rpn_head import ATSSRPNCfg, ATSSRPNConvs
from .models.dense_heads.rpn_head import RPNCfg, RPNConvs
from .models.detectors.cascade import CascadeDetector, CascadeNet
from .models.detectors.dg import (
    DGaugFasterRCNNDetector,
    DGFasterRCNNDetector,
    DomainClassifier,
    JiGENFasterRCNNDetector,
    JigsawClassifier,
)
from .models.detectors.htc import HTCDetector, HTCNet
from .models.detectors.point_rend import PointRendDetector
from .models.detectors.two_stage import (
    DynamicRCNNDetector,
    ProposalCfg,
    RCNNTestCfg,
    TwoStageDetector,
    TwoStageNet,
)
from .models.layers import set_compute_dtype
from .models.necks.fpn import FPN, HRFPN, PAFPN, RFP, SPP_TYPES
from .models.necks.fpt import FPT, FPTLite
from .models.roi_heads.bbox_head import BBoxHeadCfg, ConvFCBBoxHead
from .models.roi_heads.cascade_roi_head import CascadeCfg
from .models.roi_heads.mask_head import FCNMaskHead, FusedSemanticHead, HTCMaskHead, MaskIoUHead
from .models.roi_heads.point_rend import CoarseMaskHead, MaskPointHead, PointRendCfg
from .models.roi_heads.prob_roi_head import ProbRoICfg
from .models.roi_heads.res5_head import Res5BBoxHead
from .models.thesis_extras import FPEMAU, HiddenMixupResNet
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


def _zoo_backbone(cfg: Dict[str, Any], gen: torch.Generator):
    """``RegNet``, ``ResNeSt`` or ``HRNet`` as the JAX builders read them
    (``builder.py:195-250``): RegNet's ``arch`` by name or as a dict of its
    parameters matched against the names, ``out_indices``,
    ``frozen_stages`` and ``norm_eval``; ResNeSt's depth, ``radix``, stem and
    base widths, ``out_indices``, ``frozen_stages`` (default 1) and
    ``norm_eval`` (False: live BN, whatever BN type ``norm_cfg`` names);
    HRNet's width by ``arch`` or by ``extra.stage2.num_channels[0]`` (18,
    32 or 40; the JAX builder falls back to w32 on another) and
    ``norm_eval``.  Keys the JAX builders do not read raise where they
    would change the model (a RegNet ``dcn``), and are accepted where they
    restate its defaults."""
    kind = cfg["type"]
    if kind == "RegNet":
        # ``depth`` and ``num_stages`` are left from the ResNet base configs
        _only(cfg, "backbone", ("type", "arch", "out_indices", "frozen_stages", "norm_eval",
                                "init_cfg", "depth", "num_stages", "dcn", "stage_with_dcn"))
        if cfg.get("dcn") is not None or any(cfg.get("stage_with_dcn") or ()):
            # the JAX build_regnet reads neither and builds a plain RegNet
            raise _unported("RegNet dcn / stage_with_dcn (the JAX package's RegNet has no "
                            "deformable stage)", (cfg.get("dcn"), cfg.get("stage_with_dcn")))
        _check(cfg, "num_stages", (4,), 4)
        arch = cfg.get("arch", "regnetx_3.2gf")
        if isinstance(arch, dict):
            name = next((k for k, v in REGNET_ARCHS.items()
                         if all(abs(v[q] - arch.get(q, -1)) < 1e-6 for q in v)), None)
            if name is None:
                raise _unported("RegNet arch", arch)
            arch = name
        return RegNet(gen, arch=arch, out_indices=tuple(cfg.get("out_indices", (0, 1, 2, 3))),
                      frozen_stages=cfg.get("frozen_stages", -1),
                      norm_eval=cfg.get("norm_eval", True))
    if kind == "ResNeSt":
        _only(cfg, "backbone", ("type", "depth", "radix", "reduction_factor", "stem_channels",
                                "base_channels", "out_indices", "frozen_stages", "norm_eval",
                                "norm_cfg", "init_cfg", "num_stages"))
        _check(cfg, "reduction_factor", (4,), 4)
        _check(cfg, "num_stages", (4,), 4)
        _check({"norm_cfg.type": (cfg.get("norm_cfg") or {}).get("type", "BN")},
               "norm_cfg.type", ("BN", "SyncBN"))
        return ResNeSt(gen, depth=cfg.get("depth", 50), radix=cfg.get("radix", 2),
                       stem_channels=cfg.get("stem_channels", 64),
                       base_channels=cfg.get("base_channels", 64),
                       out_indices=tuple(cfg.get("out_indices", (0, 1, 2, 3))),
                       frozen_stages=cfg.get("frozen_stages", 1),
                       norm_eval=cfg.get("norm_eval", True))
    _only(cfg, "backbone", ("type", "arch", "extra", "frozen_stages", "norm_eval", "init_cfg"))
    arch = cfg.get("arch")
    if arch is None:
        width = (((cfg.get("extra") or {}).get("stage2") or {}).get("num_channels") or [32])[0]
        if width not in (18, 32, 40):
            raise _unported("HRNet extra.stage2.num_channels[0] (the JAX builder builds w32)",
                            width)
        arch = f"w{width}"
    return HRNet(gen, arch=arch, frozen_stages=cfg.get("frozen_stages", -1),
                 norm_eval=cfg.get("norm_eval", True))


_DETECTORS_KEYS = ("type", "depth", "base_channels", "sac", "stage_with_sac", "out_indices",
                   "frozen_stages", "norm_eval", "output_img", "num_stages", "style", "norm_cfg",
                   "init_cfg")


def _detectors_backbone(cfg: Dict[str, Any], gen: torch.Generator,
                        rfp_inplanes: Optional[int] = None):
    """``DetectoRS_ResNet`` as the JAX ``build_detectors_resnet`` reads it
    (``builder.py:146-162``): depth (50, 101), ``base_channels``, SAC in the
    stages of ``stage_with_sac`` unless ``sac`` is None, ``out_indices``,
    ``frozen_stages`` (default 1), ``norm_eval`` (False: live BN) and
    ``output_img``.  ``sac`` is ``dict(type="SAC", use_deform=...)``, its
    ``use_deform`` read as the JAX module reads it, not at all (ROADMAP
    C.5).  The ResNet base keys it does not read raise unless they restate
    what it builds (four stages, the pytorch style, BN); ``init_cfg`` is the
    runner's (``weights.load_pretrained``).  ``rfp_inplanes`` (the RFP's
    feedback backbone, built by ``_build_neck``) adds the ``rfp_conv`` of
    stages 2-4 and leaves the frozen stages' parameters trainable, as the
    JAX optimizer's mask leaves them."""
    _only(cfg, "backbone", _DETECTORS_KEYS)
    _check(cfg, "num_stages", (4,), 4)
    _check(cfg, "style", ("pytorch",), "pytorch")
    _check({"norm_cfg.type": (cfg.get("norm_cfg") or {}).get("type", "BN")}, "norm_cfg.type",
           ("BN", "SyncBN"))
    sac = cfg.get("sac")
    if sac is not None:
        _only(sac, "backbone.sac", ("type", "use_deform"))
        _check(sac, "type", ("SAC",))
    stages = tuple(cfg.get("stage_with_sac", (False, True, True, True))) if sac is not None \
        else (False,) * 4
    return DetectoRSResNet(gen, depth=cfg.get("depth", 50),
                           base_channels=cfg.get("base_channels", 64), sac_stages=stages,
                           out_indices=tuple(cfg.get("out_indices", (0, 1, 2, 3))),
                           frozen_stages=cfg.get("frozen_stages", 1),
                           norm_eval=cfg.get("norm_eval", True),
                           output_img=cfg.get("output_img", False), rfp_inplanes=rfp_inplanes,
                           freeze=rfp_inplanes is None)


def _swin_backbone(cfg: Dict[str, Any], gen: torch.Generator):
    """``SwinTransformer`` as the JAX ``build_swin`` reads it
    (``builder.py:267-281``): ``embed_dims``, ``depths``, ``num_heads``,
    ``window_size``, ``patch_size``, ``mlp_ratio``, ``out_indices`` and
    ``frozen_stages``, which the JAX module ignores and so does the port's.
    mmdet's other Swin keys (``qkv_bias``, ``drop_path_rate``,
    ``use_abs_pos_embed``, ...) raise."""
    _only(cfg, "backbone", ("type", "embed_dims", "depths", "num_heads", "window_size",
                            "patch_size", "mlp_ratio", "out_indices", "frozen_stages"))
    return SwinTransformer(gen, embed_dims=cfg.get("embed_dims", 96),
                           depths=tuple(cfg.get("depths", (2, 2, 6, 2))),
                           num_heads=tuple(cfg.get("num_heads", (3, 6, 12, 24))),
                           window_size=cfg.get("window_size", 7),
                           patch_size=cfg.get("patch_size", 4),
                           mlp_ratio=cfg.get("mlp_ratio", 4.0),
                           out_indices=tuple(cfg.get("out_indices", (0, 1, 2, 3))))


def _build_backbone(cfg: Dict[str, Any], gen: torch.Generator):
    """``ResNet``, ``ResNeXt`` (JAX ``build_resnext``'s defaults: depth 101,
    32 groups of base width 4) or ``Res2Net`` (depth 101, 4 scales of base
    width 26).  ResNet and ResNeXt take ``plugins``, ``conv_cfg`` (ConvWS)
    and ``norm_cfg`` (BN / SyncBN / GN); ResNet also ``norm_eval`` (False:
    live BN), which the JAX ``build_resnext`` does not read, so a ResNeXt's
    BN stays frozen whatever it says (JAX ``builder.py:68-122``); the zoo's
    ``RegNet``, ``ResNeSt`` and ``HRNet`` by ``_zoo_backbone``."""
    if cfg.get("type") in ("RegNet", "ResNeSt", "HRNet"):
        return _zoo_backbone(cfg, gen)
    if cfg.get("type") == "DetectoRS_ResNet":
        return _detectors_backbone(cfg, gen)
    if cfg.get("type") == "SwinTransformer":
        return _swin_backbone(cfg, gen)
    if cfg.get("type") == "HiddenMixupResNet":
        # the DG configs' two-view backbone around the config's ResNet (JAX
        # builder.py:93-101)
        return HiddenMixupResNet(_build_backbone(dict(cfg, type="ResNet"), gen))
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
    stages = {}
    if cfg["type"] == "Res2Net":
        _check(cfg, "num_stages", (4,), 4)
    else:  # JAX build_resnet reads the stages' strides and dilations, build_resnext not
        stages = dict(num_stages=cfg.get("num_stages", 4),
                      out_indices=tuple(cfg.get("out_indices", (0, 1, 2, 3))))
        if cfg["type"] == "ResNet":
            stages.update(strides=tuple(cfg.get("strides", (1, 2, 2, 2))),
                          dilations=tuple(cfg.get("dilations", (1, 1, 1, 1))))
    for key, value in (("dilations", (1, 1, 1, 1)), ("strides", (1, 2, 2, 2)),
                       ("out_indices", (0, 1, 2, 3))):
        if key not in stages:
            _check({key: tuple(cfg.get(key, value))}, key, (value,))
    dcn, stage_with_dcn = _dcn(cfg)
    common = dict(base_channels=cfg.get("base_channels", 64),
                  frozen_stages=cfg.get("frozen_stages", -1), dcn=dcn,
                  stage_with_dcn=stage_with_dcn)
    if cfg["type"] == "Res2Net":
        return Res2Net(gen, depth=cfg.get("depth", 101), scales=cfg.get("scales", 4),
                       base_width=cfg.get("base_width", 26), **common)
    common.update(style=cfg.get("style", "pytorch"), plugins=cfg.get("plugins") or None,
                  conv_cfg=_conv_cfg(cfg, "backbone"), norm_cfg=_norm_cfg(cfg, "backbone"),
                  **stages)
    if cfg["type"] == "ResNeXt":
        return ResNet(gen, depth=cfg.get("depth", 101), groups=cfg.get("groups", 32),
                      base_width=cfg.get("base_width", 4), **common)
    for key in ("groups", "base_width", "scales"):  # the JAX build_resnet reads none
        _check(cfg, key, (None,))
    return ResNet(gen, depth=cfg.get("depth", 50), norm_eval=cfg.get("norm_eval", True),
                  **common)


def _build_neck(cfg: Dict[str, Any], gen: torch.Generator, backbone_channels=None):
    """The neck (JAX ``build_neck``): ``FPN``, ``SPPFPN``, ``PAFPN``,
    ``FPT``, ``FPT_lite``, ``HRFPN`` or ``RFP``; the FPT, FPT_lite and
    HRFPN read their input widths from the backbone, as flax infers them
    (``backbone_channels``; the config's ``in_channels`` otherwise).  The
    RFP reads the keys the JAX ``build_neck`` reads (``builder.py:353-370``):
    ``in_channels``, ``out_channels``, ``num_outs``, ``rfp_steps``,
    ``aspp_out_channels`` and ``rfp_backbone`` (a ``DetectoRS_ResNet``
    without ``output_img``; its ``rfp_inplanes`` and ``pretrained``
    dropped, the ASPP's width taken for it); ``aspp_dilations`` only at the
    JAX module's (1, 3, 6, 1), which the JAX builder does not pass on."""
    _check(cfg, "type", ("PAFPN", "FPN", "SPPFPN", "FPT", "FPT_lite", "HRFPN", "RFP"))
    if cfg["type"] == "RFP":
        _only(cfg, "neck", ("type", "in_channels", "out_channels", "num_outs", "rfp_steps",
                            "aspp_out_channels", "aspp_dilations", "rfp_backbone"))
        _check({"aspp_dilations": tuple(cfg.get("aspp_dilations", (1, 3, 6, 1)))},
               "aspp_dilations", ((1, 3, 6, 1),))
        bb = {k: v for k, v in (cfg.get("rfp_backbone") or {}).items()
              if k not in ("pretrained", "rfp_inplanes")}
        bb.setdefault("type", "DetectoRS_ResNet")
        _check(bb, "type", ("DetectoRS_ResNet",))
        bb["output_img"] = False
        aspp = cfg.get("aspp_out_channels", 64)
        return RFP(gen, tuple(cfg.get("in_channels", (256, 512, 1024, 2048))),
                   _detectors_backbone(bb, gen, rfp_inplanes=4 * aspp),
                   out_channels=cfg.get("out_channels", 256), num_outs=cfg.get("num_outs", 5),
                   rfp_steps=cfg.get("rfp_steps", 2), aspp_out_channels=aspp)
    if cfg["type"] in ("FPT", "FPT_lite", "HRFPN"):
        in_channels = backbone_channels or cfg.get("in_channels")
        common = dict(out_channels=cfg.get("out_channels", 256), num_outs=cfg.get("num_outs", 5))
        if cfg["type"] == "HRFPN":
            _only(cfg, "neck", ("type", "in_channels", "out_channels", "num_outs", "stride"))
            return HRFPN(gen, in_channels, stride=cfg.get("stride", 1), **common)
        if cfg["type"] == "FPT":
            _only(cfg, "neck", ("type", "in_channels", "out_channels", "num_outs",
                                "fpt_rendering"))
            return FPT(gen, in_channels, fpt_rendering=cfg.get("fpt_rendering", True), **common)
        _only(cfg, "neck", ("type", "in_channels", "out_channels", "num_outs", "start_level"))
        return FPTLite(gen, in_channels, start_level=cfg.get("start_level", 0), **common)
    if cfg["type"] in ("FPN", "SPPFPN"):
        # no activation, as every ported config's FPN; norms and ConvWS as the
        # JAX FPN takes them; the SPP laterals of SPPFPN (its fpn convs take
        # no conv_cfg)
        _check({"FPN act": cfg.get("act")}, "FPN act", (None,))
        _check(cfg, "add_extra_convs", (False, True, "on_input", "on_lateral", "on_output"),
               False)
        spp = cfg.get("SPP_type", "ASPP") if cfg["type"] == "SPPFPN" else None
        if spp:
            _check(cfg, "conv_cfg", (None,))
            _check({"SPP_type": spp}, "SPP_type", SPP_TYPES)
        return FPN(gen, in_channels=cfg["in_channels"], spp_type=spp,
                   out_channels=cfg.get("out_channels", 256), num_outs=cfg.get("num_outs", 5),
                   start_level=cfg.get("start_level", 0), end_level=cfg.get("end_level", -1),
                   add_extra_convs=cfg.get("add_extra_convs", False),
                   relu_before_extra_convs=cfg.get("relu_before_extra_convs", False),
                   norm_cfg=_norm_cfg(cfg, "neck"), conv_cfg=_conv_cfg(cfg, "neck"),
                   no_norm_on_lateral=cfg.get("no_norm_on_lateral", False))
    _check(cfg, "norm_cfg", (None,))
    _check(cfg, "no_norm_on_lateral", (False,), False)
    _check(cfg, "add_extra_convs", (False, "on_output"), False)
    _check(cfg, "relu_before_extra_convs", (False,), False)
    return PAFPN(
        gen,
        in_channels=cfg["in_channels"],
        out_channels=cfg.get("out_channels", 256),
        num_outs=cfg.get("num_outs", 5),
        start_level=cfg.get("start_level", 0),
        end_level=cfg.get("end_level", -1),
        add_extra_convs=cfg.get("add_extra_convs", False),
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
    "VarifocalLoss": ("type", "use_sigmoid", "alpha", "gamma", "iou_weighted", "loss_weight"),
    "IoULoss": ("type", "linear", "mode", "eps", "loss_weight"),
    "CIoULoss": ("type", "eps", "loss_weight"),
    "GIoULoss": ("type", "eps", "loss_weight"),
    "DIoULoss": ("type", "eps", "loss_weight"),
    "EIoULoss": ("type", "eps", "loss_weight"),
    "FocalEIoULoss": ("type", "gamma", "eps", "loss_weight"),
    "BoundedIoULoss": ("type", "beta", "eps", "loss_weight"),
    "SeesawLoss": ("type", "use_sigmoid", "p", "q", "num_classes", "eps", "loss_weight"),
    "CrossEntropyLoss": ("type", "use_sigmoid", "use_mask", "class_weight", "loss_weight"),
    "MSELoss": ("type", "loss_weight"),
    "L1Loss": ("type", "loss_weight"),
    "SmoothL1Loss": ("type", "beta", "loss_weight"),
}


def _loss(cfg: Dict[str, Any], key: str, types, default=None) -> Dict[str, Any]:
    """The loss config ``cfg[key]``, its type checked against ``types``."""
    # a nested ``_delete_`` (the merged config keeps one inside a replaced
    # dict) is the config system's, not the loss's: the JAX builder ignores it
    loss = {k: v for k, v in (cfg.get(key) or dict(default or {})).items() if k != "_delete_"}
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


# the ATSS RPN's box losses by config type (JAX builder.py:55-66)
_RPN_BOX_LOSSES = {"IoULoss": "iou", "GIoULoss": "giou", "CIoULoss": "ciou", "DIoULoss": "diou",
                   "EIoULoss": "eiou", "FocalEIoULoss": "focal_eiou"}


def _rpn_cfg(rpn: Dict[str, Any], train_rpn: Dict[str, Any]) -> ATSSRPNCfg:
    """The ATSS RPN's coder, losses and train assigner (JAX
    ``build_rpn``).  With ``atss=True`` the ATSS assignment takes every
    anchor and reads nothing of ``train_cfg.rpn`` (the ensemble configs
    inherit a random sampler there from the Cascade R-CNN base, which the
    JAX package does not read either); with an ``aug_reg_loss`` the
    decoded-box branch adds the MSE term (``with_aug_loss``).  A
    ``VarifocalLoss`` objectness and the EIoU and Focal-EIoU box losses are
    read as JAX ``build_rpn`` reads them, at the JAX losses' fixed
    parameters; the encoded-delta branch takes no EIoU (the JAX package's
    has none)."""
    _check(rpn, "atss", (False, True), False)
    atss = rpn.get("atss", False)
    _check(rpn, "reg_decoded_bbox", (True, False), True)
    loss_cls = _loss(rpn, "loss_cls", ("FocalLoss", "VarifocalLoss"), {"type": "FocalLoss"})
    _check(loss_cls, "use_sigmoid", (True,), True)
    varifocal = loss_cls["type"] == "VarifocalLoss"
    if varifocal:  # the JAX RPN calls varifocal_loss at its defaults
        for key, value in (("alpha", 0.75), ("gamma", 2.0), ("iou_weighted", True)):
            _check(loss_cls, key, (value,), value)
    loss_bbox = _loss(rpn, "loss_bbox", tuple(_RPN_BOX_LOSSES), {"type": "IoULoss"})
    box_type = _RPN_BOX_LOSSES[loss_bbox["type"]]
    if box_type in ("eiou", "focal_eiou") and not rpn.get("reg_decoded_bbox", True):
        raise _unported("rpn_head.loss_bbox.type (on the encoded deltas)", loss_bbox["type"])
    _check(loss_bbox, "linear", (False,), False)
    _check(loss_bbox, "mode", ("log",), "log")
    _check(loss_bbox, "eps", (1e-7,), 1e-7)  # the JAX RPN calls ciou_loss at its default
    _check(loss_bbox, "gamma", (0.5,), 0.5)  # focal_eiou_loss's
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
        loss_bbox_type=box_type, loss_cls_type="varifocal" if varifocal else "focal",
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
                     train_rcnn: Dict[str, Any], gen: torch.Generator, scoring: bool = False,
                     shared: Optional[Res5BBoxHead] = None, shared_size: int = 14):
    """The FCN mask head, the mask RoIAlign's pooled size and, for
    ``scoring`` (``MaskScoringRCNN``) or a ``mask_iou_head`` in the RoI
    head, the MaskIoU head, else None (JAX ``build_detector``'s
    ``FCNMaskHead`` case).  With the C4 box head ``shared`` and no
    ``mask_roi_extractor``, the mask branch pools at the box extractor's
    ``shared_size`` and runs the box head's ``res5`` first (JAX
    ``mask_on_shared``): the FCN head reads its channels and gives logits
    of the ``res5`` output's size times 2.  The targets follow the head's
    output (JAX ``two_stage.py:697-706``): a ``train_cfg.rcnn.mask_size``
    of another size raises."""
    mh = roi["mask_head"]
    _check_mask_head(mh, ("FCNMaskHead",), norm=True)
    if shared is not None and not roi.get("mask_roi_extractor"):
        if scoring or roi.get("mask_iou_head"):
            raise _unported("mask_iou_head (on a shared res5 head)", roi.get("mask_iou_head"))
        # res5's first block halves the pooled size (stride 2, either style)
        out_size, head_in = shared_size, shared.out_channels
        head_out = 2 * ((shared_size - 1) // 2 + 1)
    else:
        if shared is not None:  # the JAX net would feed C4's res5 input to the mask head
            raise _unported("mask_roi_extractor (beside a shared_head)",
                            roi["mask_roi_extractor"])
        out_size = _mask_extractor(roi, strides)
        head_in, head_out = mh.get("in_channels", channels), 2 * out_size
    _check(train_rcnn, "mask_size", (head_out,), head_out)
    _check(roi, "semantic_head", (None,))
    mask_classes = mh.get("num_classes", num_classes)
    module = FCNMaskHead(gen, num_classes=mask_classes, in_channels=head_in,
                         num_convs=mh.get("num_convs", 4),
                         conv_channels=mh.get("conv_out_channels", 256),
                         norm_cfg=_norm_cfg(mh, "mask_head"),
                         predictor_cfg=mh.get("predictor_cfg"))
    iou_module = None
    if scoring or roi.get("mask_iou_head"):
        iou_module = _mask_iou_head(roi.get("mask_iou_head") or {}, channels, mask_classes,
                                    out_size, gen)
    else:
        _check(train_rcnn, "mask_thr_binary", (None,))
    return module, out_size, iou_module


def _mask_iou_head(mih: Dict[str, Any], channels: int, num_classes: int, out_size: int,
                   gen: torch.Generator) -> MaskIoUHead:
    """Mask Scoring R-CNN's ``MaskIoUHead`` (JAX ``builder.py:2355-2369``):
    its convs, FCs and classes from the config, on the mask branch's pooled
    neck channels (the JAX package reads no ``in_channels``); two FCs, the
    loss half the mean squared error, and the targets binarised at 0.5, as
    the JAX package fixes them."""
    _only(mih, "mask_iou_head", ("type", "num_convs", "num_fcs", "roi_feat_size", "in_channels",
                                 "conv_out_channels", "fc_out_channels", "num_classes",
                                 "loss_iou"))
    for key, value in (("type", "MaskIoUHead"), ("num_fcs", 2), ("roi_feat_size", out_size)):
        _check({f"mask_iou_head.{key}": mih.get(key, value)}, f"mask_iou_head.{key}", (value,))
    loss = _loss(mih, "loss_iou", ("MSELoss",), {"type": "MSELoss", "loss_weight": 0.5})
    _check({"mask_iou_head.loss_iou.loss_weight": loss.get("loss_weight", 1.0)},
           "mask_iou_head.loss_iou.loss_weight", (0.5,))
    return MaskIoUHead(gen, num_classes=mih.get("num_classes", num_classes), in_channels=channels,
                       num_convs=mih.get("num_convs", 4),
                       conv_channels=mih.get("conv_out_channels", 256),
                       fc_channels=mih.get("fc_out_channels", 1024), roi_feat_size=out_size)


def _check_mask_head(mh: Dict[str, Any], types, norm: bool = False) -> None:
    """An FCN-style mask head of ``types`` as the port has it: 3x3 convs
    (with a ``norm_cfg`` where ``norm``: Mask R-CNN's ``FCNMaskHead``; the
    JAX ``FCNMaskHead`` reads no ``conv_cfg``, so a ConvWS one leaves its
    convs plain), a 2x deconvolution, a plain or ``NormedConv2d`` 1x1
    predictor (its temperature only), per-class masks, the binary cross
    entropy at weight 1."""
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
    predictor = mh.get("predictor_cfg")
    if (predictor or {}).get("type") == "NormedConv2d":
        _only(predictor, "mask_head.predictor_cfg", ("type", "tempearture", "temperature"))
    else:
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


# the R-CNN head's box losses by config type (JAX builder.py:55-66): on the
# encoded deltas, and with reg_decoded_bbox on the decoded boxes, each with
# the parameters the JAX head calls it at (bbox_head.py:242-255)
_BOX_LOSSES = {"L1Loss": "l1", "SmoothL1Loss": "smooth_l1"}
_DECODED_BOX_LOSSES = {"IoULoss": "iou", "GIoULoss": "giou", "CIoULoss": "ciou",
                       "BoundedIoULoss": "bounded_iou", "EIoULoss": "eiou",
                       "FocalEIoULoss": "focal_eiou"}
_DECODED_LOSS_FIXED = {"IoULoss": {"linear": False, "mode": "log", "eps": 1e-6},
                       "GIoULoss": {"eps": 1e-7}, "CIoULoss": {"eps": 1e-7},
                       "BoundedIoULoss": {"beta": 0.2, "eps": 1e-3},
                       "EIoULoss": {"eps": 1e-7}, "FocalEIoULoss": {"gamma": 0.5, "eps": 1e-7}}


# the box heads' (shared convs, shared FCs) by type (JAX ``_std_convfc_head``)
_HEAD_PRESETS = {"Shared4Conv1FCBBoxHead": (4, 1)}


def _bbox_head(head: Dict[str, Any], channels: int, out_size: int, gen: torch.Generator,
               types=("ProbConvFCBBoxHead", "Shared2FCBBoxHead", "ConvFCBBoxHead",
                      "Shared4Conv1FCBBoxHead"),
               **head_kw):
    """A ConvFC box head module of ``types`` (JAX ``_std_convfc_head``:
    Shared2FC, or Shared4Conv1FC's 3x3 convs with their ``conv_cfg`` and
    ``norm_cfg`` and one FC) and its coder and losses (``build_bbox_head``);
    ``head_kw`` (Dynamic R-CNN's state options) go to the module, and a
    Seesaw loss gives it its counts."""
    _check(head, "type", types)
    cfg = _bbox_cfg(head)
    convs, fcs = _HEAD_PRESETS.get(head.get("type"), (0, 2))
    module = ConvFCBBoxHead(
        gen, num_classes=head.get("num_classes", 80), in_channels=channels,
        num_shared_fcs=head.get("num_shared_fcs", fcs),
        fc_out_channels=head.get("fc_out_channels", 1024), roi_feat_size=out_size,
        reg_class_agnostic=head.get("reg_class_agnostic", False),
        num_shared_convs=head.get("num_shared_convs", convs),
        conv_out_channels=head.get("conv_out_channels", 256),
        conv_cfg=_conv_cfg(head, "bbox_head"), norm_cfg=_norm_cfg(head, "bbox_head"),
        seesaw=cfg.loss_cls_type == "seesaw", **head_kw,
    )
    return module, cfg


def _bbox_cfg(head: Dict[str, Any]) -> BBoxHeadCfg:
    """The Shared2FC head's coder and losses (JAX ``build_bbox_head``):
    cross entropy or the Seesaw loss (its ``p`` and ``q``; the JAX loss's
    fixed ``eps`` 1e-2); L1 or smooth L1 on the deltas, or with
    ``reg_decoded_bbox`` an IoU-family loss on the decoded boxes."""
    _check(head, "reg_decoded_bbox", (False, True), False)
    decoded = head.get("reg_decoded_bbox", False)
    _check(head, "focal_reg", (False,), False)
    num_classes = head.get("num_classes", 80)
    loss_cls = _loss(head, "loss_cls", ("CrossEntropyLoss", "SeesawLoss"),
                     {"type": "CrossEntropyLoss"})
    seesaw = loss_cls["type"] == "SeesawLoss"
    for key in ("use_sigmoid", "use_mask"):
        _check(loss_cls, key, (False,), False)
    _check(loss_cls, "class_weight", (None,))
    if seesaw:
        _check(loss_cls, "eps", (1e-2,), 1e-2)
        _check(loss_cls, "num_classes", (num_classes,), num_classes)
    losses = _DECODED_BOX_LOSSES if decoded else _BOX_LOSSES
    if (head.get("loss_bbox") or {"type": "L1Loss"}).get("type") not in losses:
        raise _unported(f"loss_bbox.type (with reg_decoded_bbox={decoded})",
                        head["loss_bbox"].get("type"))
    loss_bbox = _loss(head, "loss_bbox", tuple(losses), {"type": "L1Loss"})
    for key, value in _DECODED_LOSS_FIXED.get(loss_bbox["type"], {}).items():
        _check(loss_bbox, key, (value,), value)
    means, stds = _coder(head, (1.0,) * 4)
    return BBoxHeadCfg(
        num_classes=num_classes, target_means=means, target_stds=stds,
        reg_class_agnostic=head.get("reg_class_agnostic", False), reg_decoded_bbox=decoded,
        loss_cls_weight=loss_cls.get("loss_weight", 1.0),
        loss_bbox_weight=loss_bbox.get("loss_weight", 1.0),
        loss_bbox_type=losses[loss_bbox["type"]],
        smooth_l1_beta=loss_bbox.get("beta", 1.0),
        loss_cls_type="seesaw" if seesaw else "ce",
        seesaw_p=loss_cls.get("p", 0.8), seesaw_q=loss_cls.get("q", 2.0),
    )


def _roi_cfg(roi: Dict[str, Any], train_rcnn: Dict[str, Any],
             point_rend: bool = False) -> ProbRoICfg:
    """The RoI head's boosting options (boosting on by default for
    ``ProbRoIHead`` only, prior fusion for ``ProbRoIHead`` and
    ``BoostRoIHead``) and its train sampler and assigner (JAX
    ``build_detector``, two-stage branch); PointRend's ``point`` options
    are ``_point_rend_parts``'."""
    _check(roi, "quality", (False,), False)
    _check(roi, "alpha", (0,), 0)
    _check(roi, "reg_norm", ("bbox_num", "mean"), "bbox_num")
    _only(train_rcnn, "train_cfg.rcnn", ("assigner", "sampler", "pos_weight", "debug",
                                         "mask_size", "mask_thr_binary", "isr", "carl")
          + (("dynamic_rcnn",) if roi["type"] == "DynamicRoIHead" else ())
          + (("point",) if point_rend else ()))
    sampler = train_rcnn.get("sampler", {})
    # PISA's ScoreHLRSampler is read as the random sampler: the JAX builder
    # reads its num, pos_fraction, neg_pos_ub and add_gt_as_proposals and
    # neither its type nor its k and bias (builder.py:2452-2471)
    hlr = sampler.get("type") == "ScoreHLRSampler"
    _only(sampler, "train_cfg.rcnn.sampler", ("type", "num", "pos_fraction", "neg_pos_ub",
                                              "add_gt_as_proposals")
          + (("k", "bias") if hlr else ()))
    _check(sampler, "type", ("RandomSampler", "ScoreHLRSampler"), "RandomSampler")
    _check(sampler, "add_gt_as_proposals", (True,), True)
    _check(train_rcnn, "pos_weight", (-1,), -1)
    _check(train_rcnn, "debug", (False,), False)
    # the MaskIoU targets' binarisation (``mask_iou_targets``' fixed 0.5)
    _check(train_rcnn, "mask_thr_binary", (None, 0.5))
    prob_head = roi["type"] == "ProbRoIHead"
    boost = roi.get("boost", prob_head)
    pisa = {}
    for key in ("isr", "carl"):  # PISA's (JAX builder.py:2475-2476)
        part = train_rcnn.get(key)
        if part is not None:
            _only(part, f"train_cfg.rcnn.{key}", ("k", "bias"))
            if boost:  # the JAX boosting loss reads neither
                raise _unported(f"train_cfg.rcnn.{key} (beside the boosting loss)", part)
            pisa[key] = tuple(sorted(part.items()))
    return ProbRoICfg(
        gamma=roi.get("gamma", 0.1), boost=boost,
        # the fork's ProbPISARoIHead: PISA's losses, the prior fusion at test
        prob=roi.get("prob", roi["type"] in ("ProbRoIHead", "BoostRoIHead", "ProbPISARoIHead")),
        reg_norm=roi.get("reg_norm", "bbox_num"), **pisa,
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
    _check(model_cfg, "type", ("FasterRCNN", "MaskRCNN", "MaskScoringRCNN", "PointRend",
                               "CascadeRCNN") + _HTC_TYPES + tuple(_DG_TYPES))
    for key in ("num_domains", "total_img", "jig_classes", "k"):
        if key in model_cfg and key not in _DG_TYPES.get(model_cfg["type"], ()):
            raise _unported(f"{model_cfg['type']} {key}", model_cfg[key])
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
    neck_cfg = model_cfg.get("neck")
    if isinstance(neck_cfg, list):
        raise _unported("neck (stacked necks)", [n.get("type") for n in neck_cfg])
    if neck_cfg:
        neck = _build_neck(neck_cfg, gen, getattr(backbone, "out_channels", None))
        channels = neck_cfg.get("out_channels", 256)
    else:
        # C4 and DC5 (JAX builder.py:2240-2252): no neck, the backbone's one
        # map feeds the RPN and the RoI heads
        neck, neck_cfg = None, {}
        if cascade or len(getattr(backbone, "out_channels", ())) != 1:
            raise _unported("neck (none, beside a cascade or several backbone outputs)",
                            model_cfg.get("neck"))
        channels = backbone.out_channels[0]
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

    point_rend = model_cfg["type"] == "PointRend"
    _check(roi, "type", ("PointRendRoIHead",) if point_rend else (
        "ProbRoIHead", "StandardRoIHead", "BoostRoIHead", "DynamicRoIHead",
        "MaskScoringRoIHead", "ProbPISARoIHead"))
    scoring = model_cfg["type"] == "MaskScoringRCNN"
    if (scoring or point_rend) and not roi.get("mask_head"):
        raise ValueError(f"{model_cfg['type']} needs a mask_head")
    train_rcnn = train_cfg.get("rcnn") or {}
    dynamic = roi["type"] == "DynamicRoIHead"
    head_kw, det_kw = _dynamic_rcnn(train_rcnn, roi) if dynamic else ({}, {})
    if roi.get("shared_head"):
        if dynamic:
            raise _unported("shared_head (in a DynamicRoIHead)", roi["shared_head"])
        bbox_module, bbox_cfg = _res5_head(roi, channels, gen)
    else:
        bbox_module, bbox_cfg = _bbox_head(roi["bbox_head"], channels, out_size, gen, **head_kw)
    roi_cfg = _roi_cfg(roi, train_rcnn, point_rend)
    mask_module, mask_out_size, iou_module, point_module = None, 14, None, None
    if point_rend:
        mask_module, mask_out_size, point_module, det_kw = _point_rend_parts(
            roi, strides, channels, bbox_cfg.num_classes, train_cfg, test_cfg, gen)
    elif roi.get("mask_head"):
        mask_module, mask_out_size, iou_module = _build_mask_head(
            roi, strides, channels, bbox_cfg.num_classes, train_rcnn, gen, scoring,
            shared=bbox_module if roi.get("shared_head") else None, shared_size=out_size)
    else:
        for key in ("mask_size", "mask_thr_binary"):
            _check(train_rcnn, key, (None,))
        _check(roi, "mask_iou_head", (None,))

    dg_kw = _dg_parts(model_cfg, backbone, channels, gen)
    if dg_kw and (point_rend or dynamic or not neck):
        raise _unported(f"{model_cfg['type']} with a {roi['type']}"
                        f"{'' if neck else ' and no neck'}", model_cfg["type"])
    net = TwoStageNet(backbone, neck, rpn_module, bbox_module, mask_head=mask_module,
                      mask_roi_out_size=mask_out_size, mask_iou_head=iou_module,
                      mask_on_shared=bool(roi.get("shared_head") and mask_module is not None),
                      point_head=point_module, **roi_kw, **dg_kw)
    set_compute_dtype(net, dtype)
    det_cls = (PointRendDetector if point_rend else
               DynamicRCNNDetector if dynamic else
               _DG_DETECTORS.get(model_cfg["type"], TwoStageDetector))
    return det_cls(
        net, ag, rpn_cfg=rpn_cfg, roi_cfg=roi_cfg, bbox_cfg=bbox_cfg, device=device,
        train_proposal_cfg=_proposal_cfg(train_cfg.get("rpn_proposal") or {}, 4000, 2000),
        test_proposal_cfg=_proposal_cfg(test_cfg.get("rpn") or {}, 1000, 256),
        rcnn_test_cfg=rcnn_test,
        rpn_type=rpn_type, **det_kw,
    )


# the fork's DG and EMA detectors, each with the model keys it reads
_DG_TYPES = {"DGFasterRCNN": ("num_domains", "total_img"),
             "JiGENFasterRCNN": ("jig_classes",), "DGaugFasterRCNN": (),
             "EMAFasterRCNN": ("k",)}
_DG_DETECTORS = {"DGFasterRCNN": DGFasterRCNNDetector,
                 "JiGENFasterRCNN": JiGENFasterRCNNDetector,
                 "DGaugFasterRCNN": DGaugFasterRCNNDetector}


def _dg_parts(model_cfg: Dict[str, Any], backbone, channels: int, gen: torch.Generator):
    """``TwoStageNet``'s ``domain_head`` / ``jig_head`` / ``emau`` for the DG
    and EMA detector types (JAX ``builder.py:2397-2421``): DANN's
    ``DomainClassifier`` on the backbone's second output (``num_domains``
    2, ``total_img`` 56064), JiGEN's ``JigsawClassifier`` on its last
    (``jig_classes`` 31), EMAFasterRCNN's ``FPEMAU`` over the neck's
    ``channels`` (``k`` 64)."""
    t = model_cfg["type"]
    if t == "DGFasterRCNN":
        return {"domain_head": DomainClassifier(
            backbone.out_channels[1], gen, num_domains=model_cfg.get("num_domains", 2),
            total_img=float(model_cfg.get("total_img", 56064)))}
    if t == "JiGENFasterRCNN":
        return {"jig_head": JigsawClassifier(backbone.out_channels[-1], gen,
                                             jig_classes=model_cfg.get("jig_classes", 31))}
    if t == "EMAFasterRCNN":
        return {"emau": FPEMAU(channels, model_cfg.get("k", 64), gen)}
    return {}


def _res5_head(roi: Dict[str, Any], channels: int, gen: torch.Generator):
    """The C4 detectors' shared res5 head and its ``BBoxHeadCfg`` (JAX
    ``builder.py:2269-2293``): three caffe- or pytorch-style res5
    bottlenecks (mmdet's ``ResLayer`` of ResNet-50's stage 3) of half the
    pooled channels as planes, 512 on C4's 1024 channels, the JAX
    package's fixed width (a narrower backbone, as ``--tiny`` makes, gets
    a narrower res5), the average pool and ``fc_cls`` / ``fc_reg``.  Like the JAX
    builder, the ``BBoxHeadCfg`` takes the classes, the coder,
    ``reg_class_agnostic``, the box loss's weight and ``beta`` from the
    config and leaves the rest at its defaults: the L1 box loss and a
    classification weight of 2.0, whatever ``loss_cls`` says."""
    shared = roi["shared_head"]
    _only(shared, "shared_head", ("type", "depth", "stage", "stride", "dilation", "style",
                                  "norm_eval", "norm_cfg"))
    for key, value in (("type", "ResLayer"), ("depth", 50), ("stage", 3), ("stride", 2),
                       ("dilation", 1), ("norm_eval", True)):
        _check({f"shared_head.{key}": shared.get(key, value)}, f"shared_head.{key}", (value,))
    _check(shared, "style", ("pytorch", "caffe"), "pytorch")
    # the JAX res5 blocks' BN is frozen whatever the config says
    _check({"shared_head.norm_cfg.type": (shared.get("norm_cfg") or {}).get("type", "BN")},
           "shared_head.norm_cfg.type", ("BN", "SyncBN", "FrozenBN"))
    head = roi["bbox_head"]
    _only(head, "bbox_head", ("type", "with_avg_pool", "roi_feat_size", "in_channels",
                              "num_classes", "bbox_coder", "reg_class_agnostic", "loss_cls",
                              "loss_bbox"))
    _check(head, "type", ("BBoxHead",))
    _check(head, "with_avg_pool", (True,))
    loss_cls = _loss(head, "loss_cls", ("CrossEntropyLoss",), {"type": "CrossEntropyLoss"})
    _check(loss_cls, "use_sigmoid", (False,), False)
    _check(loss_cls, "class_weight", (None,))
    loss_bbox = _loss(head, "loss_bbox", ("L1Loss",), {"type": "L1Loss"})
    num_classes = head.get("num_classes", 80)
    agnostic = head.get("reg_class_agnostic", False)
    means, stds = _coder(head, (1.0,) * 4)
    module = Res5BBoxHead(gen, num_classes=num_classes, in_channels=channels,
                          planes=channels // 2, reg_class_agnostic=agnostic,
                          style=shared.get("style", "pytorch"))
    return module, BBoxHeadCfg(num_classes=num_classes, target_means=means, target_stds=stds,
                               reg_class_agnostic=agnostic,
                               loss_bbox_weight=loss_bbox.get("loss_weight", 1.0))


def _point_rend_parts(roi: Dict[str, Any], strides, channels: int, num_classes: int,
                      train_cfg: Dict[str, Any], test_cfg: Dict[str, Any],
                      gen: torch.Generator):
    """PointRend's ``CoarseMaskHead``, the mask RoIAlign's pooled size, the
    ``MaskPointHead`` and the detector's ``point_cfg`` (JAX
    ``builder.py:2319-2345``, ``:2524-2543``): the coarse head's convs, FCs,
    ``roi_feat_size`` and ``downsample_factor`` from the config and its
    conv width 256 (the JAX package reads no ``conv_out_channels``); the
    point head's FCs on the finest neck level's channels and the classes'
    coarse logits; ``train_cfg.rcnn.point`` and
    ``test_cfg.rcnn.subdivision_*``.  Like the JAX builder it reads no
    ``train_cfg.rcnn.mask_size``: the coarse targets take the coarse
    head's size (7)."""
    mh = roi["mask_head"]
    _only(mh, "mask_head", ("type", "num_convs", "num_fcs", "in_channels", "conv_out_channels",
                            "fc_out_channels", "num_classes", "roi_feat_size",
                            "downsample_factor"))
    _check(mh, "type", ("CoarseMaskHead",))
    _check(mh, "conv_out_channels", (256,), 256)
    out_size = _mask_extractor(roi, strides)
    _check({"mask_head.roi_feat_size": mh.get("roi_feat_size", 14)}, "mask_head.roi_feat_size",
           (out_size,))
    coarse = CoarseMaskHead(gen, num_classes=mh.get("num_classes", num_classes),
                            in_channels=channels, num_convs=mh.get("num_convs", 0),
                            num_fcs=mh.get("num_fcs", 2),
                            fc_channels=mh.get("fc_out_channels", 1024), roi_feat_size=out_size,
                            downsample_factor=mh.get("downsample_factor", 2))
    ph = roi.get("point_head") or {}
    _only(ph, "point_head", ("type", "num_fcs", "in_channels", "fc_channels", "num_classes",
                             "coarse_pred_each_layer"))
    _check(ph, "type", ("MaskPointHead",), "MaskPointHead")
    point = MaskPointHead(gen, in_channels=channels, num_classes=ph.get("num_classes",
                                                                       num_classes),
                          num_fcs=ph.get("num_fcs", 3), fc_channels=ph.get("fc_channels", 256),
                          coarse_pred_each_layer=ph.get("coarse_pred_each_layer", True))
    if point.fc_logits.out_features != coarse.num_classes:
        raise ValueError(f"point_head has {point.fc_logits.out_features} classes, the coarse "
                         f"mask head {coarse.num_classes}")
    pc = (train_cfg.get("rcnn") or {}).get("point") or {}
    _only(pc, "train_cfg.rcnn.point", ("num_points", "oversample_ratio",
                                       "importance_sample_ratio"))
    tc = test_cfg.get("rcnn") or {}
    cfg = PointRendCfg(num_points=pc.get("num_points", 196),
                       oversample_ratio=pc.get("oversample_ratio", 3.0),
                       importance_sample_ratio=pc.get("importance_sample_ratio", 0.75),
                       subdivision_steps=tc.get("subdivision_steps", 5),
                       subdivision_num_points=tc.get("subdivision_num_points", 784),
                       scale_factor=tc.get("scale_factor", 2))
    _check({"test_cfg.rcnn.scale_factor": cfg.scale_factor}, "test_cfg.rcnn.scale_factor", (2,))
    return coarse, out_size, point, {"point_cfg": cfg}


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
                                   res_channels=res_channels if i and conv_res else None,
                                   predictor_cfg=mh.get("predictor_cfg")))
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
