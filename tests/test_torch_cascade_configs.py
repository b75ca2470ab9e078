"""Which Cascade R-CNN configs the PyTorch port builds, on the CPU, at full
width (no JAX).

Every config file named ``*cascade*`` is a ``CascadeRCNN``.  The box-only
ones and the Cascade Mask R-CNN ones on the ported backbones build
(``BUILDS``, 22 + 30 files, the ensemble configs' ATSS and RetinaNet-style
RPNs and the caffe-style ResNets among them; files with the same model,
such as a 1x and a 20e schedule, are built once); every other one raises
``NotImplementedError`` naming what is missing (``_reason``): DetectoRS,
HRNet, RegNet, ResNeSt, the Seesaw loss and SABL heads.  Each built one is
checked against its config: one class-agnostic stage head per stage, the
IoU ladder, the stage loss weights, boosting and fusion for
``ProbCascadeRoIHead`` only, the ensemble configs' RPN (its type, ATSS
and its losses); a Cascade Mask R-CNN one is the HTC detector with one
mask head per stage, none with a ``conv_res``, trained on each stage's
own sample (not interleaved) and without information flow.

``test_fork_head_config_builds`` builds the six configs of the fork's
remaining heads (the four ensemble cascades, ``ensemble/boosting_rcnn``'s
focal RPN with ``BoostRoIHead``, Dynamic R-CNN) and checks the detector
type, the RPN and the RoI head each is read as.
"""
import functools
import glob
import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.models import layers as t_layers  # noqa: E402
from boosting_rcnn_tpu_torch.models import plugins as t_plugins  # noqa: E402
from boosting_rcnn_tpu_torch.models.detectors.cascade import CascadeDetector  # noqa: E402
from boosting_rcnn_tpu_torch.models.detectors.htc import HTCDetector  # noqa: E402
from boosting_rcnn_tpu_torch.models.detectors.two_stage import (  # noqa: E402
    DynamicRCNNDetector,
    TwoStageDetector,
)

CONFIGS = os.path.join(REPO, "configs")
BUILDS = {
    "cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py", "cascade_rcnn/cascade_rcnn_r50_fpn_20e_coco.py",
    "cascade_rcnn/cascade_rcnn_r50_fpn_1x_brackish.py",
    "cascade_rcnn/cascade_rcnn_r50_fpn_1x_trashcanins.py",
    "cascade_rcnn/cascade_rcnn_s4_r50_fpn_1x_coco.py",
    "cascade_rcnn/cascade_rcnn_r101_fpn_1x_coco.py", "cascade_rcnn/cascade_rcnn_r101_fpn_20e_coco.py",
    "cascade_rcnn/cascade_rcnn_x101_32x4d_fpn_1x_coco.py",
    "cascade_rcnn/cascade_rcnn_x101_32x4d_fpn_20e_coco.py",
    "cascade_rcnn/cascade_rcnn_x101_64x4d_fpn_1x_coco.py",
    "cascade_rcnn/cascade_rcnn_x101_64x4d_fpn_20e_coco.py",
    "dcn/cascade_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py", "dcn/cascade_rcnn_r101_fpn_dconv_c3-c5_1x_coco.py",
    "ensemble/prob_cascade_rcnn_r50_pafpn_1x_utdac.py",
    "ensemble/cascade_atss_r50_fpn_1x_coco.py", "ensemble/cascade_atss_s2_r50_fpn_1x_coco.py",
    "ensemble/cascade_retinanet_r50_fpn_1x_coco.py",
    "ensemble/cascade_retinanet_s2_r50_fpn_1x_coco.py",
    "pascal_voc/cascade_rcnn_r50_fpn_1x_voc0712.py", "res2net/cascade_rcnn_r2_101_fpn_20e_coco.py",
    "cascade_rcnn/cascade_rcnn_r50_caffe_fpn_1x_coco.py",
    "cascade_rcnn/cascade_rcnn_r101_caffe_fpn_1x_coco.py",
    # Cascade Mask R-CNN
    *(f"cascade_rcnn/cascade_mask_rcnn_{m}.py" for m in (
        "r50_fpn_1x_coco", "r50_fpn_20e_coco", "r50_fpn_mstrain_3x_coco", "r101_fpn_1x_coco",
        "r101_fpn_20e_coco", "r101_fpn_mstrain_3x_coco", "x101_32x4d_fpn_1x_coco",
        "x101_32x4d_fpn_20e_coco", "x101_32x4d_fpn_mstrain_3x_coco", "r50_caffe_fpn_1x_coco",
        "r50_caffe_fpn_mstrain_3x_coco", "r101_caffe_fpn_1x_coco", "r101_caffe_fpn_mstrain_3x_coco",
        "x101_32x8d_fpn_mstrain_3x_coco", "x101_64x4d_fpn_1x_coco", "x101_64x4d_fpn_20e_coco",
        "x101_64x4d_fpn_mstrain_3x_coco")),
    "dcn/cascade_mask_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py",
    "dcn/cascade_mask_rcnn_r101_fpn_dconv_c3-c5_1x_coco.py",
    "dcn/cascade_mask_rcnn_x101_32x4d_fpn_dconv_c3-c5_1x_coco.py",
    "instaboost/cascade_mask_rcnn_r50_fpn_instaboost_4x_coco.py",
    "instaboost/cascade_mask_rcnn_r101_fpn_instaboost_4x_coco.py",
    "instaboost/cascade_mask_rcnn_x101_64x4d_fpn_instaboost_4x_coco.py",
    "res2net/cascade_mask_rcnn_r2_101_fpn_20e_coco.py",
    # GCNet's: ResNeXt's BN frozen, as the JAX
    # build_resnext reads no norm_eval, with and without its ContextBlocks
    *(f"gcnet/cascade_mask_rcnn_x101_32x4d_fpn_syncbn-backbone_{m}1x_coco.py" for m in (
        "", "dconv_c3-c5_", "dconv_c3-c5_r16_gcb_c3-c5_", "dconv_c3-c5_r4_gcb_c3-c5_",
        "r16_gcb_c3-c5_", "r4_gcb_c3-c5_")),
}


def _names():
    return sorted(os.path.relpath(p, CONFIGS)
                  for p in glob.glob(os.path.join(CONFIGS, "*", "*cascade*.py")))


def _reason(name: str) -> str:
    """The missing piece that the builder names for a config it rejects."""
    for key, what in (("detectors/", "DetectoRS_ResNet"), ("hrnet/", "HRNet"),
                      ("resnest/", "ResNeSt"), ("sabl/", "SABLHead"),
                      ("regnet/", "RegNet"),
                      ("seesaw_loss/", "SeesawLoss")):
        if name.startswith(key):
            return what
    raise AssertionError(f"{name}: no expected reason")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: each full-width build initialises ~70-110M weights,
    and several test workers share the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def seeded_init_skipped():
    """The builds skip the seeded LeCun initialisation: the checks read the
    built detectors' structure and configs, never their weights, and the
    draws took most of the file's time."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (t_layers, t_plugins):
            mp.setattr(module, "lecun_normal_", lambda weight, fan_in, gen: None)
        yield


@functools.lru_cache(maxsize=None)
def _built(model_json: str):
    """What the checks read of the built detector (the detector itself is
    dropped: each holds ~0.3-0.5 GB)."""
    det = build_detector(json.loads(model_json), device="cpu")
    net = det.net
    return dict(type=type(det), cascade=getattr(det, "cascade_cfg", None), roi=det.roi_cfg,
                bbox=det.bbox_cfg, rpn_type=det.rpn_type, rpn=det.rpn_cfg,
                rpn_convs=getattr(net.rpn, "conv_names", None),
                test_proposals=det.test_proposal_cfg.max_per_img,
                heads=[(h.fc_cls.weight.shape[0], h.fc_reg.weight.shape[0])
                       for h in getattr(net, "bbox_heads", [net.bbox_head])],
                dyn={k: v.clone() for k, v in net.state_dict().items() if ".dyn_" in k},
                masks=[(h.conv_logits.weight.shape[0], h.num_convs, h.conv_res is not None)
                       for h in getattr(net, "mask_heads", ())],
                info_flow=getattr(net, "mask_info_flow", None),
                semantic=(None if getattr(net, "semantic_head", None) is None else
                          (net.semantic_head.conv_seg.weight.shape[0], net.semantic_stride)))


def test_the_probe_covers_the_buildable_configs():
    assert BUILDS <= set(_names()) and len(_names()) == 79


@pytest.mark.parametrize("name", _names())
def test_cascade_config_builds_or_names_what_is_missing(name):
    mc = load_config(os.path.join(CONFIGS, name)).model.to_dict()
    assert mc["type"] == "CascadeRCNN"
    if name not in BUILDS:
        with pytest.raises(NotImplementedError, match=_reason(name)):
            build_detector(mc, device="cpu")
        return
    det = _built(json.dumps(mc, sort_keys=True))
    roi = mc["roi_head"]
    if roi.get("mask_head"):
        check_mask_heads(det, roi, htc=False)
    else:
        assert det["type"] is CascadeDetector and det["masks"] == []
    cc = det["cascade"]
    n = roi.get("num_stages", 3)
    heads = roi["bbox_head"] if isinstance(roi["bbox_head"], list) else [roi["bbox_head"]] * n
    assert cc.num_stages == len(det["heads"]) == n
    assert cc.stage_pos_iou == tuple(min(0.5 + 0.1 * i, 0.9) for i in range(n))
    assert cc.stage_loss_weights[:n] == tuple(float(w) for w in roi["stage_loss_weights"])[:n]
    prob = roi["type"] == "ProbCascadeRoIHead"
    assert (cc.prob, cc.boost, det["roi"].prob) == (prob, roi.get("boost", False), prob)
    agnostic = heads[0].get("reg_class_agnostic", False)
    k = heads[0].get("num_classes", 80)
    assert det["bbox"].reg_class_agnostic == agnostic and det["bbox"].num_classes == k
    assert det["heads"] == [(k + 1, 4 if agnostic else 4 * k)] * n
    if name.startswith("ensemble/prob_cascade"):
        assert (cc.gamma, cc.boost, det["rpn_type"]) == (0.5, True, "atss_rpn")
        assert det["test_proposals"] == 256
    if "_s4_" in name:
        assert n == 4 and cc.stage_pos_iou[3] == 0.8
    if name.startswith("ensemble/cascade_"):
        check_ensemble_rpn(det, mc["rpn_head"])


def check_ensemble_rpn(det, rpn):
    """The ensemble configs' RPNs: ATSS assignment with GIoU on decoded
    boxes and no MSE term, or the plain RPN with focal objectness (and
    ``cascade_retinanet``'s four convs, its ``L1Loss`` read as smooth L1 at
    beta 1/9)."""
    r = det["rpn"]
    if rpn["type"] == "ATSSRPNHead":
        assert det["rpn_type"] == "atss_rpn" and r.atss and not r.with_aug_loss
        assert (r.loss_bbox_type, r.loss_bbox_weight) == ("giou",
                                                          rpn["loss_bbox"]["loss_weight"])
        return
    assert det["rpn_type"] == "rpn" and not getattr(r, "atss", False)
    assert (r.loss_cls_type, r.loss_cls_weight) == ("focal", rpn["loss_cls"]["loss_weight"])
    assert len(det["rpn_convs"]) == rpn.get("num_convs", 1)
    assert abs(r.smooth_l1_beta - 1 / 9) < 1e-12


FORK_HEADS = ("ensemble/cascade_atss_r50_fpn_1x_coco.py",
              "ensemble/cascade_atss_s2_r50_fpn_1x_coco.py",
              "ensemble/cascade_retinanet_r50_fpn_1x_coco.py",
              "ensemble/cascade_retinanet_s2_r50_fpn_1x_coco.py",
              "ensemble/boosting_rcnn_r50_fpn_1x_coco.py",
              "dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_coco.py")


@pytest.mark.parametrize("name", FORK_HEADS)
def test_fork_head_config_builds(name):
    """The fork's remaining heads build as the JAX builder reads them: the
    ensemble cascades (a ProbCascade with boosting on an ATSS or focal
    RPN); ``BoostRoIHead`` as prior fusion without boosting on the focal
    plain RPN; ``DynamicRoIHead`` as the ``DynamicRCNNDetector`` with its
    state (iou 0.4, beta 1.0, a 100-step ring) in the box head."""
    mc = load_config(os.path.join(CONFIGS, name)).model.to_dict()
    det = _built(json.dumps(mc, sort_keys=True))
    roi = mc["roi_head"]
    if name.startswith("ensemble/cascade_"):
        assert det["type"] is CascadeDetector
        assert det["cascade"].num_stages == (2 if "_s2_" in name else 3)
        assert det["cascade"].prob and det["cascade"].boost
        check_ensemble_rpn(det, mc["rpn_head"])
        return
    assert det["cascade"] is None and det["heads"] == [(5, 16)]
    if roi["type"] == "BoostRoIHead":
        assert det["type"] is TwoStageDetector and det["dyn"] == {}
        assert (det["roi"].prob, det["roi"].boost, det["roi"].gamma) == (True, False, 0.5)
        check_ensemble_rpn(det, {**mc["rpn_head"], "num_convs": 1})
        return
    assert det["type"] is DynamicRCNNDetector and det["rpn_type"] == "rpn"
    assert not det["roi"].prob and not det["roi"].boost
    dyn = det["dyn"]
    assert float(dyn["bbox_head.dyn_iou_thr"]) == pytest.approx(0.4)
    assert float(dyn["bbox_head.dyn_beta"]) == 1.0
    assert dyn["bbox_head.dyn_iou_hist"].shape == (100,)
    assert not dyn["bbox_head.dyn_beta_hist"].any()
    assert dyn["bbox_head.dyn_count"].dtype == torch.int32 and int(dyn["bbox_head.dyn_count"]) == 0


def check_mask_heads(det, roi, htc: bool):
    """The HTC detector with one mask head per stage of the config's
    classes and convs; for HTC interleaved and with information flow (a
    ``conv_res`` in the heads after the first), for Cascade Mask R-CNN
    neither (no ``conv_res``)."""
    assert det["type"] is HTCDetector
    n = roi.get("num_stages", 3)
    heads = roi["mask_head"] if isinstance(roi["mask_head"], list) else [roi["mask_head"]] * n
    assert det["masks"] == [(h.get("num_classes", 80), h.get("num_convs", 4), htc and i > 0)
                            for i, h in enumerate(heads)]
    assert det["cascade"].interleaved is htc and det["info_flow"] is htc
