"""Which caffe-style configs the PyTorch port builds, predicts with and
trains, on the CPU (no JAX).

Every config file named ``*caffe*`` is probed: the 23 caffe-style Faster
R-CNN, Mask R-CNN, Cascade R-CNN and Cascade Mask R-CNN configs on an FPN
and the 3 SyncBN strong baselines (``BUILDS``) build at full width with the
caffe backbone (each stage's stride on its first block's first 1x1), and
each other one raises ``NotImplementedError`` naming the part that is
missing (``REASONS``): the DC5 ``dilations``, the C4 ``num_stages=3``, and
detector or head types the port lacks.  ``tests/test_torch_caffe_models.py`` drives each
built model at a tiny size.
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

CONFIGS = os.path.join(REPO, "configs")
BUILDS = {
    *(f"faster_rcnn/faster_rcnn_{m}.py" for m in (
        "r50_caffe_fpn_1x_coco", "r101_caffe_fpn_1x_coco", "r101_caffe_fpn_mstrain_3x_coco",
        "r50_caffe_fpn_mstrain_1x_coco-person-bicycle-car", "r50_caffe_fpn_mstrain_1x_coco-person",
        "r50_caffe_fpn_mstrain_1x_coco", "r50_caffe_fpn_mstrain_2x_coco",
        "r50_caffe_fpn_mstrain_3x_coco", "r50_caffe_fpn_mstrain_90k_coco")),
    *(f"mask_rcnn/mask_rcnn_{m}.py" for m in (
        "r50_caffe_fpn_1x_coco", "r101_caffe_fpn_1x_coco", "r101_caffe_fpn_mstrain-poly_3x_coco",
        "r50_caffe_fpn_mstrain-poly_1x_coco", "r50_caffe_fpn_mstrain-poly_2x_coco",
        "r50_caffe_fpn_mstrain-poly_3x_coco", "r50_caffe_fpn_mstrain_1x_coco",
        "r50_caffe_fpn_poly_1x_coco_v1")),
    *(f"cascade_rcnn/cascade_{m}.py" for m in (
        "rcnn_r50_caffe_fpn_1x_coco", "rcnn_r101_caffe_fpn_1x_coco",
        "mask_rcnn_r50_caffe_fpn_1x_coco", "mask_rcnn_r101_caffe_fpn_1x_coco",
        "mask_rcnn_r50_caffe_fpn_mstrain_3x_coco", "mask_rcnn_r101_caffe_fpn_mstrain_3x_coco")),
    # SyncBN with batch statistics in the backbone, frozen BN in the FPN and
    # the heads, as the JAX package builds them
    *(f"strong_baselines/mask_rcnn_r50_caffe_fpn_syncbn-all_rpn-2conv_lsj_{m}_coco.py"
      for m in ("100e", "100e_fp16", "400e")),
}
# the first missing part the builder names, by the file name's start
REASONS = (("cascade_rpn/crpn_faster", "CascadeRPNHead"), ("cascade_rpn/crpn_fast", "FastRCNN"),
           ("cascade_rpn/crpn_r50", "'RPN'"), ("fast_rcnn/", "FastRCNN"),
           ("faster_rcnn/faster_rcnn_r50_caffe_c4", "num_stages=3"),
           ("faster_rcnn/faster_rcnn_r50_caffe_dc5", "dilations"), ("fcos/", "FCOS"),
           ("guided_anchoring/ga_fast_", "FastRCNN"), ("guided_anchoring/ga_faster", "GARPNHead"),
           ("guided_anchoring/ga_retinanet", "RetinaNet"), ("guided_anchoring/ga_rpn", "'RPN'"),
           ("mask_rcnn/mask_rcnn_r50_caffe_c4", "num_stages=3"), ("ms_rcnn/", "MaskScoringRCNN"),
           ("nas_fcos/", "NASFCOS"), ("point_rend/", "PointRend"), ("retinanet/", "RetinaNet"),
           ("rpn/", "'RPN'"),
           ("tridentnet/", "TridentFasterRCNN"))


def _names():
    return sorted(os.path.relpath(p, CONFIGS)
                  for p in glob.glob(os.path.join(CONFIGS, "*", "*caffe*.py")))


def _reason(name: str) -> str:
    for start, what in REASONS:
        if name.startswith(start):
            return what
    raise AssertionError(f"{name}: no expected reason")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: each full-width build initialises 40-60M weights,
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
    """What the checks read of the full-width detector (dropped after)."""
    net = build_detector(json.loads(model_json), device="cpu").net
    return [(getattr(net.backbone, f"layer{s}_0").conv1.stride,
             getattr(net.backbone, f"layer{s}_0").conv2.stride) for s in (2, 3, 4)]


def test_the_probe_covers_the_caffe_configs():
    assert BUILDS <= set(_names()) and len(_names()) == 72 and len(BUILDS) == 26


@pytest.mark.parametrize("name", _names())
def test_caffe_config_builds_or_names_what_is_missing(name):
    mc = load_config(os.path.join(CONFIGS, name)).model.to_dict()
    if name not in BUILDS:
        with pytest.raises(NotImplementedError, match=_reason(name)):
            build_detector(mc, device="cpu")
        return
    assert mc["backbone"]["style"] == "caffe" and mc["backbone"]["type"] == "ResNet"
    assert _built(json.dumps(mc, sort_keys=True)) == [((2, 2), (1, 1))] * 3
