"""Which HTC configs the PyTorch port builds, on the CPU, at full width
(no JAX): the probe of ``tests/test_torch_cascade_configs.py`` over every
config file named ``*htc*``, each a ``HybridTaskCascade``.  Those on the
ported backbones build (``BUILDS``, 17 files, HRNet's and, since the
twenty-first slice, DetectoRS's among them; a model shared by several
files is built once); any other one would raise ``NotImplementedError``
naming what is missing (``_reason``: none is left).  Each built one is checked against its config:
one mask head per stage, interleaved, with information flow (a
``conv_res`` in the heads after the first), and the semantic head where
the config has one (183 stuff classes, its embedding pooled at stride 8).
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.models import layers as t_layers  # noqa: E402
from boosting_rcnn_tpu_torch.models import plugins as t_plugins  # noqa: E402
from boosting_rcnn_tpu_torch.models.backbones import detectors_resnet as t_det  # noqa: E402
from test_torch_cascade_configs import check_mask_heads  # noqa: E402

CONFIGS = os.path.join(REPO, "configs")
BUILDS = {
    "htc/htc_r50_fpn_1x_coco.py", "htc/htc_r50_fpn_20e_coco.py", "htc/htc_r101_fpn_20e_coco.py",
    "htc/htc_without_semantic_r50_fpn_1x_coco.py", "htc/htc_x101_32x4d_fpn_16x1_20e_coco.py",
    "htc/htc_x101_64x4d_fpn_16x1_20e_coco.py",
    "htc/htc_x101_64x4d_fpn_dconv_c3-c5_mstrain_400_1400_16x1_20e_coco.py",
    "hrnet/htc_x101_64x4d_fpn_16x1_28e_coco.py", "res2net/htc_r2_101_fpn_20e_coco.py",
    # HRNet with HRFPN
    "hrnet/htc_hrnetv2p_w18_20e_coco.py", "hrnet/htc_hrnetv2p_w32_20e_coco.py",
    "hrnet/htc_hrnetv2p_w40_20e_coco.py", "hrnet/htc_hrnetv2p_w40_28e_coco.py",
    # DetectoRS: SAC and the RFP neck, SAC alone, RFP alone
    "detectors/detectors_htc_r50_1x_coco.py", "detectors/detectors_htc_r101_20e_coco.py",
    "detectors/htc_r50_sac_1x_coco.py", "detectors/htc_r50_rfp_1x_coco.py",
}


def _names():
    return sorted(os.path.relpath(p, CONFIGS)
                  for p in glob.glob(os.path.join(CONFIGS, "*", "*htc*.py")))


def _reason(name: str) -> str:
    """The missing piece that the builder names for a config it rejects."""
    raise AssertionError(f"{name}: no expected reason")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
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
        for module in (t_layers, t_plugins, t_det):
            mp.setattr(module, "lecun_normal_", lambda weight, fan_in, gen: None)
        for name in ("kaiming_uniform_", "uniform_"):  # torch's own inits, overwritten
            mp.setattr(torch.nn.init, name, lambda tensor, *a, **k: tensor)
        yield


@functools.lru_cache(maxsize=None)
def _built(model_json: str):
    det = build_detector(json.loads(model_json), device="cpu")
    net = det.net
    return dict(type=type(det), cascade=det.cascade_cfg, info_flow=net.mask_info_flow,
                masks=[(h.conv_logits.weight.shape[0], h.num_convs, h.conv_res is not None)
                       for h in net.mask_heads],
                semantic=(None if net.semantic_head is None else
                          (net.semantic_head.conv_seg.weight.shape[0], net.semantic_stride)),
                heads=len(net.bbox_heads))


def test_the_probe_covers_the_buildable_configs():
    assert BUILDS <= set(_names()) and len(_names()) == 17


@pytest.mark.parametrize("name", _names())
def test_htc_config_builds_or_names_what_is_missing(name):
    mc = load_config(os.path.join(CONFIGS, name)).model.to_dict()
    assert mc["type"] == "HybridTaskCascade"
    if name not in BUILDS:
        with pytest.raises(NotImplementedError, match=_reason(name)):
            build_detector(mc, device="cpu")
        return
    det = _built(json.dumps(mc, sort_keys=True))
    roi = mc["roi_head"]
    assert det["heads"] == det["cascade"].num_stages == roi.get("num_stages", 3)
    check_mask_heads(det, roi, htc=True)
    sem = roi.get("semantic_head")
    assert det["semantic"] == (None if sem is None else (sem["num_classes"], 8))
