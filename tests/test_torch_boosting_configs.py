"""The Boosting R-CNN family's configs and weights in the PyTorch port, on
the CPU.

  * each of the nine Boosting R-CNN configs builds at full width (the
    approximate top-k one raises ``NotImplementedError``), with the
    backbone, RPN regression, box-loss normaliser and test NMS its config
    names;
  * for ResNeXt-101 32x4d UTDAC and Res2Net-101-DCN COCO the port's
    parameter names and shapes equal those of the JAX package's
    ``jax.eval_shape`` tree through ``weights.from_jax_params``, which loads
    strictly;
  * ``from_mmdet_state_dict`` on a ResNeXt-101 FPN ``on_input`` state dict
    in mmdet's names (a tiny COCO detector's: base width 4 at 16 base
    channels, 4 groups) gives the source tensors back, equal to
    ``from_jax_params`` of the JAX converter's output where it has them,
    and refuses an mmdet Res2Net state dict.
"""
import copy
import functools
import glob
import os
import sys

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""  # no compile-cache writes

import numpy as np
import pytest
import torch

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from boosting_rcnn_tpu.builder import build_detector as jax_build  # noqa: E402
from boosting_rcnn_tpu.config import load_config as jax_load_config  # noqa: E402
from tools.convert_torch_weights import convert_mmdet_checkpoint  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.weights import (  # noqa: E402
    from_jax_params,
    from_mmdet_state_dict,
)

CONFIGS = os.path.join(REPO, "configs/boosting_rcnn")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the full-width builds initialise ~60-100M weights
    each, and several test workers share the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _port_net(name: str):
    """The port's ``TwoStageNet`` of the config ``name`` at full width on the
    CPU, built once for the module's tests (read only)."""
    return build_detector(load_config(os.path.join(CONFIGS, name)).model.to_dict(),
                          device="cpu")


def _config_names():
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(CONFIGS, "*.py")))


@pytest.mark.parametrize("name", _config_names())
def test_family_config_builds_at_full_width(name):
    mc = load_config(os.path.join(CONFIGS, name)).model.to_dict()
    if name.endswith("_approx_topk.py"):
        with pytest.raises(NotImplementedError, match="approx_topk"):
            build_detector(mc, device="cpu")
        return
    det = _port_net(name)
    nets = {"Res2Net": "Res2Net", "ResNeXt": "ResNet", "ResNet": "ResNet"}
    assert type(det.net.backbone).__name__ == nets[mc["backbone"]["type"]]
    assert det.rcnn_test_cfg.nms_type == mc["test_cfg"]["rcnn"].get("nms", {}).get("type", "nms")
    assert det.rpn_cfg.reg_decoded_bbox == mc["rpn_head"].get("reg_decoded_bbox", True)
    assert det.roi_cfg.reg_norm == mc["roi_head"].get("reg_norm", "bbox_num")


@pytest.mark.parametrize("name", ["boosting_rcnn_x101_32x4d_pafpn_1x_utdac.py",
                                  "boosting_rcnn_r2_101_dcn_pafpn_mstrain_3x_coco.py"])
def test_full_width_parameters_match_jax_tree(name):
    path = os.path.join(CONFIGS, name)
    jdet = jax_build(jax_load_config(path).model.to_dict())
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), (64, 64)))
    state = from_jax_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    net = _port_net(name).net
    own = net.state_dict()
    assert set(state) == set(own)
    for k, v in own.items():
        assert tuple(state[k].shape) in (tuple(v.shape), (1,) * (v.dim() == 0)), k
    copy.deepcopy(net).load_state_dict(state, strict=True)
    if "x101" in name:
        assert len([k for k in own if k.startswith("backbone.layer3_")]) // 15 == 23
        assert own["backbone.layer1_0.conv2.weight"].shape == (128, 4, 3, 3)  # 32 groups of 4
    else:
        assert own["backbone.layer2_0.conv2_0.conv_offset.weight"].shape == (27, 52, 3, 3)
        assert "backbone.layer1_0.conv2_0.conv_offset.weight" not in own


def _mmdet_names(state):
    """The port's state dict (a ResNeXt FPN detector) in mmdet's names."""
    out = {}
    for k, v in state.items():
        k = k.replace("downsample_conv", "downsample.0").replace("downsample_bn", "downsample.1")
        parts = k.split(".")
        if parts[0] == "backbone" and parts[1].startswith("layer"):
            stage, block = parts[1].split("_")
            k = ".".join(["backbone", stage, block] + parts[2:])
        elif parts[0] == "neck":
            kind, i = parts[1].rsplit("_", 1)
            k = ".".join(["neck", {"lateral": "lateral_convs", "fpn_conv": "fpn_convs"}[kind], i]
                         + parts[2:])
        elif parts[0] == "rpn" and parts[1].startswith("rpn_conv_"):
            k = ".".join(["rpn_head", "rpn_convs", parts[1].split("_")[-1],
                          "gn" if parts[2] == "norm" else parts[2], parts[3]])
        elif parts[0] == "rpn" and parts[1].startswith("scale_"):
            k, v = f"rpn_head.scales.{parts[1].split('_')[-1]}.scale", v.reshape(1)
        elif parts[0] == "rpn":
            k = "rpn_head." + ".".join(parts[1:])
        elif parts[0] == "bbox_head":
            if parts[1] == "shared_fc_0" and parts[2] == "weight":
                v = v.reshape(v.shape[0], 7, 7, -1).permute(0, 3, 1, 2).reshape(v.shape[0], -1)
            k = "roi_head.bbox_head." + parts[1].replace("shared_fc_", "shared_fcs.") + "." \
                + parts[2]
        out[k] = v.clone()
    return out


def test_mmdet_resnext101_fpn_on_input(tmp_path):
    mc = load_config(os.path.join(CONFIGS, "boosting_rcnn_r50_fpn_1x_coco.py")).model.to_dict()
    mc["backbone"] = dict(type="ResNeXt", depth=101, groups=4, base_width=4, base_channels=16,
                          frozen_stages=1)
    mc["neck"].update(in_channels=[64, 128, 256, 512], out_channels=32)
    mc["rpn_head"].update(feat_channels=32, stacked_convs=2)
    mc["roi_head"]["bbox_head"]["fc_out_channels"] = 16
    det = build_detector(mc, device="cpu", seed=3)
    own = det.net.state_dict()
    sd = _mmdet_names(own)
    assert sd["neck.fpn_convs.3.conv.weight"].shape == (32, 512, 3, 3)  # on_input: over C5
    assert "backbone.layer3.22.conv2.weight" in sd
    got = from_mmdet_state_dict(sd)
    torch.save({"state_dict": sd}, tmp_path / "x101.pth")
    params, stats = convert_mmdet_checkpoint(str(tmp_path / "x101.pth"))
    ref = from_jax_params({"params": params, "batch_stats": stats})
    for k, v in own.items():
        assert torch.equal(got[k], v), k
        if k in ref:
            assert torch.equal(ref[k].reshape(v.shape), v), k
    assert sum(k.startswith("backbone.") for k in ref) == sum(k.startswith("backbone.")
                                                               for k in own)
    det.net.load_state_dict(got, strict=True)
    res2net = {"backbone.stem.0.weight": torch.zeros(32, 3, 3, 3),
               "backbone.layer1.0.convs.0.weight": torch.zeros(26, 26, 3, 3)}
    with pytest.raises(NotImplementedError, match="Res2Net"):
        from_mmdet_state_dict(res2net)
