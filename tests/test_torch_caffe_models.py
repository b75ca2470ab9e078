"""The caffe-style configs that the PyTorch port builds
(``tests/test_torch_caffe_configs.py::BUILDS``), each distinct model with
its backbone kept (ResNet-50 or -101 at width 8, caffe style) and its
heads at the tiny size of ``engine.runner.shrink_model`` (mask convs of
16 channels): ``predict`` and
one train step in float32 and in bfloat16 on two fake images (with mask
crops for a mask head), on the CPU (no JAX).  Checked: finite float32
detections of the config's classes, finite and positive losses (each mask
loss too), the caffe stride's conv moved by the step and the frozen stem
and stage 1 not (the SyncBN strong baselines freeze neither: they move).
"""
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
from boosting_rcnn_tpu_torch.data.loader import FakeDetLoader  # noqa: E402
from boosting_rcnn_tpu_torch.engine.runner import shrink_model  # noqa: E402
from boosting_rcnn_tpu_torch.engine.train import make_optimizer, make_train_step  # noqa: E402
from test_torch_caffe_configs import BUILDS, CONFIGS, one_torch_thread  # noqa: E402,F401


def _tiny_caffe(mc):
    """``shrink_model``'s heads, mask convs of 16 channels, on the config's
    own caffe backbone at width 8."""
    depth = mc["backbone"]["depth"]
    mc = shrink_model(mc)
    mc["backbone"].update(depth=depth, base_channels=8, style="caffe")
    if mc.get("neck"):  # C4 and DC5 have none
        mc["neck"]["in_channels"] = [32, 64, 128, 256]
    heads = mc["roi_head"].get("mask_head") or []
    for head in heads if isinstance(heads, list) else [heads]:
        if head["type"] != "CoarseMaskHead":  # PointRend's downsample conv is 256 wide
            head["conv_out_channels"] = 16
    return mc


def _models():
    """The distinct models of ``BUILDS`` (a schedule or data change keeps the model)."""
    seen = {}
    for name in sorted(BUILDS):
        mc = load_config(os.path.join(CONFIGS, name)).model.to_dict()
        seen.setdefault(json.dumps(mc, sort_keys=True), name)
    return sorted(seen.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", _models())
def test_tiny_caffe_model_predicts_and_trains(name, dtype):
    mc = _tiny_caffe(load_config(os.path.join(CONFIGS, name)).model.to_dict())
    det = build_detector(mc, device="cpu", seed=0, dtype=dtype)
    assert det.net.backbone.layer2_0.conv1.stride == (2, 2)
    masks = bool(mc["roi_head"].get("mask_head"))
    bbox_head = mc["roi_head"]["bbox_head"]
    k = (bbox_head[0] if isinstance(bbox_head, list) else bbox_head)["num_classes"]
    batch = next(iter(FakeDetLoader(2, (128, 160), k, max_gt=6, seed=1, num_batches=1,
                                    with_masks=masks).epoch_iter(0)))
    anchors, nla = det.anchors_for((128, 160))
    out = det.predict(batch, anchors, nla)
    dets, labels, valid = out[:3]
    assert dets.dtype == torch.float32 and torch.isfinite(dets).all()
    assert bool(((labels >= 0) & (labels < k))[valid].all())
    before = {n: p.detach().clone() for n, p in det.net.named_parameters() if p.requires_grad}
    step = make_train_step(det, anchors, nla, make_optimizer(det.net.parameters(),
                                                             lambda s: 0.01))
    metrics = step(batch, generator=torch.Generator().manual_seed(2))
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in metrics.values())
    assert float(metrics["loss"]) > 0
    assert not masks or all(float(v) > 0 for n, v in metrics.items() if "loss_mask" in n)
    assert not masks or any("loss_mask" in n for n in metrics)
    moved = [n for n, p in det.net.named_parameters() if p.requires_grad
             and not torch.equal(p.detach(), before[n])]
    assert any(n.startswith("backbone.layer2_0.conv1") for n in moved)
    # the stem and stage 1 frozen, but in the SyncBN strong baselines
    # (frozen_stages=-1), where they train
    frozen = mc["backbone"].get("frozen_stages", -1) >= 1
    assert any(n.startswith(("backbone.conv1", "backbone.layer1_")) for n in moved) != frozen
