"""The PyTorch port's tiny Res2Net-DCN Boosting R-CNN against the JAX
package's, on the CPU: ``boosting_rcnn_r2_101_fpn_mstrain_3x_coco.py``
(Res2Net with DCNv2 in stages 2-4, the RPN's ``gamma=2``, the box loss
normalised by four times the positives, ``reg_norm='mean'``, soft-NMS at
score threshold 0, 80 classes) with its backbone cut to Res2Net at depth
18's block counts (2 ``Bottle2neck`` a stage, 4 scales of base width 8 at
8 base channels) and the tiny flagship's heads, through
``tests/test_torch_boosting_detectors.py``'s harness and at its
tolerances: ``predict`` (labels and valid equal, detections within 1e-3),
the five losses (rtol 1e-4), every parameter gradient (the offset convs'
seeded nonzero, so the samples move off the grid) and the parameters
after two SGD steps.  The soft-NMS's ``min_score`` is set to 1e-3, the
value the JAX package uses whatever the config says (ROADMAP §C); the
detections' kept scores are non-increasing per image.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_boosting_detectors import (  # noqa: E402
    ATSS_LOSSES,
    check_gradients,
    check_losses,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
    run_pair,
    shrink_heads,
)


def _r2dcn(load):
    mc = load(config_path("boosting_rcnn/boosting_rcnn_r2_101_fpn_mstrain_3x_coco.py"))
    mc = mc.model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8, base_width=8)
    mc["neck"]["in_channels"] = [32, 64, 128, 256]
    mc["test_cfg"]["rcnn"]["nms"]["min_score"] = 1e-3
    return shrink_heads(mc)


@pytest.fixture(scope="module")
def run():
    return run_pair(_r2dcn)


def test_r2dcn_config_reaches_the_branches(run):
    det = run["tdet"]
    net = det.net.backbone
    assert type(net).__name__ == "Res2Net"
    assert net.layer2_0.conv2_0.conv_offset.weight.abs().max() > 0
    assert not hasattr(net.layer1_0.conv2_0, "conv_offset")
    assert det.roi_cfg.reg_norm == "mean" and det.rpn_cfg.gamma == 2
    assert (det.rcnn_test_cfg.nms_type, det.rcnn_test_cfg.score_thr) == ("soft_nms", 0.0)


def test_r2dcn_predict_matches_jax(run):
    dets, _, valid = check_predict(run)
    for d, v in zip(dets.numpy(), valid.numpy()):
        assert (np.diff(d[v, 4]) <= 0).all()


def test_r2dcn_losses_match_jax(run):
    check_losses(run, ATSS_LOSSES)


def test_r2dcn_gradients_match_jax(run):
    check_gradients(run)


@pytest.mark.parametrize("step", [0, 1])
def test_r2dcn_sgd_steps_match_jax(run, step):
    check_step(run, step, ATSS_LOSSES)
