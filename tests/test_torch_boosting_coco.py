"""The PyTorch port's tiny COCO Boosting R-CNN against the JAX package's, on
the CPU: ``boosting_rcnn_r50_fpn_1x_coco.py`` (FPN from C3 with its first
extra level a stride-2 conv on C5, ``add_extra_convs='on_input'``; the ATSS
RPN regressing encoded deltas, ``reg_decoded_bbox=False``, with the CIoU
loss applied to the delta vectors read as boxes and ``gamma=2``; 80
classes) at the tiny flagship's size (ResNet-18 at width 8, FPN 32, RPN
32 x 2, FC 64), through ``tests/test_torch_boosting_detectors.py``'s
harness and at its tolerances: ``predict`` (labels and valid equal,
detections within 1e-3), the five losses (rtol 1e-4), every parameter
gradient and the parameters after two SGD steps.
"""
import os
import sys

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


def _coco(load):
    mc = load(config_path("boosting_rcnn/boosting_rcnn_r50_fpn_1x_coco.py")).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"]["in_channels"] = [8, 16, 32, 64]
    return shrink_heads(mc)


@pytest.fixture(scope="module")
def run():
    return run_pair(_coco)


def test_coco_config_reaches_the_branches(run):
    det = run["tdet"]
    assert (det.rpn_cfg.reg_decoded_bbox, det.rpn_cfg.loss_bbox_type, det.rpn_cfg.gamma) == (
        False, "ciou", 2.0)
    assert det.net.neck.add_extra_convs == "on_input"
    assert tuple(det.net.neck.fpn_conv_3.conv.weight.shape) == (32, 64, 3, 3)
    assert det.bbox_cfg.num_classes == 80


def test_coco_predict_matches_jax(run):
    check_predict(run)


def test_coco_losses_match_jax(run):
    check_losses(run, ATSS_LOSSES)


def test_coco_gradients_match_jax(run):
    check_gradients(run)


@pytest.mark.parametrize("step", [0, 1])
def test_coco_sgd_steps_match_jax(run, step):
    check_step(run, step, ATSS_LOSSES)
