"""The PyTorch port's Faster R-CNN R50-FPN against the JAX package's, on the
CPU: ``configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py`` (FPN with extra
levels by max pool, the one-conv RPN with its random anchor sampler, the
standard RoI head with plain cross entropy) at the tiny Mask R-CNN test's
size without the mask head (ResNet-18 at width 8, FPN 32, RPN 32, FC 64, 4
classes), through ``tests/test_torch_boosting_detectors.py``'s harness and
at its tolerances: ``predict`` (labels and valid equal, detections within
1e-3), the four losses (rtol 1e-4; the port's RPN sampler ranks its
anchors by the uniforms JAX's ``rpn_loss`` draws), every parameter
gradient and the parameters after two SGD steps.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_boosting_detectors import (  # noqa: E402
    check_gradients,
    check_losses,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
    run_pair,
    shrink_heads,
)

LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox")


def _faster(load):
    mc = load(config_path("faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py")).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"]["in_channels"] = [8, 16, 32, 64]
    mc["roi_head"]["bbox_roi_extractor"]["out_channels"] = 32
    return shrink_heads(mc, num_classes=4)


@pytest.fixture(scope="module")
def run():
    return run_pair(_faster)


def test_faster_rcnn_is_the_plain_family(run):
    det = run["tdet"]
    assert det.rpn_type == "rpn" and not det.roi_cfg.boost and not det.roi_cfg.prob
    assert det.net.neck.add_extra_convs is False


def test_faster_rcnn_predict_matches_jax(run):
    check_predict(run)


def test_faster_rcnn_losses_match_jax(run):
    check_losses(run, LOSSES)


def test_faster_rcnn_gradients_match_jax(run):
    check_gradients(run)


@pytest.mark.parametrize("step", [0, 1])
def test_faster_rcnn_sgd_steps_match_jax(run, step):
    check_step(run, step, LOSSES)
