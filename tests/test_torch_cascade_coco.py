"""The PyTorch port's plain Cascade R-CNN against the JAX package's, on the
CPU: ``configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py`` (FPN at
strides 4-32 with a max-pooled P6, the plain RPN with its random anchor
sampler, three class-agnostic Shared2FC stages with smooth L1 at IoU 0.5 /
0.6 / 0.7, softmax scores averaged over the stages) at the tiny size of
``tests/test_torch_cascade.py``, with 4 classes for its 80 (as
``tests/test_torch_faster_rcnn.py`` cuts them: at 81 classes no random
head's softmax passes the 0.05 score threshold), and through its harness, at
its tolerances: ``predict`` (labels and valid equal, detections within
1e-3), each stage's sample field by field with JAX's draws (the RPN's
anchor sampler and the three RoI samplers), the eight losses (rtol 1e-4),
every parameter gradient, and two fused SGD steps.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_boosting_detectors import (  # noqa: E402
    check_gradients,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
)
from test_torch_cascade import (  # noqa: E402
    check_cascade_losses,
    check_samples,
    run_cascade_pair,
    tiny_cascade,
)


def _coco(load):
    mc = load(config_path("cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py")).model.to_dict()
    for head in mc["roi_head"]["bbox_head"]:
        head["num_classes"] = 4
    return tiny_cascade(mc)


@pytest.fixture(scope="module")
def run():
    return run_cascade_pair(_coco)


def test_cascade_coco_config(run):
    det = run["tdet"]
    cc = det.cascade_cfg
    assert det.rpn_type == "rpn" and not cc.prob and not cc.boost
    assert cc.stage_pos_iou == (0.5, 0.6, 0.7) and cc.stage_loss_weights == (1.0, 0.5, 0.25)
    assert det.net.roi_strides == (4, 8, 16, 32) and det.bbox_cfg.num_classes == 4
    assert [tuple(h.fc_reg.weight.shape) for h in det.net.bbox_heads] == [(4, 64)] * 3


def test_cascade_coco_predict_matches_jax(run):
    check_predict(run)


def test_cascade_coco_samples_match_jax(run):
    check_samples(run)


def test_cascade_coco_losses_match_jax(run):
    check_cascade_losses(run)


def test_cascade_coco_gradients_match_jax(run):
    check_gradients(run)


@pytest.mark.parametrize("step", [0, 1])
def test_cascade_coco_sgd_steps_match_jax(run, step):
    check_step(run, step, check_cascade_losses(run))
