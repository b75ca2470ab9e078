"""The tiny HRNet-W18 Faster R-CNN (``configs/hrnet/faster_rcnn_hrnetv2p_w18_1x_coco.py``
with HRFPN 32, RPN 32, FC 64, 4 classes) of the PyTorch port against the
JAX package's, on the CPU, through ``tests/test_torch_boosting_detectors.py``'s
harness and at its tolerances: predict, the losses, every gradient and two
SGD steps, no stage frozen.  On a 128 x 192 canvas: HRFPN pools its levels
to floor sizes where the anchors take ceil ones, and the JAX loss fails to
broadcast unless 64 divides the canvas (the port's raises, naming the
sizes; ``tests/test_torch_zoo_backbones.py``).  The random variables have
each block's last norm and the regressors damped (``damp_residuals``,
``damp_regressors``), and HRNet-W18 is cut to one module a stage of two
blocks a branch (``small_hrnet``: the JAX side's four jits of the whole
W18 took about 3 minutes on the CPU).
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_boosting_detectors as harness  # noqa: E402
from test_torch_boosting_detectors import (  # noqa: E402
    check_gradients,
    check_losses,
    check_predict,
    check_step,
    one_torch_thread,  # noqa: F401 (a module fixture)
    run_pair,
)
from test_torch_zoo_backbones import (  # noqa: E402
    FASTER_LOSSES,
    HRNET_CANVAS,
    _tiny_hrnet,
    damp_regressors,
    damp_residuals,
    small_hrnet,
)

from boosting_rcnn_tpu_torch.models.backbones import hrnet as t_hrnet  # noqa: E402
from boosting_rcnn_tpu_torch.models.necks import fpn as t_fpn  # noqa: E402

SEED = 3


@pytest.fixture(scope="module")
def run():
    draw = harness._random_variables
    harness._random_variables = lambda shapes, rs: damp_regressors(
        damp_residuals(draw(shapes, rs)))
    try:
        with small_hrnet():
            return run_pair(_tiny_hrnet, seed=SEED, canvas=HRNET_CANVAS, frozen_stages=-1)
    finally:
        harness._random_variables = draw


def test_tiny_hrnet_has_its_backbone(run):
    net = run["tdet"].net
    assert isinstance(net.backbone, t_hrnet.HRNet)
    assert net.backbone.out_channels == (18, 36, 72, 144)
    assert hasattr(net.backbone, "stage4_module0") and not hasattr(net.backbone,
                                                                   "stage4_module1")
    assert isinstance(net.neck, t_fpn.HRFPN)


def test_tiny_hrnet_predict_matches_jax(run):
    check_predict(run)


def test_tiny_hrnet_losses_match_jax(run):
    check_losses(run, FASTER_LOSSES)


def test_tiny_hrnet_gradients_match_jax(run):
    check_gradients(run, ())


@pytest.mark.parametrize("step", [0, 1])
def test_tiny_hrnet_sgd_steps_match_jax(run, step):
    check_step(run, step, FASTER_LOSSES, frozen_names=())
