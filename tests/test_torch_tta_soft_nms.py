"""The PyTorch port's test-time augmentation with soft-NMS against the JAX
package's, on the CPU: ``boosting_rcnn_x101_pafpn_mstrain_3x_coco.py`` as
``--tiny`` shrinks it (ResNet-18 at width 8, 80 classes, soft-NMS with
its ``min_score`` set to 1e-3, the value the JAX
package uses whatever the config says), through
``tests/test_torch_tta.py``'s checks: ``aug_predict`` and
``aug_predict_multi`` over two short sides with flip, labels and valid
equal, detections within 1e-3.  The weights are drawn from seed 1: at
seed 0 two of image 0's kept detections are 6e-8 apart in score, and the
two packages' float32 view averages put them in opposite orders.
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_tta import check_flip, check_multi, pair  # noqa: E402

SOFT_NMS = "boosting_rcnn/boosting_rcnn_x101_pafpn_mstrain_3x_coco.py"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread: beside the suite's other pytest
    workers, torch's default of a thread a core oversubscribes the host
    (this file's cases ran several times slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def det_pair():
    return pair(SOFT_NMS, seed=1)


def test_soft_nms_model_reaches_its_branch(det_pair):
    det = det_pair["tdet"]
    t = det.rcnn_test_cfg
    assert (t.nms_type, t.soft_min_score) == ("soft_nms", 1e-3)
    assert det.roi_cfg.prob and det.bbox_cfg.num_classes == 80


def test_soft_nms_aug_predict_flip_matches_jax(det_pair):
    check_flip(det_pair)


def test_soft_nms_aug_predict_multi_two_scales_flip_matches_jax(det_pair):
    check_multi(det_pair)
