"""The PyTorch port's Cascade Mask R-CNN
(``configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py``: the JAX
package's HTC detector with interleaving and information flow off, one
FCN mask head per stage on the stage's own sample) against the JAX
package's, on the CPU, with ``tests/test_torch_htc.py``'s harness and
tolerances: the tiny detector's ``predict`` with masks, every stage's box
sample and its mask branch (the same slots), every loss, every gradient,
and the stages in bfloat16 on JAX's inputs.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_boosting_detectors import config_path  # noqa: E402
from test_torch_boosting_detectors import one_torch_thread  # noqa: E402,F401
from test_torch_cascade import check_cascade_losses, check_samples  # noqa: E402
from test_torch_htc import (  # noqa: E402
    bf16_htc_stages,
    check_bf16_htc,
    check_htc_gradients,
    check_htc_predict,
    check_mask_samples,
    run_htc_pair,
    tiny_htc,
)


def _cascade_mask(load):
    return tiny_htc(load(config_path("cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py"))
                    .model.to_dict())


@pytest.fixture(scope="module")
def run():
    return run_htc_pair(_cascade_mask, steps=False)


def test_cascade_mask_config(run):
    det = run["tdet"]
    assert not det.cascade_cfg.interleaved and not det.net.mask_info_flow
    assert det.net.semantic_head is None
    assert all(h.conv_res is None for h in det.net.mask_heads)
    assert len(det.net.mask_heads) == det.cascade_cfg.num_stages == 3


def test_cascade_mask_predict_matches_jax(run):
    check_htc_predict(run)


def test_cascade_mask_samples_match_jax(run):
    check_samples(run)
    check_mask_samples(run)


def test_cascade_mask_losses_match_jax(run):
    check_cascade_losses(run)


def test_cascade_mask_gradients_match_jax(run):
    check_htc_gradients(run)


def test_bf16_cascade_mask_stages_on_jax_inputs():
    check_bf16_htc(bf16_htc_stages(_cascade_mask))
