"""The PyTorch port's HTC without the semantic branch
(``configs/htc/htc_without_semantic_r50_fpn_1x_coco.py``) against the
JAX package's, on the CPU, with ``tests/test_torch_htc.py``'s harness and
tolerances: the tiny detector's ``predict`` with masks, every stage's box
and interleaved mask sample on JAX's draws, every loss, every gradient,
two SGD steps, and the stages in bfloat16 on JAX's inputs.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_boosting_detectors import check_step, config_path  # noqa: E402
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


def _htc_nosem(load):
    return tiny_htc(load(config_path("htc/htc_without_semantic_r50_fpn_1x_coco.py"))
                    .model.to_dict())


@pytest.fixture(scope="module")
def run():
    return run_htc_pair(_htc_nosem)


def test_htc_without_semantic_config(run):
    det = run["tdet"]
    assert det.cascade_cfg.interleaved and det.net.mask_info_flow
    assert det.net.semantic_head is None
    assert "loss_semantic_seg" not in run["t_losses"]


def test_htc_without_semantic_predict_matches_jax(run):
    check_htc_predict(run)


def test_htc_without_semantic_samples_match_jax(run):
    check_samples(run)
    check_mask_samples(run)


def test_htc_without_semantic_losses_match_jax(run):
    check_cascade_losses(run)


def test_htc_without_semantic_gradients_match_jax(run):
    check_htc_gradients(run)


@pytest.mark.parametrize("step", [0, 1])
def test_htc_without_semantic_sgd_steps_match_jax(run, step):
    check_step(run, step, check_cascade_losses(run))


def test_bf16_htc_without_semantic_stages_on_jax_inputs():
    check_bf16_htc(bf16_htc_stages(_htc_nosem))
