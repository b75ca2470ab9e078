"""Cascade R-CNN through the PyTorch port's weight bridges and entry points,
on the CPU.

  * ``weights.from_jax_params`` of the JAX package's parameter tree
    (``jax.eval_shape`` of its ``init``; flax names a cascade's stage heads
    ``bbox_heads_N``) loads strictly into the port's full-width model of
    the ProbCascade UTDAC, the four-stage COCO and the brackish (stage
    heads given as only ``{"num_classes": 6}``: class-wise deltas, FC 1024)
    configs;
  * ``weights.from_mmdet_state_dict`` of a tiny Cascade R-CNN in mmdet's
    names (``roi_head.bbox_head.N.*``) equals ``from_jax_params`` of the
    JAX ``convert_mmdet_checkpoint`` of the same file, tensor for tensor
    (but the plain RPN's conv, which the JAX converter drops), and loads
    strictly; a key of a module the port lacks raises;
  * the CLIs' functions on the ProbCascade and the plain Cascade R-CNN
    configs: ``tools.train --device cpu --tiny --fake-data --iters 2``
    writes a checkpoint, and ``tools.test --tiny`` on it evaluates a
    synthetic COCO-format set (``data/synthetic.py``).
"""
import copy
import os
import sys

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""  # no compile-cache writes

import numpy as np
import pytest
import torch

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from boosting_rcnn_tpu.builder import build_detector as jax_build  # noqa: E402
from boosting_rcnn_tpu.config import load_config as jax_load_config  # noqa: E402
from tools.convert_torch_weights import convert_mmdet_checkpoint  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.data.synthetic import generate  # noqa: E402
from boosting_rcnn_tpu_torch.engine.runner import shrink_model  # noqa: E402
from boosting_rcnn_tpu_torch.tools import test as test_cli  # noqa: E402
from boosting_rcnn_tpu_torch.tools import train as train_cli  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params, from_mmdet_state_dict  # noqa: E402
from test_torch_boosting_configs import _mmdet_names  # noqa: E402

CONFIGS = os.path.join(REPO, "configs")
UTDAC = os.path.join(CONFIGS, "ensemble/prob_cascade_rcnn_r50_pafpn_1x_utdac.py")
COCO = os.path.join(CONFIGS, "cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the full-width builds, and the CPU convolution
    backward of the train CLI (racy with several threads in some PyTorch
    CPU builds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["ensemble/prob_cascade_rcnn_r50_pafpn_1x_utdac.py",
                                  "cascade_rcnn/cascade_rcnn_s4_r50_fpn_1x_coco.py",
                                  "cascade_rcnn/cascade_rcnn_r50_fpn_1x_brackish.py"])
def test_full_width_cascade_trees_match_jax(name):
    path = os.path.join(CONFIGS, name)
    jdet = jax_build(jax_load_config(path).model.to_dict())
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), (64, 64)))
    assert {k for k in shapes["params"] if k.startswith("bbox_heads_")} == {
        f"bbox_heads_{i}" for i in range(jdet.cascade_cfg.num_stages)}
    state = from_jax_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    net = build_detector(load_config(path).model.to_dict(), device="cpu").net
    own = net.state_dict()
    assert set(state) == set(own)
    for k, v in own.items():
        assert tuple(state[k].shape) in (tuple(v.shape), (1,) * (v.dim() == 0)), k
    net.load_state_dict(state, strict=True)
    if "brackish" in name:  # the merged config's bare stages: class-wise, FC 1024
        assert own["bbox_heads.2.fc_reg.weight"].shape == (24, 1024)


def _tiny_cascade_coco():
    mc = shrink_model(load_config(COCO).model.to_dict())
    for head in mc["roi_head"]["bbox_head"]:
        head["num_classes"] = 4
    return build_detector(mc, device="cpu", seed=5)


def test_cascade_mmdet_state_dict(tmp_path):
    det = _tiny_cascade_coco()
    own = det.net.state_dict()
    heads = {k: v for k, v in own.items() if k.startswith("bbox_heads.")}
    sd = _mmdet_names({k: v for k, v in own.items() if k not in heads})
    for k, v in heads.items():
        _, stage, layer, leaf = k.split(".")
        if layer == "shared_fc_0" and leaf == "weight":  # mmdet flattens (C, 7, 7)
            v = v.reshape(v.shape[0], 7, 7, -1).permute(0, 3, 1, 2).reshape(v.shape[0], -1)
        sd[f"roi_head.bbox_head.{stage}.{layer.replace('shared_fc_', 'shared_fcs.')}.{leaf}"] = \
            v.clone()
    assert "roi_head.bbox_head.2.shared_fcs.1.weight" in sd
    got = from_mmdet_state_dict(sd)
    torch.save({"state_dict": sd}, tmp_path / "cascade.pth")
    params, stats = convert_mmdet_checkpoint(str(tmp_path / "cascade.pth"))
    ref = from_jax_params({"params": params, "batch_stats": stats})
    # the JAX converter reads the ATSS RPN's rpn_convs.N only: the plain RPN's
    # one conv is what it drops
    assert set(got) == set(own) and set(own) - set(ref) == {"rpn.rpn_conv.weight",
                                                            "rpn.rpn_conv.bias"}
    for k, v in own.items():
        assert torch.equal(got[k], v), k
        if k in ref:
            assert torch.equal(ref[k].reshape(v.shape), v), k
    copy.deepcopy(det.net).load_state_dict(got, strict=True)
    with pytest.raises(ValueError, match="cascade"):
        from_mmdet_state_dict({**sd, "roi_head.bbox_head.1.cascade.weight": torch.zeros(1)})


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    generate(root, n_train=4, n_val=3, seed=3)
    return root


@pytest.mark.parametrize("config", [UTDAC, COCO], ids=["prob_cascade_utdac", "cascade_coco"])
def test_train_and_test_clis_on_a_cascade(config, synth, tmp_path):
    data = [f"data.{s}.{k}={synth}/{v}" for s in ("train", "val", "test")
            for k, v in (("ann_file", "val.json" if s != "train" else "train.json"),
                         ("img_prefix", "val" if s != "train" else "train"))]
    opts = ["--device", "cpu", "--tiny", "--cfg-options", *data, "data.samples_per_gpu=2",
            "model.backbone.init_cfg=None", "compute_dtype=float32"]
    wd = str(tmp_path / "wd")
    summary = train_cli.main([config, "--work-dir", wd, "--iters", "2", "--fake-data", *opts])
    assert summary["steps"] == 2 and np.isfinite(summary["last_metrics"]["loss"])
    assert {"s0.loss_cls", "s2.loss_bbox"} <= set(summary["last_metrics"])
    ckpt = summary["checkpoints"][-1]
    metrics = test_cli.main([config, ckpt, "--out", str(tmp_path / "res.json"), *opts])
    assert metrics["num_results"] == 3 and metrics["eval_stats"]["images"] == 3
    assert "bbox_mAP" in metrics
