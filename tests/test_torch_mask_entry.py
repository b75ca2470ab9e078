"""The PyTorch port's entry points for Mask R-CNN, Cascade Mask R-CNN and
HTC, on the CPU at the tiny size.

  * ``--tiny``: the port's shrunk model has the parameter names and shapes
    of ``jax.eval_shape`` of the JAX build of the JAX package's
    ``tools/train.py::shrink_model`` output (through
    ``weights.from_jax_params``, loaded strictly).  For HTC with its
    semantic head the JAX shrink keeps the head's 256 channels and its
    build fails (a 256-channel embedding added to 32-channel RoI
    features); the port shrinks that width to the neck's, and the JAX side
    is built with the same change;
  * the train CLI, 2 iterations from a synthetic COCO set (the shapes'
    polygons, 8-bit PNG stuff maps under ``seg_prefix``): Mask R-CNN and
    Cascade Mask R-CNN log ``loss_mask`` (every stage's), all finite;
    ``--fake-data`` the same (HTC's in ``test_torch_mask_entry_htc.py``);
  * the test CLI with ``--eval bbox segm`` prints the six segm keys.
"""
import copy
import json
import os
import sys

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""  # no compile-cache writes

import numpy as np
import pytest
import torch

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from boosting_rcnn_tpu.builder import build_detector as jax_build  # noqa: E402
from boosting_rcnn_tpu.config import load_config as jax_load_config  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.data.image_io import write_png_gray  # noqa: E402
from boosting_rcnn_tpu_torch.data.synthetic import generate  # noqa: E402
from boosting_rcnn_tpu_torch.engine import runner  # noqa: E402
from boosting_rcnn_tpu_torch.tools import test as test_cli  # noqa: E402
from boosting_rcnn_tpu_torch.tools import train as train_cli  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402
from tools.train import shrink_model as jax_shrink  # noqa: E402

MASK_RCNN = "configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py"
CASCADE_MASK = "configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py"
HTC = "configs/htc/htc_r50_fpn_1x_coco.py"
HTC_NO_SEM = "configs/htc/htc_without_semantic_r50_fpn_1x_coco.py"
SEGM_KEYS = ("segm_mAP", "segm_mAP_50", "segm_mAP_75", "segm_mAP_s", "segm_mAP_m",
             "segm_mAP_l")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The CPU convolution backward is racy with several threads here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", [MASK_RCNN, CASCADE_MASK, HTC, HTC_NO_SEM])
def test_tiny_matches_jax_shrink(config):
    path = os.path.join(REPO, config)
    jmc = jax_shrink(jax_load_config(path).model.to_dict())
    if jmc["roi_head"].get("semantic_head"):
        jmc["roi_head"]["semantic_head"]["conv_out_channels"] = 32
    jdet = jax_build(copy.deepcopy(jmc))
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), runner.TINY_CANVAS))
    state = from_jax_params(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    mc = runner.model_config(load_config(path), tiny=True)
    net = build_detector(mc, device="cpu").net
    own = net.state_dict()
    assert set(state) == set(own)
    for k, v in own.items():
        assert tuple(state[k].shape) in (tuple(v.shape), (1,) * (v.dim() == 0)), k
    copy.deepcopy(net).load_state_dict(state, strict=True)
    # the mask heads keep their 256-channel convs and pool the neck's 32
    conv0 = [v for k, v in own.items() if "mask_head" in k and k.endswith("conv_0.weight")]
    assert conv0 and all(tuple(v.shape) == (256, 32, 3, 3) for v in conv0)


@pytest.fixture(scope="module")
def mask_set(tmp_path_factory):
    """4 train and 2 val images of the shapes set, and a stuff map for each
    under ``stuff/``."""
    root = str(tmp_path_factory.mktemp("mask_entry"))
    generate(root, n_train=4, n_val=2, seed=1)
    rs = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "stuff"))
    for split in ("train", "val"):
        for name in os.listdir(os.path.join(root, split)):
            m = rs.randint(0, 183, (160 // 8, 200 // 8)).repeat(8, 0).repeat(8, 1)
            write_png_gray(os.path.join(root, "stuff", name[:-4] + ".png"), m.astype(np.uint8))
    return root


def _options(root, config):
    opts = {f"data.{s}.{k}": f"{root}/{n}{e}"
            for s, n in (("train", "train"), ("val", "val"), ("test", "val"))
            for k, e in (("ann_file", ".json"), ("img_prefix", ""))}
    opts.update({"data.train.seg_prefix": f"{root}/stuff", "data.samples_per_gpu": 1,
                 "model.backbone.init_cfg": "None", "compute_dtype": "float32"})
    return ["--cfg-options", *[f"{k}={v}" for k, v in opts.items()]]


def _mask_losses(config):
    if config == MASK_RCNN:
        return ["loss_mask"]
    return [f"s{i}.loss_mask" for i in range(3)] + (["loss_semantic_seg"] if config == HTC
                                                    else [])


def train_cli_logs_mask_losses(mask_set, tmp_path, config, fake):
    """The train CLI, 2 iterations of ``config`` from ``mask_set``'s files
    (or ``--fake-data``), logs every mask loss (and HTC's semantic loss),
    finite and positive."""
    summary = train_cli.main([os.path.join(REPO, config), "--device", "cpu", "--tiny",
                              "--iters", "2", "--no-validate", "--work-dir", str(tmp_path),
                              *(["--fake-data"] if fake else []), *_options(mask_set, config)])
    assert summary["steps"] == 2
    metrics = summary["last_metrics"]
    for key in _mask_losses(config) + ["loss"]:
        assert key in metrics and np.isfinite(metrics[key]) and metrics[key] > 0, (key, metrics)
    with open(os.path.join(tmp_path, "train.log.json")) as f:
        logged = [json.loads(line) for line in f]
    assert all(key in logged[0] for key in _mask_losses(config))


@pytest.mark.parametrize("fake", [False, True], ids=["files", "fake_data"])
@pytest.mark.parametrize("config", [MASK_RCNN, CASCADE_MASK])
def test_train_cli_logs_mask_losses(mask_set, tmp_path, config, fake):
    train_cli_logs_mask_losses(mask_set, tmp_path, config, fake)


def test_test_cli_prints_segm(mask_set, capsys):
    metrics = test_cli.main([os.path.join(REPO, MASK_RCNN), "--device", "cpu", "--tiny",
                             "--eval", "bbox", "segm", *_options(mask_set, MASK_RCNN)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["num_results"] == 2
    for key in SEGM_KEYS + ("bbox_mAP",):
        assert key in printed and key in metrics
