"""Mask Scoring R-CNN in the PyTorch port against the JAX package, on the
CPU.

Modules, on inputs made with numpy from a seed, within 1e-5 of the
largest value:

  * ``MaskIoUHead`` (JAX ``mask_head.py:265-300``): the 2x2 max pool of the
    mask, its concatenation after the pooled features, the convs (the last
    of stride 2), the FCs and ``fc_mask_iou``; its gradients with respect
    to every parameter, the pooled features and the masks;
  * ``mask_iou_targets`` (JAX ``:303-325``), a zero-area gt and an empty
    prediction among them.

The tiny MS R-CNN (``configs/ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py`` at
``tests/test_torch_mask_rcnn.py``'s size, its MaskIoU head at convs of 16
and FCs of 64) through ``tests/test_torch_seesaw.py::run_mask_pair``, at
the detectors harness's tolerances: ``predict`` with masks (1e-4) and
``mask_scores`` (1e-4), the six losses on JAX's ``RoISample`` with
``loss_mask_iou`` (rtol 1e-4), every gradient (the mask RoIAlign's now
the sum of the FCN and MaskIoU heads' cotangents), the parameters after
two SGD steps; in bfloat16, the MaskIoU head on the JAX bfloat16 build's
pooled features and masks, within 1.5% of the largest prediction (the
RoI-head tolerance of ``tests/test_torch_bf16.py``) and closer than the
port's float32 build.

Entry points: mmdet's ``roi_head.mask_iou_head.*`` onto the port's names
by ``weights.from_mmdet_state_dict`` (a round trip), ``run_eval``'s
results with their mask scores, and the test CLI's ``--eval bbox segm``
and ``--out`` on the tiny model.
"""
import functools
import json
import os
import re
import sys

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""  # no compile-cache writes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from boosting_rcnn_tpu.builder import build_detector as jax_build  # noqa: E402
from boosting_rcnn_tpu.config import load_config as jax_load_config  # noqa: E402
from boosting_rcnn_tpu.models.detectors.two_stage import TwoStageNet  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads import mask_head as j_mask  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.data.coco import CocoDataset  # noqa: E402
from boosting_rcnn_tpu_torch.data.loader import DetDataLoader  # noqa: E402
from boosting_rcnn_tpu_torch.data.synthetic import generate  # noqa: E402
from boosting_rcnn_tpu_torch.engine.eval import run_eval  # noqa: E402
from boosting_rcnn_tpu_torch.engine.runner import shrink_model  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads import mask_head as t_mask  # noqa: E402
from boosting_rcnn_tpu_torch.tools import test as test_cli  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params, from_mmdet_state_dict  # noqa: E402

from test_torch_boosting_detectors import (  # noqa: E402
    _random_variables,
    check_gradients,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
)
from test_torch_mask_rcnn import _tiny  # noqa: E402
from test_torch_seesaw import run_mask_pair  # noqa: E402

MS_RCNN = "ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py"
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "loss_mask",
          "loss_mask_iou")
BF16 = torch.bfloat16
ROI_TOL = 0.015  # tests/test_torch_bf16.py's RoI-head tolerance
SEGM_KEYS = ("segm_mAP", "segm_mAP_50", "segm_mAP_75", "segm_mAP_s", "segm_mAP_m",
             "segm_mAP_l")
# the JAX reference rounds at every bfloat16 op, as on the TPU
_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})


def _close(got, ref, rel=1e-5, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max(), err_msg=what)


# ------------------------------------------------------------------ modules
def _head_inputs(seed, r=6, c=16):
    rs = np.random.RandomState(seed)
    pooled = rs.randn(r, 14, 14, c).astype(np.float32)
    masks = rs.uniform(0, 1, (r, 28, 28)).astype(np.float32)
    masks[0, :4, :4] = 0.75  # a window of ties: its first cell takes the gradient
    return rs, pooled, masks


def test_mask_iou_head_matches_jax():
    rs, pooled, masks = _head_inputs(0)
    flax_head = j_mask.MaskIoUHead(num_classes=5, num_convs=4, conv_channels=8, fc_channels=12)
    shapes = jax.eval_shape(lambda: flax_head.init(jax.random.PRNGKey(0), jnp.asarray(pooled),
                                                    jnp.asarray(masks)))
    params = _random_variables(shapes, rs)
    cot = rs.randn(6, 5).astype(np.float32)

    def jax_fn(v, x, m):
        out = flax_head.apply(v, x, m)
        return jnp.sum(out * cot), out

    (_, ref), (gv, gx, gm) = jax.value_and_grad(jax_fn, argnums=(0, 1, 2), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pooled), jnp.asarray(masks))
    head = t_mask.MaskIoUHead(torch.Generator().manual_seed(0), num_classes=5, in_channels=16,
                              conv_channels=8, fc_channels=12)
    head.load_state_dict(from_jax_params(params), strict=True)
    x, m = (torch.from_numpy(a).requires_grad_() for a in (pooled, masks))
    got = head(x, m)
    (got * torch.from_numpy(cot)).sum().backward()
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, 5)
    _close(got, ref, what="iou")
    _close(x.grad, gx, what="d pooled")
    _close(m.grad, gm, what="d masks")
    assert float(m.grad[0, :2, :2].abs().sum()) == float(np.abs(np.asarray(gm)[0, :2, :2]).sum())
    grads = from_jax_params(jax.tree.map(np.asarray, gv))
    for name, p in head.named_parameters():
        _close(p.grad, grads[name].reshape(p.shape), what=f"d {name}")


def test_mask_iou_targets_match_jax():
    rs = np.random.RandomState(1)
    r = 40
    pred = rs.uniform(0, 1, (r, 28, 28)).astype(np.float32)
    targets = (rs.rand(r, 28, 28) < 0.4).astype(np.float32)
    fracs = rs.uniform(0, 1, r).astype(np.float32)
    xy = rs.uniform(0, 100, (r, 2))
    rois = np.concatenate([xy, xy + rs.uniform(4, 60, (r, 2))], 1).astype(np.float32)
    gts = (rois + rs.randn(r, 4) * 5).astype(np.float32)
    gts[3] = [7.0, 7.0, 7.0, 7.0]  # a zero-area gt: floored at 1e-3
    pred[4] = 0.2  # nothing predicted
    ref = j_mask.mask_iou_targets(*map(jnp.asarray, (pred, targets, fracs, rois, gts)))
    got = t_mask.mask_iou_targets(*map(torch.from_numpy, (pred, targets, fracs, rois, gts)))
    assert float(got[4]) == 0.0
    _close(got, ref, what="targets")


# ------------------------------------------------------------- tiny MS R-CNN
def _tiny_ms(load):
    mc = _tiny(load(config_path(MS_RCNN)).model.to_dict())
    mc["roi_head"]["mask_iou_head"].update(in_channels=32, conv_out_channels=16,
                                           fc_out_channels=64, num_classes=4)
    return mc


@pytest.fixture(scope="module")
def run():
    return run_mask_pair(_tiny_ms)


def test_ms_rcnn_config(run):
    det = run["tdet"]
    head = det.net.mask_iou_head
    assert isinstance(head, t_mask.MaskIoUHead) and head.num_convs == 4
    assert tuple(head.conv_0.weight.shape) == (16, 33, 3, 3)
    assert tuple(head.fc_0.weight.shape) == (64, 16 * 7 * 7)
    assert tuple(head.fc_mask_iou.weight.shape) == (4, 64)
    assert not det.roi_cfg.boost and not det.roi_cfg.prob


def test_ms_rcnn_predict_matches_jax(run):
    ref, got = run["j_pred"], run["t_pred"]
    assert len(ref) == len(got) == 5
    _, _, valid = check_predict({"j_pred": ref[:3], "t_pred": got[:3]})
    masks, scores = got[3], got[4]
    np.testing.assert_allclose(masks.numpy(), np.asarray(ref[3]), rtol=0, atol=1e-4)
    assert scores.dtype == torch.float32 and tuple(scores.shape) == tuple(valid.shape)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref[4]), rtol=0, atol=1e-4)
    kept = valid.bool()
    assert (scores[kept] <= got[0][..., 4][kept] + 1e-6).all() and (scores[kept] >= 0).all()
    assert (scores[kept] < got[0][..., 4][kept]).any()


def test_ms_rcnn_losses_match_jax(run):
    assert set(run["t_losses"]) == set(run["j_losses"]) == set(LOSSES)
    for k in LOSSES:
        got, ref = run["t_losses"][k].item(), float(run["j_losses"][k])
        assert np.isfinite(got) and got > 0, k
        np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=k)


def test_ms_rcnn_gradients_match_jax(run):
    check_gradients(run)
    g = run["t_grads"]
    assert all(g[f"mask_iou_head.{k}.weight"].abs().max() > 0
               for k in ("conv_0", "fc_0", "fc_mask_iou"))


@pytest.mark.parametrize("step", [0, 1])
def test_ms_rcnn_sgd_steps_match_jax(run, step):
    check_step(run, step, LOSSES)


def test_bf16_mask_iou_head_matches_jax_bf16(run):
    """The MaskIoU head in bfloat16 on the JAX bfloat16 build's pooled
    features of JAX's detections (every third invalid) and its masks."""
    mc = _tiny_ms(jax_load_config)
    jdet = jax_build(mc, dtype=jnp.bfloat16)
    rs = np.random.RandomState(0)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), (128, 160)))
    variables = jax.tree.map(jnp.asarray, _random_variables(shapes, rs))
    net = jdet.net
    dets, labels, valid = run["j_pred"][:3]
    rois = dets[..., :4] * jnp.asarray(run["batch"]["scale_factor"])[:, None, :]
    valid = valid & (jnp.arange(valid.shape[1]) % 3 != 0)[None]

    @_jit
    def jax_heads(v, images, rois, valid):
        feats = net.apply(v, images, method=TwoStageNet.features)
        logits, pooled = net.apply(v, feats, rois, valid, return_pooled=True,
                                   method=TwoStageNet.mask_out)
        masks = jax.nn.sigmoid(logits[..., 0])
        return pooled, masks, net.apply(v, pooled, masks, method=TwoStageNet.mask_iou_out)

    pooled, masks, ref = jax_heads(variables, jnp.asarray(run["batch"]["images"]), rois, valid)
    assert pooled.dtype == jnp.bfloat16 and ref.dtype == jnp.float32
    x = torch.from_numpy(np.array(pooled.astype(jnp.float32)))
    m = torch.from_numpy(np.array(masks))
    params = from_jax_params(jax.tree.map(np.asarray, variables))
    errs = {}
    for dtype in (BF16, torch.float32):
        det = build_detector(_tiny_ms(load_config), device="cpu", dtype=dtype)
        det.net.load_state_dict(params, strict=True)
        with torch.inference_mode():
            got = det.net.mask_iou_out(x.to(dtype), m)
        assert got.dtype == torch.float32
        ref_np = np.asarray(ref)
        errs[dtype] = float(np.abs(got.numpy() - ref_np).max() / np.abs(ref_np).max())
    assert errs[BF16] <= ROI_TOL, errs
    assert errs[BF16] < errs[torch.float32] or errs[BF16] == 0, errs


# ------------------------------------------------------------ entry points
_TO_MMDET = (
    (r"mask_iou_head\.conv_(\d+)\.(.+)", r"roi_head.mask_iou_head.convs.\1.conv.\2"),
    (r"mask_iou_head\.fc_(\d+)\.(.+)", r"roi_head.mask_iou_head.fcs.\1.\2"),
    (r"mask_iou_head\.fc_mask_iou\.(.+)", r"roi_head.mask_iou_head.fc_mask_iou.\1"),
)


def test_mmdet_mask_iou_head_round_trip():
    """The MaskIoU head's seeded weights in mmdet's names (its first FC's
    input flattened ``(C, 7, 7)``) back through ``from_mmdet_state_dict``,
    equal."""
    det = build_detector(_tiny_ms(load_config), device="cpu", seed=1)
    src = {k: v for k, v in det.net.state_dict().items() if k.startswith("mask_iou_head.")}
    sd = {}
    for key, value in src.items():
        name = next(re.sub(p, r, key) for p, r in _TO_MMDET if re.fullmatch(p, key))
        if key == "mask_iou_head.fc_0.weight":
            o, i = value.shape
            value = value.reshape(o, 7, 7, i // 49).permute(0, 3, 1, 2).reshape(o, i)
        sd[name] = value.clone()
    assert "roi_head.mask_iou_head.convs.3.conv.weight" in sd
    assert "roi_head.mask_iou_head.fcs.1.bias" in sd
    got = from_mmdet_state_dict(sd)
    assert set(got) == set(src)
    for k, v in src.items():
        assert torch.equal(got[k], v), k


# the synthetic shapes set's 4 classes, for the box, mask and MaskIoU heads
FOUR_CLASSES = {f"model.roi_head.{h}.num_classes": 4
                for h in ("bbox_head", "mask_head", "mask_iou_head")}


@pytest.fixture(scope="module")
def ms_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ms_rcnn"))
    generate(root, n_train=0, n_val=3, seed=2)
    return root


def test_run_eval_keeps_the_mask_scores(ms_set):
    mc = shrink_model(load_config(config_path(MS_RCNN)).model.to_dict())
    mc["backbone"]["init_cfg"] = None
    for key in ("bbox_head", "mask_head", "mask_iou_head"):
        mc["roi_head"][key]["num_classes"] = 4
    det = build_detector(mc, device="cpu")
    ds = CocoDataset(os.path.join(ms_set, "val.json"), os.path.join(ms_set, "val"),
                     test_mode=True)
    loader = DetDataLoader(ds, batch_size=2, canvas=(128, 160), scale=(160, 128), train=False)
    results = run_eval(det, loader)
    assert len(results) == 3 and all(len(r) == 4 for r in results)
    for dets, labels, masks, scores in results:
        assert masks.shape == (len(dets), 28, 28) and scores.shape == (len(dets),)
        assert (scores <= dets[:, 4] + 1e-6).all() and (scores >= 0).all()
    js = ds.results_to_coco_json(results)
    assert len(js) == sum(len(r[0]) for r in results)


def test_test_cli_evaluates_segm_with_mask_scores(ms_set, tmp_path, capsys):
    out = str(tmp_path / "results.json")
    opts = {"data.test.ann_file": f"{ms_set}/val.json", "data.test.img_prefix": f"{ms_set}/val",
            "model.backbone.init_cfg": "None", "compute_dtype": "float32", **FOUR_CLASSES}
    metrics = test_cli.main([config_path(MS_RCNN), "--device", "cpu", "--tiny", "--eval", "bbox",
                             "segm", "--out", out,
                             "--cfg-options", *[f"{k}={v}" for k, v in opts.items()]])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["num_results"] == 3
    for key in SEGM_KEYS + ("bbox_mAP",):
        assert key in printed and key in metrics
    with open(out) as f:
        written = json.load(f)
    assert isinstance(written, list) and all("bbox" in d and "score" in d for d in written)
