"""The R-CNN heads' remaining box losses in the PyTorch port against the JAX
package, on the CPU, in float32.

Losses, on inputs made with numpy from a seed (degenerate boxes among
them: zero width or height, identical pairs, disjoint pairs, a box inside
another), each value and gradient within 1e-5 of its largest value:
``diou_loss``, ``eiou_loss``, ``focal_eiou_loss``, ``bounded_iou_loss``
(JAX ``guided_anchor_head.py``'s, elementwise ``(N, 4)``) and
``varifocal_loss`` (with and without ``iou_weighted``).

The ATSS RPN's other losses (JAX ``atss_rpn_head.py:297-375``), which no
repo config sets: ``atss_rpn_loss`` with the DIoU, EIoU or Focal-EIoU box
loss on decoded boxes, DIoU on the encoded deltas, and the varifocal
objectness on each branch, against JAX's losses and their gradients
(rtol 1e-5, gradients 1e-5 of the largest); the builder reads the config
types as JAX ``build_rpn`` does.

The R-CNN box head's ``reg_decoded_bbox=True`` (JAX ``bbox_head.py:201-255``):
``bbox_targets`` and ``bbox_head_loss`` for each decoded loss type against
JAX's, the elementwise ``(R, 4)`` losses of the boosting renormalisation
too; and the tiny decoded-box Faster R-CNN of
``configs/faster_rcnn/faster_rcnn_r50_fpn_{giou,bounded_iou}_1x_coco.py``
(cut as ``tests/test_torch_faster_rcnn.py`` cuts Faster R-CNN) through
``tests/test_torch_boosting_detectors.py``'s harness, at its tolerances
(``predict``, the losses rtol 1e-4, every gradient within 1e-3 of the
tensor's largest, two SGD steps).

The builder: all 31 configs of these heads (the 11 ``ms_rcnn``, the 16
``seesaw_loss`` and the four decoded-box Faster R-CNN files) build at full
width, the seeded initialisation skipped, with the parts they name.
"""
import glob
import os
import sys

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""  # no compile-cache writes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from boosting_rcnn_tpu.models.dense_heads import atss_rpn_head as j_rpn  # noqa: E402
from boosting_rcnn_tpu.models.dense_heads.guided_anchor_head import (  # noqa: E402
    bounded_iou_loss as j_bounded_iou_loss,
)
from boosting_rcnn_tpu.models.roi_heads import bbox_head as j_bbox  # noqa: E402
from boosting_rcnn_tpu.ops import losses as j_L  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config, set_by_dotted_key  # noqa: E402
from boosting_rcnn_tpu_torch.models import layers as t_layers  # noqa: E402
from boosting_rcnn_tpu_torch.models import plugins as t_plugins  # noqa: E402
from boosting_rcnn_tpu_torch.models.dense_heads import atss_rpn_head as t_rpn  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads import bbox_head as t_bbox  # noqa: E402
from boosting_rcnn_tpu_torch.ops import losses as t_L  # noqa: E402

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
FASTER_LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox")


def _close(got, ref, rel=1e-5, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max(), err_msg=what)


def _box_pairs(seed: int = 0, n: int = 64):
    """``(n, 4)`` predicted and target boxes: random pairs, then the
    degenerate ones (zero width, zero height, identical, disjoint, nested,
    both points)."""
    rs = np.random.RandomState(seed)

    def boxes(k):
        xy = rs.uniform(0, 100, (k, 2))
        return np.concatenate([xy, xy + rs.uniform(1, 60, (k, 2))], 1)

    pred, target = boxes(n), boxes(n)
    target[: n // 2] = pred[: n // 2] + rs.randn(n // 2, 4) * 6.0
    target[: n // 2, 2:] = np.maximum(target[: n // 2, 2:], target[: n // 2, :2] + 1.0)
    pred[-8] = [10.0, 10.0, 10.0, 40.0]  # zero width
    pred[-7] = [10.0, 10.0, 40.0, 10.0]  # zero height
    target[-6] = pred[-6]  # identical
    target[-5] = pred[-5] + [200.0, 200.0, 200.0, 200.0]  # disjoint
    target[-4] = [pred[-4, 0] + 2, pred[-4, 1] + 2, pred[-4, 2] - 2, pred[-4, 3] - 2]  # inside
    pred[-3] = [5.0, 5.0, 5.0, 5.0]  # a point
    target[-3] = [5.0, 5.0, 5.0, 5.0]
    target[-2] = [20.0, 30.0, 20.0, 30.0]  # a point target
    return pred.astype(np.float32), target.astype(np.float32)


_BOX_LOSSES = {
    "diou": (j_L.diou_loss, t_L.diou_loss),
    "eiou": (j_L.eiou_loss, t_L.eiou_loss),
    "focal_eiou": (j_L.focal_eiou_loss, t_L.focal_eiou_loss),
    "bounded_iou": (lambda p, t, reduction: j_bounded_iou_loss(p, t),
                    lambda p, t, reduction: t_L.bounded_iou_loss(p, t)),
}


@pytest.mark.parametrize("name", sorted(_BOX_LOSSES))
def test_box_loss_and_gradients_match_jax(name):
    j_fn, t_fn = _BOX_LOSSES[name]
    pred, target = _box_pairs()
    rs = np.random.RandomState(1)
    cot = rs.uniform(0.5, 1.5, (pred.shape[0], 4) if name == "bounded_iou"
                     else pred.shape[:1]).astype(np.float32)

    def jax_fn(p, t):
        loss = j_fn(p, t, reduction="none")
        return jnp.sum(loss * cot), loss

    (_, ref), ref_g = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(pred), jnp.asarray(target))
    p, t = (torch.from_numpy(x).requires_grad_() for x in (pred, target))
    got = t_fn(p, t, reduction="none")
    (got * torch.from_numpy(cot)).sum().backward()
    assert np.isfinite(np.asarray(ref)).all()
    _close(got, ref, what=name)
    _close(p.grad, ref_g[0], what=f"d pred {name}")
    _close(t.grad if t.grad is not None else torch.zeros_like(t), ref_g[1],
           what=f"d target {name}")


@pytest.mark.parametrize("iou_weighted", [True, False])
def test_varifocal_loss_matches_jax(iou_weighted):
    rs = np.random.RandomState(2)
    pred = (rs.randn(300, 3) * 2).astype(np.float32)
    target = np.where(rs.rand(300, 3) < 0.3, rs.uniform(0, 1, (300, 3)), 0.0).astype(np.float32)
    target[:5] = 0.0
    weight = rs.uniform(0, 2, 300).astype(np.float32)

    def jax_fn(x):
        return j_L.varifocal_loss(x, jnp.asarray(target), weight=jnp.asarray(weight),
                                  iou_weighted=iou_weighted, avg_factor=17.0)

    ref, ref_g = jax.value_and_grad(jax_fn)(jnp.asarray(pred))
    x = torch.from_numpy(pred).requires_grad_()
    got = t_L.varifocal_loss(x, torch.from_numpy(target), weight=torch.from_numpy(weight),
                             iou_weighted=iou_weighted, avg_factor=17.0)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    _close(x.grad, ref_g, what="d pred")


# ----------------------------------------------------------- ATSS RPN losses
@pytest.mark.parametrize("decoded,box,cls", [
    (True, "diou", "focal"), (True, "eiou", "focal"), (True, "focal_eiou", "focal"),
    (False, "diou", "focal"), (True, "giou", "varifocal"), (False, "ciou", "varifocal")])
def test_atss_rpn_loss_types_match_jax(decoded, box, cls):
    rs = np.random.RandomState(8)
    b, a, g = 2, 400, 5
    ctr = rs.uniform(0, 128, (a, 2))
    wh = rs.uniform(8, 48, (a, 2))
    anchors = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)
    gts = np.zeros((b, g, 4), np.float32)
    for i in range(b):
        gts[i] = anchors[rs.randint(0, a, g)] + rs.randn(g, 4).astype(np.float32) * 3.0
    gt_mask = np.ones((b, g), bool)
    gt_mask[1, -1] = False
    cls_l = rs.randn(b, a).astype(np.float32)
    reg = (rs.randn(b, a, 4) * 0.3).astype(np.float32)
    iou = rs.randn(b, a).astype(np.float32)
    valid = np.ones((b, a), bool)
    kw = dict(gamma=2.0, reg_decoded_bbox=decoded, loss_bbox_type=box, loss_cls_type=cls,
              aug_loss_weight=2.0, loss_cls_weight=1.5,
              target_stds=(0.1, 0.1, 0.2, 0.2) if not decoded else (1.0,) * 4)
    jcfg, tcfg = j_rpn.ATSSRPNCfg(**kw), t_rpn.ATSSRPNCfg(**kw)
    fixed = (anchors, valid, gts, gt_mask)

    def jax_fn(c, r, i):
        losses = j_rpn.atss_rpn_loss(jcfg, c, r, i, *map(jnp.asarray, fixed))
        return sum(losses.values()), losses

    (_, ref), ref_g = jax.value_and_grad(jax_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(cls_l), jnp.asarray(reg), jnp.asarray(iou))
    inputs = [torch.from_numpy(x).requires_grad_() for x in (cls_l, reg, iou)]
    got = t_rpn.atss_rpn_loss(tcfg, *inputs, *map(torch.from_numpy, fixed))
    sum(got.values()).backward()
    for k in ("loss_rpn_cls", "loss_rpn_bbox", "loss_rpn_iou"):
        assert float(ref[k]) > 0, k
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-5, err_msg=k)
    for x, r, what in zip(inputs, ref_g, ("cls", "reg", "iou")):
        _close(x.grad, r, what=f"d {what}")


def _flagship_cfg():
    return load_config(config_path("boosting_rcnn/boosting_rcnn_r50_pafpn_1x_utdac.py")
                       ).model.to_dict()


@pytest.mark.parametrize("loss_cls,loss_bbox,want", [
    ({"type": "VarifocalLoss", "use_sigmoid": True, "loss_weight": 1.0}, None,
     ("varifocal", "iou")),
    (None, {"type": "DIoULoss", "loss_weight": 2.0}, ("focal", "diou")),
    (None, {"type": "EIoULoss", "loss_weight": 2.0}, ("focal", "eiou")),
    (None, {"type": "FocalEIoULoss", "loss_weight": 2.0}, ("focal", "focal_eiou")),
])
def test_builder_reads_the_atss_rpn_loss_types(fast_init, loss_cls, loss_bbox, want):
    mc = _flagship_cfg()
    if loss_cls:
        mc["rpn_head"]["loss_cls"] = loss_cls
    if loss_bbox:
        mc["rpn_head"]["loss_bbox"] = loss_bbox
    r = build_detector(mc, device="cpu").rpn_cfg
    assert (r.loss_cls_type, r.loss_bbox_type) == want
    assert r.loss_bbox_weight == (loss_bbox or {"loss_weight": 1.0})["loss_weight"]


@pytest.mark.parametrize("path,value,match", [
    ("rpn_head.loss_cls", {"type": "VarifocalLoss", "use_sigmoid": True, "alpha": 0.5},
     "alpha"),
    ("rpn_head.loss_bbox", {"type": "FocalEIoULoss", "gamma": 1.0}, "gamma"),
    ("rpn_head.loss_bbox", {"type": "BoundedIoULoss"}, "BoundedIoULoss"),
])
def test_builder_rejects_atss_rpn_loss_values(fast_init, path, value, match):
    mc = _flagship_cfg()
    set_by_dotted_key(mc, path, value)
    with pytest.raises(NotImplementedError, match=match):
        build_detector(mc, device="cpu")


def test_builder_rejects_eiou_on_the_encoded_deltas(fast_init):
    mc = load_config(config_path("boosting_rcnn/boosting_rcnn_r50_fpn_1x_coco.py")
                     ).model.to_dict()
    assert mc["rpn_head"]["reg_decoded_bbox"] is False
    mc["rpn_head"]["loss_bbox"] = {"type": "EIoULoss", "loss_weight": 1.0}
    with pytest.raises(NotImplementedError, match="encoded deltas"):
        build_detector(mc, device="cpu")


# ------------------------------------------------- the decoded-box box head
def _head_inputs(seed, r=48, c=4):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 100, (r, 2))
    rois = np.concatenate([xy, xy + rs.uniform(4, 50, (r, 2))], 1).astype(np.float32)
    gt = (rois + rs.randn(r, 4) * 4).astype(np.float32)
    gt[:, 2:] = np.maximum(gt[:, 2:], gt[:, :2] + 1)
    is_pos = rs.rand(r) < 0.4
    valid = rs.rand(r) < 0.9
    labels = rs.randint(0, c, r)
    cls = rs.randn(r, c + 1).astype(np.float32)
    reg = (rs.randn(r, 4 * c) * 0.2).astype(np.float32)
    return rois, gt, is_pos, valid, labels, cls, reg


@pytest.mark.parametrize("box", ["iou", "giou", "ciou", "bounded_iou", "eiou", "focal_eiou"])
@pytest.mark.parametrize("reduction", [None, "none"])
def test_decoded_bbox_head_loss_matches_jax(box, reduction):
    rois, gt, is_pos, valid, labels, cls, reg = _head_inputs(5)
    kw = dict(num_classes=4, reg_decoded_bbox=True, loss_bbox_type=box, loss_bbox_weight=10.0,
              loss_cls_weight=1.0, target_stds=(0.1, 0.1, 0.2, 0.2))
    jcfg, tcfg = j_bbox.BBoxHeadCfg(**kw), t_bbox.BBoxHeadCfg(**kw)
    jt = j_bbox.bbox_targets(jcfg, *map(jnp.asarray, (rois, is_pos, valid, gt, labels)))
    tt = t_bbox.bbox_targets(tcfg, *map(torch.from_numpy, (rois, is_pos, valid, gt, labels)))
    for got, ref in zip(tt, jt):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    rs = np.random.RandomState(6)
    cot = {"loss_cls": rs.rand(48).astype(np.float32), "loss_bbox": rs.rand(48, 4).astype(
        np.float32)} if reduction else {"loss_cls": 1.0, "loss_bbox": 1.0}

    def jax_fn(c_, r_):
        out = j_bbox.bbox_head_loss(jcfg, c_, r_, jnp.asarray(rois), *jt,
                                    reduction_override=reduction)
        return sum(jnp.sum(out[k] * cot[k]) for k in cot), out

    (_, ref), ref_g = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(cls), jnp.asarray(reg))
    x_cls, x_reg = (torch.from_numpy(x).requires_grad_() for x in (cls, reg))
    got = t_bbox.bbox_head_loss(tcfg, x_cls, x_reg, torch.from_numpy(rois), *tt,
                                reduction_override=reduction)
    sum((got[k] * torch.as_tensor(cot[k])).sum() for k in cot).backward()
    if reduction == "none":
        assert tuple(got["loss_bbox"].shape) == (48, 4)
    for k in cot:
        _close(got[k], ref[k], what=k)
    assert float(jnp.abs(ref_g[1]).max()) > 0
    _close(x_cls.grad, ref_g[0], what="d cls")
    _close(x_reg.grad, ref_g[1], what="d reg")


def _decoded_faster(loss):
    def make(load):
        mc = load(config_path(f"faster_rcnn/faster_rcnn_r50_fpn_{loss}_1x_coco.py"))
        mc = mc.model.to_dict()
        mc["backbone"].update(depth=18, base_channels=8)
        mc["neck"]["in_channels"] = [8, 16, 32, 64]
        mc["roi_head"]["bbox_roi_extractor"]["out_channels"] = 32
        return shrink_heads(mc, num_classes=4)
    return make


@pytest.fixture(scope="module", params=["giou", "bounded_iou"])
def decoded_run(request):
    return request.param, run_pair(_decoded_faster(request.param))


def test_decoded_faster_rcnn_matches_jax(decoded_run):
    loss, run = decoded_run
    b = run["tdet"].bbox_cfg
    assert (b.reg_decoded_bbox, b.loss_bbox_type, b.loss_bbox_weight) == (True, loss, 10.0)
    check_predict(run)
    check_losses(run, FASTER_LOSSES)


def test_decoded_faster_rcnn_gradients_match_jax(decoded_run):
    check_gradients(decoded_run[1])


@pytest.mark.parametrize("step", [0, 1])
def test_decoded_faster_rcnn_sgd_steps_match_jax(decoded_run, step):
    check_step(decoded_run[1], step, FASTER_LOSSES)


# ----------------------------------------------------------- the 31 configs
@pytest.fixture
def fast_init(monkeypatch):
    """Seeded initialisation skipped: a full-width build checks the
    builder, not the draws."""
    skip = lambda weight, fan_in, gen: None  # noqa: E731
    monkeypatch.setattr(t_layers, "lecun_normal_", skip)
    monkeypatch.setattr(t_plugins, "lecun_normal_", skip)
    for name in ("kaiming_uniform_", "uniform_"):  # torch's own inits, overwritten
        monkeypatch.setattr(torch.nn.init, name, lambda tensor, *a, **k: tensor)


def _head_files():
    files = [os.path.relpath(p, CONFIGS) for d in ("ms_rcnn", "seesaw_loss")
             for p in glob.glob(os.path.join(CONFIGS, d, "*.py"))]
    files += [f"faster_rcnn/faster_rcnn_r50_fpn_{m}_1x_coco.py"
              for m in ("iou", "giou", "ciou", "bounded_iou")]
    return sorted(files)


def test_the_heads_have_31_configs():
    files = _head_files()
    assert len(files) == 31 and all(os.path.isfile(os.path.join(CONFIGS, f)) for f in files)


@pytest.mark.parametrize("name", _head_files())
def test_head_config_builds(fast_init, name):
    mc = load_config(os.path.join(CONFIGS, name)).model.to_dict()
    det = build_detector(mc, device="cpu")
    net, b = det.net, det.bbox_cfg
    heads = getattr(net, "bbox_heads", None) or [net.bbox_head]
    if name.startswith("faster_rcnn/"):
        loss = name[len("faster_rcnn/faster_rcnn_r50_fpn_"):-len("_1x_coco.py")]
        assert (b.reg_decoded_bbox, b.loss_bbox_type) == (True, loss)
        assert net.mask_head is None
    elif name.startswith("ms_rcnn/"):
        assert net.mask_iou_head is not None and b.loss_cls_type == "ce"
        assert tuple(net.mask_iou_head.fc_mask_iou.weight.shape) == (80, 1024)
        assert tuple(net.mask_iou_head.conv_0.weight.shape) == (256, 257, 3, 3)
    else:
        assert b.loss_cls_type == "seesaw" and (b.seesaw_p, b.seesaw_q) == (0.8, 2.0)
        assert all(h.seesaw and tuple(h.seesaw_counts.shape) == (1204,) for h in heads)
        assert all(tuple(h.fc_cls.weight.shape) == (1204, 1024) for h in heads)
        masks = getattr(net, "mask_heads", None) or [net.mask_head]
        normed = "normed_mask" in name
        assert all((type(m.conv_logits).__name__ == "NormedConv1x1") == normed for m in masks)
        if normed:
            assert all(m.conv_logits.temperature == 20.0 for m in masks)
