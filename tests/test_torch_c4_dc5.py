"""The neck-less caffe R-CNNs of the PyTorch port against the JAX package's,
on the CPU: C4 (three ResNet stages, the RPN and the RoI heads on C4 at
stride 16, the shared res5 box head, Mask R-CNN's mask branch on the same
res5) and DC5 (stage 4 at stride 1 with its 3x3s dilated by 2).

Modules, on inputs made with numpy from a seed, within 1e-5 of the
largest value:

  * ``ResNet`` with ``num_stages`` / ``strides`` / ``dilations`` /
    ``out_indices`` (C4's and DC5's, caffe style, ResNet-50 and -18 at
    width 8) against the JAX ``ResNet``;
  * ``Res5BBoxHead`` (caffe and pytorch styles; ``res5`` and the head)
    against the JAX module, values and input gradients.

Whole tiny detectors (``configs/mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py``
and ``configs/faster_rcnn/faster_rcnn_r50_caffe_dc5_1x_coco.py`` on
ResNet-18 at width 8, RPN 32, 4 classes; C4's res5 of 16 planes, as the
port's builder makes it for C4's 32 channels, and the JAX net's head
cloned to the same width) on ``run_fused_pair``: ``predict`` (labels and
valid equal, detections within 1e-3, masks within 1e-4), the losses on
JAX's ``RoISample`` and RPN draws (rtol 1e-4), every gradient and the
parameters after two SGD steps at the detectors harness's tolerances
(``tests/test_torch_boosting_detectors.py``); in bfloat16, C4's
``mask_out`` (14 x 14 RoIAlign, res5, the FCN head) and DC5's
``roi_out`` on the JAX bfloat16 build's level, within 1.5% of the
largest value and closer than the port's float32 build, and the losses
within 1.5% (``tests/test_torch_bf16.py``'s tolerances).

The 8 C4, DC5 and PointRend configs build at full width (the seeded
initialisation skipped).  ``weights.from_mmdet_state_dict`` maps mmdet's
``roi_head.shared_head.layer4`` (every key of ``tests/test_parity_c4.py``'s
state dict), reorders DC5's first FC at 7 x 7 x 2048, and raises on
PointRend's heads, naming why.
"""
import contextlib
import dataclasses
import functools
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
from boosting_rcnn_tpu.engine import train as j_train  # noqa: E402
from boosting_rcnn_tpu.models.backbones import resnet as j_resnet  # noqa: E402
from boosting_rcnn_tpu.models.detectors import trident as j_trident  # noqa: E402
from boosting_rcnn_tpu.models.detectors.two_stage import TwoStageNet  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads import mask_head as j_mask_head  # noqa: E402
from boosting_rcnn_tpu.ops import pallas_roi_align as j_pallas  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.engine import train as t_train  # noqa: E402
from boosting_rcnn_tpu_torch.models import layers as t_layers  # noqa: E402
from boosting_rcnn_tpu_torch.models import plugins as t_plugins  # noqa: E402
from boosting_rcnn_tpu_torch.models.backbones.resnet import ResNet  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads.res5_head import Res5BBoxHead  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params, from_mmdet_state_dict  # noqa: E402

from test_torch_boosting_detectors import (  # noqa: E402
    _batch,
    _random_variables,
    _rpn_uniforms,
    check_gradients,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
)
from test_torch_mask_rcnn import _ellipse  # noqa: E402

CANVAS = (128, 160)
BF16 = torch.bfloat16
BF16_TOL = 0.015  # tests/test_torch_bf16.py's RoI-head and loss tolerances
C4_MASK = "mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py"
DC5 = "faster_rcnn/faster_rcnn_r50_caffe_dc5_1x_coco.py"
FASTER_LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox")
MASK_LOSSES = FASTER_LOSSES + ("loss_mask",)
# the configs of this slice (and PointRend's, tests/test_torch_point_rend.py)
SLICE_CONFIGS = (C4_MASK, "faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py", DC5,
                 "faster_rcnn/faster_rcnn_r50_caffe_dc5_mstrain_1x_coco.py",
                 "faster_rcnn/faster_rcnn_r50_caffe_dc5_mstrain_3x_coco.py",
                 "point_rend/point_rend_r50_fpn_1x_coco.py",
                 "point_rend/point_rend_r50_caffe_fpn_mstrain_1x_coco.py",
                 "point_rend/point_rend_r50_caffe_fpn_mstrain_3x_coco.py")
# the JAX reference rounds at every bfloat16 op, as on the TPU
_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})


def _close(got, ref, rel=1e-5, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-12),
                               err_msg=what)


def shrink_neckless(mc):
    """A neck-less config on ResNet-18 at width 8 (its stages, strides and
    dilations kept), RPN 32, 4 classes, the detectors harness's sampling
    sizes; C4's mask head deconvolves to 16 channels."""
    mc["backbone"].update(depth=18, base_channels=8)
    mc["rpn_head"].update(in_channels=32, feat_channels=32)
    roi = mc["roi_head"]
    roi["bbox_head"]["num_classes"] = 4
    if roi["bbox_head"]["type"] != "BBoxHead":
        roi["bbox_head"]["fc_out_channels"] = 16
    if roi.get("mask_head"):
        roi["mask_head"].update(conv_out_channels=16, num_classes=4)
    mc["train_cfg"]["rpn_proposal"].update(nms_pre=200, max_per_img=64)
    mc["train_cfg"]["rcnn"]["sampler"]["num"] = 32
    mc["test_cfg"]["rpn"].update(nms_pre=100, max_per_img=32)
    return mc


def narrow_jax_res5(jdet, planes: int):
    """The JAX net with its C4 res5 head at ``planes`` (the JAX builder's is
    fixed at 512; the port's takes half the backbone's channels)."""
    head = jdet.net.bbox_head
    jdet.net = jdet.net.clone(bbox_head=j_trident.Res5BBoxHead(
        num_classes=head.num_classes, base_planes=planes, style=head.style,
        reg_class_agnostic=head.reg_class_agnostic, dtype=head.dtype))
    return jdet


def jax_detector(mc, dtype=jnp.float32):
    jdet = jax_build(mc, dtype=dtype)
    if isinstance(jdet.net.bbox_head, j_trident.Res5BBoxHead):
        narrow_jax_res5(jdet, 16)
    return jdet


def point_uniforms(key, rois: int, draws):
    """The uniforms of JAX ``get_train_points`` under ``loss(..., key)``:
    ``fold_in(key, 7)`` split in two."""
    k1, k2 = jax.random.split(jax.random.fold_in(key, 7))
    return tuple(np.array(jax.random.uniform(k, (rois, n, 2)))
                 for k, n in zip((k1, k2), draws))


@contextlib.contextmanager
def eager_mask_targets():
    """Inside the block the JAX package's ``resample_mask_targets`` runs
    op by op (a ``pure_callback``) inside jitted programs.  A gt-box RoI's
    14 x 14 (C4) or 7 x 7 (PointRend's coarse) targets sample its 28 x 28
    crop exactly between two cells, so a cell on the mask's edge is a 0.5
    tie, which the package's arithmetic as written (and the port, which
    copies it) rounds one way and XLA's fused jit code another (15 of the
    tiny C4's positive cells).  The targets take no gradient."""
    orig = j_mask_head.resample_mask_targets

    def eager(*args, **kw):
        out = jax.ShapeDtypeStruct(args[2].shape[:1] + (kw["out_size"],) * 2, jnp.float32)
        return jax.pure_callback(lambda *a: np.asarray(orig(*a, **kw), np.float32), out, *args,
                                 vmap_method="sequential")

    j_mask_head.resample_mask_targets = eager
    try:
        yield
    finally:
        j_mask_head.resample_mask_targets = orig


def run_fused_pair(make_cfg, seed: int = 0):
    with eager_mask_targets():
        return _run_fused_pair(make_cfg, seed)


def _run_fused_pair(make_cfg, seed: int = 0):
    """Both packages on ``make_cfg``'s tiny model (each package's config
    reader reads the file) through ``predict``, the loss, its gradients and
    two SGD steps on the same weights and batch (with ellipse mask crops
    for a mask head).  The JAX loss samples inside from its key (PointRend's
    has no ``sample=``); the port takes JAX's ``train_sample`` of the same
    key, JAX's RPN draws and, for PointRend, JAX's point draws."""
    mc = make_cfg(jax_load_config)
    jdet = jax_detector(mc)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    rs = np.random.RandomState(seed)
    variables = _random_variables(shapes, rs)
    batch = _batch(rs, 4)
    masks = bool(mc["roi_head"].get("mask_head"))
    if masks:
        batch["gt_mask_crops"] = np.stack([np.stack([_ellipse(rs) for _ in range(6)])
                                           for _ in range(2)])
    jv = jax.tree.map(jnp.asarray, variables)
    jb = jax.tree.map(jnp.asarray, batch)
    anchors, nla = jdet.anchors_for(CANVAS)
    rng = jax.random.PRNGKey(3)
    n_anchors = anchors.shape[0]

    tdet, tdet_train = (build_detector(make_cfg(load_config), device="cpu") for _ in range(2))
    for det in (tdet, tdet_train):
        det.net.load_state_dict(from_jax_params(variables), strict=True)
    t_anchors, t_nla = tdet.anchors_for(CANVAS)
    assert t_nla == nla
    point_cfg = getattr(tdet, "point_cfg", None)

    def draws(key):
        kw = {"rpn_uniforms": _rpn_uniforms(key, n_anchors)}
        if point_cfg is not None:
            kw["point_uniforms"] = point_uniforms(key, 2 * mc["train_cfg"]["rcnn"]["sampler"]["num"],
                                                  point_cfg.train_draws)
        return kw

    j_pred = jax.jit(lambda v, b: jdet.predict(v, b, anchors, nla))(jv, jb)
    t_pred = tdet.predict(batch, t_anchors, t_nla)
    stats = jv["batch_stats"]
    sample_fn = jax.jit(lambda p, r: jdet.train_sample(
        {"params": p, "batch_stats": stats}, r, jb, anchors, nla))

    def j_loss(params, key):
        losses = jdet.loss({"params": params, "batch_stats": stats}, key, jb, anchors, nla)
        return sum(losses.values()), losses

    grad_fn = jax.jit(jax.value_and_grad(j_loss, has_aux=True))
    (_, j_losses), j_grads = grad_fn(jv["params"], rng)
    sample0 = sample_fn(jv["params"], rng)
    t_losses = tdet.loss(batch, t_anchors, t_nla, sample=tuple(np.array(x) for x in sample0),
                         **draws(rng))
    sum(t_losses.values()).backward()
    t_grads = {k: (None if p.grad is None else p.grad.clone())
               for k, p in tdet.net.named_parameters()}

    kw = dict(decay_epochs=(1,), warmup_iters=2, warmup_ratio=0.5)  # lr 0.01, then 0.0015
    j_sched, t_sched = (m.step_lr_schedule(0.02, 1, **kw) for m in (j_train, t_train))
    tx = j_train.make_optimizer(j_sched, params=jv["params"], frozen_stages=1)
    state = j_train.create_train_state(jv, tx)
    apply_fn = jax.jit(lambda st, g: (st.apply_gradients(grads=g), jnp.sqrt(sum(
        jnp.sum(x * x) for x in jax.tree_util.tree_leaves(g)))))
    t_step = t_train.make_train_step(
        tdet_train, t_anchors, t_nla,
        t_train.make_optimizer(tdet_train.net.parameters(), t_sched))
    p0 = {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()}
    steps = []
    for k in range(2):
        key = jax.random.fold_in(rng, k)
        sample = sample_fn(state.params, key)
        (total, losses), grads = grad_fn(state.params, key)
        state, grad_norm = apply_fn(state, grads)
        j_metrics = {"loss": total, **losses, "grad_norm": grad_norm}
        t_metrics = t_step(batch, tuple(np.array(x) for x in sample), **draws(key))
        steps.append((from_jax_params(jax.tree.map(np.asarray, state.params)),
                      {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()},
                      j_metrics, t_metrics))
    return dict(mc=mc, jdet=jdet, tdet=tdet, variables=variables, jv=jv, batch=batch,
                j_pred=j_pred, t_pred=t_pred, sample0=sample0, draws=draws(rng),
                j_losses=j_losses, t_losses=t_losses,
                j_grads=from_jax_params(jax.tree.map(np.asarray, j_grads)), t_grads=t_grads,
                p0=p0, steps=steps)


def check_losses(run, names):
    assert set(run["t_losses"]) == set(run["j_losses"]) == set(names)
    for k in names:
        got, ref = run["t_losses"][k].item(), float(run["j_losses"][k])
        assert np.isfinite(got) and got > 0, k
        np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=k)
    assert np.asarray(run["sample0"].is_pos).sum() > 4


def bf16_losses(run, make_cfg):
    """The losses of the port's bfloat16 build against the JAX bfloat16
    build's (XLA's excess precision off) on the same weights, batch, JAX's
    float32 ``RoISample`` and draws: each within ``BF16_TOL`` of its value."""
    jdet = jax_detector(make_cfg(jax_load_config), jnp.bfloat16)
    anchors, nla = jdet.anchors_for(CANVAS)
    jb = jax.tree.map(jnp.asarray, run["batch"])
    with eager_mask_targets():
        ref = _jit(lambda v: jdet.loss(v, jax.random.PRNGKey(3), jb, anchors, nla))(run["jv"])
    det = build_detector(make_cfg(load_config), device="cpu", dtype=BF16)
    det.net.load_state_dict(from_jax_params(run["variables"]), strict=True)
    t_anchors, t_nla = det.anchors_for(CANVAS)
    with torch.no_grad():
        got = det.loss(run["batch"], t_anchors, t_nla,
                       sample=tuple(np.array(x) for x in run["sample0"]), **run["draws"])
    assert set(got) == set(ref)
    for k, v in got.items():
        assert v.dtype == torch.float32 and torch.isfinite(v), k
        np.testing.assert_allclose(v.item(), float(ref[k]), rtol=BF16_TOL, err_msg=k)
    return jdet


@pytest.fixture
def fast_init(monkeypatch):
    """The full-width builds skip the seeded LeCun initialisation (their
    checks read structure, never weights)."""
    for module in (t_layers, t_plugins):
        monkeypatch.setattr(module, "lecun_normal_", lambda weight, fan_in, gen: None)
    for name in ("kaiming_uniform_", "uniform_"):  # torch's own inits, overwritten
        monkeypatch.setattr(torch.nn.init, name, lambda tensor, *a, **k: tensor)


# ------------------------------------------------------------------ modules
@pytest.mark.parametrize("depth,stages", [
    (50, dict(num_stages=3, strides=(1, 2, 2), dilations=(1, 1, 1), out_indices=(2,))),
    (50, dict(num_stages=4, strides=(1, 2, 2, 1), dilations=(1, 1, 1, 2), out_indices=(3,))),
    (18, dict(num_stages=4, strides=(1, 2, 2, 1), dilations=(1, 1, 1, 2), out_indices=(1, 3))),
], ids=["c4_r50", "dc5_r50", "dc5_r18"])
def test_resnet_stages_match_jax(depth, stages):
    jnet = j_resnet.ResNet(depth=depth, base_channels=8, frozen_stages=1, style="caffe",
                           **stages)
    rs = np.random.RandomState(depth)
    x = rs.randn(1, 64, 96, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _random_variables(shapes, rs)
    ref = jax.jit(jnet.apply)(jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    net = ResNet(torch.Generator().manual_seed(0), depth=depth, base_channels=8,
                 frozen_stages=1, style="caffe", **stages)
    net.load_state_dict(from_jax_params(variables), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == len(stages["out_indices"])
    assert net.out_channels == tuple(r.shape[-1] for r in ref)
    assert got[-1].shape[2:] == (4, 6)  # stride 16 on the 64 x 96 image
    for g, r in zip(got, ref):
        _close(g.permute(0, 2, 3, 1), r, what="stage output")


@pytest.mark.parametrize("style", ["caffe", "pytorch"])
def test_res5_head_matches_jax(style):
    jhead = j_trident.Res5BBoxHead(num_classes=4, base_planes=8, style=style)
    rs = np.random.RandomState(1)
    x = rs.randn(5, 14, 14, 16).astype(np.float32)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = _random_variables(shapes, rs)
    jv = jax.tree.map(jnp.asarray, variables)
    w = rs.randn(5, 5).astype(np.float32)

    def jax_fn(xx):
        cls, reg = jhead.apply(jv, xx)
        return jnp.sum(cls * jnp.asarray(w)) + jnp.sum(reg ** 2), (cls, reg)

    (_, (cls, reg)), gx = jax.jit(jax.value_and_grad(jax_fn, has_aux=True))(jnp.asarray(x))
    res5 = jhead.apply(jv, jnp.asarray(x), method=j_trident.Res5BBoxHead.res5)
    head = Res5BBoxHead(torch.Generator().manual_seed(0), num_classes=4, in_channels=16,
                        planes=8, style=style)
    head.load_state_dict(from_jax_params(variables), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    t_cls, t_reg = head(xt)
    ((t_cls * torch.from_numpy(w)).sum() + (t_reg ** 2).sum()).backward()
    _close(t_cls, cls, what="cls")
    _close(t_reg, reg, what="reg")
    _close(xt.grad, gx, what="input gradient")
    with torch.no_grad():
        _close(head.res5(torch.from_numpy(x)), res5, what="res5")
    assert tuple(res5.shape) == (5, 7, 7, 32)


# --------------------------------------------------------- tiny C4 Mask R-CNN
def _tiny_c4(load):
    return shrink_neckless(load(config_path(C4_MASK)).model.to_dict())


@pytest.fixture(scope="module")
def c4_run():
    return run_fused_pair(_tiny_c4)


def test_c4_builds_the_shared_res5_path(c4_run):
    det = c4_run["tdet"]
    net = det.net
    assert net.neck is None and net.roi_strides == (16,) and net.mask_on_shared
    assert net.roi_out_size == net.mask_roi_out_size == 14
    assert isinstance(net.bbox_head, Res5BBoxHead) and net.bbox_head.out_channels == 64
    assert tuple(net.mask_head.upsample.weight.shape[:2]) == (64, 16)
    assert net.rpn.rpn_cls.weight.shape[0] == 15  # 5 scales x 3 ratios, one level
    # JAX's BBoxHeadCfg defaults (builder.py:2285-2293): L1, cls weight 2
    assert det.bbox_cfg.loss_cls_weight == 2.0 and det.bbox_cfg.loss_bbox_type == "l1"
    for field in dataclasses.fields(det.bbox_cfg):
        assert getattr(det.bbox_cfg, field.name) == getattr(c4_run["jdet"].bbox_cfg, field.name)


def test_c4_predict_matches_jax(c4_run):
    ref, got = c4_run["j_pred"], c4_run["t_pred"]
    check_predict({"j_pred": ref[:3], "t_pred": got[:3]})
    assert tuple(got[3].shape) == (2, 100, 14, 14) and got[3].dtype == torch.float32
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=0, atol=1e-4)


def test_c4_losses_match_jax(c4_run):
    check_losses(c4_run, MASK_LOSSES)


def test_c4_gradients_match_jax(c4_run):
    check_gradients(c4_run)
    g = c4_run["t_grads"]
    # res5 takes the box and the mask branches' gradients
    assert g["bbox_head.res5_0.conv2.weight"].abs().max() > 0
    assert g["mask_head.conv_logits.weight"].abs().max() > 0


@pytest.mark.parametrize("step", [0, 1])
def test_c4_sgd_steps_match_jax(c4_run, step):
    check_step(c4_run, step, MASK_LOSSES)


def test_c4_bf16_mask_out_and_losses_match_jax_bf16(c4_run):
    """``mask_out`` in bfloat16 (RoIAlign at 14 on C4, the shared res5, the
    conv-free FCN head) on the JAX bfloat16 build's level and JAX's
    detections (every third invalid), then the losses."""
    jdet = bf16_losses(c4_run, _tiny_c4)
    net = jdet.net
    dets, _, valid, _ = c4_run["j_pred"]
    rois = dets[..., :4] * jnp.asarray(c4_run["batch"]["scale_factor"])[:, None, :]
    valid = valid & (jnp.arange(valid.shape[1]) % 3 != 0)[None]

    @_jit
    def jax_mask_out(v, images, rois, valid):
        feats = net.apply(v, images, method=TwoStageNet.features)
        pooled = j_pallas.batched_multilevel_roi_align_pallas(
            feats, rois, valid, (16,), out_size=14, interpret=True)
        pooled = pooled.reshape(-1, 14, 14, pooled.shape[-1])
        return feats, net.apply(v, pooled, method=lambda m, x: m.mask_head(m.bbox_head.res5(x)))

    feats, ref = jax_mask_out(c4_run["jv"], jnp.asarray(c4_run["batch"]["images"]), rois, valid)
    assert len(feats) == 1 and feats[0].dtype == jnp.bfloat16 and ref.shape[1] == 14
    level = torch.from_numpy(np.array(feats[0].astype(jnp.float32)))
    errs = {}
    for dtype in (BF16, torch.float32):
        det = build_detector(_tiny_c4(load_config), device="cpu", dtype=dtype)
        det.net.load_state_dict(from_jax_params(c4_run["variables"]), strict=True)
        with torch.inference_mode():
            got = det.net.mask_out([level.to(dtype)], torch.from_numpy(np.array(rois)),
                                   torch.from_numpy(np.array(valid)))
        ref_np = np.asarray(ref)
        errs[dtype] = float(np.abs(got.numpy() - ref_np).max() / np.abs(ref_np).max())
    assert errs[BF16] <= BF16_TOL, errs
    assert errs[BF16] < errs[torch.float32] or errs[BF16] == 0, errs


# --------------------------------------------------------- tiny DC5 Faster R-CNN
def _tiny_dc5(load):
    return shrink_neckless(load(config_path(DC5)).model.to_dict())


@pytest.fixture(scope="module")
def dc5_run():
    return run_fused_pair(_tiny_dc5)


def test_dc5_builds_the_dilated_stage(dc5_run):
    net = dc5_run["tdet"].net
    assert net.neck is None and net.roi_strides == (16,) and net.roi_out_size == 7
    assert net.backbone.out_channels == (64,)
    assert net.backbone.layer4_0.conv1.dilation == (2, 2)
    assert net.backbone.layer4_0.conv1.stride == (1, 1)
    assert net.backbone.layer4_1.conv2.dilation == (1, 1)  # a BasicBlock's second 3x3
    assert tuple(net.bbox_head.shared_fc_0.weight.shape) == (16, 7 * 7 * 64)


def test_dc5_predict_matches_jax(dc5_run):
    check_predict(dc5_run)


def test_dc5_losses_match_jax(dc5_run):
    check_losses(dc5_run, FASTER_LOSSES)


def test_dc5_gradients_match_jax(dc5_run):
    check_gradients(dc5_run)


@pytest.mark.parametrize("step", [0, 1])
def test_dc5_sgd_steps_match_jax(dc5_run, step):
    check_step(dc5_run, step, FASTER_LOSSES)


def test_dc5_bf16_roi_out_and_losses_match_jax_bf16(dc5_run):
    """``roi_out`` in bfloat16 (RoIAlign at 7 on the one dilated level, the
    Shared2FC head) on the JAX bfloat16 build's level and JAX's
    detections, then the losses."""
    jdet = bf16_losses(dc5_run, _tiny_dc5)
    net = jdet.net
    dets, _, valid = dc5_run["j_pred"]
    rois = dets[..., :4] * jnp.asarray(dc5_run["batch"]["scale_factor"])[:, None, :]

    @_jit
    def jax_roi_out(v, images, rois, valid):
        feats = net.apply(v, images, method=TwoStageNet.features)
        pooled = j_pallas.batched_multilevel_roi_align_pallas(
            feats, rois, valid, (16,), out_size=7, interpret=True)
        pooled = pooled.reshape(-1, 7, 7, pooled.shape[-1])
        return feats, net.apply(v, pooled, method=lambda m, x: m.bbox_head(x))

    feats, (cls, reg) = jax_roi_out(dc5_run["jv"], jnp.asarray(dc5_run["batch"]["images"]),
                                    rois, valid)
    level = torch.from_numpy(np.array(feats[0].astype(jnp.float32)))
    errs = {}
    for dtype in (BF16, torch.float32):
        det = build_detector(_tiny_dc5(load_config), device="cpu", dtype=dtype)
        det.net.load_state_dict(from_jax_params(dc5_run["variables"]), strict=True)
        with torch.inference_mode():
            got = det.net.roi_out([level.to(dtype)], torch.from_numpy(np.array(rois)),
                                  torch.from_numpy(np.array(valid)))
        errs[dtype] = max(float(np.abs(g.float().numpy() - np.asarray(r, np.float32)).max()
                                / np.abs(np.asarray(r, np.float32)).max())
                          for g, r in zip(got, (cls, reg)))
    assert errs[BF16] <= BF16_TOL, errs
    assert errs[BF16] < errs[torch.float32] or errs[BF16] == 0, errs


# ------------------------------------------------------------ full-width builds
@pytest.mark.parametrize("name", SLICE_CONFIGS)
def test_slice_config_builds(fast_init, name):
    mc = load_config(config_path(name)).model.to_dict()
    det = build_detector(mc, device="cpu")
    net = det.net
    if "c4" in name:
        assert net.backbone.out_channels == (1024,) and net.roi_strides == (16,)
        assert net.bbox_head.out_channels == 2048 and net.roi_out_size == 14
        assert net.mask_on_shared == name.startswith("mask_rcnn")
    elif "dc5" in name:
        assert net.backbone.out_channels == (2048,) and net.roi_strides == (16,)
        assert net.backbone.layer4_0.conv2.dilation == (2, 2)
        assert net.backbone.layer4_0.conv1.stride == (1, 1)
    else:
        assert type(det).__name__ == "PointRendDetector" and net.mask_roi_out_size == 14
        assert det.point_cfg.num_points == 196 and det.point_cfg.subdivision_num_points == 784
        assert net.mask_head.side == 7 and net.point_head.fc_logits.out_features == 80
    if "caffe" in name:
        assert net.backbone.layer2_0.conv1.stride == (2, 2)
    assert net.rpn.rpn_cls.weight.shape[0] == (15 if net.neck is None else 3)


# ----------------------------------------------------------------- mmdet weights
def test_mmdet_shared_head_round_trip():
    """The C4 head's seeded weights in mmdet's names (``layer4.B``, the
    shortcut as ``downsample.0`` / ``.1``) back through
    ``from_mmdet_state_dict``, equal; every key of
    ``tests/test_parity_c4.py``'s state dict maps."""
    det = build_detector(_tiny_c4(load_config), device="cpu", seed=1)
    src = {k: v for k, v in det.net.state_dict().items()
           if k.startswith(("bbox_head.", "mask_head."))}
    sd = {}
    for key, value in src.items():
        m = re.fullmatch(r"bbox_head\.res5_(\d)\.(\w+)\.(\w+)", key)
        if m:
            part = {"down_conv": "downsample.0", "down_bn": "downsample.1"}.get(m[2], m[2])
            name = f"roi_head.shared_head.layer4.{m[1]}.{part}.{m[3]}"
        else:
            name = "roi_head." + key
        sd[name] = value.clone()
    assert "roi_head.shared_head.layer4.0.downsample.1.running_var" in sd
    got = from_mmdet_state_dict(sd)
    assert set(got) == set(src)
    for k, v in src.items():
        assert torch.equal(got[k], v), k
    from test_parity_c4 import _rand_sd

    parity = from_mmdet_state_dict(_rand_sd(np.random.RandomState(0)))
    assert sum(k.startswith("bbox_head.res5_") for k in parity) == 3 * (3 + 3 * 4) + 1 + 4
    assert {"bbox_head.res5_0.down_bn.running_mean", "mask_head.upsample.weight",
            "bbox_head.fc_cls.weight"} <= set(parity)


def test_mmdet_dc5_first_fc_reorders_at_7x7x2048():
    w = torch.arange(8 * 2048 * 49, dtype=torch.float32).reshape(8, 2048 * 49)
    got = from_mmdet_state_dict({"roi_head.bbox_head.shared_fcs.0.weight": w})
    want = w.reshape(8, 2048, 7, 7).permute(0, 2, 3, 1).reshape(8, -1)
    assert torch.equal(got["bbox_head.shared_fc_0.weight"], want)


@pytest.mark.parametrize("key", ["roi_head.point_head.fcs.0.conv.weight",
                                 "roi_head.point_head.fc_logits.weight",
                                 "roi_head.mask_head.fcs.1.weight",
                                 "roi_head.mask_head.fc_logits.bias",
                                 "roi_head.mask_head.downsample_conv.conv.weight"])
def test_mmdet_point_rend_keys_raise_named(key):
    with pytest.raises(NotImplementedError, match="PointRend"):
        from_mmdet_state_dict({key: torch.zeros(2, 2)})
