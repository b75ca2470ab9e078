"""The PyTorch port's modules of the Boosting R-CNN family against the JAX
package's, on the CPU.

Random weights and inputs are made with numpy from a seed; the weights go
to the JAX package as flax variables and to the port through
``weights.from_jax_params``.  Checked, with the tolerance of each:

  * ResNeXt (depth 50, base width 4 at 16 base channels, 4 groups) and
    Res2Net with DCNv2 in stages 2-4 (depth 50, 4 scales of base width 8
    at 16 base channels; the offset convs' weights seeded and nonzero, so
    the samples move off the grid): each stage's output within 1e-5 of its
    largest value in float32; in bfloat16 against the JAX package's
    bfloat16 module (XLA's excess precision off), within 2.5% (the level
    tolerance of tests/test_torch_bf16.py) and closer than the port's
    float32 module;
  * ``deform_conv2d`` alone, v1 and v2, strides 1 and 2, one and two
    deform groups, with offsets that put samples outside the map: the
    output within 1e-5 of its largest value, the gradients of the input,
    offsets, weight and mask within 1e-5 of their largest value against
    ``jax.grad``;
  * the FPN with each ``add_extra_convs`` mode, with and without
    ``relu_before_extra_convs``: parameter names and shapes equal, every
    level within 1e-5 of its largest value;
  * ``ciou_loss`` on boxes with negative widths and heights (deltas read
    as boxes) with ``(N, 4)`` weights: the value rtol 1e-5, the gradient
    within 1e-5 of its largest value;
  * ``soft_nms_padded``, linear and gaussian, and ``multiclass_nms_padded``'s
    soft path: the survivors and their order equal, the scores within
    1e-6;
  * the ATSS RPN loss on encoded deltas (CIoU and IoU) and on decoded boxes
    with CIoU: the three losses rtol 1e-5 and their gradients within 1e-5
    of the largest.

The family's configs and weights: ``tests/test_torch_boosting_configs.py``.
"""
import functools
import os
import sys

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""  # no compile-cache writes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from boosting_rcnn_tpu.models.backbones.res2net import Res2Net as JRes2Net  # noqa: E402
from boosting_rcnn_tpu.models.backbones.resnet import ResNet as JResNet  # noqa: E402
from boosting_rcnn_tpu.models.dense_heads import atss_rpn_head as j_rpn  # noqa: E402
from boosting_rcnn_tpu.models.necks.fpn import FPN as JFPN  # noqa: E402
from boosting_rcnn_tpu.ops import deform_conv as j_dcn  # noqa: E402
from boosting_rcnn_tpu.ops import losses as j_losses  # noqa: E402
from boosting_rcnn_tpu.ops import nms as j_nms  # noqa: E402
from boosting_rcnn_tpu_torch.models.backbones.res2net import Res2Net  # noqa: E402
from boosting_rcnn_tpu_torch.models.backbones.resnet import ResNet  # noqa: E402
from boosting_rcnn_tpu_torch.models.dense_heads import atss_rpn_head as t_rpn  # noqa: E402
from boosting_rcnn_tpu_torch.models.layers import set_compute_dtype  # noqa: E402
from boosting_rcnn_tpu_torch.models.necks.fpn import FPN  # noqa: E402
from boosting_rcnn_tpu_torch.ops import deform_conv as t_dcn  # noqa: E402
from boosting_rcnn_tpu_torch.ops import losses as t_losses  # noqa: E402
from boosting_rcnn_tpu_torch.ops import nms as t_nms  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402

BF16 = torch.bfloat16
LEVEL_TOL = 0.025  # tests/test_torch_bf16.py's level tolerance
# the JAX reference rounds at every bfloat16 op, as on the TPU
_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU backward on one thread (``tests/test_torch_train.py``:
    torch's threaded CPU convolution backward was not repeatable)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_variables(shapes, rs):
    """flax variables of the given shapes: LeCun-scaled kernels (the offset
    convs' too, so that the samples move), biases and norm parameters drawn
    around their init."""
    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        shape = s.shape
        if name.endswith("['kernel']"):
            return rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        if name.endswith("['var']"):
            return rs.uniform(0.5, 1.5, shape)
        if name.endswith("['scale']"):
            return 1.0 + 0.1 * rs.randn(*shape)
        return 0.1 * rs.randn(*shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def _close(got, ref, rel=1e-5, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max(), err_msg=what)


def _rel_err(got, ref) -> float:
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _load(module, variables):
    module.load_state_dict(from_jax_params(variables), strict=True)
    return module


# ------------------------------------------------------------------ backbones
BACKBONES = {
    "resnext50_4x4d": (
        lambda dtype: JResNet(depth=50, base_channels=16, groups=4, base_width=4,
                              frozen_stages=1, dtype=dtype),
        lambda gen: ResNet(gen, depth=50, base_channels=16, groups=4, base_width=4,
                           frozen_stages=1)),
    "res2net50_dcnv2": (
        lambda dtype: JRes2Net(depth=50, base_channels=16, scales=4, base_width=8,
                               frozen_stages=1, dcn=dict(type="DCNv2", deform_groups=1),
                               stage_with_dcn=(False, True, True, True), dtype=dtype),
        lambda gen: Res2Net(gen, depth=50, base_channels=16, scales=4, base_width=8,
                            frozen_stages=1, dcn=dict(type="DCNv2", deform_groups=1),
                            stage_with_dcn=(False, True, True, True))),
}


@pytest.fixture(scope="module", params=sorted(BACKBONES))
def backbone(request):
    make_jax, make_port = BACKBONES[request.param]
    rs = np.random.RandomState(0)
    images = (rs.rand(2, 64, 96, 3) * 2.0 - 1.0).astype(np.float32)
    jmod = make_jax(jnp.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros(images.shape)))
    variables = _random_variables(shapes, rs)
    jv = jax.tree.map(jnp.asarray, variables)
    ref = {dt: _jit(lambda v, x, m=make_jax(dt): m.apply(v, x))(jv, jnp.asarray(images))
           for dt in (jnp.float32, jnp.bfloat16)}
    got = {}
    for dtype in (torch.float32, BF16):
        net = _load(make_port(torch.Generator().manual_seed(0)), variables)
        set_compute_dtype(net, dtype)
        with torch.inference_mode():
            got[dtype] = [c.permute(0, 2, 3, 1) for c in net(
                torch.from_numpy(images).permute(0, 3, 1, 2))]
    return dict(name=request.param, ref=ref, got=got, variables=variables)


def test_backbone_stages_match_jax_in_float32(backbone):
    ref, got = backbone["ref"][jnp.float32], backbone["got"][torch.float32]
    assert len(got) == len(ref) == 4
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, 1e-5, f"{backbone['name']} C{i + 2}")
    if backbone["name"].startswith("res2net"):
        offsets = [v for k, v in from_jax_params(backbone["variables"]).items()
                   if "conv_offset.weight" in k]
        assert len(offsets) == 13 * 3 and all(v.abs().max() > 0 for v in offsets)


def test_backbone_stages_match_jax_in_bfloat16(backbone):
    ref = backbone["ref"][jnp.bfloat16]
    for i, r in enumerate(ref):
        assert r.dtype == jnp.bfloat16
        errs = {d: _rel_err(backbone["got"][d][i], r) for d in (BF16, torch.float32)}
        assert backbone["got"][BF16][i].dtype == BF16
        assert errs[BF16] <= LEVEL_TOL, (i, errs)
        assert errs[BF16] < errs[torch.float32] or errs[BF16] == 0, (i, errs)


def test_backbone_frozen_stages():
    for _, make_port in BACKBONES.values():
        net = make_port(torch.Generator().manual_seed(0))
        frozen = {n for n, p in net.named_parameters() if not p.requires_grad}
        assert frozen and all(n.startswith(("conv1.", "bn1.", "stem_", "layer1_")) for n in frozen)
        assert all(p.requires_grad for n, p in net.named_parameters() if n.startswith("layer2_"))


# -------------------------------------------------------------- deform_conv2d
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("deform_groups", [1, 2])
@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
def test_deform_conv2d_matches_jax(stride, deform_groups, modulated):
    rs = np.random.RandomState(stride * 10 + deform_groups * 2 + modulated)
    b, c, h, w, cout = 2, 8, 9, 11, 6
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rs.randn(b, h, w, c).astype(np.float32)
    offset = (rs.randn(b, ho, wo, deform_groups * 18) * 3.0).astype(np.float32)
    mask = rs.rand(b, ho, wo, deform_groups * 9).astype(np.float32) if modulated else None
    weight = (rs.randn(3, 3, c, cout) / np.sqrt(9 * c)).astype(np.float32)
    cot = rs.randn(b, ho, wo, cout).astype(np.float32)
    # samples outside the map: the offsets move some taps past the padding
    rows = np.arange(ho)[:, None] * stride - 1 + offset[..., 0::2].max()
    assert rows.max() > h and (np.arange(ho) * stride - 1 + offset[..., 0::2].min()).min() < -1

    def jax_fn(x, offset, weight, mask):
        out = j_dcn.deform_conv2d(x, offset, weight, mask=mask, stride=stride,
                                  deform_groups=deform_groups)
        return jnp.sum(out * cot), out

    args = [jnp.asarray(a) for a in (x, offset, weight)] + [
        None if mask is None else jnp.asarray(mask)]
    argnums = (0, 1, 2, 3) if modulated else (0, 1, 2)
    (_, ref), grads = jax.value_and_grad(jax_fn, argnums=argnums, has_aux=True)(*args)

    nchw = [torch.from_numpy(a).permute(0, 3, 1, 2).requires_grad_() for a in (x, offset)]
    wt = torch.from_numpy(weight).permute(3, 2, 0, 1).contiguous().requires_grad_()
    mt = (torch.from_numpy(mask).permute(0, 3, 1, 2).requires_grad_() if modulated else None)
    got = t_dcn.deform_conv2d(nchw[0], nchw[1], wt, mask=mt, stride=stride,
                              deform_groups=deform_groups)
    (got * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    _close(got.permute(0, 2, 3, 1), ref, 1e-5, "output")
    _close(nchw[0].grad.permute(0, 2, 3, 1), grads[0], 1e-5, "d input")
    _close(nchw[1].grad.permute(0, 2, 3, 1), grads[1], 1e-5, "d offset")
    _close(wt.grad.permute(2, 3, 1, 0), grads[2], 1e-5, "d weight")
    if modulated:
        _close(mt.grad.permute(0, 2, 3, 1), grads[3], 1e-5, "d mask")


def test_deform_conv2d_bfloat16_matches_jax():
    """bfloat16: the grid, positions and bilinear weights in bfloat16 op by
    op, the contraction in float32 rounded once; on a 300-wide map, where
    the bfloat16 grid itself rounds."""
    rs = np.random.RandomState(5)
    x = rs.randn(1, 6, 300, 4).astype(np.float32)
    offset = (rs.randn(1, 6, 300, 18) * 2.0).astype(np.float32)
    mask = rs.rand(1, 6, 300, 9).astype(np.float32)
    weight = (rs.randn(3, 3, 4, 5) / 6.0).astype(np.float32)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, offset, weight, mask)]
    ref = _jit(lambda a, o, w, m: j_dcn.deform_conv2d(a, o, w, mask=m))(*bf)
    assert ref.dtype == jnp.bfloat16
    errs = {}
    for dtype in (BF16, torch.float32):
        t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype) for a in bf]
        got = t_dcn.deform_conv2d(t[0].permute(0, 3, 1, 2), t[1].permute(0, 3, 1, 2),
                                  t[2].permute(3, 2, 0, 1), mask=t[3].permute(0, 3, 1, 2))
        assert got.dtype == dtype
        errs[dtype] = _rel_err(got.permute(0, 2, 3, 1), ref)
    assert errs[BF16] <= LEVEL_TOL and (errs[BF16] < errs[torch.float32] or errs[BF16] == 0), errs


# ------------------------------------------------------------------------ FPN
@pytest.mark.parametrize("extra,relu", [(False, False), ("on_input", False), (True, True),
                                        ("on_lateral", True), ("on_output", False),
                                        ("on_output", True)])
def test_fpn_extra_levels_match_jax(extra, relu):
    rs = np.random.RandomState(3)
    chans = (8, 16, 32, 64)
    inputs = [rs.randn(2, 32 // 2 ** i, 40 // 2 ** i, c).astype(np.float32)
              for i, c in enumerate(chans)]
    kw = dict(out_channels=16, num_outs=5, start_level=1, add_extra_convs=extra,
              relu_before_extra_convs=relu)
    jmod = JFPN(in_channels=chans, **kw)
    j_in = tuple(jnp.asarray(a) for a in inputs)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), j_in))
    variables = _random_variables(shapes, rs)
    ref = jax.jit(jmod.apply)(jax.tree.map(jnp.asarray, variables), j_in)
    net = _load(FPN(torch.Generator().manual_seed(0), in_channels=chans, **kw), variables)
    if extra in ("on_input", True):
        assert net.fpn_conv_3.conv.weight.shape[1] == chans[-1]
    with torch.inference_mode():
        got = net([torch.from_numpy(a).permute(0, 3, 1, 2) for a in inputs])
    assert len(got) == len(ref) == 5
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g.permute(0, 2, 3, 1), r, 1e-5, f"P{i + 3}")


# ----------------------------------------------------------------------- CIoU
def test_ciou_loss_and_gradient_match_jax():
    rs = np.random.RandomState(4)
    n = 64
    # deltas read as boxes: widths and heights of either sign
    pred = rs.randn(n, 4).astype(np.float32)
    target = rs.randn(n, 4).astype(np.float32)
    target[:8] = pred[:8] + 0.01 * rs.randn(8, 4)  # near-equal pairs
    weight = np.repeat(rs.rand(n, 1), 4, 1).astype(np.float32)
    assert (pred[:, 2] < pred[:, 0]).any() and (pred[:, 3] < pred[:, 1]).any()

    def jax_fn(p):
        return j_losses.ciou_loss(p, jnp.asarray(target), weight=jnp.asarray(weight),
                                  avg_factor=7.0)

    ref, ref_g = jax.value_and_grad(jax_fn)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = t_losses.ciou_loss(p, torch.from_numpy(target), weight=torch.from_numpy(weight),
                             avg_factor=7.0)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    _close(p.grad, ref_g, 1e-5, "d pred")
    none = t_losses.ciou_loss(torch.from_numpy(pred), torch.from_numpy(target),
                              reduction="none")
    _close(none, j_losses.ciou_loss(jnp.asarray(pred), jnp.asarray(target), reduction="none"),
           1e-5, "elementwise")


# ------------------------------------------------------------------- soft-NMS
def _clustered_boxes(rs, n, clusters=12):
    centres = rs.uniform(20, 300, (clusters, 2))
    c = centres[rs.randint(0, clusters, n)] + rs.randn(n, 2) * 6.0
    wh = rs.uniform(10, 60, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)


@pytest.mark.parametrize("method", ["linear", "gaussian"])
def test_soft_nms_matches_jax(method):
    rs = np.random.RandomState(6)
    n = 300
    boxes = _clustered_boxes(rs, n)
    scores = rs.rand(n).astype(np.float32)
    scores[5] = scores[9]  # a tie: the first index wins in both
    valid = rs.rand(n) > 0.1
    kw = dict(iou_threshold=0.3, sigma=0.5, min_score=0.2, method=method)
    ref = j_nms.soft_nms_padded(jnp.asarray(boxes), jnp.asarray(scores), 250,
                                valid=jnp.asarray(valid), **kw)
    got = t_nms.soft_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores), 250,
                                valid=torch.from_numpy(valid), **kw)
    ov = np.asarray(ref[2])
    assert 20 < ov.sum() < 250
    np.testing.assert_array_equal(got[2].numpy(), ov)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[1].numpy()[ov], np.asarray(ref[1])[ov], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[0].numpy()[ov], np.asarray(ref[0])[ov])
    kept = got[1].numpy()[ov]
    assert (kept <= scores[got[3].numpy()[ov]]).all()


@pytest.mark.parametrize("method", ["linear", "gaussian"])
def test_multiclass_soft_nms_matches_jax(method):
    rs = np.random.RandomState(7)
    n, c = 200, 4
    boxes = np.stack([_clustered_boxes(rs, n) for _ in range(c)], 1)
    scores = (rs.rand(n, c) ** 3).astype(np.float32)
    valid = rs.rand(n) > 0.2
    kw = dict(score_thr=0.01, iou_threshold=0.7, max_per_img=100, nms_type="soft_nms",
              soft_min_score=0.0, soft_method=method)
    ref = j_nms.multiclass_nms_padded(jnp.asarray(boxes), jnp.asarray(scores),
                                      valid=jnp.asarray(valid), **kw)
    got = t_nms.multiclass_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                                      valid=torch.from_numpy(valid), **kw)
    ov = np.asarray(ref[2])
    assert ov.sum() == 100
    np.testing.assert_array_equal(got[2].numpy(), ov)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy()[:, :4], np.asarray(ref[0])[:, :4])
    np.testing.assert_allclose(got[0].numpy()[:, 4], np.asarray(ref[0])[:, 4], rtol=0, atol=1e-6)
    kept = got[0][:, 4].numpy()[ov]
    assert (np.diff(kept) <= 0).all()


# ------------------------------------------------------------------- RPN loss
@pytest.mark.parametrize("decoded,box", [(False, "ciou"), (False, "iou"), (True, "ciou")])
def test_atss_rpn_loss_branches_match_jax(decoded, box):
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
    cls = rs.randn(b, a).astype(np.float32)
    reg = (rs.randn(b, a, 4) * 0.3).astype(np.float32)
    iou = rs.randn(b, a).astype(np.float32)
    valid = np.ones((b, a), bool)
    kw = dict(gamma=2.0, reg_decoded_bbox=decoded, loss_bbox_type=box, aug_loss_weight=2.0,
              target_stds=(0.1, 0.1, 0.2, 0.2) if not decoded else (1.0,) * 4)
    jcfg = j_rpn.ATSSRPNCfg(**kw)
    tcfg = t_rpn.ATSSRPNCfg(**kw)
    names = ("loss_rpn_cls", "loss_rpn_bbox", "loss_rpn_iou")

    def jax_fn(c, r, i):
        losses = j_rpn.atss_rpn_loss(jcfg, c, r, i, jnp.asarray(anchors), jnp.asarray(valid),
                                     jnp.asarray(gts), jnp.asarray(gt_mask))
        return sum(losses.values()), losses

    (_, ref), ref_g = jax.value_and_grad(jax_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(iou))
    inputs = [torch.from_numpy(x).requires_grad_() for x in (cls, reg, iou)]
    got = t_rpn.atss_rpn_loss(tcfg, *inputs, torch.from_numpy(anchors), torch.from_numpy(valid),
                              torch.from_numpy(gts), torch.from_numpy(gt_mask))
    sum(got.values()).backward()
    for k in names:
        assert float(ref[k]) > 0, k
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-5, err_msg=k)
    for x, r, what in zip(inputs, ref_g, ("cls", "reg", "iou")):
        _close(x.grad, r, 1e-5, f"d {what}")
