"""The PyTorch port's Mask R-CNN modules against the JAX package's, on the CPU.

Each module of Mask R-CNN at a small size (widths 8-64, a few RoIs),
with inputs and flax parameters made from seeds with numpy; the
flax parameters reach the port through ``weights.from_jax_params``.
Checked against the JAX functions:

  * ``FPN`` (lateral 1x1 convs, nearest top-down merge, 3x3 output convs,
    the max-pool extra level): each level within 1e-5 of its largest value;
  * ``RPNConvs``: the cls and reg maps within 1e-5 of their largest values;
  * ``rpn_proposals``: the survivor set and its order equal, boxes within
    1e-4 px, scores within 1e-6;
  * ``rpn_loss`` fed the uniforms that the JAX sampler draws from the same
    key: both losses rtol 1e-4, their gradients within 1e-4 of the largest;
  * ``FCNMaskHead``, whose transposed conv maps to PyTorch with its taps
    flipped: logits within 1e-5 of the largest (unflipped they are not);
  * ``resample_mask_targets``: equal;
  * ``mask_loss`` and its gradient: rtol 1e-4;
  * the port's plain RoIAlign at 14 x 14 (the mask branch's) against the
    Pallas kernels in interpret mode, batched (K1, K4) and per image (K2,
    K3): float32 within 1e-5 (of the largest value for the gradient),
    bfloat16 bit for bit.
"""
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

from boosting_rcnn_tpu.models.dense_heads import rpn_head as j_rpn  # noqa: E402
from boosting_rcnn_tpu.models.necks.fpn import FPN as JaxFPN  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads import mask_head as j_mask  # noqa: E402
from boosting_rcnn_tpu.ops import anchors as j_anchors  # noqa: E402
from boosting_rcnn_tpu.ops import pallas_roi_align as j_pallas  # noqa: E402
from boosting_rcnn_tpu_torch.models.dense_heads import rpn_head as t_rpn  # noqa: E402
from boosting_rcnn_tpu_torch.models.dense_heads.atss_rpn_head import (  # noqa: E402
    flatten_levels,
)
from boosting_rcnn_tpu_torch.models.necks.fpn import FPN  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads import mask_head as t_mask  # noqa: E402
from boosting_rcnn_tpu_torch.ops import roi_align as t_roi  # noqa: E402
from boosting_rcnn_tpu_torch.ops.roi_align_kernel import (  # noqa: E402
    multilevel_roi_align,
    roi_align_bwd_plain,
)
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402

BF16 = torch.bfloat16
CANVAS = (96, 128)
STRIDES = (4, 8, 16, 32, 64)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))
    return t if dtype is None else t.to(dtype)


def _params(module, rs, *inputs):
    """flax parameters of ``module`` for ``inputs``: shapes by
    ``jax.eval_shape``, values from ``rs`` (LeCun-scaled kernels, biases
    around 0.1)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs))

    def leaf(path, s):
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            return rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return 0.1 * rs.randn(*s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def _load(module, variables):
    module.load_state_dict(from_jax_params(variables), strict=True)
    return module


def _close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


# ------------------------------------------------------------ FPN, RPN head


def test_fpn_matches_jax():
    rs = np.random.RandomState(0)
    chans = [8, 16, 32, 64]
    inputs = tuple(rs.randn(2, -(-CANVAS[0] // s), -(-CANVAS[1] // s), c).astype(np.float32)
                   for s, c in zip(STRIDES, chans))
    jfpn = JaxFPN(in_channels=chans, out_channels=32, num_outs=5)
    variables = _params(jfpn, rs, inputs)
    ref = jfpn.apply(variables, tuple(map(jnp.asarray, inputs)))
    fpn = _load(FPN(torch.Generator(), chans, 32, 5), variables)
    with torch.no_grad():
        got = fpn([_nchw(x) for x in inputs])
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert tuple(g.permute(0, 2, 3, 1).shape) == r.shape
        _close(g.permute(0, 2, 3, 1).numpy(), r, 1e-5)


@pytest.fixture(scope="module")
def rpn_case():
    """A pyramid, the RPN head's parameters and maps in both packages, the
    anchors of the canvas and two images' gt boxes."""
    rs = np.random.RandomState(1)
    feats = tuple(rs.randn(2, -(-CANVAS[0] // s), -(-CANVAS[1] // s), 32).astype(np.float32)
                  for s in STRIDES)
    jconv = j_rpn.RPNConvs(num_anchors=3, feat_channels=32)
    variables = _params(jconv, rs, feats)
    j_cls, j_reg, _ = jconv.apply(variables, tuple(map(jnp.asarray, feats)))
    conv = _load(t_rpn.RPNConvs(torch.Generator(), 32, 3, 32), variables)
    ag = j_anchors.AnchorGenerator(strides=list(STRIDES), ratios=[0.5, 1.0, 2.0], scales=[8])
    sizes = [f.shape[1:3] for f in feats]
    anchors = np.asarray(ag.flat_anchors(sizes))
    nla = tuple(a.shape[0] for a in ag.grid_anchors(sizes))
    gts = np.array([[[10, 8, 60, 70], [40, 30, 120, 90], [0, 0, 0, 0]],
                    [[5, 20, 45, 60], [30, 10, 110, 80], [70, 40, 126, 94]]], np.float32)
    gt_mask = np.array([[True, True, False], [True, True, True]])
    return dict(feats=feats, j_maps=(j_cls, j_reg), conv=conv, anchors=anchors, nla=nla,
                gts=gts, gt_mask=gt_mask)


def test_rpn_convs_match_jax(rpn_case):
    with torch.no_grad():
        cls, reg, iou = rpn_case["conv"]([_nchw(f) for f in rpn_case["feats"]])
    assert iou is None
    for got, ref in zip(cls + reg, rpn_case["j_maps"][0] + rpn_case["j_maps"][1]):
        assert got.dtype == torch.float32
        _close(got.permute(0, 2, 3, 1).numpy(), ref, 1e-5)


def _flat_maps(rpn_case):
    j_cls, j_reg = rpn_case["j_maps"]
    cls = np.concatenate([np.asarray(c).reshape(2, -1) for c in j_cls], 1)
    reg = np.concatenate([np.asarray(r).reshape(2, -1, 4) for r in j_reg], 1)
    return cls, reg


def test_flatten_levels_matches_jax_order(rpn_case):
    """The port's level flattening of its NCHW maps gives the JAX package's
    flat (H, W, A) order."""
    with torch.no_grad():
        cls, reg, _ = rpn_case["conv"]([_nchw(f) for f in rpn_case["feats"]])
    ref_cls, ref_reg = _flat_maps(rpn_case)
    _close(flatten_levels(cls, 1)[..., 0].numpy(), ref_cls, 1e-5)
    _close(flatten_levels(reg, 4).numpy(), ref_reg, 1e-5)


@pytest.mark.parametrize("nms_pre,max_per_img,min_size", [(60, 40, 0.0), (200, 100, 4.0)])
def test_rpn_proposals_match_jax(rpn_case, nms_pre, max_per_img, min_size):
    cls, reg = _flat_maps(rpn_case)
    img_shape = np.array([[96.0, 120.0], [90.0, 128.0]], np.float32)
    cfg_j, cfg_t = j_rpn.RPNCfg(), t_rpn.RPNCfg()
    kw = dict(nms_pre=nms_pre, max_per_img=max_per_img, nms_iou_thr=0.7,
              min_bbox_size=min_size)
    ref = jax.vmap(lambda c, r, s: j_rpn.rpn_proposals(
        cfg_j, c, r, jnp.asarray(rpn_case["anchors"]), rpn_case["nla"], s, **kw))(
            jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(img_shape))
    got = t_rpn.rpn_proposals(cfg_t, torch.from_numpy(cls), torch.from_numpy(reg),
                              torch.from_numpy(rpn_case["anchors"]), rpn_case["nla"],
                              torch.from_numpy(img_shape), **kw)
    (jb, js, jv), (tb, ts, tv) = [np.asarray(x) for x in ref], [x.numpy() for x in got]
    np.testing.assert_array_equal(tv, jv)
    assert jv.sum() > 10
    np.testing.assert_allclose(tb[tv], jb[jv], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)


def _jax_rpn_uniforms(rng, b, a):
    """What JAX's ``rpn_loss`` samples with: per image, the uniforms of the
    two halves of its key (``random_sample``)."""
    out = []
    for key in jax.random.split(rng, b):
        kp, kn = jax.random.split(key)
        out.append([np.asarray(jax.random.uniform(k, (a,))) for k in (kp, kn)])
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("seed", [3, 4])
def test_rpn_loss_with_jax_uniforms(rpn_case, seed):
    cls, reg = _flat_maps(rpn_case)
    anchors, gts, gt_mask = rpn_case["anchors"], rpn_case["gts"], rpn_case["gt_mask"]
    valid = np.ones(cls.shape, bool)
    rng = jax.random.PRNGKey(seed)
    cfg_j = j_rpn.RPNCfg(num_samples=64)

    def j_loss(c, r):
        out = j_rpn.rpn_loss(cfg_j, c, r, jnp.asarray(anchors), jnp.asarray(valid),
                             jnp.asarray(gts), jnp.asarray(gt_mask), rng=rng)
        return out["loss_rpn_cls"] + out["loss_rpn_bbox"], out

    (_, ref), (g_cls, g_reg) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(cls), jnp.asarray(reg))
    c_t = torch.from_numpy(cls).requires_grad_()
    r_t = torch.from_numpy(reg).requires_grad_()
    got = t_rpn.rpn_loss(t_rpn.RPNCfg(num_samples=64), c_t, r_t, torch.from_numpy(anchors),
                         torch.from_numpy(valid), torch.from_numpy(gts),
                         torch.from_numpy(gt_mask),
                         uniforms=torch.from_numpy(_jax_rpn_uniforms(rng, 2, cls.shape[1])))
    assert set(got) == set(ref) == {"loss_rpn_cls", "loss_rpn_bbox"}
    for k in got:
        assert float(ref[k]) > 0
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-4, err_msg=k)
    (got["loss_rpn_cls"] + got["loss_rpn_bbox"]).backward()
    _close(c_t.grad.numpy(), g_cls, 1e-4)
    _close(r_t.grad.numpy(), g_reg, 1e-4)


def test_rpn_targets_draw_from_generator(rpn_case):
    """Without uniforms the anchor sampler draws from the generator: the
    same seed gives the same targets, 64 sampled anchors per image, at
    most half of them positive."""
    anchors = torch.from_numpy(rpn_case["anchors"])
    valid = torch.ones(anchors.shape[0], dtype=torch.bool)
    gts, gt_mask = (torch.from_numpy(rpn_case[k][1]) for k in ("gts", "gt_mask"))
    cfg = t_rpn.RPNCfg(num_samples=64)
    a, b = (t_rpn.rpn_targets(cfg, anchors, valid, gts, gt_mask,
                              generator=torch.Generator().manual_seed(9)) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    pos, weight, box_t = a
    assert int(weight.sum()) == 64 and 0 < int(pos.sum()) <= 32
    assert not box_t[~pos].any() and box_t[pos].abs().sum() > 0


# -------------------------------------------------------------- mask head


@pytest.fixture(scope="module")
def mask_case():
    rs = np.random.RandomState(5)
    pooled = rs.randn(6, 14, 14, 32).astype(np.float32)
    jhead = j_mask.FCNMaskHead(num_classes=4, num_convs=2, conv_channels=16)
    variables = _params(jhead, rs, pooled)
    ref = jhead.apply(variables, jnp.asarray(pooled))
    head = _load(t_mask.FCNMaskHead(torch.Generator(), 4, 32, 2, 16), variables)
    return pooled, variables, ref, head


def test_fcn_mask_head_matches_jax(mask_case):
    pooled, _, ref, head = mask_case
    with torch.no_grad():
        got = head(torch.from_numpy(pooled))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (6, 28, 28, 4)
    _close(got.numpy(), ref, 1e-5)


def test_conv_transpose_needs_the_flipped_taps(mask_case):
    """flax's transposed conv against PyTorch's: equal with the kernel's
    taps flipped (``weights.py``), not without."""
    pooled, variables, ref, head = mask_case
    kernel = variables["params"]["upsample"]["kernel"]
    flipped = torch.from_numpy(np.ascontiguousarray(kernel[::-1, ::-1].transpose(2, 3, 0, 1)))
    assert torch.equal(head.upsample.weight, flipped)
    with torch.no_grad():
        head.upsample.weight.copy_(torch.from_numpy(kernel.transpose(2, 3, 0, 1)))
        unflipped = head(torch.from_numpy(pooled))
        head.upsample.weight.copy_(flipped)
    assert np.abs(unflipped.numpy() - np.asarray(ref)).max() > 1e-2 * np.abs(ref).max()


def _mask_targets_case(rs, r=40, g=5, s=28):
    crops = (rs.rand(g, s, s) > 0.5).astype(np.uint8)
    xy = rs.uniform(0, 150, (g, 2))
    gt = np.concatenate([xy, xy + rs.uniform(4, 90, (g, 2))], -1).astype(np.float32)
    gt[-1, 2:] = gt[-1, :2]  # a degenerate gt box
    idx = rs.randint(0, g, r)
    jitter = rs.uniform(-15, 15, (r, 4)).astype(np.float32)
    rois = gt[idx] + jitter
    rois[:, 2:] = np.maximum(rois[:, 2:], rois[:, :2] + 1.0)
    return crops, gt, rois, idx


@pytest.mark.parametrize("out_size", [28, 14])
def test_resample_mask_targets_match_jax(out_size):
    crops, gt, rois, idx = _mask_targets_case(np.random.RandomState(6))
    ref = np.asarray(j_mask.resample_mask_targets(
        jnp.asarray(crops), jnp.asarray(gt), jnp.asarray(rois), jnp.asarray(idx),
        out_size=out_size))
    got = t_mask.resample_mask_targets(torch.from_numpy(crops), torch.from_numpy(gt),
                                       torch.from_numpy(rois), torch.from_numpy(idx),
                                       out_size=out_size)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    assert 0 < ref.mean() < 1
    np.testing.assert_array_equal(got.numpy(), ref)


def test_mask_loss_and_gradient_match_jax():
    rs = np.random.RandomState(7)
    logits = (rs.randn(12, 28, 28, 4) * 3).astype(np.float32)
    targets = (rs.rand(12, 28, 28) > 0.5).astype(np.float32)
    labels = rs.randint(0, 4, 12)
    labels[3] = -1  # off the positives: clamped, weighted out
    pos = rs.rand(12) > 0.4
    pos[3] = False
    ref, g_ref = jax.value_and_grad(lambda x: j_mask.mask_loss(
        x, jnp.asarray(targets), jnp.asarray(labels), jnp.asarray(pos)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = t_mask.mask_loss(x, torch.from_numpy(targets), torch.from_numpy(labels),
                           torch.from_numpy(pos))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(g_ref)).max())
    assert not x.grad[3].any() and not x.grad[~torch.from_numpy(pos)].any()


# ------------------------------------------------------- RoIAlign at 14


def _roi_case(seed, b=2):
    """C = 128, a small 3-level pyramid, 6 RoIs an image of which the last
    is invalid and one routes to the coarsest level."""
    rs = np.random.RandomState(seed)
    feats = [rs.randn(b, h, w, 128).astype(np.float32) for h, w in [(24, 32), (12, 16), (6, 8)]]
    cx, cy = rs.uniform(12, 230, (b, 6)), rs.uniform(12, 170, (b, 6))
    bw, bh = rs.uniform(8, 180, (b, 6)), rs.uniform(8, 150, (b, 6))
    rois = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1).astype(np.float32)
    rois[:, 0] = [2.0, 4.0, 300.0, 200.0]
    valid = np.ones((b, 6), bool)
    valid[:, -1] = False
    g = rs.randn(b, 6, 14, 14, 128).astype(np.float32)
    g[~valid] = 1e3  # the invalid RoIs' cotangent adds nothing
    return feats, rois, valid, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_roi_align_14_matches_pallas_interpret(dtype):
    """The batched forward (K1, ``_kernel_flat``) and gradient (K4,
    ``_bwd_kernel``) at out_size 14."""
    feats, rois, valid, g = _roi_case(40)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jf = tuple(jnp.asarray(f, jdt) for f in feats)
    jg = jnp.asarray(g, jdt)
    strides = (8, 16, 32)
    ref = j_pallas.batched_multilevel_roi_align_pallas(
        jf, jnp.asarray(rois), jnp.asarray(valid), strides, out_size=14, interpret=True)
    d_ref = j_pallas.batched_multilevel_roi_align_pallas_bwd(
        jf, jnp.asarray(rois), jnp.asarray(valid), jg, strides, out_size=14, interpret=True)
    tdt = torch.float32 if dtype == "float32" else BF16
    tf = [_t(f, tdt) for f in jf]
    got = t_roi.multilevel_roi_align_fast(tf, torch.from_numpy(rois), torch.from_numpy(valid),
                                          strides, out_size=14)
    d_got = roi_align_bwd_plain(_t(jg, tdt).reshape(12, 14, 14, 128), tf,
                                torch.from_numpy(rois), torch.from_numpy(valid), strides)
    assert got.dtype == tdt and tuple(got.shape) == (2, 6, 14, 14, 128)
    assert all(float(jnp.abs(d.astype(jnp.float32)).max()) > 0 for d in d_ref)
    if dtype == "float32":
        _close(got.numpy(), ref, 1e-5)
        for a, r in zip(d_got, d_ref):
            _close(a.numpy(), r, 1e-5)
    else:
        assert torch.equal(got, _t(ref, BF16))
        for a, r in zip(d_got, d_ref):
            assert a.dtype == BF16 and torch.equal(a, _t(r, BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_image_entry_14_matches_pallas_interpret(dtype):
    """The per-image entry at out_size 14 (its plain version on CPU
    tensors) against the TPU's per-image forward ``_kernel`` (K2) and
    gradient ``_bwd_kernel`` (K3) in interpret mode."""
    feats, rois, valid, g = _roi_case(41, b=1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else BF16
    jf = tuple(jnp.asarray(f[0], jdt) for f in feats)
    strides = (8, 16, 32)
    ref, vjp = jax.vjp(lambda f: j_pallas.multilevel_roi_align_pallas_trainable(
        f, jnp.asarray(rois[0]), jnp.asarray(valid[0]), strides, out_size=14, interpret=True),
        jf)
    (d_ref,) = vjp(jnp.asarray(g[0], jdt))
    levels = [_t(f, tdt).requires_grad_() for f in jf]
    got = multilevel_roi_align(levels, torch.from_numpy(rois[0]), torch.from_numpy(valid[0]),
                               strides, out_size=14)
    got.backward(_t(jnp.asarray(g[0], jdt), tdt))
    assert tuple(got.shape) == (6, 14, 14, 128)
    if dtype == "float32":
        _close(got.detach().numpy(), ref, 1e-5)
        for lv, d in zip(levels, d_ref):
            _close(lv.grad.numpy(), d, 1e-5)
    else:
        assert torch.equal(got.detach(), _t(ref, BF16))
        for lv, d in zip(levels, d_ref):
            assert torch.equal(lv.grad, _t(d, BF16))
    assert multilevel_roi_align.batched.launches == 0


def test_kernel_wrappers_pool_to_7_and_14_only():
    """The wrappers select an entry point by the pooled size, 7 or 14, and
    raise for any other, before anything is built or launched; each entry
    point has its own launch count."""
    from boosting_rcnn_tpu_torch.ops import roi_align_kernel as kern

    fn = kern.RoIAlignForward()
    levels = [torch.zeros((1, 8, 8, 8))]
    with pytest.raises(ValueError, match="7 or 14"):
        fn.launch(levels, torch.zeros((2, 4)), torch.ones(2, dtype=torch.uint8), (8,),
                  out_size=9)
    with pytest.raises(ValueError, match="7 or 14"):
        kern._check_out_size(28)
    assert [kern._check_out_size(k) for k in kern.OUT_SIZES] == ["", "_o14"]
    assert kern.GEOM_BYTES == {7: 1488, 14: 2944}
    names = {kern._count_name(dt, k) for dt in kern.KERNEL_DTYPES for k in kern.OUT_SIZES}
    assert names == {"launches", "bf16_launches", "o14_launches", "bf16_o14_launches"}
    assert all(getattr(fn, n) == 0 and getattr(fn.backward, n) == 0 for n in names)
    assert (fn.backward.tile_launches, fn.backward.o14_tile_launches) == (0, 0)
    # on CPU tensors the wrapper is the plain version at either size
    feats, rois, valid, _ = _roi_case(42)
    tf = [torch.from_numpy(f) for f in feats]
    got = fn(tf, torch.from_numpy(rois), torch.from_numpy(valid), (8, 16, 32), out_size=14)
    ref = t_roi.multilevel_roi_align_fast(tf, torch.from_numpy(rois), torch.from_numpy(valid),
                                          (8, 16, 32), out_size=14)
    assert torch.equal(got, ref) and fn.o14_launches == 0


def test_optimizer_without_clip_matches_jax_chain():
    """Mask R-CNN's ``optimizer_config`` has ``grad_clip=None``: the port's
    optimizer with ``grad_clip_norm=None`` against the JAX chain without
    the clip stage, two steps at a gradient norm far above 35."""
    from boosting_rcnn_tpu.engine import train as j_train
    from boosting_rcnn_tpu_torch.engine import train as t_train

    rs = np.random.RandomState(19)
    shapes = {"layer2_0": (3, 3, 4, 8), "neck": (8,), "mask_head": (16, 5)}
    params = {k: (rs.randn(*v) * 0.1).astype(np.float32) for k, v in shapes.items()}
    tx = j_train.make_optimizer(lambda step: 0.01, grad_clip_norm=None)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = t_train.make_optimizer(tparams.values(), lambda step: 0.01, grad_clip_norm=None)
    for _ in range(2):
        grads = {k: (rs.randn(*v) * 50).astype(np.float32) for k, v in shapes.items()}
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        assert float(opt.step()) > 35.0
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(jp[k])).max(), err_msg=k)


# ---------------------------------------------------------------- builder

MASK_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py")


def _mask_cfg(tiny=True):
    from boosting_rcnn_tpu_torch.config import load_config

    mc = load_config(MASK_CONFIG).model.to_dict()
    if tiny:
        mc["backbone"].update(depth=18, base_channels=8)
        mc["neck"].update(in_channels=[8, 16, 32, 64], out_channels=32)
        mc["rpn_head"].update(in_channels=32, feat_channels=32)
        mc["roi_head"]["bbox_head"].update(in_channels=32, fc_out_channels=16, num_classes=4)
        mc["roi_head"]["mask_head"].update(in_channels=32, conv_out_channels=16, num_classes=4)
    return mc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_builder_builds_full_width_mask_rcnn(dtype, monkeypatch):
    """The config at full width: R50, FPN 256, RPN 256 with 3 anchors,
    Shared2FC 1024, 80 classes, a 4 x 256 conv mask head with its 2x
    transposed conv, RoIAlign 7 (box) and 14 (mask) over the 4 route
    levels; the plain RPN's and StandardRoIHead's train configs; on the
    GPU unless ``device='cpu'`` (none here: it raises)."""
    from boosting_rcnn_tpu_torch.builder import build_detector

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_detector(_mask_cfg(tiny=False), dtype=dtype)
    det = build_detector(_mask_cfg(tiny=False), device="cpu", dtype=dtype)
    net = det.net
    assert (det.rpn_type, type(net.neck).__name__, net.roi_strides) == ("rpn", "FPN",
                                                                         (4, 8, 16, 32))
    assert (net.roi_out_size, net.mask_roi_out_size) == (7, 14)
    assert tuple(net.rpn.rpn_cls.weight.shape) == (3, 256, 1, 1)
    assert tuple(net.bbox_head.fc_cls.weight.shape) == (81, 1024)
    head = net.mask_head
    assert (head.num_convs, tuple(head.upsample.weight.shape),
            tuple(head.conv_logits.weight.shape)) == (4, (256, 256, 2, 2), (80, 256, 1, 1))
    assert head.upsample.compute_dtype == dtype
    assert 44e6 < sum(p.numel() for p in net.parameters()) < 45e6
    r, roi = det.rpn_cfg, det.roi_cfg
    assert (r.pos_iou_thr, r.neg_iou_thr, r.num_samples, r.pos_fraction) == (0.7, 0.3, 256, 0.5)
    assert abs(r.smooth_l1_beta - 1 / 9) < 1e-12
    assert (roi.boost, roi.prob, roi.num_samples, roi.match_low_quality) == (False, False, 512,
                                                                             True)
    assert (det.train_proposal_cfg.nms_pre, det.train_proposal_cfg.max_per_img) == (2000, 1000)
    assert (det.test_proposal_cfg.nms_pre, det.test_proposal_cfg.max_per_img) == (1000, 1000)


@pytest.mark.parametrize("path,value", [
    ("neck.act", "relu"),
    # ConvWS and GN are ported; DCN and LN are not
    ("neck.conv_cfg", {"type": "DCN"}),
    ("neck.norm_cfg", {"type": "LN"}),
    ("rpn_head.loss_cls.type", "VarifocalLoss"),
    ("rpn_head.loss_bbox.type", "GIoULoss"),
    ("train_cfg.rpn.sampler.add_gt_as_proposals", True),
    ("roi_head.mask_head.type", "HTCMaskHead"),
    ("roi_head.mask_head.norm_cfg", {"type": "LN"}),
    ("roi_head.mask_head.predictor_cfg", {"type": "NormedConv2d", "tempearture": 20}),
    ("roi_head.mask_head.class_agnostic", True),
    ("roi_head.mask_head.loss_mask.loss_weight", 2.0),
    ("roi_head.mask_roi_extractor.roi_layer.output_size", 7),
    ("roi_head.mask_roi_extractor.featmap_strides", [8, 16, 32, 64]),
    ("roi_head.mask_roi_extractor", None),
    ("roi_head.mask_iou_head", {"type": "MaskIoUHead"}),
    ("train_cfg.rcnn.mask_size", 56),
    ("type", "MaskScoringRCNN"),
])
def test_builder_rejects_unported_mask_rcnn_values(path, value):
    from boosting_rcnn_tpu_torch.builder import build_detector
    from boosting_rcnn_tpu_torch.config import set_by_dotted_key

    mc = _mask_cfg()
    set_by_dotted_key(mc, path, value)
    with pytest.raises(NotImplementedError, match=path.split(".")[-1]):
        build_detector(mc, device="cpu")


@pytest.mark.parametrize("path,value", [
    ("rpn_head.num_convs", 2),
    ("rpn_head.loss_cls.type", "FocalLoss"),
    ("rpn_head.loss_bbox", {"type": "L1Loss", "loss_weight": 1.0}),
])
def test_builder_reads_the_ensemble_plain_rpn_values(path, value):
    """Values of the plain RPN the builder rejected before the ensemble
    configs were ported now build as the JAX builder reads them: stacked
    convs, focal objectness (gamma 2, alpha 0.25), and an ``L1Loss`` read
    as smooth L1 at beta 1/9."""
    from boosting_rcnn_tpu_torch.builder import build_detector
    from boosting_rcnn_tpu_torch.config import set_by_dotted_key

    mc = _mask_cfg()
    set_by_dotted_key(mc, path, value)
    det = build_detector(mc, device="cpu")
    r = det.rpn_cfg
    if path.endswith("num_convs"):
        assert det.net.rpn.conv_names == ["rpn_conv", "rpn_conv_1"]
    elif value == "FocalLoss":
        assert (r.loss_cls_type, r.focal_gamma, r.focal_alpha) == ("focal", 2.0, 0.25)
    else:
        assert abs(r.smooth_l1_beta - 1 / 9) < 1e-12
