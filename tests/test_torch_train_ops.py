"""The PyTorch port's train-side ops against the JAX package's, on the CPU.

Inputs are made from seeds with numpy and go through both packages in
float32.  Losses and their gradients with respect to the predictions:
rtol 1e-5 (atol 1e-6 of the largest value; float32, sums in other
orders).  Assignment and sampling: exact (the sampler gets the JAX
package's own uniform draws).  The RoIAlign gradient: the port's plain
backward against the TPU kernel ``_bwd_kernel`` in interpret mode at
C = 128 (batched, K4, and per image, K3) and against ``jax.vjp`` of the
vmapped ``multilevel_roi_align_fast`` at C = 32, atol 1e-5 of the largest
gradient, for autograd through the wrapper's CPU path and for
``roi_align_bwd_plain``.  The optimizer: parameters after each of three
steps within 1e-6 relative (float32 sums in other orders); the clip
against ``optax.clip_by_global_norm``: the norm within 1e-7 relative (the
sum orders differ), the clipped gradients bit for bit at that norm.  The CUDA kernels' autograd plumbing is checked here
with their launches replaced by the plain versions; the kernels
themselves only on the card (``tests/test_torch_cuda.py``).
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

from boosting_rcnn_tpu.engine import train as j_train  # noqa: E402
from boosting_rcnn_tpu.models.dense_heads import atss_rpn_head as j_rpn  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads import bbox_head as j_bbox  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads import prob_roi_head as j_prob  # noqa: E402
from boosting_rcnn_tpu.ops import assigners as j_assign  # noqa: E402
from boosting_rcnn_tpu.ops import box_ops as j_box  # noqa: E402
from boosting_rcnn_tpu.ops import losses as j_L  # noqa: E402
from boosting_rcnn_tpu.ops import pallas_roi_align as j_pallas  # noqa: E402
from boosting_rcnn_tpu.ops import roi_align as j_roi  # noqa: E402
from boosting_rcnn_tpu.ops import samplers as j_samp  # noqa: E402
from boosting_rcnn_tpu_torch.engine import train as t_train  # noqa: E402
from boosting_rcnn_tpu_torch.models.dense_heads import atss_rpn_head as t_rpn  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads import bbox_head as t_bbox  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads import prob_roi_head as t_prob  # noqa: E402
from boosting_rcnn_tpu_torch.ops import assigners as t_assign  # noqa: E402
from boosting_rcnn_tpu_torch.ops import box_ops as t_box  # noqa: E402
from boosting_rcnn_tpu_torch.ops import losses as t_L  # noqa: E402
from boosting_rcnn_tpu_torch.ops import roi_align as t_roi  # noqa: E402
from boosting_rcnn_tpu_torch.ops import roi_align_kernel as t_kern  # noqa: E402
from boosting_rcnn_tpu_torch.ops import samplers as t_samp  # noqa: E402

STRIDES = (8, 16, 32, 64, 128)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's multi-threaded CPU convolution backward (2.13.0+cpu) gave
    run-to-run different weight gradients, and in some runs heap
    corruption, on an 8-core x86 host; single-threaded it is repeatable.
    The port's CPU backward runs on one thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x))
    return t.requires_grad_() if grad else t


def _close(got, ref, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * 0.1 * max(np.abs(ref).max(), 1e-30))


def _boxes(rs, n, extent=200.0, lo=2.0, hi=None):
    xy = rs.uniform(0, extent, (n, 2))
    wh = rs.uniform(lo, hi or extent / 3, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---------------------------------------------------------------- box ops


@pytest.mark.parametrize("case", ["random", "overlapping", "degenerate"])
def test_bbox_overlaps_aligned_matches_jax(case):
    rs = np.random.RandomState(0)
    a, b = _boxes(rs, 50), _boxes(rs, 50)
    if case != "random":
        b = a + rs.randn(50, 4).astype(np.float32) * 3.0
    if case == "degenerate":  # zero-size and disjoint pairs: the eps floor
        a[:10, 2:] = a[:10, :2]
        b[10:20] = a[10:20] + 500.0
    ref = j_box.bbox_overlaps_aligned(jnp.asarray(a), jnp.asarray(b))
    _close(t_box.bbox_overlaps_aligned(_t(a), _t(b)), ref, rtol=1e-6)


@pytest.mark.parametrize("zero_size", [False, True])
def test_bbox2delta_matches_jax(zero_size):
    """The JAX package's ``bbox2delta(eps=1e-6)``, as both heads call it."""
    rs = np.random.RandomState(1)
    p, g = _boxes(rs, 40), _boxes(rs, 40)
    if zero_size:
        p[:3, 2:] = p[:3, :2]  # zero-size rows, floored by eps
        g[3:5, 2:] = g[3:5, :2]
    stds = (0.1, 0.1, 0.2, 0.2)
    ref = j_box.bbox2delta(jnp.asarray(p), jnp.asarray(g), (0.0,) * 4, stds, eps=1e-6)
    _close(t_box.bbox2delta(_t(p), _t(g), (0.0,) * 4, stds), ref, rtol=1e-5)


# ------------------------------------------------------------------ losses


def _loss_inputs(name, rs):
    n = 60
    if name == "iou":
        pred = _boxes(rs, n)
        target = pred + rs.randn(n, 4).astype(np.float32) * 5.0
        target[:, 2:] = np.maximum(target[:, 2:], target[:, :2] + 1.0)
        target[:5] = pred[:5] + 300.0  # no overlap: -log(eps)
        return pred, target, rs.rand(n).astype(np.float32)
    if name == "ce":
        return (rs.randn(n, 5).astype(np.float32) * 2, rs.randint(0, 5, n),
                rs.rand(n).astype(np.float32))
    if name == "focal":
        return (rs.randn(n, 1).astype(np.float32) * 3, (rs.rand(n, 1) > 0.7).astype(np.float32),
                rs.rand(n).astype(np.float32))
    if name == "bce":
        return (rs.randn(n).astype(np.float32) * 3, rs.rand(n).astype(np.float32),
                rs.rand(n).astype(np.float32))
    return (rs.randn(n, 4).astype(np.float32), rs.randn(n, 4).astype(np.float32),
            rs.rand(n, 4).astype(np.float32))


_LOSSES = {
    "focal": (j_L.sigmoid_focal_loss, t_L.sigmoid_focal_loss),
    "ce": (j_L.cross_entropy_loss, t_L.cross_entropy_loss),
    "bce": (j_L.binary_cross_entropy_loss, t_L.binary_cross_entropy_loss),
    "l1": (j_L.l1_loss, t_L.l1_loss),
    "mse": (j_L.mse_loss, t_L.mse_loss),
    "iou": (j_L.iou_loss, t_L.iou_loss),
}


@pytest.mark.parametrize("weighted,avg_factor", [(False, None), (True, None),
                                                 (False, 7.5), (True, 7.5)])
@pytest.mark.parametrize("name", sorted(_LOSSES))
def test_loss_and_gradient_match_jax(name, weighted, avg_factor):
    rs = np.random.RandomState(len(name))
    pred, target, weight = _loss_inputs(name, rs)
    j_fn, t_fn = _LOSSES[name]
    jw = jnp.asarray(weight) if weighted else None
    ref, ref_g = jax.value_and_grad(
        lambda p: j_fn(p, jnp.asarray(target), weight=jw, avg_factor=avg_factor))(
            jnp.asarray(pred))
    p = _t(pred, grad=True)
    got = t_fn(p, _t(target), weight=_t(weight) if weighted else None, avg_factor=avg_factor)
    got.backward()
    _close(got, ref)
    _close(p.grad, ref_g)


def test_iou_loss_averages_four_column_weights():
    rs = np.random.RandomState(3)
    pred, target, _ = _loss_inputs("iou", rs)
    w4 = rs.rand(len(pred), 4).astype(np.float32)
    ref = j_L.iou_loss(jnp.asarray(pred), jnp.asarray(target), weight=jnp.asarray(w4),
                       reduction="none")
    _close(t_L.iou_loss(_t(pred), _t(target), weight=_t(w4), reduction="none"), ref)


# --------------------------------------------------------------- assigner


def _assign_case(rs):
    """Boxes and padded gts with every rule in play: two identical gts
    (argmax ties), a padded gt row that copies a real box, gts only
    matched at low quality, duplicate best boxes, invalid boxes."""
    gts = _boxes(rs, 5, lo=20.0, hi=60.0)
    gts[1] = gts[0]  # tie: the first index must win
    gts[4] = gts[2]  # padded below, holds a real box
    gt_mask = np.array([True, True, True, True, False])
    boxes = np.concatenate([
        gts[:4] + rs.randn(4, 4).astype(np.float32) * 2.0,
        gts[:4] + rs.randn(4, 4).astype(np.float32) * 12.0,  # low quality
        _boxes(rs, 40),
    ]).astype(np.float32)
    boxes[-1] = boxes[5]  # duplicate of a low-quality best box
    box_valid = rs.rand(len(boxes)) > 0.15
    box_valid[[0, 5, len(boxes) - 1]] = True
    labels = np.array([0, 1, 2, 3, 1], np.int32)
    return boxes, box_valid, gts, gt_mask, labels


@pytest.mark.parametrize("low_quality,thr", [
    (True, (0.5, 0.4, 0.0)), (True, (0.5, 0.5, 0.3)),
    (False, (0.6, 0.6, 0.6)), (True, (0.7, 0.3, 0.2))])
def test_max_iou_assign_matches_jax(low_quality, thr):
    rs = np.random.RandomState(4)
    boxes, box_valid, gts, gt_mask, labels = _assign_case(rs)
    kw = dict(pos_iou_thr=thr[0], neg_iou_thr=thr[1], min_pos_iou=thr[2],
              match_low_quality=low_quality)
    ref = j_assign.max_iou_assign(jnp.asarray(boxes), jnp.asarray(box_valid),
                                  jnp.asarray(gts), jnp.asarray(gt_mask),
                                  gt_labels=jnp.asarray(labels), **kw)
    got = t_assign.max_iou_assign(_t(boxes), _t(box_valid), _t(gts), _t(gt_mask),
                                  gt_labels=_t(labels), **kw)
    np.testing.assert_array_equal(got.gt_inds.numpy(), np.asarray(ref.gt_inds))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.max_overlaps.numpy(), np.asarray(ref.max_overlaps),
                               rtol=1e-6, atol=1e-7)
    assert not np.isin(5, got.gt_inds.numpy())  # the padded gt never wins
    # box 0 is a near copy of the identical gts 0 and 1: the argmax tie
    # goes to the first, low-quality matching then to the last
    assert int(got.gt_inds[0]) == (2 if low_quality else 1)
    assert np.all(got.gt_inds.numpy()[~box_valid] == -1)


# ----------------------------------------------------------------- sampler


def _jax_uniforms(rng, n):
    kp, kn = jax.random.split(rng)
    return (np.asarray(jax.random.uniform(kp, (n,))),
            np.asarray(jax.random.uniform(kn, (n,))))


@pytest.mark.parametrize("case", ["many", "few_pos", "none_valid", "neg_pos_ub",
                                  "fewer_candidates"])
def test_random_sample_with_jax_uniforms(case):
    rs = np.random.RandomState(5)
    n, num = 300, 64
    gt_inds = rs.choice([-1, 0, 0, 0, 1, 2, 3], n).astype(np.int32)
    valid = rs.rand(n) > 0.1
    ub = -1
    if case == "few_pos":  # ~5 positives for 16 positive slots
        gt_inds = np.where((gt_inds > 0) & (rs.rand(n) > 0.1), 0, gt_inds).astype(np.int32)
    elif case == "none_valid":
        valid[:] = False
    elif case == "neg_pos_ub":
        ub = 1
    elif case == "fewer_candidates":
        n = 40
        gt_inds, valid = gt_inds[:n], valid[:n]
    assign = (gt_inds, np.zeros(n, np.float32), np.zeros(n, np.int32))
    rng = jax.random.PRNGKey(11)
    ref = j_samp.random_sample(rng, j_assign.AssignResult(*map(jnp.asarray, assign)),
                               jnp.asarray(valid), num=num, pos_fraction=0.25,
                               neg_pos_ub=ub)
    u_pos, u_neg = _jax_uniforms(rng, n)
    got = t_samp.random_sample_from_uniforms(
        t_assign.AssignResult(*map(_t, assign)), _t(valid), _t(u_pos), _t(u_neg),
        num=num, pos_fraction=0.25, neg_pos_ub=ub)
    for field in ref._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    if case == "few_pos":
        assert 0 < int(got.num_pos) < 16
    if case == "none_valid":
        assert not got.valid.any()


def test_random_sample_draws_from_generator():
    """The generator path ranks by its own uniforms: repeatable from a
    seed, and the slot layout rules hold (positives first, capped)."""
    rs = np.random.RandomState(6)
    gt_inds = _t(rs.choice([0, 0, 1, 2], 200).astype(np.int64))
    assign = t_assign.AssignResult(gt_inds, torch.zeros(200), torch.zeros(200))
    valid = torch.ones(200, dtype=torch.bool)
    a, b = (t_samp.random_sample(assign, valid, num=64,
                                 generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a.num_pos) == 16 and torch.all(a.is_pos[:16]) and not a.is_pos[16:].any()
    assert a.valid.all()


# ----------------------------------------------------------------- RPN loss


def _rpn_case(rs, b=2, a=400):
    anchors = _boxes(rs, a, extent=180.0, lo=8.0, hi=60.0)
    gts = np.stack([_boxes(rs, 4, extent=150.0, lo=15.0, hi=60.0) for _ in range(b)])
    gt_mask = np.ones((b, 4), bool)
    gt_mask[1, 3] = False
    # some anchors near the gts, so that there are positives of every kind
    anchors[:8] = gts.reshape(-1, 4)[:8] + rs.randn(8, 4).astype(np.float32)
    return dict(
        cls=(rs.randn(b, a) * 2 - 2).astype(np.float32),
        reg=(rs.randn(b, a, 4) * 0.2).astype(np.float32),
        iou=rs.randn(b, a).astype(np.float32),
        anchors=anchors, valid=rs.rand(b, a) > 0.05, gts=gts, gt_mask=gt_mask)


def test_atss_rpn_targets_match_jax():
    rs = np.random.RandomState(7)
    c = _rpn_case(rs)
    cfg_j, cfg_t = j_rpn.ATSSRPNCfg(gamma=0.5), t_rpn.ATSSRPNCfg(gamma=0.5)
    for i in range(2):
        ref = j_rpn.atss_rpn_targets(cfg_j, jnp.asarray(c["anchors"]), jnp.asarray(c["valid"][i]),
                                     jnp.asarray(c["gts"][i]), jnp.asarray(c["gt_mask"][i]))
        got = t_rpn.atss_rpn_targets(cfg_t, _t(c["anchors"]), _t(c["valid"][i]),
                                     _t(c["gts"][i]), _t(c["gt_mask"][i]))
        assert ref[0].sum() > 0
        for g_, r_ in zip(got, ref):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))


@pytest.mark.parametrize("gamma", [0.5, 1.0])
def test_atss_rpn_loss_and_gradients_match_jax(gamma):
    rs = np.random.RandomState(8)
    c = _rpn_case(rs)
    cfg_j, cfg_t = j_rpn.ATSSRPNCfg(gamma=gamma), t_rpn.ATSSRPNCfg(gamma=gamma)
    fixed = [jnp.asarray(c[k]) for k in ("anchors", "valid", "gts", "gt_mask")]

    def j_total(cls, reg, iou):
        out = j_rpn.atss_rpn_loss(cfg_j, cls, reg, iou, *fixed)
        return sum(out.values()), out

    (_, ref), ref_g = jax.jit(jax.value_and_grad(j_total, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(c["cls"]), jnp.asarray(c["reg"]), jnp.asarray(c["iou"]))
    ins = [_t(c[k], grad=True) for k in ("cls", "reg", "iou")]
    got = t_rpn.atss_rpn_loss(cfg_t, *ins, *[_t(c[k]) for k in ("anchors", "valid", "gts",
                                                              "gt_mask")])
    sum(got.values()).backward()
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k])
    for x, r_ in zip(ins, ref_g):
        _close(x.grad, r_, rtol=1e-4)


def test_atss_rpn_loss_rejects_unported_branches():
    z = torch.zeros((1, 4))
    for cfg in (t_rpn.ATSSRPNCfg(atss=True), t_rpn.ATSSRPNCfg(reg_decoded_bbox=False),
                t_rpn.ATSSRPNCfg(loss_cls_type="varifocal")):
        with pytest.raises(NotImplementedError):
            t_rpn.atss_rpn_loss(cfg, z, z[..., None].expand(1, 4, 4), z, z.reshape(4, 1)
                                .expand(4, 4), z.bool(), z[:, :1, None].expand(1, 1, 4),
                                z[:, :1].bool())


# ----------------------------------------------------------- R-CNN losses


def _roi_case(rs, r=48, k=4):
    boxes = _boxes(rs, r, lo=10.0, hi=60.0)
    gt = boxes + rs.randn(r, 4).astype(np.float32) * 4.0
    gt[:, 2:] = np.maximum(gt[:, 2:], gt[:, :2] + 2.0)
    is_pos = rs.rand(r) > 0.6
    valid = rs.rand(r) > 0.15
    is_pos &= valid
    return dict(
        boxes=boxes, gt=gt, is_pos=is_pos, valid=valid,
        label=np.where(is_pos, rs.randint(0, k, r), -1).astype(np.int32),
        cls=rs.randn(r, k + 1).astype(np.float32), reg=rs.randn(r, 4 * k).astype(np.float32),
        prior=np.where(valid, rs.rand(r), 0.0).astype(np.float32))


def test_bbox_targets_and_head_loss_match_jax():
    rs = np.random.RandomState(9)
    c = _roi_case(rs)
    cfg_j, cfg_t = j_bbox.BBoxHeadCfg(), t_bbox.BBoxHeadCfg()
    lab = np.where(c["is_pos"], c["label"], 4)
    ref_t = j_bbox.bbox_targets(cfg_j, *(jnp.asarray(c[k]) for k in ("boxes", "is_pos",
                                                                     "valid", "gt")),
                                jnp.asarray(lab))
    got_t = t_bbox.bbox_targets(cfg_t, *(_t(c[k]) for k in ("boxes", "is_pos", "valid", "gt")),
                                _t(lab))
    for g_, r_ in zip(got_t, ref_t):
        _close(g_, r_, rtol=1e-6)
    for reduction in (None, "none"):
        ref = j_bbox.bbox_head_loss(cfg_j, jnp.asarray(c["cls"]), jnp.asarray(c["reg"]),
                                    jnp.asarray(c["boxes"]), *ref_t, reduction_override=reduction)
        got = t_bbox.bbox_head_loss(cfg_t, _t(c["cls"]), _t(c["reg"]), _t(c["boxes"]), *got_t,
                                    reduction_override=reduction)
        for k in ("loss_cls", "loss_bbox"):
            _close(got[k], ref[k])
        np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(ref["pos"]))
    with pytest.raises(NotImplementedError):
        t_bbox.bbox_targets(t_bbox.BBoxHeadCfg(loss_bbox_type="smooth_l1"),
                            *(_t(c[k]) for k in ("boxes", "is_pos", "valid", "gt")), _t(lab))


def test_norm_loss_matches_jax_with_detached_rescale():
    rs = np.random.RandomState(10)
    loss = rs.rand(30).astype(np.float32) * 3
    w = rs.rand(30).astype(np.float32)
    for wv in (w, np.zeros_like(w)):  # zero weights: the denominator guard
        ref, ref_g = jax.value_and_grad(
            lambda lv: j_prob.norm_loss(lv, jnp.asarray(wv), 12.0))(jnp.asarray(loss))
        x = _t(loss, grad=True)
        got = t_prob.norm_loss(x, _t(wv), 12.0)
        got.backward()
        _close(got, ref)
        _close(x.grad, ref_g)


def _sample(c, xp):
    r = len(c["boxes"])
    z = np.zeros(r, np.int32)
    fields = dict(boxes=c["boxes"], is_pos=c["is_pos"], valid=c["valid"], prior=c["prior"],
                  iou=c["prior"], matched_gt=c["gt"], matched_label=c["label"], gt_idx=z,
                  cand_idx=z, is_gt=np.zeros(r, bool))
    return (j_prob.RoISample if xp is jnp else t_prob.RoISample)(
        **{k: (jnp.asarray(v) if xp is jnp else _t(v)) for k, v in fields.items()})


@pytest.mark.parametrize("boost", [True, False])
def test_prob_roi_loss_and_gradients_match_jax(boost):
    rs = np.random.RandomState(11)
    c = _roi_case(rs)
    kw = dict(boost=boost, gamma=0.5)
    cfg_j, cfg_t = j_prob.ProbRoICfg(**kw), t_prob.ProbRoICfg(**kw)

    def j_total(cls, reg):
        out = j_prob.prob_roi_loss(cfg_j, j_bbox.BBoxHeadCfg(), cls, reg, _sample(c, jnp))
        return sum(out.values()), out

    (_, ref), ref_g = jax.value_and_grad(j_total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(c["cls"]), jnp.asarray(c["reg"]))
    cls, reg = _t(c["cls"], grad=True), _t(c["reg"], grad=True)
    got = t_prob.prob_roi_loss(cfg_t, t_bbox.BBoxHeadCfg(), cls, reg, _sample(c, torch))
    sum(got.values()).backward()
    for k in ("loss_cls", "loss_bbox"):
        _close(got[k], ref[k])
    _close(cls.grad, ref_g[0])
    _close(reg.grad, ref_g[1])


# ------------------------------------------------------- RoIAlign gradient


def _small_pyramid(rs, b, c):
    hw = [(24, 32), (12, 16), (6, 8)]
    return [rs.randn(b, h, w, c).astype(np.float32) for h, w in hw], (8, 16, 32)


def _small_rois(rs, b, r=7):
    cx, cy = rs.uniform(12, 230, (b, r)), rs.uniform(12, 170, (b, r))
    bw, bh = rs.uniform(8, 250, (b, r)), rs.uniform(8, 150, (b, r))
    rois = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    rois = np.clip(rois, 0, [256, 192, 256, 192]).astype(np.float32)
    valid = np.ones((b, r), bool)
    valid[:, -1] = False
    return rois, valid


def _port_grad(fn, feats, g):
    leaves = [_t(f, grad=True) for f in feats]
    out = fn(leaves)
    out.backward(_t(g))
    return out.detach(), [x.grad for x in leaves]


def test_plain_gradient_matches_pallas_bwd_interpret():
    """K4 itself (``_bwd_kernel`` through ``batched_multilevel_roi_align``'s
    backward, interpret mode), C = 128, B = 2; invalid RoIs carry a large
    cotangent that must add nothing."""
    rs = np.random.RandomState(12)
    feats, strides = _small_pyramid(rs, 2, 128)
    rois, valid = _small_rois(rs, 2)
    g = rs.randn(2, rois.shape[1], 7, 7, 128).astype(np.float32)
    g[~valid] = 1e3
    _, vjp = jax.vjp(lambda f: j_pallas.batched_multilevel_roi_align(
        f, jnp.asarray(rois), jnp.asarray(valid), strides, interpret=True),
        tuple(jnp.asarray(f) for f in feats))
    (ref,) = vjp(jnp.asarray(g))
    _, got = _port_grad(lambda lv: t_kern.batched_multilevel_roi_align(
        lv, _t(rois), _t(valid), strides), feats, g)
    plain = t_kern.roi_align_bwd_plain(_t(g).reshape(-1, 7, 7, 128), [_t(f) for f in feats],
                                       _t(rois), _t(valid), strides)
    for gl, pl, rl in zip(got, plain, ref):
        for d in (gl, pl):
            np.testing.assert_allclose(d.numpy(), np.asarray(rl), rtol=0,
                                       atol=1e-5 * np.abs(np.asarray(rl)).max())


def test_plain_gradient_matches_jax_vjp_of_fast():
    """Against ``jax.vjp`` of the vmapped ``multilevel_roi_align_fast``
    at C = 32 on the five flagship levels: autograd through the wrapper's
    CPU path and ``roi_align_bwd_plain``, the plain gradient the card
    holds the gradient kernel against, each level within 1e-5 of its
    largest value."""
    rs = np.random.RandomState(13)
    hw = [(-(-200 // s), -(-264 // s)) for s in STRIDES]
    feats = [rs.randn(2, h, w, 32).astype(np.float32) for h, w in hw]
    rois, valid = _small_rois(rs, 2, r=12)
    g = rs.randn(2, 12, 7, 7, 32).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jax.vmap(
        lambda fl, rb, vb: j_roi.multilevel_roi_align_fast(fl, rb, vb, STRIDES))(
            f, jnp.asarray(rois), jnp.asarray(valid)), tuple(jnp.asarray(f) for f in feats))
    (ref,) = vjp(jnp.asarray(g))
    _, got = _port_grad(lambda lv: t_kern.batched_multilevel_roi_align(
        lv, _t(rois), _t(valid), STRIDES), feats, g)
    plain = t_kern.roi_align_bwd_plain(_t(g).reshape(-1, 7, 7, 32), [_t(f) for f in feats],
                                       _t(rois).reshape(-1, 4), _t(valid).reshape(-1), STRIDES)
    assert [tuple(p.shape) for p in plain] == [f.shape for f in feats]
    for gl, pl, rl in zip(got, plain, ref):
        for d in (gl, pl):
            np.testing.assert_allclose(d.numpy(), np.asarray(rl), rtol=0,
                                       atol=1e-5 * np.abs(np.asarray(rl)).max())


def test_per_image_entry_matches_pallas_interpret():
    """The per-image entry (batch of one) against the TPU's per-image
    forward ``_kernel`` (``multilevel_roi_align_pallas``) and gradient
    ``_bwd_kernel`` (``multilevel_roi_align_pallas_trainable``), interpret
    mode, C = 128."""
    rs = np.random.RandomState(14)
    feats, strides = _small_pyramid(rs, 1, 128)
    feats = [f[0] for f in feats]
    rois, valid = (x[0] for x in _small_rois(rs, 1))
    g = rs.randn(rois.shape[0], 7, 7, 128).astype(np.float32)
    jf = tuple(jnp.asarray(f) for f in feats)
    ref_fwd = j_pallas.multilevel_roi_align_pallas(jf, jnp.asarray(rois), jnp.asarray(valid),
                                                   strides, interpret=True)
    _, vjp = jax.vjp(lambda f: j_pallas.multilevel_roi_align_pallas_trainable(
        f, jnp.asarray(rois), jnp.asarray(valid), strides, interpret=True), jf)
    (ref,) = vjp(jnp.asarray(g))
    out, got = _port_grad(lambda lv: t_kern.multilevel_roi_align(
        lv, _t(rois), _t(valid), strides), feats, g)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_fwd), rtol=0, atol=1e-5)
    for gl, rl in zip(got, ref):
        np.testing.assert_allclose(gl.numpy(), np.asarray(rl), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(rl)).max())
    assert t_kern.multilevel_roi_align.batched.launches == 0


def test_autograd_function_wiring_with_plain_launches(monkeypatch):
    """The CUDA path's plumbing (the autograd Function on the route levels,
    one gradient per level back to each, the saved RoIs and valid mask,
    launch counts), exercised on the CPU with each kernel launch replaced
    by its plain version; against autograd of the plain RoIAlign."""
    rs = np.random.RandomState(15)
    feats, strides = _small_pyramid(rs, 2, 16)
    rois, valid = _small_rois(rs, 2)
    g = rs.randn(2, rois.shape[1], 7, 7, 16).astype(np.float32)
    wrapper = t_kern.RoIAlignForward()
    r = rois.shape[1]

    def fwd_launch(levels, rois_flat, valid_u8, strides_, finest_scale=56, out_size=7):
        wrapper.launches += 1
        out = t_roi.multilevel_roi_align_fast(
            [f.detach() for f in levels], rois_flat.reshape(2, r, 4),
            valid_u8.reshape(2, r).bool(), strides_, finest_scale=finest_scale)
        return out.reshape(2 * r, 7, 7, -1)

    def bwd_launch(gr, level_shapes, rois_flat, valid_u8, strides_, finest_scale=56,
                   tiles=None):
        wrapper.backward.launches += 1
        wrapper.backward.tile_launches += 1
        return t_kern.roi_align_bwd_plain(gr, [torch.empty(s) for s in level_shapes],
                                          rois_flat, valid_u8, strides_, finest_scale)

    monkeypatch.setattr(wrapper, "launch", fwd_launch)
    monkeypatch.setattr(wrapper.backward, "launch", bwd_launch)
    leaves = [_t(f, grad=True) for f in feats]
    rf = _t(rois).reshape(-1, 4).contiguous()
    vf = _t(valid).reshape(-1).to(torch.uint8)
    out = t_kern._RoIAlignFunction.apply(rf, vf, wrapper, strides, 56.0, 7, *leaves)
    out.backward(_t(g).reshape(out.shape))
    ref_out, ref = _port_grad(lambda lv: t_roi.multilevel_roi_align_fast(
        lv, _t(rois), _t(valid), strides), feats, g)
    np.testing.assert_allclose(out.detach().reshape(ref_out.shape).numpy(), ref_out.numpy(),
                               rtol=0, atol=1e-5)
    for gl, rl in zip(leaves, ref):
        np.testing.assert_allclose(gl.grad.numpy(), rl.numpy(), rtol=0, atol=1e-5)
    assert (wrapper.launches, wrapper.backward.launches, wrapper.backward.tile_launches) == (
        1, 1, 1)
    with torch.inference_mode():  # no graph: the forward alone
        t_kern._RoIAlignFunction.apply(rf, vf, wrapper, strides, 56.0, 7,
                                       *[f.detach() for f in leaves])
    assert (wrapper.launches, wrapper.backward.launches) == (2, 1)


def test_backward_wrapper_rejects_cpu_and_bad_shapes():
    """The gradient kernels' wrapper takes CUDA tensors only, and no channel
    count that is not a multiple of 4."""
    bwd = t_kern.RoIAlignBackward()
    rois = torch.zeros((2, 4))
    valid = torch.ones(2, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        bwd.launch(torch.zeros(2, 7, 7, 8), [(1, 8, 8, 8)], rois, valid, (8,))
    with pytest.raises(ValueError, match="CUDA"):
        bwd.tile_lists([(1, 8, 8, 8)], rois, valid, (8,))
    with pytest.raises(ValueError, match="multiple of 4"):
        t_kern._check_shapes([(1, 8, 8, 6)])
    with pytest.raises(ValueError, match="1 to 5"):
        t_kern._check_shapes([(1, 8, 8, 8)] * 6)
    with pytest.raises(ValueError, match="one batch"):
        t_kern._check_shapes([(1, 8, 8, 8), (2, 4, 4, 8)])


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("base_lr,spe", [(0.005, 100), (0.02, 7)])
def test_step_lr_schedule_matches_jax(base_lr, spe):
    j_s = j_train.step_lr_schedule(base_lr, spe, warmup_iters=50)
    t_s = t_train.step_lr_schedule(base_lr, spe, warmup_iters=50)
    for step in (0, 1, 25, 49, 50, 51, 8 * spe - 1, 8 * spe, 11 * spe + 3):
        assert t_s(step) == float(j_s(step)), step


def test_optimizer_matches_jax_chain():
    """Three steps of clip 35 -> weight decay 1e-4 -> SGD momentum 0.9 on
    a small tree with a frozen stem and stage 1 (``frozen_stages=1``);
    the clip acts in steps 0 and 2, not in step 1."""
    rs = np.random.RandomState(17)
    shapes = {"backbone": {"conv1": {"kernel": (3, 3, 3, 4)}, "bn1": {"scale": (4,)},
                           "layer1_0": {"conv1": {"kernel": (3, 3, 4, 4)}},
                           "layer2_0": {"conv1": {"kernel": (3, 3, 4, 8)}}},
              "rpn": {"rpn_cls": {"kernel": (3, 3, 8, 3), "bias": (3,)}}}
    params = jax.tree.map(lambda s: rs.randn(*s).astype(np.float32) * 0.1, shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    frozen = ("backbone/conv1", "backbone/bn1", "backbone/layer1_0")
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    tparams = {k: torch.nn.Parameter(_t(v), requires_grad=not k.startswith(frozen))
               for k, v in flat.items()}
    sched_j = j_train.step_lr_schedule(0.02, 2, decay_epochs=(1,), warmup_iters=2)
    tx = j_train.make_optimizer(sched_j, params=params, frozen_stages=1)
    opt_state = tx.init(jax.tree.map(jnp.asarray, params))
    jp = jax.tree.map(jnp.asarray, params)
    opt = t_train.make_optimizer(tparams.values(),
                                 t_train.step_lr_schedule(0.02, 2, decay_epochs=(1,),
                                                          warmup_iters=2))
    assert len(opt.params) == 3  # layer2_0 kernel, rpn_cls kernel and bias
    for scale in (300.0, 1.0, 80.0):
        grads = jax.tree.map(lambda p: rs.randn(*p.shape).astype(np.float32) * scale, params)
        grads_j = jax.tree_util.tree_map_with_path(
            lambda path, gv: gv * 0 if "/".join(str(getattr(k, "key", k)) for k in path)
            .startswith(frozen) else gv, grads)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads_j), opt_state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        opt.zero_grad()
        for path, gv in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            if tparams[key].requires_grad:
                tparams[key].grad = _t(gv)
        norm = opt.step()
        ref_norm = float(jnp.sqrt(sum(jnp.sum(jnp.asarray(g) ** 2)
                                      for g in jax.tree.leaves(grads_j))))
        np.testing.assert_allclose(float(norm), ref_norm, rtol=1e-5)
        for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            np.testing.assert_allclose(tparams[key].detach().numpy(), np.asarray(v),
                                       rtol=1e-6, atol=1e-6 * np.abs(np.asarray(v)).max(),
                                       err_msg=key)
    for key in flat:
        if key.startswith(frozen):
            np.testing.assert_array_equal(tparams[key].detach().numpy(), flat[key])


@pytest.mark.parametrize("scale,clipped", [(6.0, True), (0.3, False)])
def test_optimizer_clip_matches_optax(scale, clipped):
    """The port's clip against optax's ``clip_by_global_norm(35)``, the
    first stage of the JAX ``make_optimizer`` chain, on a small tree whose
    global norm is above 35 (the clip acts) or below it (the gradients
    pass unchanged): the global norm within 1e-7 relative of optax's
    ``global_norm`` (the sum orders differ); the clipped gradients bit for
    bit what ``clip_by_global_norm`` makes of them at that norm
    (``select(norm < 35, g, (g / norm) * 35)``), and within 1e-6 of optax's
    own; the parameters after the step against the whole chain."""
    import optax

    rs = np.random.RandomState(18)
    shapes = {"layer2_0": (3, 3, 4, 8), "neck": (8,), "rpn": (16, 5)}
    params = {k: (rs.randn(*v) * 0.1).astype(np.float32) for k, v in shapes.items()}
    grads = {k: (rs.randn(*v) * scale).astype(np.float32) for k, v in shapes.items()}
    jgrads = jax.tree.map(jnp.asarray, grads)
    clip = optax.clip_by_global_norm(35.0)
    ref, _ = clip.update(jgrads, clip.init(jgrads))
    tx = j_train.make_optimizer(lambda step: 0.01, params=params, frozen_stages=0)
    updates, _ = tx.update(jgrads, tx.init(jax.tree.map(jnp.asarray, params)),
                           jax.tree.map(jnp.asarray, params))
    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    for k, p in tparams.items():
        p.grad = _t(grads[k])
    opt = t_train.make_optimizer(tparams.values(), lambda step: 0.01)
    norm = opt.step()
    ref_norm = float(optax.global_norm(jgrads))
    np.testing.assert_allclose(float(norm), ref_norm, rtol=1e-7)
    assert (ref_norm >= 35.0) == clipped
    jnorm = jnp.asarray(norm.numpy())
    for k, p in tparams.items():
        at_norm = jax.lax.select(jnorm < 35.0, jgrads[k], (jgrads[k] / jnorm) * 35.0)
        np.testing.assert_array_equal(p.grad.numpy(), np.asarray(at_norm))
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref[k]), rtol=1e-6)
        np.testing.assert_allclose(p.detach().numpy(), params[k] + np.asarray(updates[k]),
                                   rtol=1e-6, atol=1e-6 * np.abs(params[k]).max())


# ------------------------------------------------------------------ builder


def _flagship_cfg():
    from boosting_rcnn_tpu_torch.config import load_config

    mc = load_config(os.path.join(
        REPO, "configs/boosting_rcnn/boosting_rcnn_r50_pafpn_1x_utdac.py")).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"].update(in_channels=[8, 16, 32, 64], out_channels=32)
    mc["rpn_head"].update(feat_channels=32, stacked_convs=1)
    mc["roi_head"]["bbox_head"]["fc_out_channels"] = 16
    return mc


def test_builder_reads_the_flagship_train_cfg():
    from boosting_rcnn_tpu_torch.builder import build_detector

    det = build_detector(_flagship_cfg(), device="cpu")
    r, b, roi = det.rpn_cfg, det.bbox_cfg, det.roi_cfg
    assert (r.gamma, r.aug_loss_weight, r.pos_iou_thr, r.min_pos_iou, r.match_low_quality) == (
        0.5, 1.0, 0.5, 0, True)
    assert (b.loss_cls_weight, b.loss_bbox_weight, b.target_stds) == (2.0, 2.0,
                                                                      (0.1, 0.1, 0.2, 0.2))
    assert (roi.boost, roi.gamma, roi.num_samples, roi.pos_fraction, roi.pos_iou_thr,
            roi.match_low_quality) == (True, 0.5, 512, 0.25, 0.6, False)
    tp = det.train_proposal_cfg
    assert (tp.nms_pre, tp.max_per_img, tp.nms_iou_thr) == (4000, 2000, 0.7)
    frozen = {n for n, p in det.net.named_parameters() if not p.requires_grad}
    assert frozen and all(n.startswith(("backbone.conv1.", "backbone.bn1.", "backbone.layer1_"))
                          for n in frozen)
    assert any(n.startswith("backbone.layer1_") for n in frozen)


@pytest.mark.parametrize("path,value", [
    ("rpn_head.atss", True),
    ("rpn_head.reg_decoded_bbox", False),
    ("rpn_head.loss_cls.type", "VarifocalLoss"),
    ("rpn_head.loss_bbox.type", "GIoULoss"),
    ("rpn_head.aug_reg_loss.type", "L1Loss"),
    ("rpn_head.aug_reg_loss", None),
    ("roi_head.quality", True),
    ("roi_head.alpha", 0.5),
    ("roi_head.reg_norm", "mean"),
    ("train_cfg.rcnn.sampler.add_gt_as_proposals", False),
    ("roi_head.bbox_head.loss_bbox.type", "SmoothL1Loss"),
    ("roi_head.bbox_head.loss_cls.use_sigmoid", True),
    ("train_cfg.rpn.assigner.ignore_iof_thr", 0.5),
    ("train_cfg.rpn.sampler.type", "RandomSampler"),
    ("train_cfg.rpn_proposal.nms.type", "soft_nms"),
    ("train_cfg.rcnn.sampler.type", "OHEMSampler"),
    ("train_cfg.rcnn.assigner.gt_max_assign_all", False),
    ("train_cfg.rcnn.isr", {"k": 2.0}),
    ("train_cfg.rpn.center_sampling", True),
    ("train_cfg.rpn_proposal.nms_across_levels", True),
    ("roi_head.bbox_head.loss_cls.label_smoothing", 0.1),
])
def test_builder_rejects_unported_train_values(path, value):
    from boosting_rcnn_tpu_torch.builder import build_detector
    from boosting_rcnn_tpu_torch.config import set_by_dotted_key

    mc = _flagship_cfg()
    set_by_dotted_key(mc, path, value)
    with pytest.raises(NotImplementedError, match=path.split(".")[-1]):
        build_detector(mc, device="cpu")
