"""The fork's ensemble heads in the PyTorch port against the JAX package, on
the CPU, in float32: ATSS assignment and GIoU in the ATSS RPN
(``configs/ensemble/cascade_atss*``), the stacked-conv focal RPN
(``cascade_retinanet*``, ``ensemble/boosting_rcnn``) and ``BoostRoIHead``.

Modules, on inputs made with numpy from a seed:

  * ``atss_assign``: ``gt_inds`` exactly equal to JAX's over the tiny
    canvas's anchors (9 a location, sharing its centre, so distances tie
    everywhere), a gt centred exactly between two locations among them;
    the max IoUs within 1e-6;
  * ``giou_loss`` and its gradient within 1e-6;
  * the RPN losses and their gradients, rtol 1e-4: the plain RPN with the
    focal objectness (its anchor sampler fed JAX's uniforms) and the ATSS
    RPN with ATSS assignment and GIoU, with and without the MSE term; the
    four-conv ``RPNConvs`` within 1e-5 of the largest value;
  * ``sample_rois_boost`` (fed JAX's uniforms) field by field and
    ``boost_fuse_scores`` within 1e-6, on the inputs of
    ``tests/test_boosting_semantics.py::test_boost_roi_head_multiclass_prior``;
  * mmdet's stacked RPN (``rpn_head.rpn_conv.N.conv``) mapped onto the
    port's names by ``weights.from_mmdet_state_dict``;
  * ``--tiny`` on the six configs of the fork's heads: the port's shrunk
    model has the parameter and buffer names and shapes of
    ``jax.eval_shape`` of the JAX build of the JAX package's
    ``tools/train.py::shrink_model`` output.

Whole tiny detectors, through ``tests/test_torch_cascade.py``'s harness
and at its tolerances (``predict``: labels and valid equal, detections
within 1e-3; each stage's sample on JAX's draws; the losses rtol 1e-4;
every gradient within 1e-3 of the tensor's largest; two fused SGD steps):
``cascade_atss`` (weights and batch from seed 2: seeds 0 and 1 each hold
a float32 edge, ``atss_run``) and ``cascade_retinanet`` as
``tiny_cascade`` cuts them;
and ``ensemble/boosting_rcnn`` (the focal plain RPN, ``BoostRoIHead``:
prior fusion, no boosting) cut as ``tests/test_torch_faster_rcnn.py``
cuts Faster R-CNN: ``predict`` and the losses on JAX's ``RoISample``.
"""
import copy
import os
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
from boosting_rcnn_tpu.models.dense_heads import atss_rpn_head as j_atss  # noqa: E402
from boosting_rcnn_tpu.models.dense_heads import rpn_head as j_rpn  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads import prob_roi_head as j_prob  # noqa: E402
from boosting_rcnn_tpu.ops import assigners as j_assign  # noqa: E402
from boosting_rcnn_tpu.ops import losses as j_L  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.engine import runner  # noqa: E402
from boosting_rcnn_tpu_torch.models.dense_heads import atss_rpn_head as t_atss  # noqa: E402
from boosting_rcnn_tpu_torch.models.dense_heads import rpn_head as t_rpn  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads import prob_roi_head as t_prob  # noqa: E402
from boosting_rcnn_tpu_torch.ops import assigners as t_assign  # noqa: E402
from boosting_rcnn_tpu_torch.ops import losses as t_L  # noqa: E402
from boosting_rcnn_tpu_torch.ops.anchors import AnchorGenerator  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params, from_mmdet_state_dict  # noqa: E402
from test_torch_boosting_detectors import (  # noqa: E402
    CANVAS,
    _batch,
    _random_variables,
    _rpn_uniforms,
    check_gradients,
    check_losses,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
    shrink_heads,
)
from test_torch_cascade import (  # noqa: E402
    check_cascade_losses,
    check_samples,
    run_cascade_pair,
    tiny_cascade,
)
from test_torch_cascade_configs import FORK_HEADS  # noqa: E402
from tools.train import shrink_model as jax_shrink  # noqa: E402

ATSS_CONFIG = "ensemble/cascade_atss_r50_fpn_1x_coco.py"
RETINA_CONFIG = "ensemble/cascade_retinanet_r50_fpn_1x_coco.py"
BOOST_CONFIG = "ensemble/boosting_rcnn_r50_fpn_1x_coco.py"


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x))
    return t.requires_grad_() if grad else t


def _close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def _atss_anchors():
    """The ``cascade_atss`` anchors on the tiny canvas: 9 a location (3
    octave scales x 3 ratios) at strides 8-128, and each level's count."""
    ag = load_config(config_path(ATSS_CONFIG)).model.to_dict()["rpn_head"]["anchor_generator"]
    ag.pop("type")
    gen = AnchorGenerator(**ag)
    sizes = [(-(-CANVAS[0] // s[1]), -(-CANVAS[1] // s[0])) for s in gen.strides]
    per_level = gen.grid_anchors(sizes)
    return np.concatenate(per_level).astype(np.float32), tuple(len(a) for a in per_level)


def _gts(rs, n, h=CANVAS[0], w=CANVAS[1], side=(10.0, 90.0)):
    wh = rs.uniform(*side, (n, 2))
    xy = rs.uniform(0, 1, (n, 2)) * ([w, h] - wh)
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ------------------------------------------------------------------ modules
def test_atss_assign_matches_jax():
    anchors, nla = _atss_anchors()
    rs = np.random.RandomState(0)
    gts = _gts(rs, 7)
    # centred exactly between the stride-8 locations x = 40 and x = 48 on
    # the row y = 56: 18 anchors at one distance, of which ATSS takes 9
    gts[0] = [44.0 - 20.0, 56.0 - 14.0, 44.0 + 20.0, 56.0 + 14.0]
    gts[1] = [0.0, 0.0, 24.0, 16.0]  # at the corner, centre on a location
    gt_mask = np.ones(7, bool)
    gt_mask[6] = False
    for valid in (np.ones(len(anchors), bool), rs.rand(len(anchors)) > 0.1):
        ref = j_assign.atss_assign(jnp.asarray(anchors), jnp.asarray(valid), nla,
                                   jnp.asarray(gts), jnp.asarray(gt_mask))
        got = t_assign.atss_assign(_t(anchors), _t(valid), nla, _t(gts), _t(gt_mask))
        ref_inds = np.asarray(ref.gt_inds)
        assert (ref_inds == 1).sum() > 0 and len(set(ref_inds[ref_inds > 0])) >= 5
        np.testing.assert_array_equal(got.gt_inds.numpy(), ref_inds)
        np.testing.assert_allclose(got.max_overlaps.numpy(), np.asarray(ref.max_overlaps),
                                   rtol=0, atol=1e-6)


def test_giou_loss_matches_jax():
    rs = np.random.RandomState(1)
    pred = _gts(rs, 64, side=(0.0, 60.0))
    target = _gts(rs, 64, side=(4.0, 60.0))
    target[:8] = pred[:8]  # exact hits
    pred[8:12, 2:] = pred[8:12, :2]  # degenerate boxes
    for weight in (rs.rand(64).astype(np.float32), rs.rand(64, 4).astype(np.float32)):
        def j_fn(p):
            return j_L.giou_loss(p, jnp.asarray(target), weight=jnp.asarray(weight),
                                 avg_factor=7.0)

        ref, ref_g = jax.value_and_grad(j_fn)(jnp.asarray(pred))
        p = _t(pred, grad=True)
        got = t_L.giou_loss(p, _t(target), weight=_t(weight), avg_factor=7.0)
        got.backward()
        _close(got, ref, 1e-6)
        # at an exact hit every min / max of the two boxes ties, and the
        # packages take other subgradients there, both within 1e-6 of 0
        _close(p.grad[8:], np.asarray(ref_g)[8:], 1e-6)
        for g in (p.grad[:8].numpy(), np.asarray(ref_g)[:8]):
            assert np.abs(g).max() < 1e-6


def _rpn_inputs(rs, a, b=2):
    return ((rs.randn(b, a) * 1.5 - 2).astype(np.float32),
            (rs.randn(b, a, 4) * 0.2).astype(np.float32),
            rs.randn(b, a).astype(np.float32))


def _gt_batch(rs, b=2, g=6):
    gts = np.stack([_gts(rs, g) for _ in range(b)])
    gt_mask = np.ones((b, g), bool)
    gt_mask[1, g - 1] = False
    return gts, gt_mask


def _check_loss(j_total, t_total, inputs):
    (_, ref), ref_g = jax.jit(jax.value_and_grad(j_total, argnums=tuple(range(len(inputs))),
                                                 has_aux=True))(*map(jnp.asarray, inputs))
    ins = [_t(x, grad=True) for x in inputs]
    got = t_total(*ins)
    sum(got.values()).backward()
    assert set(got) == set(ref)
    for k in ref:
        assert float(ref[k]) > 0, k
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-4, err_msg=k)
    for x, r in zip(ins, ref_g):
        _close(x.grad, r, 1e-4)


def test_focal_plain_rpn_loss_matches_jax():
    """The ``cascade_retinanet`` RPN's loss: focal objectness at weight 0.5
    over the sampled anchors, smooth L1 at beta 1/9, the sampler ranking by
    JAX's draws."""
    anchors, _ = _atss_anchors()
    rs = np.random.RandomState(2)
    cls, reg, _ = _rpn_inputs(rs, len(anchors))
    gts, gt_mask = _gt_batch(rs)
    valid = np.ones((2, len(anchors)), bool)
    key = jax.random.PRNGKey(4)
    uniforms = []
    for k in jax.random.split(key, 2):
        kp, kn = jax.random.split(k)
        uniforms.append([np.asarray(jax.random.uniform(x, (len(anchors),))) for x in (kp, kn)])
    kw = dict(loss_cls_type="focal", loss_cls_weight=0.5)
    cfg_j, cfg_t = j_rpn.RPNCfg(**kw), t_rpn.RPNCfg(**kw)
    fixed = [anchors, valid, gts, gt_mask]

    def j_total(c, r):
        out = j_rpn.rpn_loss(cfg_j, c, r, *map(jnp.asarray, fixed), rng=key)
        return sum(out.values()), out

    _check_loss(j_total, lambda c, r: t_rpn.rpn_loss(
        cfg_t, c, r, *map(_t, fixed), uniforms=_t(np.asarray(uniforms, np.float32))),
        [cls, reg])


@pytest.mark.parametrize("aug", [False, True])
def test_atss_rpn_loss_with_atss_and_giou_matches_jax(aug):
    """The ``cascade_atss`` RPN's loss (ATSS assignment, focal, GIoU on the
    decoded boxes at weight 2 as in ``_s2``, the IoU branch's BCE), without
    the MSE term as the configs have it and with it."""
    anchors, nla = _atss_anchors()
    rs = np.random.RandomState(3)
    cls, reg, iou = _rpn_inputs(rs, len(anchors))
    gts, gt_mask = _gt_batch(rs)
    valid = np.ones((2, len(anchors)), bool)
    kw = dict(gamma=1.0, atss=True, loss_bbox_type="giou", loss_bbox_weight=2.0,
              with_aug_loss=aug)
    cfg_j, cfg_t = j_atss.ATSSRPNCfg(**kw), t_atss.ATSSRPNCfg(**kw)
    fixed = [anchors, valid, gts, gt_mask]

    def j_total(c, r, i):
        out = j_atss.atss_rpn_loss(cfg_j, c, r, i, *map(jnp.asarray, fixed), nla)
        return sum(out.values()), out

    _check_loss(j_total, lambda c, r, i: t_atss.atss_rpn_loss(cfg_t, c, r, i, *map(_t, fixed),
                                                              nla), [cls, reg, iou])
    with pytest.raises(ValueError, match="num_level_anchors"):
        t_atss.atss_rpn_loss(cfg_t, *map(_t, (cls, reg, iou)), *map(_t, fixed))


def test_stacked_rpn_convs_match_jax():
    rs = np.random.RandomState(5)
    jconv = j_rpn.RPNConvs(num_anchors=9, feat_channels=16, num_convs=4)
    feats = [rs.randn(2, s, s + 2, 16).astype(np.float32) for s in (8, 4)]
    shapes = jax.eval_shape(jconv.init, jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])
    variables = _random_variables(shapes, rs)
    ref_cls, ref_reg, _ = jconv.apply(jax.tree.map(jnp.asarray, variables),
                                      [jnp.asarray(f) for f in feats])
    conv = t_rpn.RPNConvs(torch.Generator(), 16, 9, 16, num_convs=4)
    assert conv.conv_names == ["rpn_conv", "rpn_conv_1", "rpn_conv_2", "rpn_conv_3"]
    conv.load_state_dict(from_jax_params(variables), strict=True)
    got_cls, got_reg, _ = conv([_t(f).permute(0, 3, 1, 2) for f in feats])
    for got, ref in zip(got_cls + got_reg, list(ref_cls) + list(ref_reg)):
        _close(got.permute(0, 2, 3, 1), ref, 1e-5)


def test_mmdet_stacked_rpn_maps_to_the_port():
    """mmdet's ``RPNHead(num_convs=4)`` keeps its convs in one
    ``nn.Sequential`` of ConvModules, ``rpn_head.rpn_conv.N.conv``: they
    map to ``rpn.rpn_conv`` and ``rpn.rpn_conv_N``."""
    mc = tiny_cascade(load_config(config_path(RETINA_CONFIG)).model.to_dict())
    net = build_detector(mc, device="cpu", seed=3).net
    own = {k: v for k, v in net.state_dict().items() if k.startswith("rpn.")}
    mmdet = {}
    for key, value in own.items():
        name, leaf = key[len("rpn."):].rsplit(".", 1)
        if name.startswith("rpn_conv"):
            i = name[len("rpn_conv_"):] or "0"
            mmdet[f"rpn_head.rpn_conv.{i}.conv.{leaf}"] = value.clone()
        else:
            mmdet[f"rpn_head.{name}.{leaf}"] = value.clone()
    assert sum(k.startswith("rpn_head.rpn_conv.") for k in mmdet) == 8
    got = from_mmdet_state_dict(mmdet)
    assert set(got) == set(own)
    for key, value in own.items():
        assert torch.equal(got[key], value), key


def test_boost_sampling_and_fusion_match_jax():
    """``sample_rois_boost`` and ``boost_fuse_scores`` on the inputs of the
    JAX package's ``test_boost_roi_head_multiclass_prior`` (one gt, a
    proposal on it and two far away, 3 classes, 4 slots), the sampler fed
    the uniforms of JAX's key."""
    kw = dict(num_samples=4, pos_fraction=0.5, pos_iou_thr=0.5, neg_iou_thr=0.5,
              min_pos_iou=0.5)
    props = np.asarray([[0.0, 0, 48, 50], [60, 60, 90, 90], [62, 60, 92, 90]], np.float32)
    cls_scores = np.asarray([[0.7, 0.2, 0.1], [0.3, 0.8, 0.4], [0.3, 0.5, 0.8]], np.float32)
    pvalid = np.ones(3, bool)
    gts, gmask, glab = np.asarray([[0.0, 0, 50, 50]], np.float32), np.asarray([True]), \
        np.asarray([0])
    key = jax.random.PRNGKey(0)
    ref = j_prob.sample_rois_boost(j_prob.ProbRoICfg(add_gt_as_proposals=True, **kw), key,
                                   *map(jnp.asarray, (props, cls_scores, pvalid, gts, gmask,
                                                      glab)))
    kp, kn = jax.random.split(key)
    uniforms = tuple(_t(np.asarray(jax.random.uniform(k, (4,)))) for k in (kp, kn))
    got = t_prob.sample_rois_boost(t_prob.ProbRoICfg(**kw), *map(_t, (props, cls_scores, pvalid,
                                                                     gts, gmask, glab)),
                                   uniforms=uniforms)
    assert bool(np.asarray(ref.is_pos).any()) and bool((np.asarray(ref.prior) > 0).any())
    for name in ref._fields:
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        if name == "matched_label":
            r, g = np.where(ref.is_pos, r, -1), np.where(ref.is_pos, g, -1)
        np.testing.assert_allclose(g, r.astype(g.dtype), rtol=0, atol=1e-7, err_msg=name)

    rs = np.random.RandomState(6)
    cls, prior = rs.randn(16, 4).astype(np.float32), rs.rand(16, 3).astype(np.float32)
    _close(t_prob.boost_fuse_scores(_t(cls), _t(prior)),
           j_prob.boost_fuse_scores(jnp.asarray(cls), jnp.asarray(prior)), 1e-6)


@pytest.mark.parametrize("name", FORK_HEADS)
def test_tiny_fork_head_matches_jax_shrink(name):
    path = config_path(name)
    jdet = jax_build(jax_shrink(jax_load_config(path).model.to_dict()))
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), runner.TINY_CANVAS))
    state = from_jax_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    net = build_detector(runner.model_config(load_config(path), tiny=True), device="cpu").net
    own = net.state_dict()
    assert set(state) == set(own)
    for k, v in own.items():
        assert tuple(state[k].shape) in (tuple(v.shape), (1,) * (v.dim() == 0)), k
        assert state[k].dtype == v.dtype, k
    copy.deepcopy(net).load_state_dict(state, strict=True)
    assert own["rpn.rpn_cls.weight"].shape[1] == 32


# ----------------------------------------------------- whole tiny detectors
def _cascade(name):
    def make(load):
        return tiny_cascade(load(config_path(name)).model.to_dict())
    return make


@pytest.fixture(scope="module")
def atss_run():
    # seed 2: seed 0's weights put one of layer2_0's conv1 outputs 2.1e-7
    # from its ReLU's edge, where the two packages' float32 sums take
    # opposite signs (step 0's update of that channel then differs by 16
    # times the per-tensor tolerance); at seed 1 one train proposal of the
    # second image differs (a float32 near-tie in its top-k or NMS), which
    # shifts that image's stage-0 candidates by one.  Float32 edges, both
    return run_cascade_pair(_cascade(ATSS_CONFIG), seed=2)


@pytest.fixture(scope="module")
def retina_run():
    return run_cascade_pair(_cascade(RETINA_CONFIG))


def test_cascade_atss_config(atss_run):
    det = atss_run["tdet"]
    r = det.rpn_cfg
    assert det.rpn_type == "atss_rpn" and r.atss and r.loss_bbox_type == "giou"
    assert not r.with_aug_loss and det.cascade_cfg.prob and det.cascade_cfg.boost


def test_cascade_retinanet_config(retina_run):
    det = retina_run["tdet"]
    r = det.rpn_cfg
    assert det.rpn_type == "rpn" and (r.loss_cls_type, r.loss_cls_weight) == ("focal", 0.5)
    assert det.net.rpn.conv_names == ["rpn_conv", "rpn_conv_1", "rpn_conv_2", "rpn_conv_3"]
    assert abs(r.smooth_l1_beta - 1 / 9) < 1e-12


@pytest.mark.parametrize("model", ["atss", "retina"])
def test_ensemble_cascade_predict_matches_jax(model, request):
    check_predict(request.getfixturevalue(f"{model}_run"))


@pytest.mark.parametrize("model", ["atss", "retina"])
def test_ensemble_cascade_samples_match_jax(model, request):
    check_samples(request.getfixturevalue(f"{model}_run"))


@pytest.mark.parametrize("model", ["atss", "retina"])
def test_ensemble_cascade_losses_match_jax(model, request):
    check_cascade_losses(request.getfixturevalue(f"{model}_run"))


@pytest.mark.parametrize("model", ["atss", "retina"])
def test_ensemble_cascade_gradients_match_jax(model, request):
    check_gradients(request.getfixturevalue(f"{model}_run"))


@pytest.mark.parametrize("model", ["atss", "retina"])
@pytest.mark.parametrize("step", [0, 1])
def test_ensemble_cascade_sgd_steps_match_jax(model, step, request):
    run = request.getfixturevalue(f"{model}_run")
    check_step(run, step, check_cascade_losses(run))


def _boosting(load):
    mc = load(config_path(BOOST_CONFIG)).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"]["in_channels"] = [8, 16, 32, 64]
    mc["roi_head"]["bbox_roi_extractor"]["out_channels"] = 32
    return shrink_heads(mc)


@pytest.fixture(scope="module")
def boost_run():
    """``predict`` and the losses of both packages on the same weights,
    batch, ``RoISample`` (JAX's ``train_sample``) and RPN draws."""
    mc = _boosting(jax_load_config)
    jdet = jax_build(mc, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    rs = np.random.RandomState(0)
    variables = _random_variables(shapes, rs)
    batch = _batch(rs, 4)
    jv, jb = (jax.tree.map(jnp.asarray, x) for x in (variables, batch))
    anchors, nla = jdet.anchors_for(CANVAS)
    rng = jax.random.PRNGKey(3)
    tdet = build_detector(_boosting(load_config), device="cpu")
    tdet.net.load_state_dict(from_jax_params(variables), strict=True)
    t_anchors, t_nla = tdet.anchors_for(CANVAS)
    sample = jax.jit(lambda v: jdet.train_sample(v, rng, jb, anchors, nla))(jv)
    j_losses = jax.jit(lambda v: jdet.loss(v, rng, jb, anchors, nla, sample=sample))(jv)
    return dict(tdet=tdet, sample0=sample, j_losses=j_losses,
                j_pred=jax.jit(lambda v: jdet.predict(v, jb, anchors, nla))(jv),
                t_pred=tdet.predict(batch, t_anchors, t_nla),
                t_losses=tdet.loss(batch, t_anchors, t_nla,
                                   sample=tuple(np.array(x) for x in sample),
                                   rpn_uniforms=_rpn_uniforms(rng, anchors.shape[0])))


def test_boosting_rcnn_ensemble_predict_and_loss_match_jax(boost_run):
    det = boost_run["tdet"]
    assert (det.roi_cfg.prob, det.roi_cfg.boost, det.rpn_cfg.loss_cls_type) == (True, False,
                                                                                "focal")
    check_predict(boost_run)
    check_losses(boost_run, ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox"))
