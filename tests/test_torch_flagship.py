"""The PyTorch port's flagship inference against the JAX package, on the CPU.

The tiny flagship (``_build(tiny=True)``'s overrides of
``boosting_rcnn_r50_pafpn_1x_utdac.py``: ResNet-18 at width 8, PAFPN 32,
RPN 32 x 2, FC 64) gets random weights made with numpy from a seed, which
go to the JAX package as flax variables and to the port through
``weights.from_jax_params``.  Both see the same images.  Stage by stage:

  * C2-C5 and P3-P7: rtol 1e-4 (atol 1e-4 of the level's largest value);
  * RPN cls/reg/iou maps: the same;
  * proposals: the same set of valid boxes, within 1e-3 px;
  * the JAX proposals through the port's RoI stage: ``dets`` within 1e-4,
    ``labels`` and ``valid`` equal (so that a flip between two near-equal
    scores in the RPN top-k cannot decide the test);
  * ``predict`` end to end: ``labels`` and ``valid`` equal, ``dets`` within
    1e-3.
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

from boosting_rcnn_tpu.builder import build_detector as jax_build  # noqa: E402
from boosting_rcnn_tpu.config import load_config as jax_load_config  # noqa: E402
from boosting_rcnn_tpu.models.detectors.two_stage import TwoStageNet  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads.bbox_head import bbox_head_decode  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads.prob_roi_head import prob_fuse_scores  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402

CONFIG = os.path.join(REPO, "configs/boosting_rcnn/boosting_rcnn_r50_pafpn_1x_utdac.py")
CANVAS = (128, 160)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread: beside the suite's other pytest
    workers, torch's default of a thread a core oversubscribes the host
    (this file's cases ran several times slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(mc):
    """The overrides of ``__graft_entry__._build(tiny=True)`` (copied: that
    module switches on the in-repo compile cache)."""
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"].update(in_channels=[8, 16, 32, 64], out_channels=32)
    mc["rpn_head"].update(feat_channels=32, stacked_convs=2)
    mc["roi_head"]["bbox_head"]["fc_out_channels"] = 64
    mc["train_cfg"]["rpn_proposal"].update(nms_pre=200, max_per_img=64)
    mc["train_cfg"]["rcnn"]["sampler"]["num"] = 32
    mc["test_cfg"]["rpn"].update(nms_pre=100, max_per_img=32)
    return mc


def _random_variables(shapes, rs):
    """flax variables of the given shapes: LeCun-scaled kernels, biases and
    norm parameters drawn around their init so every mapping is seen."""
    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        shape = s.shape
        if name.endswith("['kernel']"):
            return rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        if name.endswith("['var']"):
            return rs.uniform(0.5, 1.5, shape)
        if name.endswith("['scale']"):
            return 1.0 + 0.1 * rs.randn(*shape)
        if "rpn_cls" in name:
            return -2.0 + 0.1 * rs.randn(*shape)
        return 0.1 * rs.randn(*shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


@pytest.fixture(scope="module")
def pair():
    mc = _tiny(jax_load_config(CONFIG).model.to_dict())
    jdet = jax_build(mc, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    rs = np.random.RandomState(0)
    variables = _random_variables(shapes, rs)
    tdet = build_detector(_tiny(load_config(CONFIG).model.to_dict()), device="cpu")
    tdet.net.load_state_dict(from_jax_params(variables), strict=True)
    images = rs.rand(2, *CANVAS, 3).astype(np.float32) * 2.0 - 1.0
    batch = {
        "images": images,
        "img_shape": np.array([[128.0, 150.0], [116.0, 160.0]], np.float32),
        "scale_factor": np.array([[1.0] * 4, [1.25] * 4], np.float32),
    }
    jv = jax.tree.map(jnp.asarray, variables)
    anchors, nla = jdet.anchors_for(CANVAS)
    return jdet, jv, tdet, batch, anchors, nla


def _jit_apply(jdet, method):
    return jax.jit(lambda v, *a: jdet.net.apply(v, *a, method=method))


def _close(got, ref, rtol=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _port_feats(tdet, batch):
    with torch.inference_mode():
        return tdet.net.features(torch.from_numpy(batch["images"]))


def test_backbone_and_neck_levels(pair):
    jdet, jv, tdet, batch, _, _ = pair
    images = jnp.asarray(batch["images"])
    c_ref = _jit_apply(jdet, lambda m, x: m.backbone(x))(jv, images)
    p_ref = _jit_apply(jdet, TwoStageNet.features)(jv, images)
    with torch.inference_mode():
        c_got = tuple(x.permute(0, 2, 3, 1) for x in tdet.net.backbone(
            torch.from_numpy(batch["images"]).permute(0, 3, 1, 2)))
    p_got = _port_feats(tdet, batch)
    assert len(c_got) == 4 and len(p_got) == 5
    for got, ref in zip(c_got + p_got, tuple(c_ref) + tuple(p_ref)):
        assert tuple(got.shape) == ref.shape
        _close(got.numpy(), ref)


def test_rpn_outputs(pair):
    jdet, jv, tdet, batch, _, _ = pair
    feats = _jit_apply(jdet, TwoStageNet.features)(jv, jnp.asarray(batch["images"]))
    ref = _jit_apply(jdet, TwoStageNet.rpn_out)(jv, feats)
    with torch.inference_mode():
        got = tdet.net.rpn_out([torch.from_numpy(np.array(f)) for f in feats])
    for got_l, ref_l in zip(got, ref):
        for g, r in zip(got_l, ref_l):
            _close(g.permute(0, 2, 3, 1).numpy(), r)


def _jax_proposals(jdet, jv, batch, anchors, nla):
    @jax.jit
    def run(v, images, img_shape):
        feats = jdet.net.apply(v, images, method=TwoStageNet.features)
        cls, reg, iou = jdet._rpn_flat(v, feats)
        return jdet._proposals(cls, reg, iou, anchors, nla, img_shape,
                               jdet.test_proposal_cfg), (cls, reg, iou)

    return run(jv, jnp.asarray(batch["images"]), jnp.asarray(batch["img_shape"]))


def test_proposals_same_set(pair):
    jdet, jv, tdet, batch, anchors, nla = pair
    (jb, js, jval), _ = _jax_proposals(jdet, jv, batch, anchors, nla)
    _, tb, ts, tval = tdet.proposals(batch["images"], batch["img_shape"],
                                     np.array(anchors), nla)
    for i in range(2):
        ref = np.asarray(jb[i])[np.asarray(jval[i])]
        got = tb[i][tval[i]].numpy()
        assert len(got) == len(ref) > 0
        # same set: every reference box has a port box within 1e-3 px
        dist = np.abs(ref[:, None, :] - got[None, :, :]).max(-1)
        assert dist.min(1).max() < 1e-3
        assert sorted(dist.argmin(1).tolist()) == list(range(len(got)))
        np.testing.assert_allclose(np.sort(ts[i][tval[i]].numpy()),
                                   np.sort(np.asarray(js[i])[np.asarray(jval[i])]),
                                   rtol=1e-4)


def test_roi_stage_on_jax_proposals(pair):
    jdet, jv, tdet, batch, anchors, nla = pair
    (jb, js, jval), _ = _jax_proposals(jdet, jv, batch, anchors, nla)
    tc = jdet.rcnn_test_cfg

    @jax.jit
    def jax_roi(v, images, boxes, scores, valid, img_shape, scale_factor):
        feats = jdet.net.apply(v, images, method=TwoStageNet.features)
        cls_s, reg_s = jdet.net.apply(v, feats, boxes, valid, inference=True,
                                      method=TwoStageNet.roi_out)
        b, r = boxes.shape[:2]
        fused = jax.vmap(prob_fuse_scores)(cls_s.reshape(b, r, -1), scores)
        return jax.vmap(lambda ro, sc, bp, rv, shp, sf: bbox_head_decode(
            jdet.bbox_cfg, ro, sc, bp, shp, sf, True, tc.score_thr, tc.nms_iou_thr,
            tc.max_per_img, roi_valid=rv, pre_nms_top_k=tc.pre_nms_top_k,
        ))(boxes, fused, reg_s.reshape(b, r, -1), valid, img_shape, scale_factor)

    ref = jax_roi(jv, jnp.asarray(batch["images"]), jb, js, jval,
                  jnp.asarray(batch["img_shape"]), jnp.asarray(batch["scale_factor"]))
    feats = _port_feats(tdet, batch)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    dets, labels, valid = tdet.roi_predict(
        feats, t(jb), t(js), t(jval), t(batch["img_shape"]), t(batch["scale_factor"]))
    assert valid.any()
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(dets.numpy(), np.asarray(ref[0]), rtol=0, atol=1e-4)


def test_predict_end_to_end(pair):
    jdet, jv, tdet, batch, anchors, nla = pair
    ref = jax.jit(lambda v, b: jdet.predict(v, b, anchors, nla))(
        jv, jax.tree.map(jnp.asarray, batch))
    t_anchors, t_nla = tdet.anchors_for(CANVAS)
    assert t_nla == nla
    dets, labels, valid = tdet.predict(batch, t_anchors, t_nla)
    assert valid.any()
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(dets.numpy(), np.asarray(ref[0]), rtol=0, atol=1e-3)
