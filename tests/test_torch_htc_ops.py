"""HTC's and Cascade Mask R-CNN's modules in the PyTorch port against the
JAX package's, on the CPU, and the builder and weights for them.

Modules on random inputs made with numpy from a seed, within 1e-5 of the
largest value: ``HTCMaskHead`` with and without a running feature, each
return flag; ``FusedSemanticHead`` on five FPN-shaped levels;
``semantic_seg_loss`` with ignored (255) and out-of-range pixels and its
gradient; the stuff map's nearest resize against ``jax.image.resize``;
the one-level semantic pooling at 7 and 14 (RoIs wider than the 24-cell
window among them) against JAX's ``multilevel_roi_align_fast((f,), ...,
num_route_levels=1)``, forward and gradient.

The builder: ``htc_r50_fpn_1x_coco.py``, ``htc_without_semantic_...``
and ``cascade_mask_rcnn_r50_fpn_1x_coco.py`` at full width, and what it
rejects.  Weights: the tiny HTC's flax tree into the port through
``from_jax_params`` with ``strict=True`` (stage 0's head has no
``conv_res`` in either); ``tests/test_torch_mmdet_weights.py`` loads
mmdet's per-stage mask head and semantic head keys.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from boosting_rcnn_tpu.builder import build_detector as jax_build  # noqa: E402
from boosting_rcnn_tpu.config import load_config as jax_load_config  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads import mask_head as j_mask  # noqa: E402
from boosting_rcnn_tpu.ops import roi_align as j_roi  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.models.detectors.htc import HTCDetector  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads import mask_head as t_mask  # noqa: E402
from boosting_rcnn_tpu_torch.ops.roi_align_kernel import batched_multilevel_roi_align  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402
from test_torch_boosting_detectors import CANVAS, _random_variables, config_path  # noqa: E402
from test_torch_htc import tiny_htc  # noqa: E402
from test_torch_mask_ops import _close, _load, _params  # noqa: E402

HTC = "htc/htc_r50_fpn_1x_coco.py"
HTC_NOSEM = "htc/htc_without_semantic_r50_fpn_1x_coco.py"
CASCADE_MASK = "cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py"
# FPN levels of a 128 x 160 canvas, strides 4-64
LEVEL_HW = ((32, 40), (16, 20), (8, 10), (4, 5), (2, 3))


# ------------------------------------------------------------------ heads
@pytest.fixture(scope="module")
def htc_head_case():
    """A stage-1 HTC mask head (with ``conv_res``) on 16-channel pooled
    features and an 8-channel running feature."""
    rs = np.random.RandomState(3)
    pooled = rs.randn(5, 14, 14, 16).astype(np.float32)
    res = rs.randn(5, 14, 14, 8).astype(np.float32)
    jhead = j_mask.HTCMaskHead(num_classes=4, num_convs=2, conv_channels=8)
    variables = _params(jhead, rs, pooled, res)
    head = _load(t_mask.HTCMaskHead(torch.Generator(), 4, 16, 2, 8, res_channels=8), variables)
    return pooled, res, jhead, variables, head


@pytest.mark.parametrize("flags", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("with_res", [True, False])
def test_htc_mask_head_matches_jax(htc_head_case, flags, with_res):
    pooled, res, jhead, variables, head = htc_head_case
    logits, feat = flags
    ref = jhead.apply(variables, jnp.asarray(pooled), jnp.asarray(res) if with_res else None,
                      return_logits=logits, return_feat=feat)
    with torch.no_grad():
        got = head(torch.from_numpy(pooled), torch.from_numpy(res) if with_res else None,
                   return_logits=logits, return_feat=feat)
    ref, got = (x if isinstance(x, tuple) else (x,) for x in (ref, got))
    assert len(got) == len(ref) == logits + feat
    shapes = [(5, 28, 28, 4)] * logits + [(5, 14, 14, 8)] * feat
    for g, r, shape in zip(got, ref, shapes):
        assert tuple(g.shape) == r.shape == shape and g.dtype == torch.float32
        _close(g.numpy(), r, 1e-5)


def test_stage0_htc_mask_head_owns_no_conv_res():
    """flax creates ``conv_res`` only when a running feature is passed: a
    head called without one (stage 0) has none, and neither has the
    port's, so that ``load_state_dict(strict=True)`` holds."""
    rs = np.random.RandomState(4)
    pooled = rs.randn(3, 14, 14, 16).astype(np.float32)
    jhead = j_mask.HTCMaskHead(num_classes=4, num_convs=1, conv_channels=8)
    variables = _params(jhead, rs, pooled)
    assert set(variables["params"]) == {"conv_0", "upsample", "conv_logits"}
    head = _load(t_mask.HTCMaskHead(torch.Generator(), 4, 16, 1, 8), variables)
    assert head.conv_res is None
    with pytest.raises(ValueError, match="conv_res"):
        head(torch.from_numpy(pooled), torch.zeros(3, 14, 14, 8))


def _levels(rs, c=16, b=2):
    return [rs.randn(b, h, w, c).astype(np.float32) for h, w in LEVEL_HW]


def test_fused_semantic_head_matches_jax():
    rs = np.random.RandomState(5)
    feats = _levels(rs)
    jhead = j_mask.FusedSemanticHead(num_classes=6, fusion_level=1, num_convs=2, channels=16)
    variables = _params(jhead, rs, [jnp.asarray(f) for f in feats])
    ref_seg, ref_emb = jhead.apply(variables, [jnp.asarray(f) for f in feats])
    head = _load(t_mask.FusedSemanticHead(torch.Generator(), num_ins=5, in_channels=16,
                                          num_classes=6, fusion_level=1, num_convs=2,
                                          channels=16), variables)
    with torch.no_grad():
        seg, emb = head([torch.from_numpy(f) for f in feats])
    assert tuple(seg.shape) == ref_seg.shape == (2, 16, 20, 6) and seg.dtype == torch.float32
    assert tuple(emb.shape) == ref_emb.shape == (2, 16, 20, 16)
    _close(seg.numpy(), ref_seg, 1e-5)
    _close(emb.numpy(), ref_emb, 1e-5)


def test_semantic_seg_loss_and_gradient_match_jax():
    rs = np.random.RandomState(6)
    logits = (rs.randn(2, 16, 20, 6) * 2).astype(np.float32)
    gt = rs.randint(0, 6, (2, 16, 20)).astype(np.int32)
    gt[0, :4] = 255  # ignored
    gt[1, 2, :5] = 7  # out of range: ignored as well
    ref, ref_g = jax.value_and_grad(j_mask.semantic_seg_loss)(jnp.asarray(logits),
                                                              jnp.asarray(gt))
    x = torch.from_numpy(logits).requires_grad_()
    got = t_mask.semantic_seg_loss(x, torch.from_numpy(gt))
    got.backward()
    _close(got.detach().numpy(), ref, 1e-5)
    _close(x.grad.numpy(), ref_g, 1e-5)
    assert float(ref) > 0
    all_ignored = t_mask.semantic_seg_loss(x.detach(), torch.full((2, 16, 20), 255))
    assert float(all_ignored) == 0.0  # divided by at least one pixel


@pytest.mark.parametrize("src", [(32, 40), (16, 20), (13, 21), (7, 9)])
def test_stuff_map_nearest_resize_matches_jax(src):
    rs = np.random.RandomState(7)
    gt = rs.randint(0, 200, (2,) + src).astype(np.int32)
    ref = jax.image.resize(jnp.asarray(gt).astype(jnp.float32), (2, 16, 20),
                           "nearest").astype(jnp.int32)
    got = t_mask.resize_nearest(torch.from_numpy(gt), (16, 20))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------- one-level pooling
def _semantic_case(seed, out_size):
    """A stride-8 embedding (2, 16, 20, 16) and 7 RoIs an image: small ones,
    ones wider than the 24-cell window (up to the whole image), one on
    the border, the last invalid."""
    rs = np.random.RandomState(seed)
    sem = rs.randn(2, 16, 20, 16).astype(np.float32)
    cx, cy = rs.uniform(10, 150, (2, 7)), rs.uniform(10, 118, (2, 7))
    bw, bh = rs.uniform(6, 60, (2, 7)), rs.uniform(6, 60, (2, 7))
    rois = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    rois[:, 4] = [0.0, 0.0, 160.0, 128.0]
    rois[:, 5] = [100.0, 2.0, 159.5, 127.0]
    rois = rois.astype(np.float32)
    valid = np.ones((2, 7), bool)
    valid[:, -1] = False
    g = rs.randn(2, 7, out_size, out_size, 16).astype(np.float32)
    return sem, rois, valid, g


@pytest.mark.parametrize("out_size", [7, 14])
def test_one_level_semantic_pooling_matches_jax(out_size):
    """The semantic embedding as one route level at stride 8, forward and
    gradient, against the XLA function that the JAX HTC pools it with."""
    sem, rois, valid, g = _semantic_case(8 + out_size, out_size)

    def ref_fn(f):
        return jax.vmap(lambda fl, rb, vb: j_roi.multilevel_roi_align_fast(
            (fl,), rb, vb, (8,), out_size=out_size, sample_num=2, finest_scale=56,
            num_route_levels=1))(f, jnp.asarray(rois), jnp.asarray(valid))

    ref, vjp = jax.vjp(ref_fn, jnp.asarray(sem))
    (ref_g,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(sem).requires_grad_()
    got = batched_multilevel_roi_align([x], torch.from_numpy(rois), torch.from_numpy(valid),
                                       (8,), out_size=out_size, num_route_levels=1)
    assert tuple(got.shape) == ref.shape == (2, 7, out_size, out_size, 16)
    _close(got.detach().numpy(), ref, 1e-5)
    assert not got[:, -1].any()
    got.backward(torch.from_numpy(g))
    _close(x.grad.numpy(), ref_g, 1e-5)


# ----------------------------------------------------------------- builder
def _model(name, load=load_config):
    return load(config_path(name)).model.to_dict()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", [HTC, HTC_NOSEM, CASCADE_MASK])
def test_builder_builds_full_width_htc_and_cascade_mask(name):
    det = build_detector(_model(name), device="cpu")
    assert isinstance(det, HTCDetector) and det.rpn_type == "rpn"
    net, cc = det.net, det.cascade_cfg
    htc = name.startswith("htc/")
    assert (cc.num_stages, cc.stage_pos_iou, cc.stage_loss_weights) == (
        3, (0.5, 0.6, 0.7), (1.0, 0.5, 0.25))
    assert (cc.interleaved, net.mask_info_flow, cc.prob, cc.boost) == (htc, htc, False, False)
    assert net.roi_strides == (4, 8, 16, 32) and net.mask_roi_out_size == 14
    assert len(net.mask_heads) == 3
    for i, head in enumerate(net.mask_heads):
        assert head.num_convs == 4 and tuple(head.conv_logits.weight.shape[:2]) == (80, 256)
        assert (head.conv_res is not None) == (htc and i > 0)
    if name == HTC:
        sem = net.semantic_head
        assert net.semantic_stride == 8 and sem.fusion_level == 1 and sem.num_convs == 4
        assert tuple(sem.conv_seg.weight.shape[:2]) == (183, 256)
        assert [hasattr(sem, f"lateral_{i}") for i in range(6)] == [True] * 5 + [False]
    else:
        assert net.semantic_head is None


@pytest.mark.parametrize("edit, match", [
    (lambda roi: roi["mask_head"][1].update(predictor_cfg=dict(type="NormedConv2d",
                                                               power=2.0)),
     "predictor_cfg"),
    (lambda roi: roi["mask_head"][0].update(norm_cfg=dict(type="GN", num_groups=32)),
     "norm_cfg"),
    (lambda roi: roi["semantic_head"].update(loss_seg=dict(type="CrossEntropyLoss",
                                                           ignore_index=0, loss_weight=0.2)),
     "ignore_index"),
    (lambda roi: roi["semantic_head"].update(num_ins=4), "num_ins"),
    (lambda roi: roi["semantic_roi_extractor"].update(featmap_strides=[4, 8]),
     "featmap_strides"),
    (lambda roi: roi["mask_roi_extractor"]["roi_layer"].update(output_size=7), "output_size"),
])
def test_builder_rejects_unported_htc_values(edit, match):
    mc = _model(HTC)
    edit(mc["roi_head"])
    with pytest.raises(NotImplementedError, match=match):
        build_detector(mc, device="cpu")


def test_builder_rejects_a_semantic_embedding_of_other_width():
    mc = tiny_htc(_model(HTC))
    mc["roi_head"]["semantic_head"]["conv_out_channels"] = 8
    with pytest.raises(ValueError, match="conv_out_channels=8"):
        build_detector(mc, device="cpu")


# ----------------------------------------------------------------- weights
@pytest.mark.parametrize("name", [HTC, CASCADE_MASK])
def test_flax_tree_loads_strictly(name):
    """The tiny model's flax tree (shapes by ``jax.eval_shape``) maps onto
    the port's parameters one to one: ``mask_heads_N`` -> ``mask_heads.N``,
    ``semantic_head`` as it is; no head owns a ``conv_res`` that the tree
    lacks."""
    jdet = jax_build(tiny_htc(_model(name, jax_load_config)))
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    params = shapes["params"]
    assert set(params["mask_heads_0"]) == {"conv_0", "upsample", "conv_logits"}
    variables = _random_variables(shapes, np.random.RandomState(1))
    det = build_detector(tiny_htc(_model(name)), device="cpu")
    state = from_jax_params(variables)
    det.net.load_state_dict(state, strict=True)
    keys = {k.split(".")[2] for k in state if k.startswith("mask_heads.")}
    assert keys == {"conv_0", "upsample", "conv_logits"} | (
        {"conv_res"} if name == HTC else set())
    assert not any(k.startswith("mask_heads.0.conv_res") for k in state)
    assert any(k.startswith("semantic_head.lateral_4.") for k in state) == (name == HTC)
    for k, v in det.net.state_dict().items():
        assert torch.equal(v, state[k]), k

