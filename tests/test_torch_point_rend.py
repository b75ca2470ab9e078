"""PointRend in the PyTorch port against the JAX package's, on the CPU.

The point ops, on inputs made with numpy from a seed, within 1e-6 (of the
largest value where values are logits):

  * ``point_sample`` (points past the borders among them) and
    ``rel_roi_point_to_rel_img_point``;
  * ``get_train_points`` fed the JAX function's own two uniform draws;
  * ``upsample2x`` against ``jax.image.resize(..., "bilinear")`` at scale 2
    (XLA's matrix products sum in another order: values 2 ulps apart);
  * ``subdivision_refine`` with a point function, on random logits and on
    small integers, whose upsampling is exact in both packages and whose
    uncertainties tie in whole blocks: the stable descending sort takes the
    cells ``jax.lax.top_k`` takes, bit for bit;
  * ``sample_gt_mask_at_points``;
  * ``CoarseMaskHead`` and ``MaskPointHead`` against the flax modules,
    values and input gradients (1e-5).

The tiny PointRend (``configs/point_rend/point_rend_r50_fpn_1x_coco.py``
at ``tests/test_torch_mask_rcnn.py``'s size: ResNet-18 at width 8, FPN
32, 4 classes; the coarse head's FCs of 16, the point head's of 16) on
``tests/test_torch_c4_dc5.py::run_fused_pair``: ``predict`` (labels and
valid equal, detections within 1e-3, the masks ``(2, 20, 224, 224)``
within 1e-4 where the subdivision's top-k picks the same cells), the six losses on JAX's ``RoISample``, RPN draws and point
draws (rtol 1e-4), every gradient and the parameters after two SGD steps
at the detectors harness's tolerances; in bfloat16 the coarse head's
``mask_out`` and the point head on the JAX bfloat16 build's levels and
detections (1.5% of the largest value, closer than the port's float32
build) and the six losses (1.5%).

Masks of any size through evaluation: ``paste_mask`` of 14 x 14 and
224 x 224 masks against the JAX package's (cv2), and ``run_eval`` of the
tiny C4 Mask R-CNN and PointRend over a synthetic COCO set, with segm
evaluation.
"""
import os
import sys

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""  # no compile-cache writes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from boosting_rcnn_tpu.data import mask_utils as j_mask_utils  # noqa: E402
from boosting_rcnn_tpu.models.detectors.two_stage import TwoStageNet  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads import point_rend as j_pr  # noqa: E402
from boosting_rcnn_tpu.ops import pallas_roi_align as j_pallas  # noqa: E402
from boosting_rcnn_tpu.ops import point_sample as j_ps  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.data import mask_utils as t_mask_utils  # noqa: E402
from boosting_rcnn_tpu_torch.data.coco import CocoDataset  # noqa: E402
from boosting_rcnn_tpu_torch.data.loader import DetDataLoader  # noqa: E402
from boosting_rcnn_tpu_torch.data.synthetic import generate  # noqa: E402
from boosting_rcnn_tpu_torch.engine.eval import run_eval  # noqa: E402
from boosting_rcnn_tpu_torch.engine.runner import shrink_model  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads import point_rend as t_pr  # noqa: E402
from boosting_rcnn_tpu_torch.ops import point_sample as t_ps  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402

from test_torch_boosting_detectors import (  # noqa: E402
    _random_variables,
    check_gradients,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
)
from test_torch_c4_dc5 import (  # noqa: E402
    BF16,
    BF16_TOL,
    C4_MASK,
    CANVAS,
    _jit,
    bf16_losses,
    check_losses,
    run_fused_pair,
)
from test_torch_mask_rcnn import _tiny  # noqa: E402

POINT_REND = "point_rend/point_rend_r50_fpn_1x_coco.py"
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "loss_mask", "loss_point")
CFG, T_CFG = j_pr.PointRendCfg(), t_pr.PointRendCfg()


def _close(got, ref, rel=1e-6, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-12),
                               err_msg=what)


# ----------------------------------------------------------------- point ops
def test_point_sample_matches_jax():
    rs = np.random.RandomState(0)
    feat = rs.randn(3, 9, 11, 5).astype(np.float32)
    pts = rs.uniform(-0.1, 1.1, (3, 40, 2)).astype(np.float32)  # some past the borders
    pts[0, :4] = [[0.0, 0.0], [1.0, 1.0], [0.5 / 11, 0.5 / 9], [1.0, 0.0]]
    ref = jax.vmap(j_ps.point_sample)(feat, pts)
    _close(t_ps.point_sample(torch.from_numpy(feat), torch.from_numpy(pts)), ref, 0.0)
    # a bfloat16 map gives float32 samples, as jnp's promotion does
    got = t_ps.point_sample(torch.from_numpy(feat).to(BF16), torch.from_numpy(pts))
    ref = jax.vmap(j_ps.point_sample)(jnp.asarray(feat, jnp.bfloat16), pts)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(got, ref, what="bfloat16 map")


def test_rel_roi_point_to_rel_img_point_matches_jax():
    rs = np.random.RandomState(1)
    rois = rs.uniform(0, 80, (3, 4)).astype(np.float32)
    rois[:, 2:] += rois[:, :2]
    rel = rs.uniform(0, 1, (3, 40, 2)).astype(np.float32)
    ref = jax.vmap(lambda r, p: j_ps.rel_roi_point_to_rel_img_point(r, p, (96.0, 128.0)))(
        rois, rel)
    got = t_ps.rel_roi_point_to_rel_img_point(torch.from_numpy(rois), torch.from_numpy(rel),
                                              (96.0, 128.0))
    _close(got, ref, 0.0)


def test_get_train_points_match_jax_on_its_draws():
    rs = np.random.RandomState(2)
    coarse = rs.randn(6, 7, 7, 4).astype(np.float32)
    coarse[0] = np.round(coarse[0])  # whole runs of equal uncertainty
    labels = rs.randint(-1, 5, 6).astype(np.int32)  # clamped to the classes
    key = jax.random.PRNGKey(5)
    ref = j_pr.get_train_points(CFG, key, jnp.asarray(coarse), jnp.asarray(labels))
    k1, k2 = jax.random.split(key)
    draws = [np.array(jax.random.uniform(k, (6, n, 2))) for k, n in zip((k1, k2),
                                                                      T_CFG.train_draws)]
    got = t_pr.get_train_points(T_CFG, torch.from_numpy(coarse), torch.from_numpy(labels),
                                draws)
    assert tuple(got.shape) == (6, 196, 2)
    _close(got, ref, 0.0)


@pytest.mark.parametrize("shape", [(5, 7, 9), (2, 56, 56)])
def test_upsample2x_matches_jax_image_resize(shape):
    rs = np.random.RandomState(3)
    x = (rs.randn(*shape) * 3).astype(np.float32)
    out = (shape[0], 2 * shape[1], 2 * shape[2])
    ref = jax.jit(lambda a: jax.image.resize(a, out, "bilinear"))(x)
    got = t_pr.upsample2x(torch.from_numpy(x))
    _close(got, ref, what="within 1e-6 of the largest value")
    # the borders copy their one sample, as the renormalised JAX weights do
    np.testing.assert_array_equal(got.numpy()[:, 0, 0], x[:, 0, 0])
    np.testing.assert_array_equal(got.numpy()[:, -1, -1], x[:, -1, -1])


@pytest.mark.parametrize("case", ["random", "ties"])
def test_subdivision_refine_matches_jax(case):
    rs = np.random.RandomState(4)
    if case == "ties":
        logits = rs.randint(-3, 4, (4, 7, 7)).astype(np.float32)

        def jfn(p):
            return jnp.round(p[..., 0] * 8) - 4.0

        def tfn(p):
            return torch.round(p[..., 0] * 8) - 4.0
    else:
        logits = (rs.randn(4, 7, 7) * 3).astype(np.float32)

        def jfn(p):
            return jnp.sin(p[..., 0] * 7) + jnp.cos(p[..., 1] * 5)

        def tfn(p):
            return torch.sin(p[..., 0] * 7) + torch.cos(p[..., 1] * 5)

    ref = jax.jit(lambda x: j_pr.subdivision_refine(CFG, x, jfn))(logits)
    got = t_pr.subdivision_refine(T_CFG, torch.from_numpy(logits), tfn)
    assert tuple(got.shape) == (4, 224, 224)
    if case == "ties":
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        _close(got, ref)


def test_sample_gt_mask_at_points_matches_jax():
    rs = np.random.RandomState(5)
    crops = (rs.rand(6, 28, 28) > 0.5).astype(np.uint8)
    gts = rs.uniform(0, 60, (6, 4)).astype(np.float32)
    gts[:, 2:] += gts[:, :2] + 5
    gts[5, 2:] = gts[5, :2]  # a zero-size gt: its sides floored at 1e-3
    rois = gts + rs.uniform(-6, 6, (6, 4)).astype(np.float32)
    pts = rs.uniform(0, 1, (6, 30, 2)).astype(np.float32)
    ref = jax.vmap(j_pr.sample_gt_mask_at_points)(crops, gts, rois, pts)
    got = t_pr.sample_gt_mask_at_points(*map(torch.from_numpy, (crops, gts, rois, pts)))
    _close(got, ref, 0.0)
    assert 0 < float(got.mean()) < 1


def _module_pair(jmod, tmod, inputs, seed):
    """The flax module's values and input gradients (of a seeded weighted
    sum) against the port's on the same variables."""
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs)))
    variables = _random_variables(shapes, rs)
    jv = jax.tree.map(jnp.asarray, variables)
    out_shape = jax.eval_shape(lambda *a: jmod.apply(jv, *a), *map(jnp.asarray, inputs)).shape
    w = rs.randn(*out_shape).astype(np.float32)

    def fn(*a):
        y = jmod.apply(jv, *a)
        return jnp.sum(y * jnp.asarray(w)), y

    (_, ref), grads = jax.jit(jax.value_and_grad(fn, argnums=tuple(range(len(inputs))),
                                                 has_aux=True))(*map(jnp.asarray, inputs))
    tmod.load_state_dict(from_jax_params(variables), strict=True)
    xs = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    got = tmod(*xs)
    (got * torch.from_numpy(w)).sum().backward()
    _close(got, ref, 1e-5, "values")
    for x, g in zip(xs, grads):
        _close(x.grad, g, 1e-5, "input gradient")


def test_coarse_mask_head_matches_jax():
    jmod = j_pr.CoarseMaskHead(num_classes=4, fc_channels=16)
    tmod = t_pr.CoarseMaskHead(torch.Generator().manual_seed(0), num_classes=4, in_channels=8,
                               fc_channels=16)
    x = np.random.RandomState(6).randn(5, 14, 14, 8).astype(np.float32)
    _module_pair(jmod, tmod, [x], 6)
    assert tmod(torch.from_numpy(x)).shape == (5, 7, 7, 4)


@pytest.mark.parametrize("each_layer", [True, False])
def test_mask_point_head_matches_jax(each_layer):
    jmod = j_pr.MaskPointHead(num_classes=4, fc_channels=16, coarse_pred_each_layer=each_layer)
    tmod = t_pr.MaskPointHead(torch.Generator().manual_seed(0), in_channels=8, num_classes=4,
                              fc_channels=16, coarse_pred_each_layer=each_layer)
    rs = np.random.RandomState(7)
    _module_pair(jmod, tmod, [rs.randn(30, 8).astype(np.float32),
                              rs.randn(30, 4).astype(np.float32)], 7)


# ------------------------------------------------------------ tiny PointRend
def _tiny_point_rend(load):
    mc = load(config_path(POINT_REND)).model.to_dict()
    mask_head = dict(mc["roi_head"]["mask_head"])
    mc = _tiny(mc)
    mask_head.update(in_channels=32, fc_out_channels=16, num_classes=4)
    mc["roi_head"]["mask_head"] = mask_head
    mc["roi_head"]["point_head"].update(in_channels=32, fc_channels=16, num_classes=4)
    mc["test_cfg"]["rcnn"]["max_per_img"] = 20  # 40 detections through the subdivision
    return mc


@pytest.fixture(scope="module")
def run():
    return run_fused_pair(_tiny_point_rend)


def test_point_rend_builds(run):
    det = run["tdet"]
    net = det.net
    assert type(det).__name__ == "PointRendDetector" and det.point_cfg == T_CFG
    assert isinstance(net.mask_head, t_pr.CoarseMaskHead) and net.mask_head.side == 7
    assert tuple(net.point_head.fc_0.weight.shape) == (16, 32 + 4)
    assert tuple(net.point_head.fc_logits.weight.shape) == (4, 16 + 4)


def test_point_rend_predict_matches_jax(run):
    """Detections as ``check_predict``; the coarse logits of JAX's
    detections within 1e-5 of JAX's; the masks within 1e-4 but in a few
    cells (under 1e-4 of them, each within 0.01) that the subdivision's
    top-k explains: the packages' upsampled and re-predicted logits differ
    by ulps (XLA's matrix products sum in other orders), which moves a near
    tie across the 784th place, so one package re-predicts a cell that the
    other interpolates (exact ties pick the same cells:
    ``test_subdivision_refine_matches_jax``)."""
    ref, got = run["j_pred"], run["t_pred"]
    check_predict({"j_pred": ref[:3], "t_pred": got[:3]}, min_dets=10)
    masks, ref_masks = got[3], np.asarray(ref[3])
    assert masks.dtype == torch.float32 and tuple(masks.shape) == (2, 20, 224, 224)
    assert float(masks.min()) >= 0.0 and float(masks.max()) <= 1.0
    diff = np.abs(masks.numpy() - ref_masks)
    assert (diff > 1e-4).mean() < 1e-4 and diff.max() < 0.01, ((diff > 1e-4).sum(), diff.max())
    batch, jdet = run["batch"], run["jdet"]
    rois = ref[0][..., :4] * jnp.asarray(batch["scale_factor"])[:, None, :]
    ref_coarse = jax.jit(lambda v, im: jdet.net.apply(
        v, jdet.net.apply(v, im, method=TwoStageNet.features), rois, ref[2],
        method=TwoStageNet.mask_out))(run["jv"], jnp.asarray(batch["images"]))
    with torch.inference_mode():
        feats = run["tdet"].net.features(torch.from_numpy(batch["images"]))
        coarse = run["tdet"].net.mask_out(feats, torch.from_numpy(np.array(rois)),
                                          torch.from_numpy(np.array(ref[2])))
    _close(coarse, ref_coarse, 1e-5, "coarse logits")


def test_point_rend_losses_match_jax(run):
    check_losses(run, LOSSES)


def test_point_rend_gradients_match_jax(run):
    check_gradients(run)
    g = run["t_grads"]
    assert all(g[f"point_head.{k}.weight"].abs().max() > 0 for k in ("fc_0", "fc_logits"))
    assert g["mask_head.downsample_conv.weight"].abs().max() > 0


@pytest.mark.parametrize("step", [0, 1])
def test_point_rend_sgd_steps_match_jax(run, step):
    check_step(run, step, LOSSES)


def test_point_rend_bf16_heads_and_losses_match_jax_bf16(run):
    """The coarse head's ``mask_out`` (14 x 14 RoIAlign over the FPN) and the
    point head on P2's point samples in bfloat16, on the JAX bfloat16
    build's levels and JAX's detections (every third invalid), then the
    six losses."""
    jdet = bf16_losses(run, _tiny_point_rend)
    net = jdet.net
    dets, _, valid, _ = run["j_pred"]
    rois = dets[..., :4] * jnp.asarray(run["batch"]["scale_factor"])[:, None, :]
    valid = valid & (jnp.arange(valid.shape[1]) % 3 != 0)[None]
    pts = jnp.asarray(np.random.RandomState(8).uniform(0, 1, (2, rois.shape[1], 5, 2)),
                      jnp.float32)

    @_jit
    def jax_heads(v, images, rois, valid, pts):
        feats = net.apply(v, images, method=TwoStageNet.features)
        pooled = j_pallas.batched_multilevel_roi_align_pallas(
            feats[:4], rois, valid, net.roi_strides, out_size=14, interpret=True)
        coarse = net.apply(v, pooled.reshape(-1, 14, 14, pooled.shape[-1]),
                           method=lambda m, x: m.mask_head(x))
        b, r, p = pts.shape[:3]
        coarse_at = jax.vmap(j_ps.point_sample)(coarse, pts.reshape(b * r, p, 2))
        return feats, coarse, jdet._point_logits(
            v, feats, rois, pts, coarse_at.reshape(b, r, p, -1), CANVAS)

    feats, ref_coarse, ref_points = jax_heads(run["jv"], jnp.asarray(run["batch"]["images"]),
                                              rois, valid, pts)
    levels = [torch.from_numpy(np.array(f.astype(jnp.float32))) for f in feats]
    errs = {}
    for dtype in (BF16, torch.float32):
        det = build_detector(_tiny_point_rend(load_config), device="cpu", dtype=dtype)
        det.net.load_state_dict(from_jax_params(run["variables"]), strict=True)
        lv = [f.to(dtype) for f in levels]
        with torch.inference_mode():
            coarse = det.net.mask_out(lv, torch.from_numpy(np.array(rois)),
                                      torch.from_numpy(np.array(valid)))
            b, r, p = pts.shape[:3]
            coarse_at = t_ps.point_sample(coarse, torch.from_numpy(np.array(pts)).reshape(
                b * r, p, 2))
            points = det._point_logits(lv, torch.from_numpy(np.array(rois)),
                                       torch.from_numpy(np.array(pts)),
                                       coarse_at.reshape(b, r, p, -1), CANVAS)
        errs[dtype] = max(float(np.abs(g.numpy() - np.asarray(x)).max() / np.abs(np.asarray(x)).max())
                          for g, x in ((coarse, ref_coarse), (points, ref_points)))
    assert errs[BF16] <= BF16_TOL, errs
    assert errs[BF16] < errs[torch.float32] or errs[BF16] == 0, errs


# ------------------------------------------------- masks of any size, evaluated
@pytest.mark.parametrize("size", [14, 224])
def test_paste_mask_matches_jax_at_any_size(size):
    """The port's ``paste_mask`` against the JAX package's (cv2's linear
    resize): equal but where cv2's value is within 1e-5 of the threshold
    (``tests/test_torch_mask_data.py``)."""
    pytest.importorskip("cv2")
    rs = np.random.RandomState(size)
    for _ in range(8):
        mask = rs.uniform(0, 1, (size, size)).astype(np.float32)
        box = np.sort(rs.uniform(-10, 150, 4).reshape(2, 2), axis=0).T.reshape(-1)[[0, 2, 1, 3]]
        ref = j_mask_utils.paste_mask(mask, box, 120, 140)
        got = t_mask_utils.paste_mask(mask, box, 120, 140)
        assert got.shape == ref.shape == (120, 140)
        assert (got != ref).mean() < 1e-3


@pytest.fixture(scope="module")
def shapes_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("point_rend"))
    generate(root, n_train=0, n_val=3, seed=2)
    return root


@pytest.mark.parametrize("name,side", [(C4_MASK, 14), (POINT_REND, 224)])
def test_run_eval_carries_masks_of_the_heads_size(shapes_set, name, side):
    mc = shrink_model(load_config(config_path(name)).model.to_dict())
    mc["backbone"]["init_cfg"] = None
    for key in ("bbox_head", "mask_head", "point_head"):
        if mc["roi_head"].get(key):
            mc["roi_head"][key]["num_classes"] = 4
    mc["test_cfg"]["rcnn"]["max_per_img"] = 20
    det = build_detector(mc, device="cpu")
    ds = CocoDataset(os.path.join(shapes_set, "val.json"), os.path.join(shapes_set, "val"),
                     test_mode=True)
    loader = DetDataLoader(ds, batch_size=2, canvas=(128, 160), scale=(160, 128), train=False)
    results = run_eval(det, loader)
    assert len(results) == 3
    for dets, labels, masks in results:
        assert masks.shape == (len(dets), side, side) and masks.dtype == np.float32
    metrics = ds.evaluate(results, metric=["bbox", "segm"])
    assert "segm_mAP" in metrics and np.isfinite(metrics["segm_mAP"])
