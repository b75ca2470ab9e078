"""The PyTorch port's Mask R-CNN against the JAX package's, on the CPU.

A tiny Mask R-CNN made here from ``configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py``
(ResNet-18 at width 8 with frozen stem and stage 1, FPN 32, RPN 32, FC 16,
mask-head convs 16, 4 classes, 32 sampled RoIs per image) gets random
weights made with numpy from a seed, which go to the JAX package as flax
variables and to the port through ``weights.from_jax_params``.  Both see
the same two images on the (128, 160) canvas with 6 seeded gt slots each
(the second image's last one padded) and each gt's mask, a different
ellipse, as a 28 x 28 crop relative to its box.  The JAX package's
``train_sample`` gives the ``RoISample`` that both ``loss(..., sample=)``
calls take, and the port's RPN sampler ranks its anchors by the uniforms
that JAX's ``rpn_loss`` draws from the same key, since the two packages
draw different random bits.  Checked:

  * ``predict``: labels and valid equal, detections within 1e-3, masks
    within 1e-4;
  * the five losses (RPN cls and box, R-CNN cls and box, mask): rtol 1e-4;
  * every parameter gradient: within ``1e-3 * max|g|`` of the tensor plus
    ``1e-6 * max|g|`` of the network (float32 sums in other orders through
    ~30 layers, as ``tests/test_torch_train.py``); frozen parameters get
    none in the port and zeros in the JAX package;
  * the parameters after 1 and 2 SGD steps of JAX
    ``make_train_step(proposal_mode="external")`` and the port's step:
    within ``1e-3 * max|p - p0|`` plus ``1e-7 * max|p|`` of the tensor,
    frozen ones bit-identical; the metrics rtol 1e-4;
  * in bfloat16, ``mask_out`` (the 14 x 14 RoIAlign and the FCN head) on
    the JAX bfloat16 build's levels, against that build's (XLA's excess
    precision off; its RoIAlign through the Pallas kernel in interpret
    mode, as the TPU runs it): within 1.5% of the largest logit (the
    RoI-head tolerance of tests/test_torch_bf16.py) and closer than the
    port's float32 build.
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

from boosting_rcnn_tpu.builder import build_detector as jax_build  # noqa: E402
from boosting_rcnn_tpu.config import load_config as jax_load_config  # noqa: E402
from boosting_rcnn_tpu.engine import train as j_train  # noqa: E402
from boosting_rcnn_tpu.models.detectors.two_stage import TwoStageNet  # noqa: E402
from boosting_rcnn_tpu.ops import pallas_roi_align as j_pallas  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.engine import train as t_train  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402

CONFIG = os.path.join(REPO, "configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py")
CANVAS = (128, 160)
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "loss_mask")
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1_")
BF16 = torch.bfloat16
ROI_TOL = 0.015  # tests/test_torch_bf16.py's RoI-head tolerance
# the JAX reference rounds at every bfloat16 op, as on the TPU
_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})


def _tiny(mc):
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"].update(in_channels=[8, 16, 32, 64], out_channels=32)
    mc["rpn_head"].update(in_channels=32, feat_channels=32)
    roi = mc["roi_head"]
    roi["bbox_roi_extractor"]["out_channels"] = 32
    roi["mask_roi_extractor"]["out_channels"] = 32
    roi["bbox_head"].update(in_channels=32, fc_out_channels=16, num_classes=4)
    roi["mask_head"].update(in_channels=32, conv_out_channels=16, num_classes=4)
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


def _ellipse(rs, s=28):
    """A seeded ellipse in an ``s x s`` box-relative crop, uint8."""
    cy, cx = rs.uniform(0.35, 0.65, 2) * s
    ry, rx = rs.uniform(0.25, 0.5, 2) * s
    y, x = np.mgrid[:s, :s] + 0.5
    return (((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 <= 1.0).astype(np.uint8)


def _batch(rs):
    """Two images with 6 gt slots each, boxes of sides 12-70 px inside the
    valid shape (the second image's last slot padded), each gt a different
    ellipse."""
    img_shape = np.array([[128.0, 150.0], [116.0, 160.0]], np.float32)
    gts = np.zeros((2, 6, 4), np.float32)
    for i, (h, w) in enumerate(img_shape):
        wh = rs.uniform(12, 70, (6, 2))
        xy = rs.uniform(0, 1, (6, 2)) * ([w, h] - wh)
        gts[i] = np.concatenate([xy, xy + wh], -1)
    gt_mask = np.ones((2, 6), bool)
    gt_mask[1, 5] = False
    gts[1, 5] = 0.0
    crops = np.stack([np.stack([_ellipse(rs) for _ in range(6)]) for _ in range(2)])
    return {
        "images": (rs.rand(2, *CANVAS, 3) * 2.0 - 1.0).astype(np.float32),
        "img_shape": img_shape,
        "scale_factor": np.array([[1.0] * 4, [1.25] * 4], np.float32),
        "gt_bboxes": gts,
        "gt_labels": rs.randint(0, 4, (2, 6)).astype(np.int32),
        "gt_mask": gt_mask,
        "gt_mask_crops": crops,
    }


def _rpn_uniforms(rng, num_anchors):
    """The uniforms of JAX's ``rpn_loss`` under ``loss(..., rng)``:
    ``rpn_rng`` is the first half of ``rng``, one key per image, and each
    image's sampler draws from the two halves of its key."""
    rpn_rng, _ = jax.random.split(rng)
    out = []
    for key in jax.random.split(rpn_rng, 2):
        kp, kn = jax.random.split(key)
        out.append([np.asarray(jax.random.uniform(k, (num_anchors,))) for k in (kp, kn)])
    return np.asarray(out, np.float32)


def _schedules():
    kw = dict(decay_epochs=(1,), warmup_iters=2, warmup_ratio=0.5)  # lr 0.01, then 0.0015
    return j_train.step_lr_schedule(0.02, 1, **kw), t_train.step_lr_schedule(0.02, 1, **kw)


def _numpy_sample(sample):
    return tuple(np.array(x) for x in sample)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU backward on one thread (``tests/test_torch_train.py``:
    torch's threaded CPU convolution backward was not repeatable)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run():
    """Both packages through predict, the loss, its gradients and two
    train steps on the same weights, batch, samples and RPN draws."""
    mc = _tiny(jax_load_config(CONFIG).model.to_dict())
    jdet = jax_build(mc, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    rs = np.random.RandomState(0)
    variables = _random_variables(shapes, rs)
    batch = _batch(rs)
    jv = jax.tree.map(jnp.asarray, variables)
    jb = jax.tree.map(jnp.asarray, batch)
    anchors, nla = jdet.anchors_for(CANVAS)
    rng = jax.random.PRNGKey(3)

    tdet, tdet_train = (build_detector(_tiny(load_config(CONFIG).model.to_dict()), device="cpu")
                        for _ in range(2))
    for det in (tdet, tdet_train):
        det.net.load_state_dict(from_jax_params(variables), strict=True)
    t_anchors, t_nla = tdet.anchors_for(CANVAS)
    assert t_nla == nla

    j_pred = jax.jit(lambda v, b: jdet.predict(v, b, anchors, nla))(jv, jb)
    t_pred = tdet.predict(batch, t_anchors, t_nla)

    sample_fn = jax.jit(lambda v, r: jdet.train_sample(v, r, jb, anchors, nla))
    sample0 = sample_fn(jv, rng)

    def j_loss(params, sample):
        losses = jdet.loss({"params": params, "batch_stats": jv["batch_stats"]}, rng, jb,
                           anchors, nla, sample=sample)
        return sum(losses.values()), losses

    (_, j_losses), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jv["params"], sample0)
    n_anchors = anchors.shape[0]
    t_losses = tdet.loss(batch, t_anchors, t_nla, sample=_numpy_sample(sample0),
                         rpn_uniforms=_rpn_uniforms(rng, n_anchors))
    sum(t_losses.values()).backward()
    t_grads = {k: (None if p.grad is None else p.grad.clone())
               for k, p in tdet.net.named_parameters()}
    tdet.net.zero_grad(set_to_none=True)

    # two SGD steps, each on the JAX package's sample at the current weights;
    # the JAX step folds the step count into its key
    j_sched, t_sched = _schedules()
    tx = j_train.make_optimizer(j_sched, params=jv["params"], frozen_stages=1)
    state = j_train.create_train_state(jv, tx)
    j_step = jax.jit(j_train.make_train_step(jdet, anchors, nla, proposal_mode="external"))
    t_step = t_train.make_train_step(
        tdet_train, t_anchors, t_nla,
        t_train.make_optimizer(tdet_train.net.parameters(), t_sched))
    p0 = {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()}
    steps = []
    for k in range(2):
        sample = sample_fn({"params": state.params, "batch_stats": state.batch_stats}, rng)
        state, j_metrics = j_step(state, jb, rng, sample)
        t_metrics = t_step(batch, _numpy_sample(sample),
                           rpn_uniforms=_rpn_uniforms(jax.random.fold_in(rng, k), n_anchors))
        steps.append((from_jax_params(jax.tree.map(np.asarray, state.params)),
                      {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()},
                      j_metrics, t_metrics))
    return dict(jdet=jdet, jv=jv, variables=variables, batch=batch, j_pred=j_pred,
                t_pred=t_pred, sample0=sample0, j_losses=j_losses, t_losses=t_losses,
                j_grads=from_jax_params(jax.tree.map(np.asarray, j_grads)), t_grads=t_grads,
                p0=p0, steps=steps)


def test_predict_matches_jax(run):
    ref, got = run["j_pred"], run["t_pred"]
    assert len(ref) == len(got) == 4
    dets, labels, valid, masks = got
    assert int(valid.sum()) > 20
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(dets.numpy(), np.asarray(ref[0]), rtol=0, atol=1e-3)
    assert masks.dtype == torch.float32 and tuple(masks.shape) == (2, 100, 28, 28)
    assert 0.0 <= masks.min().item() and masks.max().item() <= 1.0
    np.testing.assert_allclose(masks.numpy(), np.asarray(ref[3]), rtol=0, atol=1e-4)


def test_five_losses_match_jax(run):
    assert set(run["t_losses"]) == set(run["j_losses"]) == set(LOSSES)
    for k in LOSSES:
        got, ref = run["t_losses"][k].item(), float(run["j_losses"][k])
        assert np.isfinite(got) and got > 0, k
        np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=k)
    assert np.asarray(run["sample0"].is_pos).sum() > 4


def test_parameter_gradients_match_jax(run):
    t_grads, j_grads = run["t_grads"], run["j_grads"]
    assert set(t_grads) == set(j_grads)
    assert any(k.startswith("mask_head.upsample") for k in t_grads)
    g_max = max(g.abs().max().item() for g in j_grads.values())
    for name, ref in j_grads.items():
        got = t_grads[name]
        if name.startswith(FROZEN):
            assert got is None, name
            assert not ref.any(), name
            continue
        assert got is not None, name
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-3 * ref.abs().max().item() + 1e-6 * g_max,
                                   err_msg=name)


@pytest.mark.parametrize("step", [0, 1])
def test_parameters_after_sgd_steps_match_jax(run, step):
    j_params, t_params, j_metrics, t_metrics = run["steps"][step]
    for k in ("loss", "grad_norm", *LOSSES):
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), rtol=1e-4,
                                   err_msg=k)
    moved = 0
    for name, ref in j_params.items():
        got, p0 = t_params[name], run["p0"][name]
        if name.startswith(FROZEN):
            assert torch.equal(got, p0) and torch.equal(ref, p0), name
            continue
        delta = (ref - p0).abs().max().item()
        moved += delta > 0
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-3 * delta + 1e-7 * ref.abs().max().item(),
                                   err_msg=name)
    assert moved > 50
    assert any(t_params[k].ne(run["p0"][k]).any() for k in t_params
               if k.startswith("mask_head."))


def test_bf16_mask_out_matches_jax_bf16(run):
    """``mask_out`` in bfloat16 on the JAX bfloat16 build's levels and the
    JAX predict's detections (every third made invalid)."""
    mc = _tiny(jax_load_config(CONFIG).model.to_dict())
    jdet = jax_build(mc, dtype=jnp.bfloat16)
    jv = run["jv"]
    net = jdet.net
    dets, _, valid, _ = run["j_pred"]
    rois = dets[..., :4] * jnp.asarray(run["batch"]["scale_factor"])[:, None, :]
    valid = valid & (jnp.arange(valid.shape[1]) % 3 != 0)[None]

    @_jit
    def jax_mask_out(v, images, rois, valid):
        feats = net.apply(v, images, method=TwoStageNet.features)
        pooled = j_pallas.batched_multilevel_roi_align_pallas(
            feats[:4], rois, valid, net.roi_strides, out_size=14, interpret=True)
        logits = net.apply(v, pooled.reshape(-1, 14, 14, pooled.shape[-1]),
                           method=lambda m, x: m.mask_head(x))
        return feats, logits

    feats, ref = jax_mask_out(jv, jnp.asarray(run["batch"]["images"]), rois, valid)
    assert feats[0].dtype == jnp.bfloat16 and ref.dtype == jnp.float32
    levels = [torch.from_numpy(np.array(f.astype(jnp.float32))) for f in feats]
    errs = {}
    for dtype in (BF16, torch.float32):
        det = build_detector(_tiny(load_config(CONFIG).model.to_dict()), device="cpu",
                             dtype=dtype)
        det.net.load_state_dict(from_jax_params(run["variables"]), strict=True)
        with torch.inference_mode():
            got = det.net.mask_out([f.to(dtype) for f in levels],
                                   torch.from_numpy(np.array(rois)),
                                   torch.from_numpy(np.array(valid)))
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        ref_np = np.asarray(ref)
        errs[dtype] = float(np.abs(got.numpy() - ref_np).max() / np.abs(ref_np).max())
    assert errs[BF16] <= ROI_TOL, errs
    assert errs[BF16] < errs[torch.float32] or errs[BF16] == 0, errs
