"""The PyTorch port in bfloat16 against the JAX package's bfloat16 build, on the CPU.

The JAX flagship's full-size entry computes in bfloat16 with float32
parameters (``build_detector(mc, dtype=jnp.bfloat16)``); the port does the
same with ``build_detector(mc, dtype=torch.bfloat16)``, casting where flax
casts.  The tiny flagship of ``tests/test_torch_flagship.py`` (its
overrides copied, its random weights ``_random_variables`` at seed 0, its
images) goes to both.  Each stage is held by two things:

  (a) a tolerance against JAX's bfloat16 result, as a fraction of the
      stage's largest value (``TOL``, per stage below);
  (b) the port's bfloat16 error is smaller than the port's float32
      build's error against the same JAX bfloat16 result (the same weights
      and inputs), so a port that ignored the dtype would fail (b) even if
      it passed (a).

The JAX side is compiled with ``xla_allow_excess_precision`` off: by
default XLA on the CPU drops a bfloat16 rounding between two ops that it
fuses in float32, which the TPU (bfloat16 operands on the matrix unit)
does not; with the option off it rounds at every bfloat16 op, as the TPU
and the port do.  Both sides then round at the same points (the backbone's
C2-C4 agree bit for bit), but a value that lands on a rounding boundary
rounds one ulp apart, and the difference grows through the layers: the
stages differ by up to about a percent of their largest value (the JAX
package's own bfloat16 build differs from its float32 build by 1.1-1.6%
on P3-P7 and 1.0-3.3% on the RPN maps).  The tolerances:

  * C2-C5, P3-P7: 2.5% of each level's largest value;
  * RPN cls, reg, iou maps on JAX's P3-P7: 1.5%; cls and iou bfloat16,
    reg float32;
  * JAX's proposals through the port's RoI stage (RoIAlign, Shared2FC):
    the head's cls and reg within 1.5%;
  * ``roi_predict`` on JAX's proposals: of the detections that both keep
    (the same label, boxes within 1 px), at least 90% matched, boxes within
    0.5 px and scores within 0.01 (labels are not compared for equality: a
    near tie may flip at this precision);
  * the loss functions (``atss_rpn_loss``, ``prob_roi_loss``) on JAX's
    bfloat16 RPN and head outputs of the train batch and its
    ``RoISample``: each of the five losses within 0.1% of JAX's;
  * train, one ``RoISample`` from JAX fed to both ``loss(..., sample=)``:
    the five float32 losses within 1.5% of their value, (b) on their summed
    relative error; every parameter gradient within 15% of the tensor's
    largest (plus 1e-6 of the network's largest), (b) for at least 90% of
    the tensors and for the largest error; after one SGD step every
    parameter within 15% of the tensor's update (plus one float32 rounding
    of the parameter).

Why (b) is not per loss and per tensor end to end: one value of C5 (of
2560) rounds one ulp apart (the two packages sum a convolution in other
orders), and the FPN's top-down path carries that into every level; the
five losses then differ from JAX's by ~1e-4 in both builds, at the noise
floor, and the gradients by a median 2% in bfloat16 (27% in float32).  The
loss functions fed the same network outputs isolate the port's loss
arithmetic, where (b) holds per loss.

The kernels' plain versions in bfloat16 against the TPU kernels in
interpret mode, within 1 bfloat16 ulp of each value (``atol = 2**-8 *
|ref| + 1e-6``): the batched forward (``batched_multilevel_roi_align_
pallas``), the batched gradient (``..._pallas_bwd``) on a bfloat16
cotangent, every level bfloat16, and the per-image entry forward and
gradient (``multilevel_roi_align_pallas_trainable``).  The bfloat16 pool
fold of the plain mirror (``sample_taps`` + ``fold_pool_rounded``) equals
JAX's ``_fold_and_align(wy.astype(bf16), ...)`` bit for bit.  The builder
takes float32 and bfloat16 only and loads one state dict into both.
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
from boosting_rcnn_tpu.models.dense_heads.atss_rpn_head import (  # noqa: E402
    atss_rpn_loss as j_rpn_loss,
)
from boosting_rcnn_tpu.models.detectors.two_stage import TwoStageNet  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads.bbox_head import bbox_head_decode  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads.prob_roi_head import RoISample as JRoISample  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads.prob_roi_head import prob_fuse_scores  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads.prob_roi_head import prob_roi_loss as j_roi_loss  # noqa: E402
from boosting_rcnn_tpu.ops import pallas_roi_align as j_pallas  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.engine import train as t_train  # noqa: E402
from boosting_rcnn_tpu_torch.models.dense_heads.atss_rpn_head import (  # noqa: E402
    atss_rpn_loss as t_rpn_loss,
)
from boosting_rcnn_tpu_torch.models.roi_heads.prob_roi_head import RoISample  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads.prob_roi_head import (  # noqa: E402
    prob_roi_loss as t_roi_loss,
)
from boosting_rcnn_tpu_torch.ops import roi_align as t_roi  # noqa: E402
from boosting_rcnn_tpu_torch.ops.roi_align_kernel import (  # noqa: E402
    multilevel_roi_align,
    roi_align_bwd_plain,
)
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402

CONFIG = os.path.join(REPO, "configs/boosting_rcnn/boosting_rcnn_r50_pafpn_1x_utdac.py")
CANVAS = (128, 160)
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_rpn_iou", "loss_cls", "loss_bbox")
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1_")
TOL = {"levels": 0.025, "rpn": 0.015, "roi": 0.015, "loss_fn": 0.001, "loss": 0.015,
       "grad": 0.15, "step": 0.15}
BF16 = torch.bfloat16
# the JAX reference rounds at every bfloat16 op, as on the TPU
_jit = functools.partial(jax.jit,
                         compiler_options={"xla_allow_excess_precision": False})


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
    """``tests/test_torch_flagship.py``'s random flax variables."""
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


def _batch(rs):
    """The flagship test's images and shapes, and 5 gts per image of sides
    12-70 px inside the valid shape."""
    img_shape = np.array([[128.0, 150.0], [116.0, 160.0]], np.float32)
    images = rs.rand(2, *CANVAS, 3).astype(np.float32) * 2.0 - 1.0
    gts = np.zeros((2, 5, 4), np.float32)
    for i, (h, w) in enumerate(img_shape):
        wh = rs.uniform(12, 70, (5, 2))
        xy = rs.uniform(0, 1, (5, 2)) * ([w, h] - wh)
        gts[i] = np.concatenate([xy, xy + wh], -1)
    return {
        "images": images,
        "img_shape": img_shape,
        "scale_factor": np.array([[1.0] * 4, [1.25] * 4], np.float32),
        "gt_bboxes": gts,
        "gt_labels": rs.randint(0, 4, (2, 5)).astype(np.int32),
        "gt_mask": np.ones((2, 5), bool),
    }


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU backward on one thread (``tests/test_torch_train.py``:
    torch's threaded CPU convolution backward was not repeatable)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    mc = _tiny(jax_load_config(CONFIG).model.to_dict())
    jdet = jax_build(mc, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    rs = np.random.RandomState(0)
    variables = _random_variables(shapes, rs)
    batch = _batch(rs)
    state = from_jax_params(variables)
    ports = {}
    for dtype in (BF16, torch.float32):
        ports[dtype] = build_detector(_tiny(load_config(CONFIG).model.to_dict()), device="cpu",
                                      dtype=dtype)
        ports[dtype].net.load_state_dict(state, strict=True)
    anchors, nla = jdet.anchors_for(CANVAS)
    return dict(jdet=jdet, jv=jax.tree.map(jnp.asarray, variables), ports=ports, batch=batch,
                anchors=anchors, nla=nla)


def _t(x, dtype=None):
    """A JAX or numpy array as a torch tensor (bfloat16 through float32,
    which is exact), in ``dtype`` when given."""
    x = np.asarray(jnp.asarray(x).astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _rel_err(got, ref):
    """max |got - ref| as a fraction of max |ref|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _held(errs, tol, what):
    """(a) the bfloat16 port within ``tol``, (b) closer than the float32
    port, or exact; ``errs`` maps dtype -> error."""
    assert errs[BF16] <= tol, f"{what}: bf16 error {errs[BF16]:.4g} > {tol}"
    assert errs[BF16] < errs[torch.float32] or errs[BF16] == 0, (
        f"{what}: bf16 error {errs[BF16]:.4g} not below the float32 port's "
        f"{errs[torch.float32]:.4g}")


@pytest.fixture(scope="module")
def jax_stages(pair):
    """JAX's stages on the batch.  The RoI stage runs ``roi_out``'s RoIAlign
    as the TPU runs it, through the Pallas kernel (in interpret mode here:
    on the CPU ``roi_out`` takes the XLA path, whose bfloat16 arithmetic
    differs from the kernel's by an ulp), then ``roi_out``'s bbox head."""
    jdet, jv, batch = pair["jdet"], pair["jv"], pair["batch"]
    net, tc = jdet.net, jdet.rcnn_test_cfg

    @_jit
    def first_stage(v, images, img_shape):
        cs = net.apply(v, images, method=lambda m, x: m.backbone(x))
        feats = net.apply(v, images, method=TwoStageNet.features)
        rpn = net.apply(v, feats, method=TwoStageNet.rpn_out)
        cls, reg, iou = jdet._rpn_flat(v, feats)
        props = jdet._proposals(cls, reg, iou, pair["anchors"], pair["nla"], img_shape,
                                jdet.test_proposal_cfg)
        return cs, feats, rpn, props

    @_jit
    def roi_stage(v, feats, boxes, scores, valid, img_shape, scale_factor):
        b, r = boxes.shape[:2]
        pooled = j_pallas.batched_multilevel_roi_align_pallas(
            feats, boxes, valid, net.roi_strides, finest_scale=net.roi_finest_scale,
            num_route_levels=len(net.roi_strides), interpret=True)
        cls_s, reg_s = net.apply(v, pooled.reshape(b * r, *pooled.shape[2:]),
                                 method=lambda m, p: m.bbox_head(p))
        fused = jax.vmap(prob_fuse_scores)(cls_s.reshape(b, r, -1), scores)
        dets = jax.vmap(lambda ro, sc, bp, rv, shp, sf: bbox_head_decode(
            jdet.bbox_cfg, ro, sc, bp, shp, sf, True, tc.score_thr, tc.nms_iou_thr,
            tc.max_per_img, roi_valid=rv, pre_nms_top_k=tc.pre_nms_top_k,
        ))(boxes, fused, reg_s.reshape(b, r, -1), valid, img_shape, scale_factor)
        return (cls_s, reg_s), dets

    img_shape, scale_factor = (jnp.asarray(batch[k]) for k in ("img_shape", "scale_factor"))
    cs, feats, rpn, props = first_stage(jv, jnp.asarray(batch["images"]), img_shape)
    head, dets = roi_stage(jv, feats, *props, img_shape, scale_factor)
    return dict(cs=cs, feats=feats, rpn=rpn, props=props, head=head, dets=dets)


def test_builder_takes_float32_and_bfloat16_only(pair):
    mc = _tiny(load_config(CONFIG).model.to_dict())
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(ValueError, match=str(dtype)):
            build_detector(mc, device="cpu", dtype=dtype)
    nets = [pair["ports"][d].net for d in (BF16, torch.float32)]
    for (k, a), (_, b) in zip(*(n.state_dict().items() for n in nets)):
        assert a.dtype == torch.float32 and torch.equal(a, b), k


def test_backbone_and_neck_levels(pair, jax_stages):
    images = torch.from_numpy(pair["batch"]["images"])
    errs = {}
    for dtype, det in pair["ports"].items():
        with torch.inference_mode():
            cs = det.net.backbone(images.permute(0, 3, 1, 2))
            ps = det.net.features(images)
        assert all(x.dtype == dtype for x in cs + ps)
        got = [c.permute(0, 2, 3, 1) for c in cs] + list(ps)
        errs[dtype] = [_rel_err(g, r) for g, r in zip(got, list(jax_stages["cs"])
                                                     + list(jax_stages["feats"]))]
    for i, name in enumerate(["C2", "C3", "C4", "C5", "P3", "P4", "P5", "P6", "P7"]):
        _held({d: e[i] for d, e in errs.items()}, TOL["levels"], name)


def test_rpn_maps_on_jax_levels(pair, jax_stages):
    errs = {}
    for dtype, det in pair["ports"].items():
        with torch.inference_mode():
            got = det.net.rpn_out([_t(f, dtype) for f in jax_stages["feats"]])
        if dtype == BF16:
            assert all(x.dtype == BF16 for x in got[0] + got[2])
            assert all(x.dtype == torch.float32 for x in got[1])
        errs[dtype] = [_rel_err(g.permute(0, 2, 3, 1), r) for got_l, ref_l
                       in zip(got, jax_stages["rpn"]) for g, r in zip(got_l, ref_l)]
    for i in range(len(errs[BF16])):
        _held({d: e[i] for d, e in errs.items()}, TOL["rpn"], f"rpn map {i}")


def test_roi_head_on_jax_proposals(pair, jax_stages):
    boxes, _, valid = (_t(x) for x in jax_stages["props"])
    errs = {}
    for dtype, det in pair["ports"].items():
        with torch.inference_mode():
            cls_s, reg_s = det.net.roi_out([_t(f, dtype) for f in jax_stages["feats"]], boxes,
                                           valid)
        assert cls_s.dtype == reg_s.dtype == dtype
        errs[dtype] = [_rel_err(g, r) for g, r in zip((cls_s, reg_s), jax_stages["head"])]
    for i, name in enumerate(("cls", "reg")):
        _held({d: e[i] for d, e in errs.items()}, TOL["roi"], f"head {name}")


def _matched(dets, labels, valid, ref):
    """Pairs of detections kept by both: the same label, boxes within 1 px.
    Returns (matched count, smaller kept count, max box error, max score
    error)."""
    rd, rl, rv = (np.asarray(jnp.asarray(x).astype(jnp.float32)) for x in ref)
    n_match = n_min = 0
    box_err = score_err = 0.0
    for i in range(dets.shape[0]):
        got = dets[i][valid[i]].numpy()
        glab = labels[i][valid[i]].numpy()
        want, wlab = rd[i][rv[i] > 0], rl[i][rv[i] > 0]
        n_min += min(len(got), len(want))
        for d, lab in zip(got, glab):
            dist = np.abs(want[:, :4] - d[:4]).max(1) if len(want) else np.array([])
            ok = (wlab == lab) & (dist < 1.0)
            if ok.any():
                j = int(np.argmin(np.where(ok, dist, np.inf)))
                n_match += 1
                box_err = max(box_err, float(dist[j]))
                score_err = max(score_err, float(abs(want[j, 4] - d[4])))
    return n_match, n_min, box_err, score_err


def test_predict_on_jax_proposals(pair, jax_stages):
    boxes, scores, valid = (_t(x) for x in jax_stages["props"])
    batch = pair["batch"]
    errs = {}
    for dtype, det in pair["ports"].items():
        dets, labels, kept = det.roi_predict(
            [_t(f, dtype) for f in jax_stages["feats"]], boxes, scores, valid,
            _t(batch["img_shape"]), _t(batch["scale_factor"]))
        assert dets.dtype == torch.float32 and kept.any()
        n_match, n_min, box_err, score_err = _matched(dets, labels, kept, jax_stages["dets"])
        if dtype == BF16:
            assert n_match >= 0.9 * n_min > 0, (n_match, n_min)
            assert box_err <= 0.5 and score_err <= 0.01, (box_err, score_err)
        errs[dtype] = box_err + score_err
    assert errs[BF16] < errs[torch.float32], errs


@pytest.fixture(scope="module")
def train(pair):
    """JAX's bfloat16 loss and gradients on its own train ``RoISample``, and
    one SGD step; the port's in both dtypes on that sample."""
    jdet, jv = pair["jdet"], pair["jv"]
    jb = jax.tree.map(jnp.asarray, {k: v for k, v in pair["batch"].items()
                                    if k != "scale_factor"})
    anchors, nla = pair["anchors"], pair["nla"]
    rng = jax.random.PRNGKey(3)
    sample = _jit(lambda v: jdet.train_sample(v, rng, jb, anchors, nla))(jv)

    def j_loss(params):
        losses = jdet.loss({"params": params, "batch_stats": jv["batch_stats"]}, rng, jb,
                           anchors, nla, sample=sample)
        return sum(losses.values()), losses

    (_, j_losses), j_grads = _jit(jax.value_and_grad(j_loss, has_aux=True))(jv["params"])

    @_jit
    def j_loss_fns(v):
        """JAX's network outputs for the batch and sample, and its loss
        functions on them."""
        feats = jdet.net.apply(v, jb["images"], method=TwoStageNet.features)
        rpn = jdet._rpn_flat(v, feats)
        head = jdet.net.apply(v, feats, sample.boxes, sample.valid, method=TwoStageNet.roi_out)
        flat = JRoISample(*[x.reshape((-1,) + x.shape[2:]) for x in sample])
        losses = j_rpn_loss(jdet.rpn_cfg, *rpn, anchors, jnp.ones(rpn[0].shape, bool),
                            jb["gt_bboxes"], jb["gt_mask"], nla)
        losses.update(j_roi_loss(jdet.roi_cfg, jdet.bbox_cfg, *head, flat))
        return rpn, head, losses

    j_outs = j_loss_fns(jv)
    tx = j_train.make_optimizer(lambda s: 0.01, params=jv["params"], frozen_stages=1)
    updates, _ = tx.update(j_grads, tx.init(jv["params"]), jv["params"])
    j_params = jax.tree.map(lambda p, u: p + u, jv["params"], updates)

    np_sample = tuple(np.asarray(x) for x in sample)
    batch = {k: v for k, v in pair["batch"].items() if k != "scale_factor"}
    out = {}
    for dtype, det in pair["ports"].items():
        t_anchors, t_nla = det.anchors_for(CANVAS)
        losses = det.loss(batch, t_anchors, t_nla, sample=np_sample)
        sum(losses.values()).backward()
        grads = {k: p.grad.clone() for k, p in det.net.named_parameters() if p.grad is not None}
        det.net.zero_grad(set_to_none=True)
        out[dtype] = (losses, grads)
    det = build_detector(_tiny(load_config(CONFIG).model.to_dict()), device="cpu", dtype=BF16)
    det.net.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jv)), strict=True)
    p0 = {k: v.detach().clone() for k, v in det.net.named_parameters()}
    t_anchors, t_nla = det.anchors_for(CANVAS)
    step = t_train.make_train_step(det, t_anchors, t_nla,
                                   t_train.make_optimizer(det.net.parameters(), lambda s: 0.01))
    step(batch, np_sample)
    return dict(j_losses=j_losses, j_outs=j_outs, sample=np_sample,
                j_grads=from_jax_params(jax.tree.map(np.asarray, j_grads)),
                j_params=from_jax_params(jax.tree.map(np.asarray, j_params)), port=out, p0=p0,
                t_params={k: v.detach() for k, v in det.net.named_parameters()})


def test_loss_functions_on_jax_outputs(pair, train):
    """``atss_rpn_loss`` and ``prob_roi_loss`` on JAX's bfloat16 network
    outputs (the float32 port on the same values widened)."""
    (cls, reg, iou), head, ref = train["j_outs"]
    batch = pair["batch"]
    det = pair["ports"][BF16]
    anchors = _t(pair["anchors"])
    flat = RoISample(*(torch.from_numpy(np.array(x)).reshape((-1,) + x.shape[2:])
                       for x in train["sample"]))
    flat = flat._replace(matched_label=flat.matched_label.long())
    errs = {}
    for dtype in (BF16, torch.float32):
        rpn = (_t(cls, dtype), _t(reg), _t(iou, dtype))
        losses = t_rpn_loss(det.rpn_cfg, *rpn, anchors, torch.ones(rpn[0].shape, dtype=bool),
                            _t(batch["gt_bboxes"]), _t(batch["gt_mask"]))
        losses.update(t_roi_loss(det.roi_cfg, det.bbox_cfg, *(_t(x, dtype) for x in head), flat))
        errs[dtype] = {k: abs(losses[k].item() - float(ref[k])) / abs(float(ref[k]))
                       for k in LOSSES}
        assert all(losses[k].dtype == torch.float32 for k in LOSSES)
    for k in LOSSES:
        _held({d: e[k] for d, e in errs.items()}, TOL["loss_fn"], k)


def test_five_losses(train):
    errs = {}
    for dtype, (losses, _) in train["port"].items():
        errs[dtype] = {}
        for k in LOSSES:
            assert losses[k].dtype == torch.float32, k
            ref = float(train["j_losses"][k])
            errs[dtype][k] = abs(losses[k].item() - ref) / abs(ref)
            if dtype == BF16:
                assert errs[dtype][k] <= TOL["loss"], (k, errs[dtype][k])
    _held({d: sum(e.values()) for d, e in errs.items()}, TOL["loss"] * len(LOSSES),
          "the five losses' summed relative error")


def test_parameter_gradients(train):
    j_grads = train["j_grads"]
    g_max = max(g.abs().max().item() for g in j_grads.values())
    errs = {BF16: [], torch.float32: []}
    for name, ref in j_grads.items():
        if name.startswith(FROZEN):
            assert all(name not in grads for _, grads in train["port"].values()), name
            continue
        scale = ref.abs().max().item()
        for dtype, (_, grads) in train["port"].items():
            assert grads[name].dtype == torch.float32, name
            errs[dtype].append((grads[name] - ref).abs().max().item() / (scale + 1e-6 * g_max))
        assert errs[BF16][-1] <= TOL["grad"], (name, errs[BF16][-1])
    n_held = sum(a <= b for a, b in zip(errs[BF16], errs[torch.float32]))
    assert n_held >= 0.9 * len(errs[BF16]), (n_held, len(errs[BF16]))
    assert max(errs[BF16]) < max(errs[torch.float32])


def test_parameters_after_one_sgd_step(train):
    moved = 0
    for name, ref in train["j_params"].items():
        got, p0 = train["t_params"][name], train["p0"][name]
        if name.startswith(FROZEN):
            assert torch.equal(got, p0) and torch.equal(ref, p0), name
            continue
        delta = (ref - p0).abs().max().item()
        moved += delta > 0
        tol = TOL["step"] * delta + 1.2e-7 * ref.abs().max().item()
        assert (got - ref).abs().max().item() <= tol, name
    assert moved > 50


def _pyramid_case(seed):
    """``test_plain_roi_align_matches_pallas_interpret``'s case in
    bfloat16: C = 128, B = 2, 3 levels, the last RoI of each image
    invalid, and one RoI that routes to the coarsest level."""
    rs = np.random.RandomState(seed)
    feats = [rs.randn(2, h, w, 128).astype(np.float32) for h, w in [(24, 32), (12, 16), (6, 8)]]
    cx, cy = rs.uniform(12, 230, (2, 6)), rs.uniform(12, 170, (2, 6))
    bw, bh = rs.uniform(8, 180, (2, 6)), rs.uniform(8, 150, (2, 6))
    rois = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1).astype(np.float32)
    rois[:, 0] = [2.0, 4.0, 300.0, 200.0]
    valid = np.ones((2, 6), bool)
    valid[:, -1] = False
    jf = tuple(jnp.asarray(f, jnp.bfloat16) for f in feats)
    g = jnp.asarray(rs.randn(2, 6, 7, 7, 128), jnp.bfloat16)
    return jf, [_t(f, BF16) for f in jf], rois, valid, g


def _within_ulp(got, ref):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.dtype == BF16
    got = got.float().numpy()
    assert (np.abs(got - ref) <= 2.0 ** -8 * np.abs(ref) + 1e-6).all(), np.abs(got - ref).max()


def test_plain_bf16_roi_align_matches_pallas_interpret():
    jf, tf, rois, valid, g = _pyramid_case(30)
    strides = (8, 16, 32)
    ref = j_pallas.batched_multilevel_roi_align_pallas(
        jf, jnp.asarray(rois), jnp.asarray(valid), strides, interpret=True)
    assert ref.dtype == jnp.bfloat16
    _within_ulp(t_roi.multilevel_roi_align_fast(tf, _t(rois), _t(valid), strides), ref)
    d_ref = j_pallas.batched_multilevel_roi_align_pallas_bwd(
        jf, jnp.asarray(rois), jnp.asarray(valid), g, strides, interpret=True)
    d_got = roi_align_bwd_plain(_t(g, BF16).reshape(12, 7, 7, 128), tf, _t(rois), _t(valid),
                                strides)
    assert all(float(jnp.abs(d.astype(jnp.float32)).max()) > 0 for d in d_ref)
    for got, ref in zip(d_got, d_ref):
        assert ref.dtype == jnp.bfloat16
        _within_ulp(got, ref)


def test_plain_bf16_per_image_entry_matches_pallas_interpret():
    jf, tf, rois, valid, g = _pyramid_case(31)
    strides = (8, 16, 32)

    def jax_fwd(f):
        return j_pallas.multilevel_roi_align_pallas_trainable(
            f, jnp.asarray(rois[0]), jnp.asarray(valid[0]), strides, interpret=True)

    ref, vjp = jax.vjp(jax_fwd, tuple(f[0] for f in jf))
    (d_ref,) = vjp(g[0])
    levels = [f[0].clone().requires_grad_() for f in tf]
    got = multilevel_roi_align(levels, _t(rois[0]), _t(valid[0]), strides)
    got.backward(_t(g[0], BF16))
    _within_ulp(got.detach(), ref)
    for lv, d in zip(levels, d_ref):
        assert d.dtype == jnp.bfloat16
        _within_ulp(lv.grad, d)


def test_bf16_fold_mirror_equals_jax_fold_bitwise():
    """``sample_taps``' weights rounded and folded by ``fold_pool_rounded``
    equal the weights of ``_fold_and_align`` on JAX's bfloat16 interpolation
    matrices bit for bit (wx with JAX's alignment shift undone)."""
    rs = np.random.RandomState(32)
    level_hw = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
    strides = (8, 16, 32, 64, 128)
    xy = rs.uniform(-20, [1344, 800], (64, 2))
    wh = rs.uniform(1, [900, 700], (64, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    feats = [jnp.zeros((1, h, w, 8), jnp.bfloat16) for h, w in level_hw]
    rows_img = sum(h for h, _ in level_hw) + 24
    win_w = min(24, max(w for _, w in level_hw))
    _, wx0, wy, wx = j_pallas._batched_geometry(
        feats, jnp.asarray(rois), 5, strides, 56, 7, 2, 24, win_w, rows_img)
    align = 16
    jwy, jwx, _ = j_pallas._fold_and_align(wy.astype(jnp.bfloat16), wx.astype(jnp.bfloat16),
                                           wx0, 7, 2, align)
    shift = np.asarray(wx0) % align
    jwx = np.stack([np.asarray(jwx[i, :, s:s + win_w].astype(jnp.float32))
                    for i, s in enumerate(shift)])
    taps = t_roi.sample_taps(_t(rois), level_hw, strides)
    got_y = t_roi.fold_pool_rounded(t_roi.taps_to_dense(taps.ky, taps.wy, 24), 7, 2, BF16)
    got_x = t_roi.fold_pool_rounded(t_roi.taps_to_dense(taps.kx, taps.wx, win_w), 7, 2, BF16)
    assert np.array_equal(got_y.numpy(), np.asarray(jwy.astype(jnp.float32)))
    assert np.array_equal(got_x.numpy(), jwx)
    assert not np.array_equal(got_y.numpy(), t_roi.fold_pool(
        t_roi.taps_to_dense(taps.ky, taps.wy, 24), 7, 2).numpy())  # the rounding shows
