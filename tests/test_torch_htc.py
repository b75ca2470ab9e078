"""The PyTorch port's Hybrid Task Cascade against the JAX package's, on the
CPU: HTC with the semantic branch (``configs/htc/htc_r50_fpn_1x_coco.py``)
here, and the harness that ``tests/test_torch_htc_nosem.py`` (HTC without
it) and ``tests/test_torch_htc_cascade_mask.py`` (Cascade Mask R-CNN)
run.

The tiny detector takes the JAX package's own tiny HTC overrides
(``tests/test_htc.py::_tiny_htc``, copied: ResNet-18 at width 8, FPN and
RPN 16, FC 16, 4 classes, one 8-channel conv in each mask head, the
semantic head 16 channels, one conv, 6 stuff classes; 32 train and 16
test proposals, 8 RoIs a stage); random weights made with numpy, into the
JAX package as flax variables and into the port through
``weights.from_jax_params``; two images on the 128 x 160 canvas with 6
seeded gt slots (one padded), a different ellipse mask each, and a seeded
stuff map at 1/8 of the canvas with a band of 255 pixels.  The JAX side
is jitted once per fixture (its eager loss takes about a minute).
Checked, at the tolerances of ``tests/test_torch_cascade.py``:

  * ``predict``: labels and valid equal, detections within 1e-3, the
    stage-averaged masks within 1e-4;
  * with JAX's own draws (its RPN sampler's, each stage's RoI sampler's
    and HTC's mask samplers', ``fold_in(roi_rng, 100 + stage)``): every
    stage's box sample field by field and its mask branch's RoIs, positive
    slots, labels and targets; every loss rtol 1e-4, ``s{i}.loss_mask``
    and ``loss_semantic_seg`` among them; every gradient within ``1e-3 *
    max|g|`` of the tensor plus ``1e-6`` of the network's; the mask heads
    before the last get gradient from the later stages' losses (the
    information flow);
  * two SGD steps of JAX ``make_train_step(proposal_mode="fused")`` and
    the port's step on the same draws, each from JAX's state before it.

bfloat16, stage by stage on JAX's bfloat16 inputs (the JAX side jitted
with ``xla_allow_excess_precision`` off): the semantic head's logits and
embedding on JAX's levels, each stage's box head on JAX's pooled features
of the stage's RoIs, and every stage's mask logits on JAX's pooled
features of its detections, each within the RoI-head tolerance (1.5% of
its largest value) and closer than the port's float32 build; the port's
pooled features (pyramid plus embedding) within that tolerance of JAX's.
(On JAX's RoIs rather than its pooled features, the heads' errors are no
smaller than the float32 build's: JAX pools with the XLA path in
bfloat16, the port with the Pallas kernels' arithmetic, which round an
ulp apart, and at these widths that ulp is as large as the heads' own
bfloat16 error.)
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
from boosting_rcnn_tpu.engine import train as j_train  # noqa: E402
from boosting_rcnn_tpu.models.detectors import htc as j_htc  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads import cascade_roi_head as j_croi  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.engine import train as t_train  # noqa: E402
from boosting_rcnn_tpu_torch.models.detectors import htc as t_htc  # noqa: E402
from boosting_rcnn_tpu_torch.models.detectors import two_stage as t_two_stage  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402
from test_torch_bf16 import _jit, _rel_err, _t  # noqa: E402
from test_torch_boosting_detectors import (  # noqa: E402
    CANVAS,
    _batch,
    _random_variables,
    _rpn_uniforms,
    check_gradients,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
)
from test_torch_cascade import (  # noqa: E402
    BF16,
    ROI_TOL,
    _roi_uniforms,
    _Spy,
    _sync,
    check_cascade_losses,
    check_samples,
    stage_losses,
)
from test_torch_mask_rcnn import _ellipse  # noqa: E402

STUFF_CLASSES = 6


def tiny_htc(mc):
    """``tests/test_htc.py::_tiny_htc``'s overrides (for Cascade Mask R-CNN
    ``tests/test_cascade_mask.py``'s, the same)."""
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"].update(in_channels=[8, 16, 32, 64], out_channels=16)
    mc["rpn_head"].update(feat_channels=16)
    for h in mc["roi_head"]["bbox_head"]:
        h.update(fc_out_channels=16, num_classes=4)
    mh = mc["roi_head"]["mask_head"]
    for h in mh if isinstance(mh, list) else [mh]:
        h.update(num_classes=4, conv_out_channels=8, num_convs=1)
    if mc["roi_head"].get("semantic_head"):
        mc["roi_head"]["semantic_head"].update(num_classes=STUFF_CLASSES, conv_out_channels=16,
                                               num_convs=1)
    mc["train_cfg"]["rpn_proposal"].update(nms_pre=64, max_per_img=32)
    for rc in mc["train_cfg"]["rcnn"]:
        rc["sampler"]["num"] = 8
    mc["test_cfg"]["rpn"].update(nms_pre=48, max_per_img=16)
    return mc


def htc_batch(rs, semantic: bool):
    """``_batch``'s two images and gts with an ellipse mask crop per gt
    and, for the semantic branch, a stuff map at 1/8 of the canvas (a band
    of its rows ignored, 255)."""
    batch = _batch(rs, 4)
    batch["gt_mask_crops"] = np.stack([np.stack([_ellipse(rs) for _ in range(6)])
                                       for _ in range(2)])
    if semantic:
        h, w = CANVAS[0] // 8, CANVAS[1] // 8
        seg = rs.randint(0, STUFF_CLASSES, (2, h, w)).astype(np.int32)
        seg[1, 3:6] = 255
        batch["gt_semantic_seg"] = seg
    return batch


def _mask_uniforms(rng, b: int, sizes):
    """The uniforms of HTC's mask samplers under ``loss(..., rng)``: stage
    ``s`` folds ``100 + s`` into ``roi_rng`` (JAX ``htc.py:278-285``), over
    the gt boxes and the stage's sampled slots."""
    _, roi_rng = jax.random.split(rng)
    out = []
    for stage, n in enumerate(sizes):
        per_image = []
        for key in jax.random.split(jax.random.fold_in(roi_rng, 100 + stage), b):
            kp, kn = jax.random.split(key)
            per_image.append([np.asarray(jax.random.uniform(k, (n,))) for k in (kp, kn)])
        out.append(np.asarray(per_image, np.float32))
    return out


class _MaskSpy:
    """Records each stage's mask branch: the RoIs and valid slots that
    ``mask_out`` pools and the targets, labels and positive slots that
    ``mask_loss`` takes, in JAX's ``htc`` module (or the port's, where the
    loss is ``two_stage.mask_loss``)."""

    def __init__(self, jax_side: bool):
        self.jax_side, self.rois, self.losses = jax_side, [], []

    def __enter__(self):
        if self.jax_side:
            net, loss_mod = j_htc.HTCNet, j_htc
        else:
            net, loss_mod = t_htc.HTCNet, t_two_stage
        self.net, self.loss_mod = net, loss_mod
        self.orig_out, self.orig_loss = net.mask_out, loss_mod.mask_loss
        orig_out, orig_loss = self.orig_out, self.orig_loss

        def mask_out(module, feats, rois, roi_valid, *args, **kw):
            self.rois.append((rois, roi_valid))
            return orig_out(module, feats, rois, roi_valid, *args, **kw)

        def mask_loss(logits, targets, labels, pos, *args, **kw):
            self.losses.append((targets, labels, pos))
            return orig_loss(logits, targets, labels, pos, *args, **kw)

        net.mask_out, loss_mod.mask_loss = mask_out, mask_loss
        return self

    def __exit__(self, *exc):
        self.net.mask_out, self.loss_mod.mask_loss = self.orig_out, self.orig_loss


def run_htc_pair(make_cfg, steps: bool = True, edit_variables=None):
    """Both packages on ``make_cfg(load_config(...))``'s tiny HTC or Cascade
    Mask R-CNN through predict, the loss with its per-stage box and mask
    samples, its gradients and (with ``steps``) two fused train steps on
    the same weights, batch and random draws; after each step, JAX's
    ``batch_stats`` and the port's buffers (``states``).
    ``edit_variables`` sets variables of the random ones (the Seesaw
    counts)."""
    mc = make_cfg(jax_load_config)
    semantic = bool(mc["roi_head"].get("semantic_head"))
    jdet = jax_build(mc, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    rs = np.random.RandomState(0)
    variables = _random_variables(shapes, rs)
    if edit_variables is not None:
        variables = edit_variables(variables)
    batch = htc_batch(rs, semantic)
    jv = jax.tree.map(jnp.asarray, variables)
    jb = jax.tree.map(jnp.asarray, batch)
    anchors, nla = jdet.anchors_for(CANVAS)
    rng = jax.random.PRNGKey(3)

    tdet, tdet_train = (build_detector(make_cfg(load_config), device="cpu") for _ in range(2))
    for det in (tdet, tdet_train):
        det.net.load_state_dict(from_jax_params(variables), strict=True)
    t_anchors, t_nla = tdet.anchors_for(CANVAS)
    assert t_nla == nla
    n_stages = tdet.cascade_cfg.num_stages
    g = batch["gt_bboxes"].shape[1]
    slots = g + tdet.roi_cfg.num_samples
    sizes = [g + tdet.train_proposal_cfg.max_per_img] + [slots] * (n_stages - 1)

    def draws(key):
        return {"roi_uniforms": _roi_uniforms(key, 2, sizes),
                "mask_uniforms": _mask_uniforms(key, 2, [slots] * n_stages),
                "rpn_uniforms": _rpn_uniforms(key, anchors.shape[0])}

    j_pred = jax.jit(lambda v, b: jdet.predict(v, b, anchors, nla))(jv, jb)
    t_pred = tdet.predict(batch, t_anchors, t_nla)

    def j_loss(params):
        with _Spy(j_htc) as spy, _MaskSpy(True) as mspy:
            losses = jdet.loss({"params": params, "batch_stats": jv["batch_stats"]}, rng, jb,
                               anchors, nla)
        return sum(losses.values()), (losses, spy.samples, mspy.rois, mspy.losses)

    (_, (j_losses, j_samples, j_mrois, j_mloss)), j_grads = jax.jit(
        jax.value_and_grad(j_loss, has_aux=True))(jv["params"])
    with _Spy(t_htc) as spy, _MaskSpy(False) as mspy:
        t_losses = tdet.loss(batch, t_anchors, t_nla, **draws(rng))
    sum(t_losses.values()).backward()
    t_grads = {k: (None if p.grad is None else p.grad.clone())
               for k, p in tdet.net.named_parameters()}
    kw = draws(rng)
    del kw["rpn_uniforms"]
    t_msamples = tdet.mask_samples(batch, t_anchors, t_nla, **kw)

    run = dict(jdet=jdet, tdet=tdet, batch=batch, j_pred=j_pred, t_pred=t_pred,
               j_samples=j_samples, t_samples=spy.samples, j_losses=j_losses,
               t_losses=t_losses, j_grads=from_jax_params(jax.tree.map(np.asarray, j_grads)),
               t_grads=t_grads, j_mrois=j_mrois, j_mloss=j_mloss, t_mrois=mspy.rois,
               t_mloss=mspy.losses, t_msamples=t_msamples, variables=variables,
               names=stage_losses(n_stages) + tuple(f"s{s}.loss_mask" for s in range(n_stages))
               + (("loss_semantic_seg",) if semantic else ()))
    if not steps:
        return run
    sched = dict(decay_epochs=(1,), warmup_iters=2, warmup_ratio=0.5)  # lr 0.01, then 0.0015
    j_sched, t_sched = (m.step_lr_schedule(0.02, 1, **sched) for m in (j_train, t_train))
    tx = j_train.make_optimizer(j_sched, params=jv["params"], frozen_stages=1)
    state = j_train.create_train_state(jv, tx)
    j_step = jax.jit(j_train.make_train_step(jdet, anchors, nla, proposal_mode="fused"))
    t_opt = t_train.make_optimizer(tdet_train.net.parameters(), t_sched)
    t_step = t_train.make_train_step(tdet_train, t_anchors, t_nla, t_opt)
    run["p0"] = {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()}
    run["steps"], run["states"] = [], []
    for k in range(2):
        _sync(tdet_train, t_opt, state)
        state, j_metrics = j_step(state, jb, rng)  # the step folds its count into rng
        t_metrics = t_step(batch, **draws(jax.random.fold_in(rng, k)))
        run["steps"].append((from_jax_params(jax.tree.map(np.asarray, state.params)),
                             {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()},
                             j_metrics, t_metrics))
        run["states"].append((from_jax_params({"params": {}, "batch_stats": jax.tree.map(
            np.asarray, state.batch_stats)}),
            {k: v.clone() for k, v in tdet_train.net.named_buffers()}))
    return run


def check_htc_predict(run):
    """Detections as ``check_predict``, then the masks ``(B, D, 28, 28)``
    within 1e-4 and inside [0, 1]."""
    dets, _, _ = check_predict({"j_pred": run["j_pred"][:3], "t_pred": run["t_pred"][:3]})
    got, ref = run["t_pred"][3], np.asarray(run["j_pred"][3])
    assert tuple(got.shape) == ref.shape == (2, dets.shape[1], 28, 28)
    assert got.dtype == torch.float32
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


def check_mask_samples(run):
    """Each stage's mask branch: the RoIs it pools (within 1e-3 px), its
    positive slots, their labels and their targets, equal; for HTC
    (interleaved) the RoIs are the stage's refined boxes sampled again,
    for Cascade Mask R-CNN the stage's box sample."""
    n = run["tdet"].cascade_cfg.num_stages
    assert len(run["j_mrois"]) == len(run["t_mrois"]) == len(run["j_mloss"]) == n
    for stage in range(n):
        (jr, _), (tr, tv) = run["j_mrois"][stage], run["t_mrois"][stage]
        ms = run["t_msamples"][stage]
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-3,
                                   err_msg=f"stage {stage} mask RoIs")
        assert torch.equal(ms.boxes, tr) and torch.equal(ms.valid & ms.is_pos, tv)
        jt, jl, jp = (np.asarray(x) for x in run["j_mloss"][stage])
        tt, tl, tp = (x.numpy() for x in run["t_mloss"][stage])
        np.testing.assert_array_equal(tp, jp.astype(bool), err_msg=f"stage {stage} positives")
        assert tp.sum() > 0, stage
        np.testing.assert_array_equal(np.where(tp, tl, -1), np.where(jp, jl, -1))
        np.testing.assert_array_equal(tt[tp], jt.reshape(tt.shape)[tp],
                                      err_msg=f"stage {stage} mask targets")
        if not run["tdet"].cascade_cfg.interleaved:
            box = run["t_samples"][stage]
            assert torch.equal(ms.boxes.reshape(-1, 4), box.boxes)


def check_htc_gradients(run):
    """``check_gradients``, and every mask head's parameters get a
    gradient; under information flow the heads before the last get more
    than their own stage's loss gives them (checked by the gradients'
    agreement with JAX's, whose heads get it the same way)."""
    check_gradients(run)
    n = run["tdet"].cascade_cfg.num_stages
    for stage in range(n):
        assert run["t_grads"][f"mask_heads.{stage}.conv_logits.weight"].abs().max() > 0
        if run["tdet"].net.mask_info_flow and stage:
            assert run["t_grads"][f"mask_heads.{stage}.conv_res.weight"].abs().max() > 0


def _fused_pool(module, feats, rois, valid, out_size, sem):
    """JAX ``HTCNet``'s pooled RoI features: the pyramid's, plus the
    semantic embedding's where given."""
    pooled = module._pool(feats, rois, valid, out_size)
    if sem is not None:
        pooled = pooled + module._pool_semantic(sem, rois, valid, out_size)
    return pooled


def bf16_htc_stages(make_cfg):
    """JAX's bfloat16 HTC on the batch: its levels, semantic outputs,
    proposals, each stage's RoIs (refined as its ``predict`` refines them),
    pooled features and head outputs, its detections, their pooled 14 x 14
    features and every stage's mask logits on them; and the port's
    bfloat16 and float32 builds on the same weights."""
    mc = make_cfg(jax_load_config)
    jdet = jax_build(mc, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    rs = np.random.RandomState(0)
    variables = _random_variables(shapes, rs)
    batch = htc_batch(rs, bool(mc["roi_head"].get("semantic_head")))
    jv = jax.tree.map(jnp.asarray, variables)
    anchors, nla = jdet.anchors_for(CANVAS)
    net, cc = jdet.net, jdet.cascade_cfg
    jb = jax.tree.map(jnp.asarray, batch)

    @_jit
    def stages(v, b):
        feats = net.apply(v, b["images"], method=j_htc.HTCNet.features)
        seg = sem = None
        if net.semantic_head is not None:
            seg, sem = net.apply(v, feats, method=j_htc.HTCNet.semantic_out)
        cls, reg, iou = jdet._rpn_flat(v, feats)
        props = jdet._proposals(cls, reg, iou, anchors, nla, b["img_shape"],
                                jdet.test_proposal_cfg)
        rois, outs = props[0], []
        bb, r = rois.shape[:2]
        for s in range(cc.num_stages):
            pooled = net.apply(v, feats, rois, props[2], 7, sem, method=_fused_pool)
            cls_s, reg_s = net.apply(v, feats, rois, props[2], method=j_htc.HTCNet.bbox_out,
                                     stage=s, sem_feat=sem)
            outs.append((rois, pooled, cls_s, reg_s))
            hc = j_croi.stage_head_cfg(jdet.bbox_cfg, s)
            rois = jax.vmap(lambda ro, cs, bp, shp: j_croi.refine_boxes(hc, ro, cs, bp, shp))(
                rois, cls_s.reshape(bb, r, -1).astype(jnp.float32),
                reg_s.reshape(bb, r, -1).astype(jnp.float32), b["img_shape"])
        dets, _, dvalid, _ = jdet.predict(v, b, anchors, nla)
        det_boxes = dets[..., :4] * b["scale_factor"][:, None, :]
        pooled = net.apply(v, feats, det_boxes, dvalid, 14, sem, method=_fused_pool)
        masks = net.apply(v, feats, det_boxes, dvalid, method=j_htc.HTCNet.mask_out_all_stages,
                          sem_feat=sem)
        return feats, (seg, sem), props, outs, (det_boxes, dvalid, pooled, masks)

    feats, semantic, props, outs, det = stages(jv, jb)
    state = from_jax_params(variables)
    ports = {}
    for dtype in (BF16, torch.float32):
        ports[dtype] = build_detector(make_cfg(load_config), device="cpu", dtype=dtype)
        ports[dtype].net.load_state_dict(state, strict=True)
    return dict(feats=feats, semantic=semantic, props=props, outs=outs, det=det, ports=ports)


def check_bf16_htc(st):
    """The semantic head on JAX's levels; each stage's box head on JAX's
    pooled features of the stage's RoIs and every stage's mask logits
    (information flow included) on JAX's pooled features of its
    detections: each within ``ROI_TOL`` and closer than the port's float32
    build.  The port's pooled features (pyramid plus embedding) of the same
    RoIs within ``ROI_TOL`` of JAX's: JAX pools with the XLA path, the port
    with the Pallas kernels' arithmetic, an ulp apart."""
    valid = _t(st["props"][2])
    seg_j, sem_j = st["semantic"]
    boxes, dvalid, pooled14_j, masks_j = st["det"]
    errs = {}
    for dtype, det in st["ports"].items():
        feats = [_t(f, dtype) for f in st["feats"]]
        sem = None if sem_j is None else _t(sem_j, dtype)
        e = {}
        with torch.no_grad():
            if sem_j is not None:
                seg, emb = det.net.semantic_out(feats)
                assert seg.dtype == torch.float32 and emb.dtype == dtype
                e["semantic"] = max(_rel_err(seg, seg_j), _rel_err(emb, sem_j))
            for stage, (rois, pooled_j, cls_j, reg_j) in enumerate(st["outs"]):
                cls, reg = det.net.bbox_heads[stage](_t(pooled_j, dtype))
                assert cls.dtype == reg.dtype == dtype
                e[f"stage {stage}"] = max(_rel_err(cls, cls_j), _rel_err(reg, reg_j))
                e[f"pooled {stage}"] = _rel_err(
                    det.net._fused_pool(feats, _t(rois), valid, 7, sem), pooled_j)
            masks = det.net.mask_heads_out(_t(pooled14_j, dtype))
            e.update({f"masks {s}": _rel_err(m, mj) for s, (m, mj) in enumerate(zip(masks,
                                                                                     masks_j))})
            e["pooled masks"] = _rel_err(
                det.net._fused_pool(feats, _t(boxes), _t(dvalid), 14, sem), pooled14_j)
        errs[dtype] = e
    for what, err in errs[BF16].items():
        assert err <= ROI_TOL, (what, errs)
        if not what.startswith("pooled"):
            assert err < errs[torch.float32][what] or err == 0, (what, errs)
    return errs


# --------------------------------------------- the tiny HTC with the semantic branch
def _htc(load):
    return tiny_htc(load(config_path("htc/htc_r50_fpn_1x_coco.py")).model.to_dict())


@pytest.fixture(scope="module")
def run():
    return run_htc_pair(_htc)


def test_htc_config(run):
    det = run["tdet"]
    cc, net = det.cascade_cfg, det.net
    assert (cc.num_stages, cc.stage_pos_iou, cc.interleaved, cc.prob) == (
        3, (0.5, 0.6, 0.7), True, False)
    assert net.mask_info_flow and net.semantic_stride == 8
    assert [h.conv_res is None for h in net.mask_heads] == [True, False, False]
    assert tuple(net.semantic_head.conv_seg.weight.shape[:2]) == (STUFF_CLASSES, 16)


def test_htc_predict_matches_jax(run):
    check_htc_predict(run)


def test_htc_samples_match_jax(run):
    check_samples(run)
    check_mask_samples(run)


def test_htc_losses_match_jax(run):
    check_cascade_losses(run)


def test_htc_gradients_match_jax(run):
    check_htc_gradients(run)
    assert run["t_grads"]["semantic_head.lateral_0.weight"].abs().max() > 0


@pytest.mark.parametrize("step", [0, 1])
def test_htc_sgd_steps_match_jax(run, step):
    check_step(run, step, check_cascade_losses(run))


def test_bf16_htc_stages_on_jax_inputs():
    check_bf16_htc(bf16_htc_stages(_htc))
