"""The PyTorch port's Cascade R-CNN against the JAX package's, on the CPU:
the fork's ProbCascade (``configs/ensemble/prob_cascade_rcnn_r50_pafpn_1x_
utdac.py``: the flagship's ATSS RPN and PAFPN, three class-agnostic
Shared2FC stages with smooth L1, boosting with gamma 0.5, prior fusion at
test) here, and the harness that ``tests/test_torch_cascade_coco.py``
runs on the plain Cascade R-CNN R50-FPN.

The modules, on random inputs made with numpy from a seed, within 1e-5 of
the largest value: ``refine_boxes`` (class-agnostic and class-wise, argmax
foreground class), ``cascade_stage_loss`` with and without boosting (and
its gradients), and the class-agnostic ``bbox_head_loss`` (L1 and smooth
L1) and ``bbox_head_decode``.

The whole tiny detector (``_build(tiny=True)``'s widths: ResNet-18 at
width 8, neck and RPN 32, FC 64, 32 RoIs a stage; random weights made with
numpy, into the JAX package as flax variables and into the port through
``weights.from_jax_params``; two images on the 128 x 160 canvas with 6
seeded gt slots, one padded), at the tolerances of the family's tests
(``tests/test_torch_boosting_detectors.py``):

  * ``predict``: labels and valid equal, detections within 1e-3;
  * the loss, with JAX's own random draws: the plain RPN's anchor sampler
    and each stage's RoI sampler are fed the uniforms the JAX cascade
    draws (``_roi_uniforms``); every stage's sample field by field (the
    refined boxes within 1e-3 px, the priors and IoUs within 1e-5), the
    losses rtol 1e-4, every gradient within ``1e-3 * max|g|`` of the
    tensor plus ``1e-6`` of the network's;
  * two SGD steps of JAX ``make_train_step(proposal_mode="fused")`` (a
    cascade has no other mode) and the port's step given the same draws,
    each from JAX's state before it (the port's parameters, momentum and
    step count set to JAX's: a fused step samples the proposals of its own
    parameters, and the float32 rounding of the first update, up to 0.4%
    of the P6 and P7 convs' near-cancelling update, moves the second
    step's proposals by up to 6e-3 px and its gradients by up to 7 times
    their tolerance): the metrics rtol 1e-4, the parameters within ``1e-3
    * max|p - p0|`` plus ``1e-7 * max|p|``, frozen ones bit-identical.

bfloat16, the ProbCascade stage by stage on JAX's bfloat16 levels and
proposals (the JAX side jitted with ``xla_allow_excess_precision`` off,
``tests/test_torch_bf16.py``): each stage's head on JAX's RoIs of that
stage within the RoI-head tolerance (1.5% of the stage's largest value)
and closer than the port's float32 build, and ``roi_predict``'s kept
detections matched 90% within 0.5 px and 0.01.  (The detections are not
held closer than the float32 build's: after three refinements both sit
at the reference's own bfloat16 noise, box and score errors 0.164 against
0.157 in all.)  The JAX cascade pools with the XLA path in bfloat16, not
the Pallas kernel's arithmetic that the port's plain RoIAlign copies:
they round an ulp apart.
"""
import os
import sys

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""  # no compile-cache writes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from boosting_rcnn_tpu.builder import build_detector as jax_build  # noqa: E402
from boosting_rcnn_tpu.config import load_config as jax_load_config  # noqa: E402
from boosting_rcnn_tpu.engine import train as j_train  # noqa: E402
from boosting_rcnn_tpu.models.detectors import cascade as j_cascade  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads import bbox_head as j_bbox  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads import cascade_roi_head as j_croi  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads.prob_roi_head import RoISample as JRoISample  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.engine import train as t_train  # noqa: E402
from boosting_rcnn_tpu_torch.models.detectors import cascade as t_cascade  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads import bbox_head as t_bbox  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads import cascade_roi_head as t_croi  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads.prob_roi_head import RoISample  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402
from test_torch_bf16 import _jit, _matched, _rel_err, _t  # noqa: E402
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

BF16 = torch.bfloat16
ROI_TOL = 0.015  # PERF.md §2: the RoI head in bfloat16, of the stage's largest value
EXACT = ("is_pos", "valid", "matched_label", "gt_idx", "cand_idx", "is_gt")


def stage_losses(num_stages: int):
    return tuple(f"s{s}.{k}" for s in range(num_stages) for k in ("loss_cls", "loss_bbox"))


def tiny_cascade(mc):
    """``_build(tiny=True)``'s widths for a cascade config: ResNet-18 at
    width 8, neck and RPN 32 (the ATSS RPN 2 convs deep), FC 64 in every
    stage, 64 train and 32 test proposals, 32 RoIs a stage."""
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"].update(in_channels=[8, 16, 32, 64], out_channels=32)
    mc["rpn_head"].update(feat_channels=32, in_channels=32)
    if mc["rpn_head"]["type"] == "ATSSRPNHead":
        mc["rpn_head"]["stacked_convs"] = 2
    for head in mc["roi_head"]["bbox_head"]:
        head.update(fc_out_channels=64, in_channels=32)
    mc["train_cfg"]["rpn_proposal"].update(nms_pre=200, max_per_img=64)
    for rcnn in mc["train_cfg"]["rcnn"]:
        rcnn["sampler"]["num"] = 32
    mc["test_cfg"]["rpn"].update(nms_pre=100, max_per_img=32)
    return mc


def _roi_uniforms(rng, b: int, sizes):
    """The uniforms of the JAX cascade's RoI samplers under ``loss(...,
    rng)``: ``roi_rng`` is the second half of ``rng``, stage ``s`` folds
    ``s`` into it and splits one key per image, and each image's sampler
    draws from the two halves of its key, over its ``sizes[s]`` candidates
    (the gt boxes, then the proposals or the slots sampled before)."""
    _, roi_rng = jax.random.split(rng)
    out = []
    for stage, n in enumerate(sizes):
        per_image = []
        for key in jax.random.split(jax.random.fold_in(roi_rng, stage), b):
            kp, kn = jax.random.split(key)
            per_image.append([np.asarray(jax.random.uniform(k, (n,))) for k in (kp, kn)])
        out.append(np.asarray(per_image, np.float32))
    return out


class _Spy:
    """Records the flat ``RoISample`` each stage's loss is given, in
    ``module.cascade_stage_loss`` for the duration of a ``with``."""

    def __init__(self, module):
        self.module, self.samples = module, []

    def __enter__(self):
        orig = self.orig = self.module.cascade_stage_loss

        def spy(cc, hc, stage, cls_s, reg_s, flat, **kw):
            self.samples.append(flat)
            return orig(cc, hc, stage, cls_s, reg_s, flat, **kw)

        self.module.cascade_stage_loss = spy
        return self

    def __exit__(self, *exc):
        self.module.cascade_stage_loss = self.orig


def _trace(opt_state):
    """The momentum (optax ``TraceState.trace``) in a JAX optimizer state."""
    if isinstance(opt_state, optax.TraceState):
        return opt_state.trace
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            trace = _trace(sub)
            if trace is not None:
                return trace
    return None


def _sync(det, opt, state):
    """The port's detector and optimizer at the JAX train state: its
    parameters, momentum and step count."""
    params = from_jax_params(jax.tree.map(np.asarray, state.params))
    det.net.load_state_dict({**det.net.state_dict(), **params}, strict=True)
    step = int(state.step)
    if step:
        trace = from_jax_params(jax.tree.map(np.asarray, _trace(state.opt_state)))
        for name, p in det.net.named_parameters():
            if p.requires_grad:
                opt.sgd.state[p]["momentum_buffer"] = trace[name].reshape(p.shape).clone()
    opt.step_count = step


def run_cascade_pair(make_cfg, seed: int = 0, edit_variables=None):
    """Both packages on ``make_cfg(load_config(...))``'s cascade (each
    package's config reader reads the file) through predict, the loss with
    its per-stage samples, its gradients and two fused train steps on the
    same weights, batch and random draws (the weights and batch drawn from
    ``seed``; ``edit_variables`` sets variables of the random ones)."""
    mc = make_cfg(jax_load_config)
    heads = mc["roi_head"]["bbox_head"]
    num_classes = heads[0]["num_classes"]
    jdet = jax_build(mc, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    rs = np.random.RandomState(seed)
    variables = _random_variables(shapes, rs)
    if edit_variables is not None:
        variables = edit_variables(variables)
    batch = _batch(rs, num_classes)
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
    sizes = [g + tdet.train_proposal_cfg.max_per_img] + [g + tdet.roi_cfg.num_samples] * (
        n_stages - 1)

    def draws(key):
        kw = {"roi_uniforms": _roi_uniforms(key, 2, sizes)}
        if tdet.rpn_type == "rpn":
            kw["rpn_uniforms"] = _rpn_uniforms(key, anchors.shape[0])
        return kw

    j_pred = jax.jit(lambda v, b: jdet.predict(v, b, anchors, nla))(jv, jb)
    t_pred = tdet.predict(batch, t_anchors, t_nla)

    def j_loss(params):
        with _Spy(j_cascade) as spy:
            losses = jdet.loss({"params": params, "batch_stats": jv["batch_stats"]}, rng, jb,
                               anchors, nla)
        return sum(losses.values()), (losses, spy.samples)

    (_, (j_losses, j_samples)), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jv["params"])
    with _Spy(t_cascade) as spy:
        t_losses = tdet.loss(batch, t_anchors, t_nla, **draws(rng))
    sum(t_losses.values()).backward()
    t_grads = {k: (None if p.grad is None else p.grad.clone())
               for k, p in tdet.net.named_parameters()}

    kw = dict(decay_epochs=(1,), warmup_iters=2, warmup_ratio=0.5)  # lr 0.01, then 0.0015
    j_sched, t_sched = (m.step_lr_schedule(0.02, 1, **kw) for m in (j_train, t_train))
    tx = j_train.make_optimizer(j_sched, params=jv["params"], frozen_stages=1)
    state = j_train.create_train_state(jv, tx)
    j_step = jax.jit(j_train.make_train_step(jdet, anchors, nla, proposal_mode="fused"))
    t_opt = t_train.make_optimizer(tdet_train.net.parameters(), t_sched)
    t_step = t_train.make_train_step(tdet_train, t_anchors, t_nla, t_opt)
    p0 = {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()}
    steps = []
    for k in range(2):
        _sync(tdet_train, t_opt, state)
        state, j_metrics = j_step(state, jb, rng)  # the step folds its count into rng
        t_metrics = t_step(batch, **draws(jax.random.fold_in(rng, k)))
        steps.append((from_jax_params(jax.tree.map(np.asarray, state.params)),
                      {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()},
                      j_metrics, t_metrics))
    return dict(jdet=jdet, tdet=tdet, batch=batch, j_pred=j_pred, t_pred=t_pred,
                j_samples=j_samples, t_samples=spy.samples, j_losses=j_losses,
                t_losses=t_losses, j_grads=from_jax_params(jax.tree.map(np.asarray, j_grads)),
                t_grads=t_grads, p0=p0, steps=steps, names=stage_losses(n_stages))


def check_samples(run):
    """Each stage's sample, field by field.  A stage past the first samples
    refined boxes: where a slot differs there, the message gives how far
    its candidates' IoUs sit from the stage's threshold."""
    cc = run["tdet"].cascade_cfg
    assert len(run["j_samples"]) == len(run["t_samples"]) == cc.num_stages
    for stage, (ref, got) in enumerate(zip(run["j_samples"], run["t_samples"])):
        ref = JRoISample(*(np.asarray(x) for x in ref))
        assert int(got.is_pos.sum()) > 0, stage
        for name in EXACT:
            r, g = getattr(ref, name), getattr(got, name).numpy()
            if name == "matched_label":  # only the positives carry a label
                r, g = np.where(ref.is_pos, r, -1), np.where(ref.is_pos, g, -1)
            if not np.array_equal(g, r.astype(g.dtype)):
                bad = np.flatnonzero(g != r)
                margin = np.abs(np.concatenate([ref.iou[bad], got.iou.numpy()[bad]])
                                - cc.stage_pos_iou[stage]).min()
                raise AssertionError(f"stage {stage}: {name} differs at {len(bad)} slots; the "
                                     f"closest IoU is {margin:.3g} from the threshold")
        for name, atol in (("boxes", 1e-3), ("matched_gt", 1e-3), ("prior", 1e-5),
                           ("iou", 1e-5)):
            np.testing.assert_allclose(getattr(got, name).numpy(), getattr(ref, name), rtol=0,
                                       atol=atol, err_msg=f"stage {stage} {name}")


def check_cascade_losses(run):
    names = ("loss_rpn_cls", "loss_rpn_bbox") + (
        ("loss_rpn_iou",) if run["tdet"].rpn_type == "atss_rpn" else ()) + run["names"]
    assert set(run["t_losses"]) == set(run["j_losses"]) == set(names)
    for k in names:
        got, ref = run["t_losses"][k].item(), float(run["j_losses"][k])
        assert np.isfinite(got) and got > 0, k
        np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=k)
    return names


# ------------------------------------------------------------------ modules
def _close(got, ref, scale=None):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-5 * max(scale, 1e-30))


def _rois(rs, n, side=(8.0, 90.0)):
    wh = rs.uniform(*side, (n, 2))
    xy = rs.uniform(0, 140, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _head_cfgs(agnostic: bool, loss: str = "l1"):
    kw = dict(num_classes=5, target_stds=(0.1, 0.1, 0.2, 0.2), reg_class_agnostic=agnostic,
              loss_cls_weight=1.0, loss_bbox_weight=1.0)
    return (j_bbox.BBoxHeadCfg(loss_bbox_type=loss, smooth_l1_beta=1.0, **kw),
            t_bbox.BBoxHeadCfg(loss_bbox_type=loss, smooth_l1_beta=1.0, **kw))


@pytest.mark.parametrize("agnostic", [True, False])
def test_refine_boxes_matches_jax(agnostic):
    rs = np.random.RandomState(1)
    b, r, c = 2, 40, 5
    rois = np.stack([_rois(rs, r) for _ in range(b)])
    cls = rs.randn(b, r, c + 1).astype(np.float32)
    cls[0, 3, 1] = cls[0, 3, 2] = cls[0, 3].max() + 1  # a tie: the first class wins
    reg = (rs.randn(b, r, 4 if agnostic else 4 * c) * 2).astype(np.float32)
    img_shape = np.array([[128.0, 150.0], [116.0, 160.0]], np.float32)
    cj, ct = _head_cfgs(agnostic)
    for stage in range(3):
        hj, ht = j_croi.stage_head_cfg(cj, stage), t_croi.stage_head_cfg(ct, stage)
        assert hj.target_stds == ht.target_stds
        ref = jax.vmap(lambda ro, cs, bp, shp: j_croi.refine_boxes(hj, ro, cs, bp, shp))(
            *(jnp.asarray(x) for x in (rois, cls, reg, img_shape)))
        got = t_croi.refine_boxes(ht, *(torch.from_numpy(x) for x in (rois, cls, reg,
                                                                      img_shape)))
        _close(got, ref)


@pytest.mark.parametrize("boost", [True, False])
def test_cascade_stage_loss_matches_jax(boost):
    rs = np.random.RandomState(2 + boost)
    n, c = 64, 5
    valid = rs.rand(n) < 0.8
    is_pos = valid & (rs.rand(n) < 0.3)
    boxes = _rois(rs, n)
    gt = boxes + rs.uniform(-6, 6, (n, 4)).astype(np.float32)
    label = np.where(is_pos, rs.randint(0, c, n), -1)
    prior = np.where(valid, rs.rand(n), 0.0).astype(np.float32)
    cls = rs.randn(n, c + 1).astype(np.float32)
    reg = rs.randn(n, 4).astype(np.float32)
    fields = dict(boxes=boxes, is_pos=is_pos, valid=valid, prior=prior,
                  iou=rs.rand(n).astype(np.float32), matched_gt=gt, matched_label=label,
                  gt_idx=np.zeros(n, np.int64), cand_idx=np.arange(n), is_gt=np.zeros(n, bool))
    cj, ct = _head_cfgs(True, "smooth_l1")
    cc = dict(stage_loss_weights=(1.0, 0.5, 0.25), boost=boost, gamma=0.5)
    for stage in range(3):
        def j_fn(cs, bp):
            out = j_croi.cascade_stage_loss(
                j_croi.CascadeCfg(**cc), cj, stage, cs, bp,
                JRoISample(**{k: jnp.asarray(v) for k, v in fields.items()}))
            return sum(out.values()), out

        (_, ref), ref_g = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(
            jnp.asarray(cls), jnp.asarray(reg))
        cs, bp = (torch.from_numpy(x).requires_grad_() for x in (cls, reg))
        got = t_croi.cascade_stage_loss(
            t_croi.CascadeCfg(**cc), ct, stage, cs, bp,
            RoISample(**{k: torch.from_numpy(np.asarray(v)) for k, v in fields.items()}))
        assert set(got) == set(ref) == {f"s{stage}.loss_cls", f"s{stage}.loss_bbox"}
        for k in got:
            _close(got[k], ref[k])
        sum(got.values()).backward()
        _close(cs.grad, ref_g[0])
        _close(bp.grad, ref_g[1])


@pytest.mark.parametrize("loss", ["l1", "smooth_l1"])
def test_agnostic_bbox_head_loss_and_decode_match_jax(loss):
    rs = np.random.RandomState(4)
    n, c = 48, 5
    boxes = _rois(rs, n)
    is_pos = rs.rand(n) < 0.4
    valid = is_pos | (rs.rand(n) < 0.7)
    gt = boxes + rs.uniform(-8, 8, (n, 4)).astype(np.float32)
    lab = np.where(is_pos, rs.randint(0, c, n), c)
    cls = rs.randn(n, c + 1).astype(np.float32)
    reg = (rs.randn(n, 4) * 0.8).astype(np.float32)
    cj, ct = _head_cfgs(True, loss)
    ref_t = j_bbox.bbox_targets(cj, *(jnp.asarray(x) for x in (boxes, is_pos, valid, gt, lab)))
    got_t = t_bbox.bbox_targets(ct, *(torch.from_numpy(x) for x in (boxes, is_pos, valid, gt,
                                                                     lab)))
    for reduction in (None, "none"):
        ref = j_bbox.bbox_head_loss(cj, jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(boxes),
                                    *ref_t, reduction_override=reduction)
        got = t_bbox.bbox_head_loss(ct, torch.from_numpy(cls), torch.from_numpy(reg),
                                    torch.from_numpy(boxes), *got_t,
                                    reduction_override=reduction)
        for k in ("loss_cls", "loss_bbox"):
            _close(got[k], ref[k])
    scores = torch.softmax(torch.from_numpy(cls) * 3, -1)
    args = (jnp.array([116.0, 150.0]), jnp.array([1.25] * 4), True, 0.05, 0.5, 20)
    rd, rl, rv = j_bbox.bbox_head_decode(cj, jnp.asarray(boxes), jnp.asarray(scores.numpy()),
                                         jnp.asarray(reg), *args, roi_valid=jnp.asarray(valid))
    dets, labels, kept = t_bbox.bbox_head_decode(
        ct, torch.from_numpy(boxes), scores, torch.from_numpy(reg),
        torch.tensor([116.0, 150.0]), torch.tensor([1.25] * 4), True, 0.05, 0.5, 20,
        roi_valid=torch.from_numpy(valid))
    assert int(kept.sum()) > 5
    np.testing.assert_array_equal(kept.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(rl))
    _close(dets, rd)


# ------------------------------------------------- the tiny ProbCascade UTDAC
def _utdac(load):
    mc = load(config_path("ensemble/prob_cascade_rcnn_r50_pafpn_1x_utdac.py")).model.to_dict()
    return tiny_cascade(mc)


@pytest.fixture(scope="module")
def run():
    return run_cascade_pair(_utdac)


def test_prob_cascade_config(run):
    det = run["tdet"]
    cc = det.cascade_cfg
    assert (cc.num_stages, cc.stage_pos_iou, cc.prob, cc.boost, cc.gamma) == (
        3, (0.5, 0.6, 0.7), True, True, 0.5)
    assert det.bbox_cfg.reg_class_agnostic and det.bbox_cfg.loss_bbox_type == "smooth_l1"
    assert [tuple(h.fc_reg.weight.shape) for h in det.net.bbox_heads] == [(4, 64)] * 3


def test_prob_cascade_predict_matches_jax(run):
    check_predict(run)


def test_prob_cascade_samples_match_jax(run):
    check_samples(run)


def test_prob_cascade_losses_match_jax(run):
    check_cascade_losses(run)


def test_prob_cascade_gradients_match_jax(run):
    check_gradients(run)
    for stage in range(3):  # each stage head gets its own gradient
        assert run["t_grads"][f"bbox_heads.{stage}.fc_cls.weight"].abs().max() > 0


@pytest.mark.parametrize("step", [0, 1])
def test_prob_cascade_sgd_steps_match_jax(run, step):
    check_step(run, step, check_cascade_losses(run))


# ------------------------------------------ bfloat16, stage by stage on JAX's
@pytest.fixture(scope="module")
def bf16_stages():
    """JAX's bfloat16 ProbCascade on the batch: its levels and test
    proposals, each stage's RoIs (refined by the stage before, as JAX's
    ``predict`` refines them) and head outputs, and its detections; and
    the port's bfloat16 and float32 builds on the same weights."""
    mc = _utdac(jax_load_config)
    jdet = jax_build(mc, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    rs = np.random.RandomState(0)
    variables = _random_variables(shapes, rs)
    batch = _batch(rs, 4)
    jv = jax.tree.map(jnp.asarray, variables)
    anchors, nla = jdet.anchors_for(CANVAS)
    net, cc = jdet.net, jdet.cascade_cfg
    img_shape = jnp.asarray(batch["img_shape"])

    @_jit
    def stages(v, images):
        feats = net.apply(v, images, method=j_cascade.CascadeNet.features)
        cls, reg, iou = jdet._rpn_flat(v, feats)
        props = jdet._proposals(cls, reg, iou, anchors, nla, img_shape, jdet.test_proposal_cfg)
        rois, outs = props[0], []
        b, r = rois.shape[:2]
        for s in range(cc.num_stages):
            cls_s, reg_s = net.apply(v, feats, rois, props[2], method=j_cascade.CascadeNet.roi_out,
                                     stage=s)
            outs.append((rois, cls_s, reg_s))
            hc = j_croi.stage_head_cfg(jdet.bbox_cfg, s)
            rois = jax.vmap(lambda ro, cs, bp, shp: j_croi.refine_boxes(hc, ro, cs, bp, shp))(
                rois, cls_s.reshape(b, r, -1).astype(jnp.float32),
                reg_s.reshape(b, r, -1).astype(jnp.float32), img_shape)
        return feats, props, outs

    feats, props, outs = stages(jv, jnp.asarray(batch["images"]))
    dets = _jit(lambda v, b: jdet.predict(v, b, anchors, nla))(
        jv, jax.tree.map(jnp.asarray, batch))
    state = from_jax_params(variables)
    ports = {}
    for dtype in (BF16, torch.float32):
        ports[dtype] = build_detector(_utdac(load_config), device="cpu", dtype=dtype)
        ports[dtype].net.load_state_dict(state, strict=True)
    return dict(batch=batch, feats=feats, props=props, outs=outs, dets=dets, ports=ports)


def test_bf16_prob_cascade_stages_on_jax_rois(bf16_stages):
    st = bf16_stages
    valid = _t(st["props"][2])
    for stage, (rois, cls_j, reg_j) in enumerate(st["outs"]):
        errs = {}
        for dtype, det in st["ports"].items():
            with torch.no_grad():
                cls, reg = det.net.roi_out([_t(f, dtype) for f in st["feats"]], _t(rois), valid,
                                           stage)
            assert cls.dtype == reg.dtype == dtype
            errs[dtype] = max(_rel_err(cls, cls_j), _rel_err(reg, reg_j))
        assert errs[BF16] <= ROI_TOL, (stage, errs)
        assert errs[BF16] < errs[torch.float32], (stage, errs)


def test_bf16_prob_cascade_predict_on_jax_proposals(bf16_stages):
    st = bf16_stages
    boxes, scores, valid = (_t(x) for x in st["props"])
    batch = st["batch"]
    det = st["ports"][BF16]
    dets, labels, kept = det.roi_predict(
        [_t(f, BF16) for f in st["feats"]], boxes, scores, valid,
        _t(batch["img_shape"]), _t(batch["scale_factor"]))
    assert dets.dtype == torch.float32 and kept.any()
    n_match, n_min, box_err, score_err = _matched(dets, labels, kept, st["dets"])
    assert n_match >= 0.9 * n_min > 0, (n_match, n_min)
    assert box_err <= 0.5 and score_err <= 0.01, (box_err, score_err)
