"""The Seesaw loss with its class counts carried, and the normed mask
logits, in the PyTorch port against the JAX package, on the CPU, in
float32.

Modules, on inputs made with numpy from a seed, values and gradients
within 1e-5 of the largest value:

  * ``seesaw_loss`` (JAX ``ops/losses.py:462-493``) with counts that are 0
    in some classes, all 0, and at another ``p`` and ``q``; the
    compensation's probabilities are not detached, as in the JAX package;
  * ``bbox_head_loss`` with the Seesaw loss, mean and elementwise;
  * ``ConvFCBBoxHead.next_seesaw_counts`` against the flax head's
    ``update_seesaw_counts`` (exactly), the buffer left as it was;
  * ``FCNMaskHead`` and ``HTCMaskHead`` with ``predictor_cfg=dict(type=
    "NormedConv2d", tempearture=20)`` (``NormedConv1x1``, JAX
    ``_NormedConv1x1``).

Whole tiny detectors, the Seesaw counts set to a vector with zeros in it
on both sides:

  * the Seesaw Mask R-CNN with the normed mask head
    (``configs/seesaw_loss/mask_rcnn_r50_fpn_random_seesaw_loss_normed_mask_mstrain_2x_lvis_v1.py``
    at ``tests/test_torch_mask_rcnn.py``'s size, 4 classes) at the
    detectors harness's tolerances: ``predict`` (the masks of JAX's
    detections within 1e-4, ``test_seesaw_mask_rcnn_predict_matches_jax``), the
    five losses on JAX's ``RoISample`` (rtol 1e-4), every gradient, the
    parameters after two SGD steps, and the counts after the loss (left
    as they were) and after each step equal to JAX's ``batch_stats``;
  * the Seesaw Cascade Mask R-CNN
    (``cascade_mask_rcnn_r101_fpn_random_seesaw_loss_mstrain_2x_lvis_v1.py``
    cut as ``tests/test_torch_htc.py::tiny_htc`` cuts Cascade Mask R-CNN)
    through that file's harness: ``predict``, every stage's losses and
    gradients, and each stage's counts after each of two fused steps
    equal to JAX's;
  * the counts through ``state_dict``, a checkpoint and a resumed model.

``weights.from_mmdet_state_dict`` raises on an mmdet Seesaw box head's
``fc_cls`` of C + 2 rows, naming why.
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

from boosting_rcnn_tpu.builder import build_detector as jax_build  # noqa: E402
from boosting_rcnn_tpu.config import load_config as jax_load_config  # noqa: E402
from boosting_rcnn_tpu.engine import train as j_train  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads import bbox_head as j_bbox  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads import mask_head as j_mask  # noqa: E402
from boosting_rcnn_tpu.ops import losses as j_L  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.engine import train as t_train  # noqa: E402
from boosting_rcnn_tpu_torch.engine.checkpoint import (  # noqa: E402
    restore_checkpoint,
    save_checkpoint,
)
from boosting_rcnn_tpu_torch.models.roi_heads import bbox_head as t_bbox  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads import mask_head as t_mask  # noqa: E402
from boosting_rcnn_tpu_torch.ops import losses as t_L  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params, from_mmdet_state_dict  # noqa: E402

from test_torch_boosting_detectors import (  # noqa: E402
    _batch,
    _random_variables,
    _rpn_uniforms,
    check_gradients,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
)
from test_torch_cascade import check_cascade_losses  # noqa: E402
from test_torch_htc import check_htc_gradients, check_htc_predict, run_htc_pair, tiny_htc  # noqa: E402
from test_torch_mask_rcnn import _ellipse, _tiny  # noqa: E402

CANVAS = (128, 160)
SEESAW_MASK = "seesaw_loss/mask_rcnn_r50_fpn_random_seesaw_loss_normed_mask_mstrain_2x_lvis_v1.py"
SEESAW_CASCADE = "seesaw_loss/cascade_mask_rcnn_r101_fpn_random_seesaw_loss_mstrain_2x_lvis_v1.py"
MASK_LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "loss_mask")
# the tiny models' starting counts (4 classes and the background): two
# classes never sampled, one rare, one common
COUNTS = np.array([0.0, 3.0, 0.0, 250.0, 4000.0], np.float32)


def _close(got, ref, rel=1e-5, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max(), err_msg=what)


# ------------------------------------------------------------------- losses
@pytest.mark.parametrize("counts,p,q", [
    ("zeros_in_some", 0.8, 2.0), ("all_zero", 0.8, 2.0), ("zeros_in_some", 0.5, 1.5)])
def test_seesaw_loss_matches_jax(counts, p, q):
    rs = np.random.RandomState(3)
    n, c = 200, 9
    pred = (rs.randn(n, c) * 2.5).astype(np.float32)
    labels = rs.randint(0, c, n)
    labels[:20] = 1  # a frequent class
    cum = (rs.randint(0, 500, c) * (rs.rand(c) < 0.6)).astype(np.float32)
    if counts == "all_zero":
        cum[:] = 0.0
    assert counts == "all_zero" or (cum == 0).any()
    weight = (rs.rand(n) < 0.9).astype(np.float32)

    def jax_fn(x):
        return j_L.seesaw_loss(x, jnp.asarray(labels), jnp.asarray(cum), weight=jnp.asarray(weight),
                               p=p, q=q, reduction="mean", avg_factor=weight.sum())

    ref, ref_g = jax.value_and_grad(jax_fn)(jnp.asarray(pred))
    x = torch.from_numpy(pred).requires_grad_()
    got = t_L.seesaw_loss(x, torch.from_numpy(labels), torch.from_numpy(cum),
                          weight=torch.from_numpy(weight), p=p, q=q, reduction="mean",
                          avg_factor=float(weight.sum()))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    _close(x.grad, ref_g, what="d pred")


@pytest.mark.parametrize("reduction", [None, "none"])
def test_seesaw_bbox_head_loss_matches_jax(reduction):
    rs = np.random.RandomState(4)
    r, c = 64, 4
    cls = (rs.randn(r, c + 1) * 2).astype(np.float32)
    reg = (rs.randn(r, 4 * c) * 0.2).astype(np.float32)
    labels = rs.randint(0, c + 1, r)
    label_w = (rs.rand(r) < 0.9).astype(np.float32)
    rois = np.tile(np.array([[10.0, 10.0, 50.0, 60.0]], np.float32), (r, 1))
    bbox_t = (rs.randn(r, 4) * 0.5).astype(np.float32)
    bbox_w = np.repeat((labels < c)[:, None], 4, 1).astype(np.float32)
    kw = dict(num_classes=c, loss_cls_type="seesaw", seesaw_p=0.8, seesaw_q=2.0,
              loss_cls_weight=1.0, loss_bbox_weight=1.0)
    jcfg, tcfg = j_bbox.BBoxHeadCfg(**kw), t_bbox.BBoxHeadCfg(**kw)
    fixed = (rois, labels, label_w, bbox_t, bbox_w)

    def jax_fn(x):
        out = j_bbox.bbox_head_loss(jcfg, x, jnp.asarray(reg), *map(jnp.asarray, fixed),
                                    reduction_override=reduction,
                                    seesaw_counts=jnp.asarray(COUNTS))
        return jnp.sum(out["loss_cls"]), out["loss_cls"]

    (_, ref), ref_g = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(cls))
    x = torch.from_numpy(cls).requires_grad_()
    got = t_bbox.bbox_head_loss(tcfg, x, torch.from_numpy(reg), *map(torch.from_numpy, fixed),
                                reduction_override=reduction,
                                seesaw_counts=torch.from_numpy(COUNTS))["loss_cls"]
    got.sum().backward()
    _close(got, ref, what="loss_cls")
    _close(x.grad, ref_g, what="d cls")
    with pytest.raises(ValueError, match="counts"):
        t_bbox.bbox_head_loss(tcfg, x, torch.from_numpy(reg), *map(torch.from_numpy, fixed))


def test_next_seesaw_counts_match_the_flax_update():
    rs = np.random.RandomState(5)
    labels = rs.randint(0, 5, 300)
    weights = (rs.rand(300) < 0.8).astype(np.float32)
    flax_head = j_bbox.ConvFCBBoxHead(num_classes=4, fc_out_channels=8, seesaw=True)
    x = jnp.zeros((2, 7, 7, 4))
    v = flax_head.init(jax.random.PRNGKey(0), x)
    v = {"params": v["params"], "batch_stats": {"seesaw_counts": jnp.asarray(COUNTS)}}
    ref, _ = flax_head.apply(v, jnp.asarray(labels), jnp.asarray(weights),
                             method=j_bbox.ConvFCBBoxHead.update_seesaw_counts,
                             mutable=["batch_stats"])
    head = t_bbox.ConvFCBBoxHead(torch.Generator().manual_seed(0), 4, in_channels=4,
                                 fc_out_channels=8, seesaw=True)
    assert tuple(head.seesaw_counts.shape) == (5,) and not head.seesaw_counts.any()
    head.seesaw_counts.copy_(torch.from_numpy(COUNTS))
    got = head.next_seesaw_counts(torch.from_numpy(labels), torch.from_numpy(weights))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(head.seesaw_counts.numpy(), COUNTS)
    assert "seesaw_counts" in head.state_dict()


@pytest.mark.parametrize("htc", [False, True])
def test_normed_mask_logits_match_jax(htc):
    predictor = dict(type="NormedConv2d", tempearture=20)
    kw = dict(num_classes=5, num_convs=2, conv_channels=8, predictor_cfg=predictor)
    flax_head = (j_mask.HTCMaskHead(**kw, with_conv_res=False) if htc
                 else j_mask.FCNMaskHead(**kw))
    rs = np.random.RandomState(6)
    x = rs.randn(6, 14, 14, 16).astype(np.float32)
    x[0, 3, 4] = 0.0  # a pixel of zeros: its norm is the 1e-6 alone
    shapes = jax.eval_shape(lambda: flax_head.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = _random_variables(shapes, rs)
    cot = rs.randn(6, 28, 28, 5).astype(np.float32)

    def jax_fn(v, xx):
        out = flax_head.apply(v, xx)
        out = out if not htc else out[0] if isinstance(out, tuple) else out
        return jnp.sum(out * cot), out

    (_, ref), (ref_gp, ref_gx) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    cls = t_mask.HTCMaskHead if htc else t_mask.FCNMaskHead
    head = cls(torch.Generator().manual_seed(0), num_classes=5, in_channels=16, num_convs=2,
               conv_channels=8, predictor_cfg=predictor)
    assert isinstance(head.conv_logits, t_mask.NormedConv1x1)
    assert head.conv_logits.temperature == 20.0
    head.load_state_dict(from_jax_params(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    got = head(xt, return_feat=False) if htc else head(xt)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got, ref, what="logits")
    _close(xt.grad, ref_gx, what="d x")
    grads = from_jax_params(jax.tree.map(np.asarray, ref_gp))
    for name, p in head.named_parameters():
        _close(p.grad, grads[name].reshape(p.shape), what=f"d {name}")


# ----------------------------------------------------- tiny Seesaw Mask R-CNN
def _tiny_seesaw(load):
    mc = _tiny(load(config_path(SEESAW_MASK)).model.to_dict())
    mc["roi_head"]["bbox_head"]["loss_cls"]["num_classes"] = 4
    return mc


def with_counts(variables, heads=("bbox_head",)):
    """The random variables with every Seesaw head's counts ``COUNTS``."""
    for head in heads:
        variables["batch_stats"][head]["seesaw_counts"] = COUNTS.copy()
    return variables


def _counts(state) -> dict:
    return {k: v for k, v in state.items() if k.endswith("seesaw_counts")}


def run_mask_pair(make_cfg, seed: int = 0, edit_variables=None):
    """Both packages on ``make_cfg``'s tiny mask model through ``predict``,
    the loss on JAX's ``RoISample`` (JAX's with its ``batch_stats`` moved,
    ``loss_with_live_bn``), its gradients and two SGD steps of JAX
    ``make_train_step(proposal_mode="external")``'s arithmetic and the
    port's train step, on the same weights, batch, samples and RPN draws;
    after the loss and each step JAX's ``batch_stats`` and the port's
    buffers.  ``edit_variables`` sets variables of the random ones."""
    mc = make_cfg(jax_load_config)
    jdet = jax_build(mc, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    rs = np.random.RandomState(seed)
    variables = _random_variables(shapes, rs)
    if edit_variables is not None:
        variables = edit_variables(variables)
    batch = _batch(rs, 4)
    batch["gt_mask_crops"] = np.stack([np.stack([_ellipse(rs) for _ in range(6)])
                                       for _ in range(2)])
    jv = jax.tree.map(jnp.asarray, variables)
    jb = jax.tree.map(jnp.asarray, batch)
    anchors, nla = jdet.anchors_for(CANVAS)
    rng = jax.random.PRNGKey(3)
    n_anchors = anchors.shape[0]

    tdet, tdet_train = (build_detector(make_cfg(load_config), device="cpu") for _ in range(2))
    for det in (tdet, tdet_train):
        det.net.load_state_dict(from_jax_params(variables), strict=True)
    t_anchors, t_nla = tdet.anchors_for(CANVAS)
    assert t_nla == nla

    j_pred = jax.jit(lambda v, b: jdet.predict(v, b, anchors, nla))(jv, jb)
    t_pred = tdet.predict(batch, t_anchors, t_nla)

    stats0 = jv["batch_stats"]
    sample_fn = jax.jit(lambda v, r: jdet.train_sample(v, r, jb, anchors, nla))
    sample0 = sample_fn(jv, rng)

    def j_loss(params, stats, sample, key):
        losses, new_stats = j_train.loss_with_live_bn(
            jdet, {"params": params, "batch_stats": stats}, key, jb, anchors, nla, sample=sample)
        return sum(losses.values()), (losses, new_stats)

    grad_fn = jax.jit(jax.value_and_grad(j_loss, has_aux=True))
    (_, (j_losses, j_stats)), j_grads = grad_fn(jv["params"], stats0, sample0, rng)
    t_losses = tdet.loss(batch, t_anchors, t_nla, sample=tuple(np.array(x) for x in sample0),
                         rpn_uniforms=_rpn_uniforms(rng, n_anchors))
    sum(t_losses.values()).backward()
    t_grads = {k: (None if p.grad is None else p.grad.clone())
               for k, p in tdet.net.named_parameters()}

    def buffers(det):
        return {k: v.clone() for k, v in det.net.named_buffers()}

    def jax_stats(stats):
        return from_jax_params({"params": {}, "batch_stats": jax.tree.map(np.asarray, stats)})

    kw = dict(decay_epochs=(1,), warmup_iters=2, warmup_ratio=0.5)  # lr 0.01, then 0.0015
    j_sched, t_sched = (m.step_lr_schedule(0.02, 1, **kw) for m in (j_train, t_train))
    tx = j_train.make_optimizer(j_sched, params=jv["params"], frozen_stages=1)
    state = j_train.create_train_state(jv, tx)
    apply_fn = jax.jit(lambda st, g, ns: (st.apply_gradients(grads=g).replace(
        batch_stats=jax.lax.stop_gradient(ns)), jnp.sqrt(sum(
            jnp.sum(x * x) for x in jax.tree_util.tree_leaves(g)))))
    t_step = t_train.make_train_step(
        tdet_train, t_anchors, t_nla,
        t_train.make_optimizer(tdet_train.net.parameters(), t_sched))
    p0 = {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()}
    steps, states = [], [(jax_stats(j_stats), buffers(tdet))]
    for k in range(2):
        sample = sample_fn({"params": state.params, "batch_stats": state.batch_stats}, rng)
        (total, (losses, new_stats)), grads = grad_fn(
            state.params, state.batch_stats, sample, jax.random.fold_in(rng, state.step))
        state, grad_norm = apply_fn(state, grads, new_stats)
        j_metrics = {"loss": total, **{n: jnp.sum(v) for n, v in losses.items()},
                     "grad_norm": grad_norm}
        t_metrics = t_step(batch, tuple(np.array(x) for x in sample),
                           rpn_uniforms=_rpn_uniforms(jax.random.fold_in(rng, k), n_anchors))
        steps.append((from_jax_params(jax.tree.map(np.asarray, state.params)),
                      {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()},
                      j_metrics, t_metrics))
        states.append((jax_stats(state.batch_stats), buffers(tdet_train)))
    return dict(jdet=jdet, tdet=tdet, tdet_train=tdet_train, batch=batch, j_pred=j_pred,
                t_pred=t_pred, sample0=sample0, j_losses=j_losses, t_losses=t_losses,
                j_grads=from_jax_params(jax.tree.map(np.asarray, j_grads)), t_grads=t_grads,
                p0=p0, steps=steps, states=states, anchors=(t_anchors, t_nla))


@pytest.fixture(scope="module")
def run():
    return run_mask_pair(_tiny_seesaw, edit_variables=with_counts)


def test_seesaw_mask_rcnn_config(run):
    det = run["tdet"]
    head = det.net.bbox_head
    assert det.bbox_cfg.loss_cls_type == "seesaw" and head.seesaw
    assert isinstance(det.net.mask_head.conv_logits, t_mask.NormedConv1x1)


def test_seesaw_mask_rcnn_predict_matches_jax(run):
    """Detections as ``check_predict``; the masks of JAX's detections within
    1e-4 of JAX's.  The normed logits are 20 times a cosine, so they move
    with the pooled features more than a plain predictor's: the two
    packages' detections, 5e-4 px apart, put 3 of the 200,704 mask cells
    of each package's own detections 1.1e-4 apart (those of the same
    detections agree within 7.3e-6)."""
    check_predict({"j_pred": run["j_pred"][:3], "t_pred": run["t_pred"][:3]})
    det, batch = run["tdet"], run["batch"]
    jd, jl, jv = (torch.from_numpy(np.array(x)) for x in run["j_pred"][:3])
    got = run["t_pred"][3]
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, jd.shape[1], 28, 28)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    with torch.inference_mode():
        feats = det.net.features(torch.from_numpy(batch["images"]))
        masks, = det.mask_predict(feats, jd, jl, jv, torch.from_numpy(batch["scale_factor"]))
    np.testing.assert_allclose(masks.numpy(), np.asarray(run["j_pred"][3]), rtol=0, atol=1e-4)


def test_seesaw_mask_rcnn_losses_match_jax(run):
    assert set(run["t_losses"]) == set(run["j_losses"]) == set(MASK_LOSSES)
    for k in MASK_LOSSES:
        got, ref = run["t_losses"][k].item(), float(run["j_losses"][k])
        assert np.isfinite(got) and got > 0, k
        np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=k)


def test_seesaw_mask_rcnn_gradients_match_jax(run):
    check_gradients(run)
    assert run["t_grads"]["mask_head.conv_logits.weight"].abs().max() > 0


@pytest.mark.parametrize("step", [0, 1])
def test_seesaw_mask_rcnn_sgd_steps_match_jax(run, step):
    check_step(run, step, MASK_LOSSES)


@pytest.mark.parametrize("after", ["loss", "step 1", "step 2"])
def test_seesaw_counts_match_jax(run, after):
    """After the loss alone the port's counts are the starting ones (JAX's
    ``loss_with_live_bn`` hands its moved ones out, which a step would
    keep); after each step both equal, bit for bit."""
    i = ("loss", "step 1", "step 2").index(after)
    ref, got = (_counts(x) for x in run["states"][i])
    assert set(ref) == set(got) == {"bbox_head.seesaw_counts"}
    r, g = ref["bbox_head.seesaw_counts"], got["bbox_head.seesaw_counts"]
    if after == "loss":
        np.testing.assert_array_equal(g.numpy(), COUNTS)
        assert (r.numpy() > COUNTS).any()
        return
    np.testing.assert_array_equal(g.numpy(), r.numpy())
    # each step adds its valid sampled slots: 2 images x 32 slots at most
    added = r.numpy() - (COUNTS if i == 1 else _counts(run["states"][i - 1][0])[
        "bbox_head.seesaw_counts"].numpy())
    assert 0 < added.sum() <= 64 and (added == np.round(added)).all()


def test_seesaw_counts_survive_state_dict_and_checkpoint(run, tmp_path):
    det = run["tdet_train"]
    want = det.net.bbox_head.seesaw_counts.clone()
    assert not torch.equal(want, torch.from_numpy(COUNTS))
    assert torch.equal(det.net.state_dict()["bbox_head.seesaw_counts"], want)
    path = save_checkpoint(str(tmp_path / "iter_2"), det.net, step=2)
    other = build_detector(_tiny_seesaw(load_config), device="cpu", seed=5)
    assert not other.net.bbox_head.seesaw_counts.any()
    assert restore_checkpoint(path, other.net)["step"] == 2
    assert torch.equal(other.net.bbox_head.seesaw_counts, want)


# -------------------------------------------- tiny Seesaw Cascade Mask R-CNN
def _tiny_cascade(load):
    return tiny_htc(load(config_path(SEESAW_CASCADE)).model.to_dict())


@pytest.fixture(scope="module")
def cascade_run():
    return run_htc_pair(_tiny_cascade, edit_variables=lambda v: with_counts(
        v, [f"bbox_heads_{s}" for s in range(3)]))


def test_seesaw_cascade_predict_and_losses_match_jax(cascade_run):
    det = cascade_run["tdet"]
    assert all(h.seesaw for h in det.net.bbox_heads) and det.bbox_cfg.loss_cls_type == "seesaw"
    check_htc_predict(cascade_run)
    check_cascade_losses(cascade_run)


def test_seesaw_cascade_gradients_match_jax(cascade_run):
    check_htc_gradients(cascade_run)


@pytest.mark.parametrize("step", [0, 1])
def test_seesaw_cascade_counts_match_jax_after_each_step(cascade_run, step):
    ref, got = (_counts(x) for x in cascade_run["states"][step])
    assert set(ref) == set(got) == {f"bbox_heads.{s}.seesaw_counts" for s in range(3)}
    for k, r in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), r.numpy(), err_msg=k)
        assert r.sum() > COUNTS.sum() + step, k
    check_step(cascade_run, step, ())


# ------------------------------------------------------------ mmdet weights
def test_mmdet_seesaw_cls_rows_raise_named():
    c = 4
    sd = {"roi_head.bbox_head.fc_cls.weight": torch.zeros(c + 2, 8),
          "roi_head.bbox_head.fc_cls.bias": torch.zeros(c + 2),
          "roi_head.bbox_head.fc_reg.weight": torch.zeros(4 * c, 8)}
    with pytest.raises(NotImplementedError, match="objectness pair"):
        from_mmdet_state_dict(sd)
    # a cascade's class-agnostic stage: the classes from its mask head
    sd = {"roi_head.bbox_head.1.fc_cls.weight": torch.zeros(c + 2, 8),
          "roi_head.bbox_head.1.fc_reg.weight": torch.zeros(4, 8),
          "roi_head.mask_head.1.conv_logits.weight": torch.zeros(c, 8, 1, 1)}
    with pytest.raises(NotImplementedError, match="Seesaw"):
        from_mmdet_state_dict(sd)
    sd["roi_head.bbox_head.1.fc_cls.weight"] = torch.zeros(c + 1, 8)
    with pytest.raises(ValueError, match="no counterpart"):  # past the rows check
        from_mmdet_state_dict({**sd, "roi_head.bbox_head.1.unknown.weight": torch.zeros(1)})
