"""PISA in the PyTorch port against the JAX package, on the CPU.

``ops/pisa.py``'s ISR-P weights and CARL loss against JAX's on seeded
inputs that hold exact IoU ties within a gt, two gts of one label, no
positive at all, and two images whose per-image gt indices collide (the
JAX package, and so the port, groups gt k of one image with gt k of the
other where their labels agree; mmdet offsets each image's ids): values
within 1e-6, CARL's gradients with respect to the logits and the box loss
within 1e-5 of the largest.  ``score_hlr_sample`` on JAX's draws, field by
field.  Then two tiny detectors through
``tests/test_torch_boosting_detectors.py``'s harness and at its tolerances
(predict, the losses with ``loss_carl``, every gradient, two SGD steps):
``configs/pisa/pisa_faster_rcnn_r50_fpn_1x_coco.py`` (ISR-P and CARL on
the standard head) and the fork's
``configs/pisa/pisa_prob_faster_rcnn_r50_fpn_1x_coco.py`` (the ATSS RPN,
the ``ProbPISARoIHead``: PISA's losses and the prior fusion at test), at
ResNet-18 width 8, FPN and RPN 32, FC 64, 4 classes; their bfloat16
losses against the JAX bfloat16 build's within 1.5% and closer than the
port's float32 losses.  The PISA configs build, the fork's with its nested
``_delete_``.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_boosting_detectors import (  # noqa: E402
    ATSS_LOSSES,
    CANVAS,
    _rpn_uniforms,
    check_gradients,
    check_losses,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
    run_pair,
    shrink_heads,
)

from boosting_rcnn_tpu.builder import build_detector as jax_build  # noqa: E402
from boosting_rcnn_tpu.config import load_config as jax_load_config  # noqa: E402
from boosting_rcnn_tpu.ops import assigners as j_assigners  # noqa: E402
from boosting_rcnn_tpu.ops import pisa as j_pisa  # noqa: E402
from boosting_rcnn_tpu.ops import samplers as j_samplers  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.ops import pisa  # noqa: E402
from boosting_rcnn_tpu_torch.ops.assigners import AssignResult  # noqa: E402
from boosting_rcnn_tpu_torch.ops.samplers import score_hlr_sample  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402

PISA_FASTER = "pisa/pisa_faster_rcnn_r50_fpn_1x_coco.py"
PISA_PROB = "pisa/pisa_prob_faster_rcnn_r50_fpn_1x_coco.py"
PLAIN_LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "loss_carl")
PROB_LOSSES = ATSS_LOSSES + ("loss_carl",)
BF16_TOL = 0.015  # tests/test_torch_bf16.py's loss tolerance
# the JAX reference rounds at every bfloat16 op, as on the TPU
_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})


# ---------------------------------------------------------------- the losses
def _isr_inputs(seed: int, n: int = 48, case: str = "random"):
    """Flattened slots of one or two images: labels of 3 classes (3 the
    background), per-image gt indices, IoUs with exact ties inside a gt,
    valid slots, positives, positive cross entropies."""
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, 3, n)
    gt = rs.randint(0, 4, n)
    pos = rs.rand(n) < 0.5
    if case == "no_positive":
        pos[:] = False
    ious = rs.uniform(0.5, 1.0, n).astype(np.float32)
    # exact ties: in the first gt group of each label, a few equal IoUs
    for lab in range(3):
        idx = np.flatnonzero(pos & (labels == lab))
        if len(idx):
            group = idx[gt[idx] == gt[idx[0]]]
            ious[group[:3]] = ious[group[0]]
    valid = rs.rand(n) < 0.9
    valid |= pos
    labels = np.where(pos, labels, 3)
    loss = rs.uniform(0.05, 3.0, n).astype(np.float32)
    return dict(labels=labels.astype(np.int32), gt_ids=gt.astype(np.int32), ious=ious,
                label_weights=valid.astype(np.float32), pos_mask=pos,
                pos_loss_cls=loss)


def _collision_inputs():
    """Two images of 8 slots: gt 0 of each is of label 1, image 1's better
    localised; ranked within one merged group (JAX), image 0's slots rank
    behind all of image 1's, ranked per image (mmdet) each image's best
    leads its own group."""
    labels = np.array([1, 1, 2, 1, 3, 3, 3, 3, 1, 1, 1, 2, 3, 3, 3, 3], np.int32)
    gt = np.array([0, 0, 1, 2, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0], np.int32)
    pos = labels < 3
    ious = np.array([0.9, 0.8, 0.7, 0.5, 0.1, 0.2, 0.3, 0.4,
                     0.95, 0.93, 0.91, 0.6, 0.1, 0.2, 0.3, 0.4], np.float32)
    return dict(labels=labels, gt_ids=gt, ious=ious, label_weights=np.ones(16, np.float32),
                pos_mask=pos, pos_loss_cls=np.linspace(0.2, 1.7, 16).astype(np.float32))


def _isr_pair(x, k=2.0, bias=0.0):
    ref = np.asarray(j_pisa.isr_p_weights(*(jnp.asarray(x[key]) for key in (
        "labels", "gt_ids", "ious", "label_weights", "pos_mask", "pos_loss_cls")), k=k,
        bias=bias))
    got = pisa.isr_p_weights(*(torch.as_tensor(x[key]) for key in (
        "labels", "gt_ids", "ious", "label_weights", "pos_mask", "pos_loss_cls")), k=k,
        bias=bias)
    return got.numpy(), ref


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("case", ["random", "no_positive"])
def test_isr_p_weights_match_jax(seed, case):
    x = _isr_inputs(seed, case=case)
    for k, bias in ((2.0, 0.0), (1.0, 0.3)):
        got, ref = _isr_pair(x, k, bias)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    if case == "no_positive":
        np.testing.assert_array_equal(got, x["label_weights"])
    else:
        pos = x["pos_mask"]
        # the positives' cross-entropy sum is kept
        np.testing.assert_allclose((got * x["pos_loss_cls"])[pos].sum(),
                                   (x["label_weights"] * x["pos_loss_cls"])[pos].sum(),
                                   rtol=1e-5)


def test_isr_p_ties_rank_by_index():
    """Equal IoUs of one gt rank by slot index (a stable sort)."""
    ious = torch.tensor([0.7, 0.7, 0.7, 0.9])
    same = torch.ones((4, 4), dtype=torch.bool)
    assert pisa.group_rank(ious, same).tolist() == [1, 2, 3, 0]


def test_isr_p_groups_gts_across_images_as_jax():
    """The batch-2 case where the per-image gt index decides the weights: the
    port's equal the JAX package's, and differ from the weights of the gt
    ids offset per image (mmdet's grouping)."""
    x = _collision_inputs()
    got, ref = _isr_pair(x)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    offset = dict(x, gt_ids=x["gt_ids"] + 8 * (np.arange(16) >= 8))
    mmdet, _ = _isr_pair(offset)
    assert np.abs(mmdet - got).max() > 1e-2


def _carl_inputs(seed: int, n: int = 40, c: int = 5):
    rs = np.random.RandomState(seed)
    return dict(cls_score=rs.randn(n, c).astype(np.float32) * 2,
                labels=np.where(rs.rand(n) < 0.4, rs.randint(0, c - 1, n), c - 1).astype(np.int32),
                reg=np.abs(rs.randn(n, 4)).astype(np.float32))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("sigmoid", [False, True])
def test_carl_loss_and_gradients_match_jax(seed, sigmoid):
    x = _carl_inputs(seed)
    c = x["cls_score"].shape[1]
    pos = x["labels"] < c - 1
    avg = float(max(pos.sum(), 1) + 3)

    def j_fn(score, reg):
        return j_pisa.carl_loss(score, jnp.asarray(x["labels"]), jnp.asarray(pos), reg,
                                k=1.0, bias=0.2, avg_factor=avg, sigmoid=sigmoid)

    ref, (g_score, g_reg) = jax.value_and_grad(j_fn, argnums=(0, 1))(
        jnp.asarray(x["cls_score"]), jnp.asarray(x["reg"]))
    score = torch.tensor(x["cls_score"], requires_grad=True)
    reg = torch.tensor(x["reg"], requires_grad=True)
    got = pisa.carl_loss(score, torch.as_tensor(x["labels"]), torch.as_tensor(pos), reg,
                         k=1.0, bias=0.2, avg_factor=avg, sigmoid=sigmoid)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    for g, r in ((score.grad, g_score), (reg.grad, g_reg)):
        r = np.asarray(r)
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())
    # the logits' gradient runs through the weights and their normaliser
    assert np.abs(np.asarray(g_score)[pos]).max() > 0


@pytest.mark.parametrize("seed", range(3))
def test_score_hlr_sample_matches_jax_draws(seed):
    rs = np.random.RandomState(seed)
    n = 300
    gt_inds = np.where(rs.rand(n) < 0.15, rs.randint(1, 5, n),
                       np.where(rs.rand(n) < 0.9, 0, -1)).astype(np.int32)
    valid = rs.rand(n) < 0.95
    scores = rs.rand(n).astype(np.float32)
    scores[:6] = scores[6]  # ties among the hard negatives
    overlaps = rs.rand(n).astype(np.float32)
    rng = jax.random.PRNGKey(seed)
    ref = j_samplers.score_hlr_sample(
        rng, j_assigners.AssignResult(jnp.asarray(gt_inds), jnp.asarray(overlaps),
                                      jnp.zeros(n, jnp.int32)),
        jnp.asarray(valid), jnp.asarray(scores), num=128, pos_fraction=0.25)
    kp, kn = jax.random.split(rng)
    u = [torch.tensor(np.asarray(jax.random.uniform(key, (n,)))) for key in (kp, kn)]
    got = score_hlr_sample(
        AssignResult(torch.as_tensor(gt_inds).long(), torch.as_tensor(overlaps),
                     torch.zeros(n, dtype=torch.long)),
        torch.as_tensor(valid), torch.as_tensor(scores), *u, num=128, pos_fraction=0.25)
    assert int(ref.num_neg) > 40 and int(ref.num_pos) > 10
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)


# ------------------------------------------------------------ tiny detectors
def _pisa_faster(load):
    mc = load(config_path(PISA_FASTER)).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"]["in_channels"] = [8, 16, 32, 64]
    mc["roi_head"]["bbox_roi_extractor"]["out_channels"] = 32
    return shrink_heads(mc, num_classes=4)


def _pisa_prob(load):
    mc = load(config_path(PISA_PROB)).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"]["in_channels"] = [8, 16, 32, 64]
    mc["roi_head"]["bbox_roi_extractor"]["out_channels"] = 32
    return shrink_heads(mc)


MODELS = {"pisa_faster": (_pisa_faster, PLAIN_LOSSES), "pisa_prob": (_pisa_prob, PROB_LOSSES)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def run(request):
    make_cfg, names = MODELS[request.param]
    out = run_pair(make_cfg)
    out.update(name=request.param, names=names, make_cfg=make_cfg)
    return out


def test_tiny_pisa_model_has_its_parts(run):
    cfg = run["tdet"].roi_cfg
    assert dict(cfg.isr) == {"k": 2, "bias": 0} and dict(cfg.carl) == {"k": 1, "bias": 0.2}
    assert not cfg.boost
    assert cfg.prob == (run["name"] == "pisa_prob")
    assert run["tdet"].rpn_type == ("atss_rpn" if run["name"] == "pisa_prob" else "rpn")


def test_tiny_pisa_predict_matches_jax(run):
    check_predict(run)


def test_tiny_pisa_losses_match_jax(run):
    check_losses(run, run["names"])


def test_tiny_pisa_gradients_match_jax(run):
    check_gradients(run)


@pytest.mark.parametrize("step", [0, 1])
def test_tiny_pisa_sgd_steps_match_jax(run, step):
    check_step(run, step, run["names"])


def test_tiny_pisa_bf16_losses_match_jax_bf16(run):
    """The port's bfloat16 losses on the run's weights, batch, JAX's float32
    ``RoISample`` and RPN draws against the JAX bfloat16 build's (XLA's
    excess precision off): each within 1.5%, and all together closer than
    the port's float32 losses are."""
    make_cfg = run["make_cfg"]
    jdet = jax_build(make_cfg(jax_load_config), dtype=jnp.bfloat16)
    anchors, nla = jdet.anchors_for(CANVAS)
    jb = jax.tree.map(jnp.asarray, run["batch"])
    jv = jax.tree.map(jnp.asarray, run["variables"])
    rng = jax.random.PRNGKey(3)
    ref = _jit(lambda v, s: jdet.loss(v, rng, jb, anchors, nla, sample=s))(jv, run["sample0"])
    det = build_detector(make_cfg(load_config), device="cpu", dtype=torch.bfloat16)
    det.net.load_state_dict(from_jax_params(run["variables"]), strict=True)
    t_anchors, t_nla = det.anchors_for(CANVAS)
    kw = ({"rpn_uniforms": _rpn_uniforms(rng, anchors.shape[0])} if det.rpn_type == "rpn"
          else {})
    with torch.no_grad():
        got = det.loss(run["batch"], t_anchors, t_nla,
                       sample=tuple(np.array(x) for x in run["sample0"]), **kw)
    assert set(got) == set(ref) == set(run["names"])
    err_bf16 = err_f32 = 0.0
    for k, v in got.items():
        r = float(ref[k])
        assert v.dtype == torch.float32 and torch.isfinite(v), k
        np.testing.assert_allclose(v.item(), r, rtol=BF16_TOL, err_msg=k)
        err_bf16 += abs(v.item() - r) / abs(r)
        err_f32 += abs(run["t_losses"][k].item() - r) / abs(r)
    assert err_bf16 < err_f32, (err_bf16, err_f32)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", [
    PISA_FASTER, PISA_PROB, "pisa/pisa_mask_rcnn_r50_fpn_1x_coco.py",
    "pisa/pisa_faster_rcnn_x101_32x4d_fpn_1x_coco.py",
    "pisa/pisa_mask_rcnn_x101_32x4d_fpn_1x_coco.py"])
def test_pisa_configs_build(name, monkeypatch):
    """Each two-stage PISA config builds at full width (the seeded
    initialisation skipped) with ISR-P and CARL; the fork's keeps a nested
    ``_delete_`` in its RPN's ``loss_bbox``, which the builder drops."""
    from boosting_rcnn_tpu_torch.models import layers as t_layers

    monkeypatch.setattr(t_layers, "lecun_normal_", lambda weight, fan_in, gen: None)
    for init in ("kaiming_uniform_", "uniform_"):  # torch's own inits, overwritten
        monkeypatch.setattr(torch.nn.init, init, lambda tensor, *a, **k: tensor)
    mc = load_config(config_path(name)).model.to_dict()
    if name == PISA_PROB:
        assert "_delete_" in mc["rpn_head"]["loss_bbox"]
        assert mc["train_cfg"]["rcnn"]["sampler"]["type"] == "ScoreHLRSampler"
    det = build_detector(mc, device="cpu")
    assert det.roi_cfg.isr is not None and det.roi_cfg.carl is not None
    assert det.roi_cfg.num_samples == 512 and det.roi_cfg.pos_fraction == 0.25


def test_pisa_with_the_boosting_loss_raises():
    mc = _pisa_faster(load_config)
    mc["roi_head"]["type"] = "ProbRoIHead"
    with pytest.raises(NotImplementedError, match="isr"):
        build_detector(mc, device="cpu")
