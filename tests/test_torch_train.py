"""The PyTorch port's flagship train step against the JAX package's, on the CPU.

The tiny flagship (``_build(tiny=True)``'s overrides of
``boosting_rcnn_r50_pafpn_1x_utdac.py``: ResNet-18 at width 8 with frozen
stem and stage 1, PAFPN 32, RPN 32 x 2, FC 64, 32 sampled RoIs per image)
gets random weights made with numpy from a seed, which go to the JAX
package as flax variables and to the port through
``weights.from_jax_params``.  Both see the same two images on the
(128, 160) canvas with 5 seeded ground-truth boxes each (and one padded
slot in the second image).  The JAX package's ``train_sample`` gives the
``RoISample`` that both ``loss(..., sample=)`` calls take, since the two
packages draw different random bits.  Checked:

  * the train-config proposals: the same set of valid boxes, within 1e-3 px;
  * the port's ``sample_rois`` fed the JAX package's uniform draws: every
    field equal;
  * the five losses: rtol 1e-4;
  * every parameter gradient, mapped with ``from_jax_params``: within
    ``1e-3 * max|g|`` of the tensor plus ``1e-6 * max|g|`` of the whole
    network (float32 convolutions and the RoIAlign scatter sum in other
    orders, through ~30 layers; the second term covers tensors whose
    gradient is a near-cancelling sum, such as the P7 conv's, ~1e-6);
    frozen parameters get none in the port and zeros in the JAX package;
  * the parameters after 1 and 2 SGD steps of JAX
    ``make_train_step(proposal_mode="external")`` and the port's step,
    with a schedule that warms up and decays within the two steps: within
    ``1e-3 * max|p - p0|`` plus ``1e-7 * max|p|`` of the tensor (one
    float32 rounding of the update), frozen ones bit-identical; the
    metrics (losses, total, gradient norm before the clip) rtol 1e-4.
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
from boosting_rcnn_tpu.engine import train as j_train  # noqa: E402
from boosting_rcnn_tpu.models.detectors.two_stage import TwoStageNet  # noqa: E402
from boosting_rcnn_tpu.models.roi_heads import prob_roi_head as j_prob  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.engine import train as t_train  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads import prob_roi_head as t_prob  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402

CONFIG = os.path.join(REPO, "configs/boosting_rcnn/boosting_rcnn_r50_pafpn_1x_utdac.py")
CANVAS = (128, 160)
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_rpn_iou", "loss_cls", "loss_bbox")
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1_")


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


def _batch(rs):
    """Two images, 5 gts each of sides 12-70 px inside the valid shape, one
    padded slot in the second image."""
    img_shape = np.array([[128.0, 150.0], [116.0, 160.0]], np.float32)
    gts = np.zeros((2, 6, 4), np.float32)
    for i, (h, w) in enumerate(img_shape):
        wh = rs.uniform(12, 70, (6, 2))
        xy = rs.uniform(0, 1, (6, 2)) * ([w, h] - wh)
        gts[i] = np.concatenate([xy, xy + wh], -1)
    gt_mask = np.ones((2, 6), bool)
    gt_mask[0, 5] = False
    gts[0, 5] = 0.0
    return {
        "images": (rs.rand(2, *CANVAS, 3) * 2.0 - 1.0).astype(np.float32),
        "gt_bboxes": gts,
        "gt_labels": rs.randint(0, 4, (2, 6)).astype(np.int32),
        "gt_mask": gt_mask,
        "img_shape": img_shape,
    }


def _schedules():
    kw = dict(decay_epochs=(1,), warmup_iters=2, warmup_ratio=0.5)  # lr 0.01, then 0.0015
    return j_train.step_lr_schedule(0.02, 1, **kw), t_train.step_lr_schedule(0.02, 1, **kw)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's multi-threaded CPU convolution backward (2.13.0+cpu) gave
    run-to-run different weight gradients, and in some runs heap
    corruption, on an 8-core x86 host; single-threaded it is repeatable.
    The port's CPU backward runs on one thread here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy_sample(sample):
    return tuple(np.array(x) for x in sample)


@pytest.fixture(scope="module")
def run():
    """Both packages through their loss, gradients and two train steps on
    the same weights, batch and samples."""
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

    sample_fn = jax.jit(lambda v, r: jdet.train_sample(v, r, jb, anchors, nla))
    sample0 = sample_fn(jv, rng)

    def j_loss(params, sample):
        losses = jdet.loss({"params": params, "batch_stats": jv["batch_stats"]}, rng, jb,
                           anchors, nla, sample=sample)
        return sum(losses.values()), losses

    (_, j_losses), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jv["params"], sample0)
    t_losses = tdet.loss(batch, t_anchors, t_nla, sample=_numpy_sample(sample0))
    sum(t_losses.values()).backward()
    t_grads = {k: (None if p.grad is None else p.grad.clone())
               for k, p in tdet.net.named_parameters()}
    tdet.net.zero_grad(set_to_none=True)

    # two SGD steps, each on the JAX package's sample at the current weights
    j_sched, t_sched = _schedules()
    tx = j_train.make_optimizer(j_sched, params=jv["params"], frozen_stages=1)
    state = j_train.create_train_state(jv, tx)
    j_step = jax.jit(j_train.make_train_step(jdet, anchors, nla, proposal_mode="external"))
    t_step = t_train.make_train_step(
        tdet_train, t_anchors, t_nla,
        t_train.make_optimizer(tdet_train.net.parameters(), t_sched))
    p0 = {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()}
    steps = []
    for _ in range(2):
        sample = sample_fn({"params": state.params, "batch_stats": state.batch_stats}, rng)
        state, j_metrics = j_step(state, jb, rng, sample)
        t_metrics = t_step(batch, _numpy_sample(sample))
        steps.append((from_jax_params(jax.tree.map(np.asarray, state.params)),
                      {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()},
                      j_metrics, t_metrics))
    return dict(jdet=jdet, jv=jv, jb=jb, tdet=tdet, batch=batch, anchors=anchors, nla=nla,
                rng=rng, sample0=sample0, j_losses=j_losses, t_losses=t_losses,
                j_grads=from_jax_params(jax.tree.map(np.asarray, j_grads)), t_grads=t_grads,
                p0=p0, steps=steps)


def test_train_proposals_same_set(run):
    jdet, jv, jb, tdet = run["jdet"], run["jv"], run["jb"], run["tdet"]

    @jax.jit
    def jax_props(v):
        feats = jdet.net.apply(v, jb["images"], method=TwoStageNet.features)
        cls, reg, iou = jdet._rpn_flat(v, feats)
        return jdet._proposals(cls, reg, iou, run["anchors"], run["nla"], jb["img_shape"],
                               jdet.train_proposal_cfg)

    jbox, jsc, jval = (np.asarray(x) for x in jax_props(jv))
    with torch.no_grad():
        feats = tdet.net.features(torch.from_numpy(run["batch"]["images"]))
        tbox, tsc, tval = tdet._proposals(*tdet._rpn_flat(feats), np.array(run["anchors"]),
                                          run["nla"], run["batch"]["img_shape"],
                                          tdet.train_proposal_cfg)
    assert tbox.shape == jbox.shape == (2, 64, 4)
    for i in range(2):
        ref, got = jbox[i][jval[i]], tbox[i][tval[i]].numpy()
        assert len(got) == len(ref) > 0
        dist = np.abs(ref[:, None, :] - got[None, :, :]).max(-1)
        assert dist.min(1).max() < 1e-3
        assert sorted(dist.argmin(1).tolist()) == list(range(len(got)))
        np.testing.assert_allclose(np.sort(tsc[i][tval[i]].numpy()), np.sort(jsc[i][jval[i]]),
                                   rtol=1e-4)


def test_sample_rois_with_jax_uniforms_field_by_field(run):
    """Each image's assignment and sampling on the JAX package's train
    proposals: the port's ``sample_rois`` given the uniforms that JAX's
    ``random_sample`` draws from the same key gives the same slots."""
    jdet, batch = run["jdet"], run["batch"]
    s0 = run["sample0"]
    rs = np.random.RandomState(5)
    cfg_t = run["tdet"].roi_cfg
    for i in range(2):
        props = np.asarray(s0.boxes[i])[~np.asarray(s0.is_gt[i])]
        props = np.concatenate([props, rs.uniform(0, 100, (20, 4)).astype(np.float32)])
        props[:, 2:] = np.maximum(props[:, 2:], props[:, :2] + 4.0)
        scores = rs.rand(len(props)).astype(np.float32)
        pvalid = rs.rand(len(props)) > 0.1
        key = jax.random.PRNGKey(20 + i)
        gt = [batch[k][i] for k in ("gt_bboxes", "gt_mask", "gt_labels")]
        ref = j_prob.sample_rois(jdet.roi_cfg, key, jnp.asarray(props), jnp.asarray(scores),
                                 jnp.asarray(pvalid), *map(jnp.asarray, gt))
        n = len(props) + gt[0].shape[0]
        kp, kn = jax.random.split(key)
        uniforms = tuple(torch.from_numpy(np.asarray(jax.random.uniform(k, (n,))))
                         for k in (kp, kn))
        got = t_prob.sample_rois(cfg_t, torch.from_numpy(props), torch.from_numpy(scores),
                                 torch.from_numpy(pvalid),
                                 *(torch.from_numpy(np.asarray(x)) for x in gt),
                                 uniforms=uniforms)
        assert got._fields == ref._fields
        assert int(got.is_pos.sum()) > 0 and int(got.valid.sum()) == 32
        for field in ref._fields:
            np.testing.assert_allclose(getattr(got, field).numpy(),
                                       np.asarray(getattr(ref, field)),
                                       rtol=1e-6, atol=1e-6, err_msg=field)


def test_five_losses_match_jax(run):
    assert set(run["t_losses"]) == set(run["j_losses"]) == set(LOSSES)
    for k in LOSSES:
        got, ref = run["t_losses"][k].item(), float(run["j_losses"][k])
        assert np.isfinite(got) and got > 0, k
        np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=k)
    assert np.asarray(run["sample0"].is_pos).sum() > 0


def test_parameter_gradients_match_jax(run):
    t_grads, j_grads = run["t_grads"], run["j_grads"]
    assert set(t_grads) == set(j_grads)
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
    assert float(t_metrics["grad_norm"]) > 35.0  # the clip acts
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
