"""The trainable norms and backbone plugins through whole tiny detectors of
the PyTorch port against the JAX package's, on the CPU, and the config
families that use them.

Four tiny detectors, each its config with the widths cut (ResNet-50's
bottlenecks at base width 8, FPN and RPN 32, FC 16, mask convs 16, 4
classes; GN in 4 groups, which divide every width):

  * ``configs/gcnet/mask_rcnn_r50_fpn_syncbn-backbone_r4_gcb_c3-c5_1x_coco.py``
    (SyncBN with batch statistics, ``norm_eval=False``, and a ContextBlock
    after conv3 of every bottleneck in stages 2-4);
  * ``configs/gn/mask_rcnn_r50_fpn_gn-all_2x_coco.py`` (GN in the backbone,
    the FPN and a ``Shared4Conv1FCBBoxHead``);
  * ``configs/gn+ws/faster_rcnn_r50_fpn_gn_ws-all_1x_coco.py`` (ConvWS and GN
    everywhere);
  * ``configs/empirical_attention/faster_rcnn_r50_fpn_attention_1111_1x_coco.py``
    (``GeneralizedAttention`` after conv2 in stages 3-4, 8 heads, kv stride
    2, all four energy terms; its ``gamma`` drawn non-zero so it counts).

Random weights made with numpy from a seed go to the JAX package as flax
variables and to the port through ``weights.from_jax_params``; the batch
and the samplers' draws are those of ``tests/test_torch_boosting_detectors.py``
(with ellipse mask crops for the mask models).  The loss, its gradients and
the train steps run with live norms: the JAX side through
``engine.train.loss_with_live_bn`` (its train step's path: each JAX step is
``make_train_step(proposal_mode="external")``'s ``_grad_part`` on one
compiled loss gradient), the port inside ``engine.train.live_norms`` (its
train step's).  Checked at the detectors
harness's tolerances: ``predict`` on the running averages (labels and valid
equal, detections within 1e-3, masks 1e-4), the losses (rtol 1e-4), every
gradient, the parameters after two SGD steps of JAX
``make_train_step(proposal_mode="external")`` and the port's step; and the
BN running statistics after the loss forward and after each step within
1e-6 + rtol 1e-4 of JAX's ``batch_stats``.

Then the families: every file under ``configs/gcnet``, ``configs/gn``,
``configs/gn+ws``, ``configs/empirical_attention`` and
``configs/selfsup_pretrain`` builds at full width with the parts it names
(the builder still names what it does not take); ``--tiny`` (``shrink_model``)
builds each family's models, which predict and take a train step in
float32 and bfloat16, with the same parameter tree as the JAX package's
build of the same shrink; the train CLI's ``--tiny`` on the GCNet model;
a resume of the tiny GCNet model is bitwise, its running statistics
included.
"""
import glob
import os
import sys

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""  # no compile-cache writes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_boosting_detectors import (  # noqa: E402
    CANVAS,
    REPO,
    _random_variables,
    _rpn_uniforms,
    check_gradients,
    check_losses,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
)
from test_torch_mask_rcnn import _ellipse  # noqa: E402

from boosting_rcnn_tpu.builder import build_detector as jax_build  # noqa: E402
from boosting_rcnn_tpu.config import load_config as jax_load_config  # noqa: E402
from boosting_rcnn_tpu.engine import train as j_train  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.engine import train as t_train  # noqa: E402
from boosting_rcnn_tpu_torch.engine.checkpoint import (  # noqa: E402
    restore_checkpoint,
    save_checkpoint,
)
from boosting_rcnn_tpu_torch.engine.runner import shrink_model  # noqa: E402
from boosting_rcnn_tpu_torch.models import layers as t_layers  # noqa: E402
from boosting_rcnn_tpu_torch.models import plugins as t_plugins  # noqa: E402
from boosting_rcnn_tpu_torch.tools import train as train_cli  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402

GCNET = "gcnet/mask_rcnn_r50_fpn_syncbn-backbone_r4_gcb_c3-c5_1x_coco.py"
GN_ALL = "gn/mask_rcnn_r50_fpn_gn-all_2x_coco.py"
GN_WS = "gn+ws/faster_rcnn_r50_fpn_gn_ws-all_1x_coco.py"
ATTENTION = "empirical_attention/faster_rcnn_r50_fpn_attention_1111_1x_coco.py"
FAMILIES = ("gcnet", "gn", "gn+ws", "empirical_attention", "selfsup_pretrain")
FASTER_LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox")
MASK_LOSSES = FASTER_LOSSES + ("loss_mask",)
STAT_KEYS = ("running_mean", "running_var")


def _groups(norm_cfg, groups=4):
    return None if norm_cfg is None else (
        dict(norm_cfg, num_groups=groups) if norm_cfg["type"] == "GN" else norm_cfg)


def tiny_norms(mc):
    """The tiny size: ResNet-50's bottlenecks at base width 8 (stage outputs
    32-256), FPN and RPN 32, FC 16, shared and mask convs 16, 4 classes, GN
    in 4 groups; the train and test proposal and sample counts of the
    detectors harness."""
    mc["backbone"].update(depth=50, base_channels=8, norm_cfg=_groups(mc["backbone"].get(
        "norm_cfg")))
    mc["neck"].update(in_channels=[32, 64, 128, 256], out_channels=32,
                      norm_cfg=_groups(mc["neck"].get("norm_cfg")))
    mc["rpn_head"].update(in_channels=32, feat_channels=32)
    roi = mc["roi_head"]
    roi["bbox_roi_extractor"]["out_channels"] = 32
    roi["bbox_head"].update(in_channels=32, fc_out_channels=16, num_classes=4,
                            norm_cfg=_groups(roi["bbox_head"].get("norm_cfg")))
    if roi["bbox_head"]["type"] == "Shared4Conv1FCBBoxHead":
        roi["bbox_head"]["conv_out_channels"] = 16
    if roi.get("mask_head"):
        roi["mask_roi_extractor"]["out_channels"] = 32
        roi["mask_head"].update(in_channels=32, conv_out_channels=16, num_classes=4,
                                norm_cfg=_groups(roi["mask_head"].get("norm_cfg")))
    mc["train_cfg"]["rpn_proposal"].update(nms_pre=200, max_per_img=64)
    mc["train_cfg"]["rcnn"]["sampler"]["num"] = 32
    mc["test_cfg"]["rpn"].update(nms_pre=100, max_per_img=32)
    return mc


def _model(name):
    return lambda load: tiny_norms(load(config_path(name)).model.to_dict())


def _batch(rs, masks: bool):
    """Two images with 6 gt slots each, boxes of sides 12-70 px (the second
    image's last slot padded), and each gt an ellipse crop for a mask head."""
    img_shape = np.array([[128.0, 150.0], [116.0, 160.0]], np.float32)
    gts = np.zeros((2, 6, 4), np.float32)
    for i, (h, w) in enumerate(img_shape):
        wh = rs.uniform(12, 70, (6, 2))
        xy = rs.uniform(0, 1, (6, 2)) * ([w, h] - wh)
        gts[i] = np.concatenate([xy, xy + wh], -1)
    gt_mask = np.ones((2, 6), bool)
    gt_mask[1, 5] = False
    gts[1, 5] = 0.0
    batch = {
        "images": (rs.rand(2, *CANVAS, 3) * 2.0 - 1.0).astype(np.float32),
        "img_shape": img_shape,
        "scale_factor": np.array([[1.0] * 4, [1.25] * 4], np.float32),
        "gt_bboxes": gts,
        "gt_labels": rs.randint(0, 4, (2, 6)).astype(np.int32),
        "gt_mask": gt_mask,
    }
    if masks:
        batch["gt_mask_crops"] = np.stack([np.stack([_ellipse(rs) for _ in range(6)])
                                           for _ in range(2)])
    return batch


def _stats(state):
    return {k: v for k, v in state.items() if k.endswith(STAT_KEYS)}


def _check_stats(got, ref, min_moved=0, before=None):
    """The port's BN running statistics against JAX's ``batch_stats``
    (through ``from_jax_params``): within 1e-6 + rtol 1e-4; at least
    ``min_moved`` tensors moved from ``before``."""
    got, ref = _stats(got), _stats(ref)
    assert set(got) == set(ref)
    moved = 0
    for k, r in ref.items():
        np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
        moved += before is not None and not torch.equal(got[k], before[k])
    assert moved >= min_moved


RESIDUAL_SCALE = 0.1


def _damped(variables):
    """The harness's random variables with each bottleneck's last norm
    scaled by ``RESIDUAL_SCALE``: the residual branches then add less than
    the shortcut, so float32 rounding in the norms' statistics is not
    amplified from block to block as it is in a random ResNet-50 whose
    branches add as much as the shortcut."""
    params = variables["params"]["backbone"]
    for name, block in params.items():
        if name.startswith("layer") and "bn3" in block:
            bn3 = block["bn3"].get("BatchNorm_0", block["bn3"])
            bn3["scale"] = (bn3["scale"] * RESIDUAL_SCALE).astype(np.float32)
    return variables


def run_live(make_cfg, seed: int = 0):
    """Both packages on ``make_cfg``'s tiny model: predict, the loss with
    live norms, its gradients and the statistics it moved, then two train
    steps, on the same weights, batch, samples and RPN draws."""
    mc = make_cfg(jax_load_config)
    masks = bool(mc["roi_head"].get("mask_head"))
    jdet = jax_build(mc, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    rs = np.random.RandomState(seed)
    variables = _damped(_random_variables(shapes, rs))
    batch = _batch(rs, masks)
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

    stats0 = jv.get("batch_stats", {})
    sample_fn = jax.jit(lambda v, r: jdet.train_sample(v, r, jb, anchors, nla))
    sample0 = sample_fn({"params": jv["params"], "batch_stats": stats0}, rng)

    def j_loss(params, stats, sample, key):
        losses, new_stats = j_train.loss_with_live_bn(
            jdet, {"params": params, "batch_stats": stats}, key, jb, anchors, nla, sample=sample)
        return sum(losses.values()), (losses, new_stats)

    grad_fn = jax.jit(jax.value_and_grad(j_loss, has_aux=True))
    (_, (j_losses, j_stats)), j_grads = grad_fn(jv["params"], stats0, sample0, rng)
    with t_train.live_norms(tdet.net):
        t_losses = tdet.loss(batch, t_anchors, t_nla, sample=tuple(np.array(x) for x in sample0),
                             rpn_uniforms=_rpn_uniforms(rng, n_anchors))
    sum(t_losses.values()).backward()
    t_grads = {k: (None if p.grad is None else p.grad.clone())
               for k, p in tdet.net.named_parameters()}

    kw = dict(decay_epochs=(1,), warmup_iters=2, warmup_ratio=0.5)  # lr 0.01, then 0.0015
    j_sched, t_sched = (m.step_lr_schedule(0.02, 1, **kw) for m in (j_train, t_train))
    tx = j_train.make_optimizer(j_sched, params=jv["params"], frozen_stages=1)
    state = j_train.create_train_state({"params": jv["params"], "batch_stats": stats0}, tx)
    apply_fn = jax.jit(lambda st, g, ns: (st.apply_gradients(grads=g).replace(
        batch_stats=jax.lax.stop_gradient(ns)), optax.global_norm(g)))
    t_step = t_train.make_train_step(
        tdet_train, t_anchors, t_nla,
        t_train.make_optimizer(tdet_train.net.parameters(), t_sched))
    p0 = {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()}
    s0 = {k: v.clone() for k, v in _stats(tdet_train.net.state_dict()).items()}
    steps = []
    for k in range(2):
        sample = sample_fn({"params": state.params, "batch_stats": state.batch_stats}, rng)
        # JAX make_train_step(proposal_mode="external")'s step (its
        # ``_grad_part``) on the compiled loss gradient above: the key folded
        # with the step count, the update, the moved statistics
        (total, (losses, new_stats)), grads = grad_fn(
            state.params, state.batch_stats, sample, jax.random.fold_in(rng, state.step))
        state, grad_norm = apply_fn(state, grads, new_stats)
        j_metrics = {"loss": total, **{n: jnp.sum(v) for n, v in losses.items()},
                     "grad_norm": grad_norm}
        t_metrics = t_step(batch, tuple(np.array(x) for x in sample),
                           rpn_uniforms=_rpn_uniforms(jax.random.fold_in(rng, k), n_anchors))
        steps.append((from_jax_params(jax.tree.map(np.asarray, state.params)),
                      {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()},
                      j_metrics, t_metrics,
                      from_jax_params({"params": {}, "batch_stats": jax.tree.map(
                          np.asarray, state.batch_stats)}),
                      {k: v.clone() for k, v in tdet_train.net.state_dict().items()}))
    return dict(tdet=tdet, masks=masks, j_pred=j_pred, t_pred=t_pred, sample0=sample0,
                j_losses=j_losses, t_losses=t_losses,
                j_stats=from_jax_params({"params": {},
                                         "batch_stats": jax.tree.map(np.asarray, j_stats)}),
                j_grads=from_jax_params(jax.tree.map(np.asarray, j_grads)), t_grads=t_grads,
                p0=p0, s0=s0, steps=steps)


MODELS = {
    # name: (config, seed, live BN)
    "gcnet": (GCNET, 0, True),
    "gn_all": (GN_ALL, 0, False),
    # seed 0 puts a layer3_1 activation of the GN+WS model at a float32
    # edge: that one block's gradients 1.2% apart (its others within 1e-5)
    "gn_ws": (GN_WS, 1, False),
    "attention": (ATTENTION, 0, False),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def run(request):
    name = request.param
    cfg, seed, live = MODELS[name]
    out = run_live(_model(cfg), seed)
    out.update(name=name, live=live)
    return out


def test_tiny_model_has_its_parts(run):
    net = run["tdet"].net
    kinds = {type(m).__name__ for m in net.modules()}
    want = {"gcnet": {"LiveBatchNorm", "ContextBlock"},
            "gn_all": {"GroupNorm"},
            "gn_ws": {"GroupNorm", "WSConv"},
            "attention": {"GeneralizedAttention"}}[run["name"]]
    assert want <= kinds, kinds
    assert ("LiveBatchNorm" in kinds) == run["live"]
    if run["name"] in ("gn_all", "gn_ws"):
        # the GN+WS config keeps its base's two FCs (num_shared_fcs=2)
        assert net.bbox_head.num_shared_convs == 4
        assert net.bbox_head.num_shared_fcs == (1 if run["name"] == "gn_all" else 2)
        assert isinstance(net.neck.lateral_0.norm, t_layers.GroupNorm)


def test_predict_matches_jax(run):
    check_predict(dict(run, j_pred=run["j_pred"][:3], t_pred=run["t_pred"][:3]))
    if run["masks"]:
        np.testing.assert_allclose(run["t_pred"][3].numpy(), np.asarray(run["j_pred"][3]),
                                   rtol=0, atol=1e-4)


def test_live_losses_match_jax(run):
    check_losses(run, MASK_LOSSES if run["masks"] else FASTER_LOSSES)


def test_live_gradients_match_jax(run):
    check_gradients(run)


def test_statistics_after_the_loss_match_jax(run):
    """The loss forward moved every live BN's statistics once, as JAX's."""
    got = run["tdet"].net.state_dict()
    _check_stats(got, run["j_stats"], min_moved=50 if run["live"] else 0, before=run["s0"])
    if not run["live"]:
        assert all(torch.equal(got[k], v) for k, v in run["s0"].items())


# A ContextBlock's attention-pooling bias shifts every logit of its softmax
# alike, so its gradient is 0 but for rounding: its steps are weight decay
# on both sides, held to 4 float32 ulps of its value.
SHIFT_INVARIANT = "conv_mask.bias"


@pytest.mark.parametrize("step", [0, 1])
def test_sgd_steps_match_jax(run, step):
    steps = []
    for j_params, t_params, j_metrics, t_metrics, *_ in run["steps"]:
        j_params = dict(j_params)
        for name in [k for k in j_params if k.endswith(SHIFT_INVARIANT)]:
            got, ref = t_params[name], j_params.pop(name)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=4 * 2.0 ** -23,
                                       atol=0, err_msg=name)
        steps.append((j_params, t_params, j_metrics, t_metrics))
    check_step(dict(run, steps=steps), step, MASK_LOSSES if run["masks"] else FASTER_LOSSES)
    j_stats, t_state = run["steps"][step][4:]
    before = run["s0"] if step == 0 else _stats(run["steps"][0][5])
    _check_stats(t_state, j_stats, min_moved=50 if run["live"] else 0, before=before)


# ------------------------------------------------------------- the families
def _family_files():
    return sorted(p for fam in FAMILIES
                  for p in glob.glob(os.path.join(REPO, "configs", fam, "*.py")))


@pytest.fixture
def fast_init(monkeypatch):
    """Seeded initialisation skipped: a full-width build checks the
    builder, not the draws."""
    skip = lambda weight, fan_in, gen: None  # noqa: E731
    monkeypatch.setattr(t_layers, "lecun_normal_", skip)
    monkeypatch.setattr(t_plugins, "lecun_normal_", skip)


def test_family_configs_build(fast_init):
    """All 47 files of the five families build at full width, with the
    parts they name: live BN where a ResNet sets ``norm_eval=False``, WS
    convs for ConvWS, each plugin's module."""
    files = _family_files()
    assert len(files) == 47
    for path in files:
        rel = os.path.relpath(path, os.path.join(REPO, "configs"))
        mc = load_config(path).model.to_dict()
        det = build_detector(mc, device="cpu")
        bb = mc["backbone"]
        kinds = {type(m).__name__ for m in det.net.modules()}
        assert ("LiveBatchNorm" in kinds) == (bb.get("norm_eval") is False
                                              and bb["type"] == "ResNet"), rel
        assert ("WSConv" in kinds) == bool(bb.get("conv_cfg")), rel
        assert ("GroupNorm" in kinds) == (rel.split("/")[0] in ("gn", "gn+ws")), rel
        for p in bb.get("plugins") or ():
            assert p["cfg"]["type"] in kinds, rel


def test_builder_names_what_it_does_not_take(fast_init):
    base = load_config(config_path(GCNET)).model.to_dict()

    def build(edit):
        mc = load_config(config_path(GCNET)).model.to_dict()
        edit(mc)
        return build_detector(mc, device="cpu")

    cases = [
        (lambda m: m["backbone"].update(norm_cfg=dict(type="LN")), "type='LN'"),
        (lambda m: m["backbone"].update(norm_cfg=dict(type="BN", requires_grad=False)),
         "requires_grad=False"),
        (lambda m: m["backbone"].update(conv_cfg=dict(type="DCN")), "type='DCN'"),
        (lambda m: m["backbone"].update(depth=18), "plugins need a Bottleneck"),
        (lambda m: m["backbone"]["plugins"][0]["cfg"].update(type="NonLocal2d"),
         "plugin type='NonLocal2d'"),
        (lambda m: m["backbone"]["plugins"][0]["cfg"].update(pooling_type="max"),
         "pooling_type='max'"),
        (lambda m: m["backbone"]["plugins"][0].update(position="after_conv4"),
         "position='after_conv4'"),
        (lambda m: m["backbone"].update(type="Res2Net", depth=50), "plugins="),
        (lambda m: m["neck"].update(norm_cfg=dict(type="GN", num_groups=32, eps=1e-3)),
         r"neck.norm_cfg: \['eps'\]"),
        (lambda m: m["roi_head"]["mask_head"].update(norm_cfg=dict(type="IN")),
         "type='IN'"),
    ]
    assert base["backbone"]["plugins"]
    for edit, message in cases:
        with pytest.raises(NotImplementedError, match=message):
            build(edit)
    with pytest.raises(NotImplementedError, match="spatial_range"):
        build(lambda m: m["backbone"].update(plugins=[dict(
            cfg=dict(type="GeneralizedAttention", spatial_range=3),
            stages=(False, False, True, True), position="after_conv2")]))


# ------------------------------------------------------------------ --tiny
TINY = {
    GCNET: ("LiveBatchNorm", "ContextBlock"),
    GN_ALL: ("GroupNorm",),
    GN_WS: ("GroupNorm", "WSConv"),
    ATTENTION: ("GeneralizedAttention",),
    "selfsup_pretrain/mask_rcnn_r50_fpn_mocov2-pretrain_1x_coco.py": ("LiveBatchNorm",),
}


@pytest.mark.parametrize("config", sorted(TINY))
def test_tiny_shrink_builds_predicts_and_trains(config):
    """``shrink_model`` keeps what the family is about and builds; the shrunk
    parameter tree is the JAX package's for the same shrink; a predict and
    a train step in both dtypes give finite values, and the live BN's
    statistics move in the step only."""
    mc = shrink_model(load_config(config_path(config)).model.to_dict())
    jdet = jax_build(shrink_model(jax_load_config(config_path(config)).model.to_dict()),
                     dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    ref = from_jax_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    rs = np.random.RandomState(1)
    batch = _batch(rs, bool(mc["roi_head"].get("mask_head")))
    batch["gt_labels"] = rs.randint(0, 80, (2, 6)).astype(np.int32)
    for dtype in (torch.float32, torch.bfloat16):
        det = build_detector(mc, device="cpu", dtype=dtype)
        state = det.net.state_dict()
        assert {k: tuple(v.shape) for k, v in state.items()} == {
            k: tuple(v.shape) for k, v in ref.items()}
        kinds = {type(m).__name__ for m in det.net.modules()}
        assert set(TINY[config]) <= kinds, kinds
        a, n = det.anchors_for(CANVAS)
        before = {k: v.clone() for k, v in _stats(state).items()}
        dets = det.predict(batch, a, n)[0]
        assert torch.isfinite(dets).all()
        assert all(torch.equal(v, det.net.state_dict()[k]) for k, v in before.items())
        step = t_train.make_train_step(det, a, n, t_train.make_optimizer(
            det.net.parameters(), lambda s: 0.01))
        metrics = step(batch, generator=torch.Generator().manual_seed(0))
        assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
        moved = [k for k, v in before.items() if not torch.equal(v, det.net.state_dict()[k])]
        assert bool(moved) == ("LiveBatchNorm" in kinds)
        assert not det.net.training


def test_train_cli_tiny_gcnet_resume_is_bitwise(tmp_path):
    """The train CLI's ``--tiny`` trains the GCNet model; from its
    checkpoint after 2 steps a fresh model, optimizer and generator take the
    same 2 more steps bit for bit, running statistics included."""
    opts = ["--device", "cpu", "--tiny", "--fake-data", "--cfg-options",
            "model.backbone.init_cfg=None", "compute_dtype=float32", "data.samples_per_gpu=2"]
    config = config_path(GCNET)
    summary = train_cli.main([config, "--work-dir", str(tmp_path / "wd"), "--iters", "2",
                              *opts])
    assert summary["steps"] == 2 and np.isfinite(summary["last_metrics"]["loss"])
    saved = torch.load(os.path.join(summary["checkpoints"][-1], "state.pth"),
                       weights_only=True)["model"]
    var = [k for k in saved if k.endswith("running_var")]
    assert var and any(not torch.equal(saved[k], torch.ones_like(saved[k])) for k in var)

    mc = shrink_model(load_config(config).model.to_dict())
    batch = _batch(np.random.RandomState(4), True)
    batch["gt_labels"] = batch["gt_labels"] * 19
    sched = t_train.step_lr_schedule(0.02, 100, warmup_iters=2)

    def trainer(seed):
        det = build_detector(mc, device="cpu", seed=seed)
        a, n = det.anchors_for(CANVAS)
        opt = t_train.make_optimizer(det.net.parameters(), sched)
        return det, opt, t_train.make_train_step(det, a, n, opt)

    det, opt, step = trainer(0)
    gen = torch.Generator().manual_seed(7)
    for _ in range(2):
        step(batch, generator=gen)
    save_checkpoint(str(tmp_path / "iter_2"), det.net, opt, step=2, generator=gen)
    saved = {k: v.clone() for k, v in _stats(det.net.state_dict()).items()}
    for _ in range(2):
        step(batch, generator=gen)
    want = {k: v.clone() for k, v in det.net.state_dict().items()}

    det2, opt2, step2 = trainer(1)
    gen2 = torch.Generator()
    restore_checkpoint(str(tmp_path / "iter_2"), det2.net, opt2, gen2)
    assert all(torch.equal(v, det2.net.state_dict()[k]) for k, v in saved.items())
    for _ in range(2):
        step2(batch, generator=gen2)
    got = det2.net.state_dict()
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, differ[:6]
    assert any(not torch.equal(got[k], saved[k]) for k in saved)


def test_imagenet_resnet_loads_into_the_gcnet_backbone(tmp_path):
    """A torchvision-named ResNet-50 file loads into the tiny GCNet model's
    live-BN backbone (its running statistics included); the ContextBlocks,
    which an ImageNet ResNet lacks, keep their seeded weights."""
    from boosting_rcnn_tpu_torch.weights import load_pretrained

    mc = shrink_model(load_config(config_path(GCNET)).model.to_dict())
    plain = dict(mc, backbone={k: v for k, v in mc["backbone"].items() if k != "plugins"})
    src = build_detector(plain, device="cpu", seed=3).net.backbone.state_dict()
    renamed = {}
    for k, v in src.items():
        k = k.replace("downsample_conv", "downsample.0").replace("downsample_bn", "downsample.1")
        head, _, rest = k.partition(".")
        renamed[(head.replace("_", ".") if head.startswith("layer") else head) + "." + rest] = v
    path = str(tmp_path / "r50.pth")
    torch.save(renamed, path)
    det = build_detector(mc, device="cpu", seed=0)
    plugins = {k: v.clone() for k, v in det.net.state_dict().items() if "_plugin" in k}
    assert plugins and load_pretrained(det.net, {"type": "Pretrained", "checkpoint": path}) == path
    state = det.net.state_dict()
    assert all(torch.equal(state["backbone." + k], v) for k, v in src.items())
    assert all(torch.equal(state[k], v) for k, v in plugins.items())


@pytest.mark.parametrize("config", [GN_ALL, GN_WS, ATTENTION])
def test_train_cli_tiny_trains_in_bf16(config, tmp_path):
    """The train CLI's ``--tiny`` on the other three families, in the CLIs'
    bfloat16 (``default_runtime.py``): one step on noise batches, finite
    metrics, a checkpoint."""
    summary = train_cli.main([config_path(config), "--work-dir", str(tmp_path), "--iters", "1",
                              "--device", "cpu", "--tiny", "--fake-data", "--cfg-options",
                              "model.backbone.init_cfg=None", "compute_dtype=bfloat16",
                              "data.samples_per_gpu=2"])
    assert summary["steps"] == 1 and summary["checkpoints"]
    assert all(np.isfinite(float(v)) for v in summary["last_metrics"].values())
