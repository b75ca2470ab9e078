"""Whole tiny detectors of the PyTorch port against the JAX package's, on
the CPU: the ResNeXt PAFPN UTDAC detector here, and the shared harness of
``tests/test_torch_boosting_coco.py`` (R50 FPN ``on_input`` with CIoU on
the encoded deltas), ``tests/test_torch_boosting_r2dcn.py`` (Res2Net with
DCNv2, soft-NMS and ``reg_norm='mean'``) and
``tests/test_torch_faster_rcnn.py`` (Faster R-CNN R50-FPN).

Each tiny detector is a family config with its widths cut (ResNeXt-50 of
2 groups of base width 4 at 8 base channels here), random weights made
with numpy from a seed, which go to the JAX package as flax variables and
to the port through ``weights.from_jax_params``, and two images on the
(128, 160) canvas with 6 seeded gt slots each (the second image's last one
padded).  The JAX package's ``train_sample`` gives the ``RoISample`` that
both ``loss(..., sample=)`` calls take (the plain RPN's anchor sampler is
fed the uniforms JAX's ``rpn_loss`` draws), since the two packages draw
different random bits.  Checked, at the tolerances of
tests/test_torch_train.py and tests/test_torch_flagship.py:

  * ``predict``: labels and valid equal, detections within 1e-3;
  * the losses: rtol 1e-4;
  * every parameter gradient: within ``1e-3 * max|g|`` of the tensor plus
    ``1e-6 * max|g|`` of the network; frozen parameters (the stem and stage
    1) get none in the port and zeros in the JAX package;
  * the parameters after 1 and 2 SGD steps of JAX
    ``make_train_step(proposal_mode="external")``'s step (its gradient
    part on the compiled loss gradient above, then the update) and the
    port's step:
    within ``1e-3 * max|p - p0|`` plus ``1e-7 * max|p|`` of the tensor,
    frozen ones bit-identical; the metrics rtol 1e-4.
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

from boosting_rcnn_tpu.builder import build_detector as jax_build  # noqa: E402
from boosting_rcnn_tpu.config import load_config as jax_load_config  # noqa: E402
from boosting_rcnn_tpu.engine import train as j_train  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.engine import train as t_train  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402

CANVAS = (128, 160)
FROZEN = ("backbone.conv1.", "backbone.bn1.", "backbone.stem_", "backbone.layer1_")
ATSS_LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_rpn_iou", "loss_cls", "loss_bbox")


def config_path(name: str) -> str:
    return os.path.join(REPO, "configs", name)


def shrink_heads(mc, num_classes=None):
    """The tiny flagship's neck, RPN, head and sampling sizes
    (``tests/test_torch_train.py::_tiny``) for a backbone of stage widths
    ``mc['neck']['in_channels']``."""
    mc["neck"]["out_channels"] = 32
    mc["rpn_head"].update(feat_channels=32, in_channels=32)
    if mc["rpn_head"]["type"] == "ATSSRPNHead":
        mc["rpn_head"]["stacked_convs"] = 2
    mc["roi_head"]["bbox_head"].update(fc_out_channels=64, in_channels=32)
    if num_classes:
        mc["roi_head"]["bbox_head"]["num_classes"] = num_classes
    mc["train_cfg"]["rpn_proposal"].update(nms_pre=200, max_per_img=64)
    mc["train_cfg"]["rcnn"]["sampler"]["num"] = 32
    mc["test_cfg"]["rpn"].update(nms_pre=100, max_per_img=32)
    return mc


def _random_variables(shapes, rs):
    """flax variables of the given shapes: LeCun-scaled kernels (the offset
    convs' too, so that DCN samples off the grid), biases and norm
    parameters drawn around their init so every mapping is seen."""
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


def _batch(rs, num_classes, canvas=CANVAS):
    """Two images with 6 gt slots each, boxes of sides 12-70 px inside the
    valid shape (the second image's last slot padded), on ``canvas``."""
    img_shape = np.array([[128.0, 150.0], [116.0, 160.0]], np.float32)
    gts = np.zeros((2, 6, 4), np.float32)
    for i, (h, w) in enumerate(img_shape):
        wh = rs.uniform(12, 70, (6, 2))
        xy = rs.uniform(0, 1, (6, 2)) * ([w, h] - wh)
        gts[i] = np.concatenate([xy, xy + wh], -1)
    gt_mask = np.ones((2, 6), bool)
    gt_mask[1, 5] = False
    gts[1, 5] = 0.0
    return {
        "images": (rs.rand(2, *canvas, 3) * 2.0 - 1.0).astype(np.float32),
        "img_shape": img_shape,
        "scale_factor": np.array([[1.0] * 4, [1.25] * 4], np.float32),
        "gt_bboxes": gts,
        "gt_labels": rs.randint(0, num_classes, (2, 6)).astype(np.int32),
        "gt_mask": gt_mask,
    }


def _rpn_uniforms(rng, num_anchors, images: int = 2):
    """The uniforms of JAX's plain ``rpn_loss`` under ``loss(..., rng)`` for
    a batch of ``images`` (``tests/test_torch_mask_rcnn.py``)."""
    rpn_rng, _ = jax.random.split(rng)
    out = []
    for key in jax.random.split(rpn_rng, images):
        kp, kn = jax.random.split(key)
        out.append([np.asarray(jax.random.uniform(k, (num_anchors,))) for k in (kp, kn)])
    return np.asarray(out, np.float32)


def _adam_state(opt_state):
    """The moments (optax ``ScaleByAdamState``) in a JAX optimizer state."""
    if isinstance(opt_state, optax.ScaleByAdamState):
        return opt_state
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def adam_moments(state):
    """A JAX AdamW train state's count and moments, by the port's names."""
    adam = _adam_state(state.opt_state)
    return (int(adam.count), from_jax_params(jax.tree.map(np.asarray, adam.mu)),
            from_jax_params(jax.tree.map(np.asarray, adam.nu)))


def sync_adamw(det, opt, state):
    """The port's detector and AdamW at a JAX train state: its parameters,
    moments, count and step."""
    params = from_jax_params(jax.tree.map(np.asarray, state.params))
    det.net.load_state_dict({**det.net.state_dict(), **params}, strict=True)
    count, mu, nu = adam_moments(state)
    names = {id(p): k for k, p in det.net.named_parameters()}
    opt.adamw.count = count
    opt.adamw.mu = [mu[names[id(p)]].reshape(p.shape).clone() for p in opt.adamw.params]
    opt.adamw.nu = [nu[names[id(p)]].reshape(p.shape).clone() for p in opt.adamw.params]
    opt.step_count = int(state.step)


def run_pair(make_cfg, seed: int = 0, canvas=CANVAS, frozen_stages: int = 1, targets=None,
             predict: bool = True, optimizer=None, base_lr: float = 0.02):
    """Both packages on ``make_cfg(load_config(...))``'s model (the JAX
    package's and the port's config readers each read the file) through
    predict (unless not ``predict``), the loss, its gradients and two
    train steps on the same weights, batch, samples and RPN draws, drawn
    from ``seed``, on ``canvas``; ``targets(rs, batch)`` adds keys to the
    batch; the JAX optimizer masks the parameters of the backbone's
    ``frozen_stages``; ``optimizer`` (``opt_type``, ``weight_decay``) goes
    to both packages' ``make_optimizer`` at ``base_lr``'s schedule (SGD at
    1e-4 without it; with
    AdamW the port starts its second step from JAX's state, its parameters
    and moments, as the cascade harness's fused steps do, and each step's
    gradients and JAX's state before it are kept).  The
    buffers after each step are kept too (JAX's ``batch_stats`` through
    ``from_jax_params``, the port's)."""
    mc = make_cfg(jax_load_config)
    num_classes = mc["roi_head"]["bbox_head"]["num_classes"]
    jdet = jax_build(mc, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), canvas))
    rs = np.random.RandomState(seed)
    variables = _random_variables(shapes, rs)
    variables.setdefault("batch_stats", {})  # a model without norm statistics (Swin)
    batch = _batch(rs, num_classes, canvas)
    if targets is not None:
        batch.update(targets(rs, batch))
    jv = jax.tree.map(jnp.asarray, variables)
    jb = jax.tree.map(jnp.asarray, batch)
    anchors, nla = jdet.anchors_for(canvas)
    rng = jax.random.PRNGKey(3)

    tdet, tdet_train = (build_detector(make_cfg(load_config), device="cpu") for _ in range(2))
    for det in (tdet, tdet_train):
        det.net.load_state_dict(from_jax_params(variables), strict=True)
    t_anchors, t_nla = tdet.anchors_for(canvas)
    assert t_nla == nla
    plain_rpn = tdet.rpn_type == "rpn"
    n_anchors = anchors.shape[0]

    def uniforms(key):
        return {"rpn_uniforms": _rpn_uniforms(key, n_anchors)} if plain_rpn else {}

    j_pred = t_pred = None
    if predict:
        j_pred = jax.jit(lambda v, b: jdet.predict(v, b, anchors, nla))(jv, jb)
        t_pred = tdet.predict(batch, t_anchors, t_nla)

    sample_fn = jax.jit(lambda v, r: jdet.train_sample(v, r, jb, anchors, nla))
    sample0 = sample_fn(jv, rng)

    # JAX make_train_step(proposal_mode="external")'s ``_grad_part``, one
    # compiled loss gradient serving the loss check and both steps (the
    # models here hold no live statistics: the mutable loss is the loss)
    def j_loss(params, stats, sample, key):
        losses, new_stats = j_train.loss_with_live_bn(
            jdet, {"params": params, "batch_stats": stats}, key, jb, anchors, nla, sample=sample)
        return sum(losses.values()), (losses, new_stats)

    grad_fn = jax.jit(jax.value_and_grad(j_loss, has_aux=True))
    (_, (j_losses, _)), j_grads = grad_fn(jv["params"], jv["batch_stats"], sample0, rng)
    t_losses = tdet.loss(batch, t_anchors, t_nla, sample=tuple(np.array(x) for x in sample0),
                         **uniforms(rng))
    sum(t_losses.values()).backward()
    t_grads = {k: (None if p.grad is None else p.grad.clone())
               for k, p in tdet.net.named_parameters()}

    # lr base_lr / 2, then 0.075 base_lr (0.01, then 0.0015)
    kw = dict(decay_epochs=(1,), warmup_iters=2, warmup_ratio=0.5)
    j_sched, t_sched = (m.step_lr_schedule(base_lr, 1, **kw) for m in (j_train, t_train))
    optimizer = optimizer or {}
    tx = j_train.make_optimizer(j_sched, params=jv["params"], frozen_stages=frozen_stages,
                                **optimizer)
    state = j_train.create_train_state(jv, tx)
    apply_fn = jax.jit(lambda st, g, ns: (st.apply_gradients(g).replace(
        batch_stats=jax.lax.stop_gradient(ns)), optax.global_norm(g)))
    t_opt = t_train.make_optimizer(tdet_train.net.parameters(), t_sched,
                                   aux_params=t_train.aux_parameters(tdet_train.net), **optimizer)
    t_step = t_train.make_train_step(tdet_train, t_anchors, t_nla, t_opt)
    # each step's gradients as the optimizer is given them (before its clip)
    t_step_grads, named = [], list(tdet_train.net.named_parameters())
    opt_step = t_opt.step

    def keep_grads_and_step():
        t_step_grads.append({k: p.grad.clone() for k, p in named if p.grad is not None})
        return opt_step()

    t_opt.step = keep_grads_and_step
    p0 = {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()}
    steps, buffers, step_grads, starts = [], [], [], []
    adamw = optimizer.get("opt_type") == "adamw"
    for k in range(2):
        if adamw:
            if k:
                sync_adamw(tdet_train, t_opt, state)
            starts.append((from_jax_params(jax.tree.map(np.asarray, state.params)),
                           *adam_moments(state)))
        sample = sample_fn({"params": state.params, "batch_stats": state.batch_stats}, rng)
        (total, (losses, new_stats)), grads = grad_fn(
            state.params, state.batch_stats, sample, jax.random.fold_in(rng, state.step))
        step_grads.append(from_jax_params(jax.tree.map(np.asarray, grads)))
        state, grad_norm = apply_fn(state, grads, new_stats)
        j_metrics = {"loss": total, **{n: jnp.sum(v) for n, v in losses.items()},
                     "grad_norm": grad_norm}
        t_metrics = t_step(batch, tuple(np.array(x) for x in sample),
                           **uniforms(jax.random.fold_in(rng, k)))
        steps.append((from_jax_params(jax.tree.map(np.asarray, state.params)),
                      {k: v.detach().clone() for k, v in tdet_train.net.named_parameters()},
                      j_metrics, t_metrics))
        buffers.append((from_jax_params({"params": {}, "batch_stats": jax.tree.map(
            np.asarray, state.batch_stats)}),
            {k: v.clone() for k, v in tdet_train.net.named_buffers()}))
    return dict(jdet=jdet, tdet=tdet, batch=batch, variables=variables, j_pred=j_pred,
                t_pred=t_pred,
                sample0=sample0, j_losses=j_losses, t_losses=t_losses,
                j_grads=from_jax_params(jax.tree.map(np.asarray, j_grads)), t_grads=t_grads,
                p0=p0, steps=steps, buffers=buffers, step_grads=step_grads,
                t_step_grads=t_step_grads, starts=starts, lr=[t_sched(k) for k in range(2)])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU backward on one thread (``tests/test_torch_train.py``:
    torch's threaded CPU convolution backward was not repeatable)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def check_predict(run, min_dets: int = 20):
    ref, got = run["j_pred"], run["t_pred"]
    dets, labels, valid = got
    assert int(valid.sum()) >= min_dets
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(dets.numpy(), np.asarray(ref[0]), rtol=0, atol=1e-3)
    return dets, labels, valid


def check_losses(run, names):
    assert set(run["t_losses"]) == set(run["j_losses"]) == set(names)
    for k in names:
        got, ref = run["t_losses"][k].item(), float(run["j_losses"][k])
        assert np.isfinite(got) and got > 0, k
        np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=k)
    assert np.asarray(run["sample0"].is_pos).sum() > 4


def check_gradients(run, frozen_names=FROZEN):
    """Every gradient within the harness's tolerance; the parameters whose
    names start with ``frozen_names`` (the frozen stages) get none in the
    port and zeros in the JAX package, and there is at least one unless
    ``frozen_names`` is empty."""
    t_grads, j_grads = run["t_grads"], run["j_grads"]
    assert set(t_grads) == set(j_grads)
    g_max = max(g.abs().max().item() for g in j_grads.values())
    frozen = 0
    for name, ref in j_grads.items():
        got = t_grads[name]
        if frozen_names and name.startswith(frozen_names):
            frozen += 1
            assert got is None, name
            assert not ref.any(), name
            continue
        assert got is not None, name
        np.testing.assert_allclose(got.numpy(), ref.reshape(got.shape).numpy(), rtol=0,
                                   atol=1e-3 * ref.abs().max().item() + 1e-6 * g_max,
                                   err_msg=name)
    assert frozen > 0 or not frozen_names


def check_step(run, step, names, min_moved: int = 50, frozen_names=FROZEN):
    j_params, t_params, j_metrics, t_metrics = run["steps"][step]
    for k in ("loss", "grad_norm", *names):
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), rtol=1e-4,
                                   err_msg=k)
    moved = 0
    for name, ref in j_params.items():
        got, p0 = t_params[name], run["p0"][name]
        ref = ref.reshape(got.shape)
        if frozen_names and name.startswith(frozen_names):
            assert torch.equal(got, p0) and torch.equal(ref, p0), name
            continue
        delta = (ref - p0).abs().max().item()
        moved += delta > 0
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-3 * delta + 1e-7 * ref.abs().max().item(),
                                   err_msg=name)
    assert moved >= min_moved


# ------------------------------------------- ResNeXt PAFPN UTDAC (X101 32x4d's)
def _x101_utdac(load):
    mc = load(config_path("boosting_rcnn/boosting_rcnn_x101_32x4d_pafpn_1x_utdac.py"))
    mc = mc.model.to_dict()
    mc["backbone"].update(depth=50, groups=2, base_width=4, base_channels=8)
    mc["neck"]["in_channels"] = [32, 64, 128, 256]
    return shrink_heads(mc)


@pytest.fixture(scope="module")
def run():
    return run_pair(_x101_utdac)


def test_x101_tiny_grouped_convs(run):
    conv2 = run["tdet"].net.backbone.layer1_0.conv2
    assert conv2.groups == 2 and tuple(conv2.weight.shape) == (8, 4, 3, 3)


def test_x101_predict_matches_jax(run):
    check_predict(run)


def test_x101_losses_match_jax(run):
    check_losses(run, ATSS_LOSSES)


def test_x101_gradients_match_jax(run):
    check_gradients(run)


@pytest.mark.parametrize("step", [0, 1])
def test_x101_sgd_steps_match_jax(run, step):
    check_step(run, step, ATSS_LOSSES)
