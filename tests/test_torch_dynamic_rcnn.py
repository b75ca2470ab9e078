"""Dynamic R-CNN in the PyTorch port against the JAX package, on the CPU, in
float32 (``configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_coco.py``: Faster
R-CNN whose RoI assigner IoU threshold and smooth-L1 beta adapt to the
training statistics, the state in the box head's buffers).

  * ``dynamic_rcnn_batch_stats`` on seeded inputs within 1e-7, NaN without
    a positive;
  * ``ConvFCBBoxHead.update_dynamic`` step by step against the JAX head's
    ``batch_stats`` within 1e-7: rings of 4 (an even count, the median the
    mean of the two middle values) and 3, between and at the boundaries,
    NaN statistics recorded as the working values, the floor of the IoU,
    the cap of beta and the median below 1e-15 that keeps beta;
  * the tiny model (ResNet-18 at width 8, FPN and RPN 32, FC 64, 64 train
    proposals, 32 RoIs an image; ``update_iter_interval=2``, ``iou_topk=1``
    and an initial IoU threshold of 0.3, so that the threshold and beta
    move at both boundaries within four steps; the
    weights made with numpy from a seed) through four fused train steps of
    both packages on the same batch and draws (the RPN's anchor sampler and
    the RoI sampler fed JAX's uniforms), each from JAX's parameters and
    momentum before it (``tests/test_torch_cascade.py::_sync``; the state
    is the port's own): the metrics rtol 1e-4, the parameters within
    ``1e-3 * max|p - p0|`` plus ``1e-7 * max|p|``, every state buffer
    within 1e-6 of JAX's ``batch_stats`` (beta and its ring within rtol
    1e-4, as the losses: its statistic, an encoded ``|dx|`` of the sampled
    boxes, follows the proposals' float32 rounding, up to 2.6e-5 of its
    value apart) and ``dyn_count`` equal; the JAX
    state after the four steps loads through ``weights.from_jax_params``
    (``dyn_count`` an int32);
  * the ``"external"`` train-step mode raises in both packages (the
    sampler reads the state);
  * a checkpoint after two steps, restored into a fresh model and
    optimizer, continues bit for bit, the state included; the train CLI
    (``--tiny --fake-data --iters 2``) writes the state into its
    checkpoint, and the test CLI evaluates from it;
  * in bfloat16 the state stays float32 through a step.
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
from boosting_rcnn_tpu.models.roi_heads import prob_roi_head as j_prob  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.data.synthetic import generate  # noqa: E402
from boosting_rcnn_tpu_torch.engine import train as t_train  # noqa: E402
from boosting_rcnn_tpu_torch.engine.checkpoint import (  # noqa: E402
    restore_checkpoint,
    save_checkpoint,
)
from boosting_rcnn_tpu_torch.models.detectors.two_stage import DynamicRCNNDetector  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads import bbox_head as t_bbox  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads import prob_roi_head as t_prob  # noqa: E402
from boosting_rcnn_tpu_torch.tools import test as test_cli  # noqa: E402
from boosting_rcnn_tpu_torch.tools import train as train_cli  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402
from test_torch_boosting_detectors import (  # noqa: E402
    CANVAS,
    FROZEN,
    _batch,
    _random_variables,
    _rpn_uniforms,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
    shrink_heads,
)
from test_torch_cascade import _sync  # noqa: E402

DYN_CONFIG = "dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_coco.py"
STATE = ("dyn_iou_thr", "dyn_beta", "dyn_iou_hist", "dyn_beta_hist", "dyn_count")
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox")
STEPS = 4
# the tiny model's random weights give proposals of max IoU 0.25-0.55, so
# the IoU threshold starts at 0.3 to move at both boundaries
INITIAL_IOU = 0.3


def tiny_dynamic(load):
    """The config at the tiny Faster R-CNN's size
    (``tests/test_torch_faster_rcnn.py``), with a ring of 2 steps, each
    image's largest IoU as the IoU statistic and ``INITIAL_IOU``."""
    mc = load(config_path(DYN_CONFIG)).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"]["in_channels"] = [8, 16, 32, 64]
    mc["roi_head"]["bbox_roi_extractor"]["out_channels"] = 32
    mc = shrink_heads(mc)
    mc["train_cfg"]["rcnn"]["dynamic_rcnn"].update(update_iter_interval=2, iou_topk=1,
                                                   initial_iou=INITIAL_IOU)
    return mc


def _initial_state(variables, interval=2):
    """The head's state as the JAX ``init`` declares it (``_random_variables``
    draws every leaf)."""
    variables["batch_stats"]["bbox_head"].update(
        dyn_iou_thr=np.float32(INITIAL_IOU), dyn_beta=np.float32(1.0),
        dyn_iou_hist=np.zeros(interval, np.float32), dyn_beta_hist=np.zeros(interval, np.float32),
        dyn_count=np.int32(0))
    return variables


def _roi_uniforms(key, b, n):
    """The uniforms of the two-stage RoI sampler under ``loss(..., key)``:
    the second half of ``key`` split into one key an image, whose halves
    the sampler draws from over its ``n`` candidates."""
    _, roi_rng = jax.random.split(key)
    out = []
    for k in jax.random.split(roi_rng, b):
        kp, kn = jax.random.split(k)
        out.append([np.asarray(jax.random.uniform(x, (n,))) for x in (kp, kn)])
    return np.asarray(out, np.float32)


def _state(net):
    return {k: getattr(net.bbox_head, k).clone() for k in STATE}


# ------------------------------------------------------------------ modules
def test_dynamic_rcnn_batch_stats_match_jax():
    rs = np.random.RandomState(9)
    overlaps = rs.rand(2, 64).astype(np.float32)
    prop_valid = rs.rand(2, 64) > 0.2
    targets = (rs.randn(64, 4) * 0.3).astype(np.float32)
    for pos in (rs.rand(64) > 0.7, rs.rand(64) > 0.95, np.zeros(64, bool)):
        for iou_topk, beta_topk in ((8, 2), (75, 10), (1, 1)):
            ref = j_prob.dynamic_rcnn_batch_stats(
                *map(jnp.asarray, (overlaps, prop_valid, targets, pos)), iou_topk=iou_topk,
                beta_topk=beta_topk)
            got = t_prob.dynamic_rcnn_batch_stats(
                *map(torch.from_numpy, (overlaps, prop_valid, targets, pos)), iou_topk=iou_topk,
                beta_topk=beta_topk)
            for g, r in zip(got, ref):
                assert g.dtype == torch.float32 and g.shape == ()
                np.testing.assert_allclose(g.item(), float(r), rtol=0, atol=1e-7)
            assert np.isnan(got[1].item()) == (not pos.any())


@pytest.mark.parametrize("interval,stats", [
    (4, [(0.6, 0.5), (np.nan, 0.7), (0.3, np.nan), (0.5, 0.2), (0.7, 2.0), (0.8, 3.0),
         (0.9, np.nan), (0.2, 0.05), (0.1, 0.3)]),
    (3, [(0.45, 0.0), (0.35, 0.0), (0.55, 0.3), (0.6, 0.9), (np.nan, 0.8), (0.65, 1.5)]),
])
def test_update_dynamic_matches_jax(interval, stats):
    jhead = j_bbox.ConvFCBBoxHead(num_classes=4, fc_out_channels=8, dynamic=True,
                                  dyn_interval=interval)
    variables = jhead.init(jax.random.PRNGKey(0), jnp.zeros((1, 7, 7, 4)))
    head = t_bbox.ConvFCBBoxHead(torch.Generator(), 4, in_channels=4, fc_out_channels=8,
                                 dynamic=True, dyn_interval=interval)
    moved = 0
    for i, (iou, beta) in enumerate(stats):
        _, upd = jhead.apply(variables, jnp.float32(iou), jnp.float32(beta),
                             method=j_bbox.ConvFCBBoxHead.update_dynamic,
                             mutable=["batch_stats"])
        variables = {**variables, **upd}
        head.update_dynamic(torch.tensor(iou, dtype=torch.float32),
                            torch.tensor(beta, dtype=torch.float32))
        ref = upd["batch_stats"]
        for k in STATE:
            got = getattr(head, k)
            assert got.dtype == (torch.int32 if k == "dyn_count" else torch.float32)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref[k]), rtol=0, atol=1e-7,
                                       err_msg=f"{k} after update {i}")
        moved += float(ref["dyn_beta"]) != 1.0 or float(ref["dyn_iou_thr"]) != np.float32(0.4)
    assert moved >= 2


# ------------------------------------------------------- the tiny detector
@pytest.fixture(scope="module")
def run():
    """Both packages through four fused train steps on the same weights,
    batch and draws, the port's parameters and momentum set to JAX's
    before each step."""
    mc = tiny_dynamic(jax_load_config)
    jdet = jax_build(mc, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), CANVAS))
    rs = np.random.RandomState(0)
    variables = _initial_state(_random_variables(shapes, rs))
    batch = _batch(rs, 4)
    jv, jb = (jax.tree.map(jnp.asarray, x) for x in (variables, batch))
    anchors, nla = jdet.anchors_for(CANVAS)
    rng = jax.random.PRNGKey(3)

    tdet = build_detector(tiny_dynamic(load_config), device="cpu")
    tdet.net.load_state_dict(from_jax_params(variables), strict=True)
    t_anchors, t_nla = tdet.anchors_for(CANVAS)
    n_cand = batch["gt_bboxes"].shape[1] + tdet.train_proposal_cfg.max_per_img

    kw = dict(decay_epochs=(1,), warmup_iters=2, warmup_ratio=0.5)  # lr 0.01, 0.015, 0.02, 0.002
    j_sched, t_sched = (m.step_lr_schedule(0.02, 3, **kw) for m in (j_train, t_train))
    tx = j_train.make_optimizer(j_sched, params=jv["params"], frozen_stages=1)
    state = j_train.create_train_state(jv, tx)
    j_step = jax.jit(j_train.make_train_step(jdet, anchors, nla, proposal_mode="fused"))
    t_opt = t_train.make_optimizer(tdet.net.parameters(), t_sched)
    t_step = t_train.make_train_step(tdet, t_anchors, t_nla, t_opt)
    p0 = {k: v.detach().clone() for k, v in tdet.net.named_parameters()}
    steps = []
    for k in range(STEPS):
        _sync(tdet, t_opt, state)
        state, j_metrics = j_step(state, jb, rng)  # the step folds its count into rng
        key = jax.random.fold_in(rng, k)
        t_metrics = t_step(batch, rpn_uniforms=_rpn_uniforms(key, anchors.shape[0]),
                           roi_uniforms=_roi_uniforms(key, 2, n_cand))
        steps.append(dict(
            j_params=from_jax_params(jax.tree.map(np.asarray, state.params)),
            t_params={k: v.detach().clone() for k, v in tdet.net.named_parameters()},
            j_state=jax.tree.map(np.asarray, state.batch_stats["bbox_head"]),
            t_state=_state(tdet.net), j_metrics=j_metrics, t_metrics=t_metrics))
    return dict(jdet=jdet, jv=jv, jb=jb, rng=rng, anchors=anchors, nla=nla, tdet=tdet,
                batch=batch, p0=p0, steps=steps,
                j_final=jax.tree.map(np.asarray, {"params": state.params,
                                                  "batch_stats": state.batch_stats}))


def test_dynamic_rcnn_config(run):
    det = run["tdet"]
    assert isinstance(det, DynamicRCNNDetector) and det.rpn_type == "rpn"
    assert (det.dyn_iou_topk, det.dyn_beta_topk) == (1, 10)
    assert not det.roi_cfg.prob and not det.roi_cfg.boost
    assert det.net.bbox_head.dyn_iou_hist.shape == (2,)


@pytest.mark.parametrize("step", range(STEPS))
def test_dynamic_rcnn_train_steps_match_jax(run, step):
    s = run["steps"][step]
    for k in ("loss", "grad_norm", *LOSSES):
        got, ref = float(s["t_metrics"][k]), float(s["j_metrics"][k])
        assert np.isfinite(got), k
        np.testing.assert_allclose(got, ref, rtol=1e-4, err_msg=k)
    moved = 0
    for name, ref in s["j_params"].items():
        got, p0 = s["t_params"][name], run["p0"][name]
        ref = ref.reshape(got.shape)
        if name.startswith(FROZEN):
            assert torch.equal(got, p0) and torch.equal(ref, p0), name
            continue
        delta = (ref - p0).abs().max().item()
        moved += delta > 0
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-3 * delta + 1e-7 * ref.abs().max().item(),
                                   err_msg=name)
    assert moved >= 50
    for k in STATE:
        got, ref = s["t_state"][k].numpy(), s["j_state"][k]
        if k == "dyn_count":
            assert got.dtype == np.int32 and int(got) == int(ref) == step + 1
        else:
            # beta's statistic is an encoded |dx| of the sampled boxes, which
            # follow the proposals' float32 rounding: held as the losses are
            np.testing.assert_allclose(got, ref, rtol=1e-4 if "beta" in k else 0, atol=1e-6,
                                       err_msg=k)
    hist = s["t_state"]["dyn_iou_hist"]
    assert torch.isfinite(hist).all() and torch.isfinite(s["t_state"]["dyn_beta_hist"]).all()
    if step % 2:  # at a boundary the threshold moved from its initial value
        assert s["t_state"]["dyn_iou_thr"].item() > INITIAL_IOU + 1e-3
        assert s["t_state"]["dyn_iou_thr"].item() == pytest.approx(hist.mean().item())


def test_dynamic_rcnn_state_loads_from_jax(run):
    net = build_detector(tiny_dynamic(load_config), device="cpu", seed=5).net
    net.load_state_dict(from_jax_params(run["j_final"]), strict=True)
    ref = run["j_final"]["batch_stats"]["bbox_head"]
    for k in STATE:
        got = getattr(net.bbox_head, k)
        assert got.dtype == (torch.int32 if k == "dyn_count" else torch.float32)
        np.testing.assert_array_equal(got.numpy(), ref[k])
    assert int(net.bbox_head.dyn_count) == STEPS


def test_dynamic_rcnn_external_mode_raises(run):
    det = run["tdet"]
    a, n = det.anchors_for(CANVAS)
    step = t_train.make_train_step(det, a, n, t_train.make_optimizer(det.net.parameters(),
                                                                     lambda s: 0.01))
    with pytest.raises(NotImplementedError, match="external RoISample"):
        det.train_sample(run["batch"], a, n)
    before = _state(det.net)
    with pytest.raises(NotImplementedError, match="external RoISample"):
        step(run["batch"], sample=tuple(np.zeros(1) for _ in range(10)))
    assert all(torch.equal(v, getattr(det.net.bbox_head, k)) for k, v in before.items())
    with pytest.raises(NotImplementedError, match="mutable state"):
        jax.eval_shape(lambda v: run["jdet"].train_sample(v, run["rng"], run["jb"],
                                                          run["anchors"], run["nla"]),
                       run["jv"])


def test_dynamic_rcnn_checkpoint_resume_is_bitwise(run, tmp_path):
    """From the JAX run's weights, two steps, a checkpoint, two more; the
    checkpoint restored into a fresh model (other seeded weights),
    optimizer and generator, then the same two steps: every tensor of the
    state dict, the state included, bit-identical, and the IoU threshold
    moved at both boundaries."""
    mc = tiny_dynamic(load_config)
    batch = run["batch"]
    sched = t_train.step_lr_schedule(0.02, 100, warmup_iters=2)
    weights = from_jax_params(jax.tree.map(np.asarray, run["jv"]))

    def trainer(seed):
        det = build_detector(mc, device="cpu", seed=seed)
        if not seed:
            det.net.load_state_dict(weights, strict=True)
        a, n = det.anchors_for(CANVAS)
        opt = t_train.make_optimizer(det.net.parameters(), sched)
        return det, opt, t_train.make_train_step(det, a, n, opt)

    det, opt, step = trainer(0)
    gen = torch.Generator().manual_seed(7)
    for _ in range(2):
        step(batch, generator=gen)
    saved = _state(det.net)
    save_checkpoint(str(tmp_path / "iter_2"), det.net, opt, step=2, generator=gen)
    for _ in range(2):
        step(batch, generator=gen)
    want = {k: v.clone() for k, v in det.net.state_dict().items()}

    det2, opt2, step2 = trainer(1)
    gen2 = torch.Generator()
    meta = restore_checkpoint(str(tmp_path / "iter_2"), det2.net, opt2, gen2)
    assert meta["step"] == 2 and opt2.step_count == 2
    assert all(torch.equal(v, getattr(det2.net.bbox_head, k)) for k, v in saved.items())
    for _ in range(2):
        step2(batch, generator=gen2)
    got = det2.net.state_dict()
    assert set(got) == set(want) and all(k in got for k in (f"bbox_head.{s}" for s in STATE))
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, differ[:6]
    assert int(got["bbox_head.dyn_count"]) == 4
    assert saved["dyn_iou_thr"].item() > INITIAL_IOU + 1e-3
    assert got["bbox_head.dyn_iou_thr"].item() != saved["dyn_iou_thr"].item()


def test_dynamic_rcnn_bf16_state_stays_float32():
    det = build_detector(tiny_dynamic(load_config), device="cpu", dtype=torch.bfloat16)
    a, n = det.anchors_for(CANVAS)
    step = t_train.make_train_step(det, a, n, t_train.make_optimizer(det.net.parameters(),
                                                                     lambda s: 0.01))
    gen = torch.Generator().manual_seed(2)
    for _ in range(2):
        metrics = step(_batch(np.random.RandomState(6), 4), generator=gen)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    state = _state(det.net)
    assert all(v.dtype == torch.float32 for k, v in state.items() if k != "dyn_count")
    assert int(state["dyn_count"]) == 2 and torch.isfinite(state["dyn_iou_hist"]).all()


def test_dynamic_rcnn_clis_carry_the_state(tmp_path):
    root = str(tmp_path / "synth")
    generate(root, n_train=4, n_val=2, seed=3)
    data = [f"data.{s}.{k}={root}/{v}" for s in ("train", "val", "test")
            for k, v in (("ann_file", "val.json" if s != "train" else "train.json"),
                         ("img_prefix", "val" if s != "train" else "train"))]
    opts = ["--device", "cpu", "--tiny", "--cfg-options", *data, "data.samples_per_gpu=2",
            "model.backbone.init_cfg=None", "compute_dtype=float32"]
    config = config_path(DYN_CONFIG)
    summary = train_cli.main([config, "--work-dir", str(tmp_path / "wd"), "--iters", "2",
                              "--fake-data", *opts])
    assert summary["steps"] == 2 and np.isfinite(summary["last_metrics"]["loss"])
    ckpt = summary["checkpoints"][-1]
    saved = torch.load(os.path.join(ckpt, "state.pth"), weights_only=True)["model"]
    assert int(saved["bbox_head.dyn_count"]) == 2
    assert torch.isfinite(saved["bbox_head.dyn_iou_hist"][:2]).all()
    metrics = test_cli.main([config, ckpt, *opts])
    assert metrics["num_results"] == 2 and "bbox_mAP" in metrics
