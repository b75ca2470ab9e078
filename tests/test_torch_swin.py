"""The Swin Transformer and AdamW in the PyTorch port against the JAX
package, on the CPU (JAX ``models/backbones/swin.py``,
``engine/train.py::make_optimizer(opt_type="adamw")``).

Modules, the same seeded numpy parameters (through
``weights.from_jax_params``) on the same seeded inputs, values and
gradients within 1e-5 of the largest: ``window_partition`` /
``window_reverse``, ``relative_position_index`` and
``shifted_window_mask`` exactly; ``WindowAttention`` with and without the
shifted windows' mask; ``SwinBlock`` on a map that needs padding to whole
windows, unshifted and shifted by 3; ``PatchMerging`` on odd sizes; the
tiny ``SwinTransformer`` (16 dims, heads 1-8, depths 2, 2, 1, 1).  In
bfloat16 the tiny backbone within 1.5% of the JAX bfloat16 build's
largest value and closer than the port's float32 build.

AdamW alone: three steps of the port's optimizer against JAX's
``make_optimizer(opt_type="adamw")`` on the same parameters and
gradients (the global-norm clip acting at one step, a frozen stem and
stage 1 masked), within rtol 1e-6; its state through ``state_dict`` and
back, and through a checkpoint, gives the next step's bits.

The tiny Swin Mask R-CNN (``configs/swin/mask_rcnn_swin-t-p4-w7_fpn_1x_coco.py``
as the runner's ``--tiny`` shrinks Swin: 16 dims, one shifted block, heads
1-8; neck and RPN 32, 4 classes, mask convs 16) through the detectors
harness (``tests/test_torch_boosting_detectors.py::run_pair``) at its
tolerances: ``predict`` (masks within 1e-4), the five losses, every
gradient, and two AdamW steps (the config's weight decay 0.05) against
JAX's.  An mmdet Swin state dict loads as the JAX converter's
``convert_swin_backbone`` maps it, tensor for tensor, with PatchMerging's
channels permuted; ``absolute_pos_embed`` raises.  The 6 Swin configs
build at full width with AdamW.
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
    _random_variables,
    check_gradients,
    check_losses,
    check_predict,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
    run_pair,
    shrink_heads,
)
from test_torch_mask_rcnn import _ellipse  # noqa: E402
from test_torch_necks_fpt import _nchw, _nhwc, check_module, run_module  # noqa: E402

from boosting_rcnn_tpu.engine import train as j_train  # noqa: E402
from boosting_rcnn_tpu.models.backbones import swin as j_swin  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.engine import train as t_train  # noqa: E402
from boosting_rcnn_tpu_torch.engine.checkpoint import (  # noqa: E402
    restore_checkpoint,
    save_checkpoint,
)
from boosting_rcnn_tpu_torch.engine.runner import build_trainer, shrink_model  # noqa: E402
from boosting_rcnn_tpu_torch.models import layers as t_layers  # noqa: E402
from boosting_rcnn_tpu_torch.models.backbones import swin as t_swin  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params, from_mmdet_state_dict  # noqa: E402
from tools.convert_torch_weights import convert_swin_backbone  # noqa: E402

SWIN_T = "swin/mask_rcnn_swin-t-p4-w7_fpn_1x_coco.py"
CONFIGS = sorted(glob.glob(config_path("swin/*.py")))
MASK_LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "loss_mask")
BF16_TOL = 0.015
TINY = dict(embed_dims=16, depths=(2, 2, 1, 1), num_heads=(1, 2, 4, 8))


@pytest.fixture(autouse=True, scope="module")
def jax_mask_at_trace_time():
    """The JAX block's ``shifted_window_mask`` evaluated at trace time: it
    turns a ``jnp`` window partition of a constant into numpy, which under
    ``jax.jit`` (and ``jax.eval_shape``) is a tracer, so the JAX package's
    Swin with a shifted block does not trace (ROADMAP C.4; its own tests run
    depths of 1).  The same function, run eagerly at trace time by
    ``jax.ensure_compile_time_eval``, gives its constant."""
    orig = j_swin.shifted_window_mask

    def at_trace_time(*args):
        with jax.ensure_compile_time_eval():
            return orig(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_swin, "shifted_window_mask", at_trace_time)
        yield


def _gen():
    return torch.Generator().manual_seed(0)


def _tokens(rs, shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def run_tokens(jmod, tmod, inputs, seed: int = 0, **kw):
    """``jmod`` and ``tmod`` on the same seeded variables and channels-last
    ``inputs`` (both packages' layout for the Swin modules), ``kw`` passed
    to both calls: outputs, and the gradients of a seeded cotangent's
    product with them (parameters and inputs), as ``run_module`` gives
    them."""
    rs = np.random.RandomState(seed)
    xs = [jnp.asarray(x) for x in inputs]
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *xs, **kw))
    variables = _random_variables(shapes, rs)
    tmod.load_state_dict(from_jax_params(variables), strict=True)

    def j_fn(params, xs_):
        return jmod.apply({"params": params}, *xs_, **kw)

    j_out = jax.jit(j_fn)(variables["params"], xs)
    cot = rs.randn(*j_out.shape).astype(np.float32)
    j_gp, j_gx = jax.jit(jax.grad(lambda p, x: jnp.sum(j_fn(p, x) * cot), argnums=(0, 1)))(
        variables["params"], xs)
    t_xs = [torch.tensor(x, requires_grad=True) for x in inputs]
    t_kw = {k: (torch.from_numpy(np.asarray(v)) if v is not None else None)
            for k, v in kw.items()}
    t_out = tmod(*t_xs, **t_kw)
    (t_out * torch.from_numpy(cot)).sum().backward()
    return dict(j_out=[np.asarray(j_out)], t_out=[t_out.detach().numpy()],
                j_gp=from_jax_params(jax.tree.map(np.asarray, j_gp)),
                t_gp={k: p.grad for k, p in tmod.named_parameters()},
                j_gx=[np.asarray(g) for g in j_gx], t_gx=[x.grad.numpy() for x in t_xs],
                j_stats={})


# ---------------------------------------------------------------- helpers
def test_window_partition_and_reverse_match_jax():
    x = _tokens(np.random.RandomState(0), (2, 14, 21, 5))
    got = t_swin.window_partition(torch.from_numpy(x), 7)
    ref = np.asarray(j_swin.window_partition(jnp.asarray(x), 7))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(t_swin.window_reverse(got, 7, 14, 21).numpy(), x)
    np.testing.assert_array_equal(
        t_swin.window_reverse(got, 7, 14, 21).numpy(),
        np.asarray(j_swin.window_reverse(jnp.asarray(ref), 7, 14, 21)))


@pytest.mark.parametrize("ws", [3, 7])
def test_relative_position_index_matches_jax(ws):
    np.testing.assert_array_equal(t_swin.relative_position_index(ws),
                                  j_swin.relative_position_index(ws))


@pytest.mark.parametrize("h,w,ws,shift", [(14, 21, 7, 3), (7, 7, 7, 3), (12, 9, 3, 1)])
def test_shifted_window_mask_matches_jax(h, w, ws, shift):
    got = t_swin.shifted_window_mask(h, w, ws, shift)
    np.testing.assert_array_equal(got, j_swin.shifted_window_mask(h, w, ws, shift))
    assert got.dtype == np.float32 and (got == -100).any()


# ---------------------------------------------------------------- modules
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "shifted"])
def test_window_attention_matches_jax(masked):
    rs = np.random.RandomState(1)
    mask = t_swin.shifted_window_mask(14, 14, 7, 3) if masked else None
    x = _tokens(rs, (8, 49, 16))  # two images of 2 x 2 windows
    r = run_tokens(j_swin.WindowAttention(16, 2, 7), t_swin.WindowAttention(16, 2, 7, _gen()),
                   [x], mask=mask)
    check_module(r)


@pytest.mark.parametrize("shift", [0, 3])
def test_swin_block_matches_jax(shift):
    x = _tokens(np.random.RandomState(2), (2, 9, 11, 16))  # padded to 14 x 14
    r = run_tokens(j_swin.SwinBlock(16, 2, window_size=7, shift=shift),
                   t_swin.SwinBlock(16, 2, _gen(), 7, shift=shift), [x])
    check_module(r)


@pytest.mark.parametrize("hw", [(7, 9), (8, 5)])
def test_patch_merging_matches_jax(hw):
    x = _tokens(np.random.RandomState(3), (2, *hw, 8))
    r = run_tokens(j_swin.PatchMerging(16), t_swin.PatchMerging(8, 16, _gen()), [x])
    assert r["t_out"][0].shape == (2, (hw[0] + 1) // 2, (hw[1] + 1) // 2, 16)
    check_module(r)


def _image(seed=7):
    return [np.random.RandomState(seed).uniform(-1, 1, (2, 64, 94, 3)).astype(np.float32)]


def test_swin_transformer_matches_jax():
    r = run_module(j_swin.SwinTransformer(**TINY), t_swin.SwinTransformer(_gen(), **TINY),
                   _image())
    assert [o.shape[1:] for o in r["t_out"]] == [(16, 24, 16), (8, 12, 32), (4, 6, 64),
                                                  (2, 3, 128)]
    check_module(r)


def test_swin_transformer_bf16_matches_jax_bf16():
    x = _image()
    jm = j_swin.SwinTransformer(**TINY, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x[0])))
    variables = _random_variables(shapes, np.random.RandomState(8))
    ref = jax.jit(jm.apply, compiler_options={"xla_allow_excess_precision": False})(
        variables, jnp.asarray(x[0]))
    ref = [np.asarray(r, np.float32) for r in ref]
    tm = t_swin.SwinTransformer(_gen(), **TINY)
    tm.load_state_dict(from_jax_params(variables), strict=True)
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        t_layers.set_compute_dtype(tm, dt)
        with torch.no_grad():
            outs[dt] = [_nhwc(o.float()) for o in tm(_nchw(x[0]).detach())]
    scale = max(np.abs(r).max() for r in ref)
    err = {dt: max(np.abs(o - r).max() for o, r in zip(out, ref)) / scale
           for dt, out in outs.items()}
    for i, r in enumerate(ref):
        np.testing.assert_allclose(outs[torch.bfloat16][i], r, rtol=0, atol=BF16_TOL * scale,
                                   err_msg=f"output {i}")
    assert err[torch.bfloat16] < err[torch.float32], err


# ------------------------------------------------------------------ AdamW
def _adamw_params(rs):
    return {"backbone": {"conv1": {"kernel": rs.randn(3, 3, 3, 4)},
                         "layer1_0": {"conv1": {"kernel": rs.randn(1, 1, 4, 4)}},
                         "layer2_0": {"conv1": {"kernel": rs.randn(1, 1, 4, 8),
                                                "bias": rs.randn(8)}}},
            "neck": {"lateral_0": {"Conv_0": {"kernel": rs.randn(1, 1, 8, 6)}}},
            "bbox_head": {"fc_cls": {"kernel": rs.randn(6, 5) * 0.1, "bias": rs.randn(5)}}}


def test_adamw_matches_optax():
    """Three steps (gradients of global norm 60, 3 and 0.2: the clip at 35
    acts at the first) at lr 1e-3, 5e-4, 2e-4 and weight decay 0.05; the
    stem and stage 1 frozen (``requires_grad=False`` in the port, JAX's
    trailing zeroing; their gradients 0, as ``stop_gradient`` gives them:
    JAX's clip counts every gradient, the port's the trainable ones); then
    a copy of the optimizer made from the port's ``state_dict`` after two
    steps gives the third step's bits."""
    rs = np.random.RandomState(0)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), _adamw_params(rs))
    grads = []
    for norm in (60.0, 3.0, 0.2):
        g = jax.tree.map(lambda a: rs.randn(*a.shape).astype(np.float32), params)
        for frozen in ("conv1", "layer1_0"):  # stopped gradients, as a detector's are
            g["backbone"][frozen] = jax.tree.map(np.zeros_like, g["backbone"][frozen])
        scale = norm / float(optax.global_norm(g))
        grads.append(jax.tree.map(lambda a: (a * scale).astype(np.float32), g))
    lrs = (1e-3, 5e-4, 2e-4)

    def sched(step):
        return jnp.asarray(lrs)[step]

    tx = j_train.make_optimizer(sched, weight_decay=0.05, grad_clip_norm=35.0, params=params,
                                frozen_stages=1, opt_type="adamw")
    state, j_params = tx.init(params), params
    for g in grads:
        updates, state = tx.update(g, state, j_params)
        j_params = optax.apply_updates(j_params, updates)
    ref = from_jax_params(jax.tree.map(np.asarray, j_params))

    def port():
        ps = {k: torch.nn.Parameter(v.clone()) for k, v in from_jax_params(params).items()}
        for k, p in ps.items():
            p.requires_grad_(not k.startswith(("backbone.conv1.", "backbone.layer1_")))
        return ps, t_train.make_optimizer(list(ps.values()), lambda s: float(np.float32(lrs[s])),
                                          weight_decay=0.05, opt_type="adamw")

    ps, opt = port()
    grad_of = [from_jax_params(jax.tree.map(np.asarray, g)) for g in grads]
    for k, g in enumerate(grad_of):
        opt.zero_grad()
        for name, p in ps.items():
            if p.requires_grad:
                p.grad = g[name].clone()
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads[k])), rtol=1e-6)
        if k == 1:
            saved = {n: p.detach().clone() for n, p in ps.items()}
            opt_state = opt.state_dict()
    assert opt.adamw.count == 3
    for name, r in ref.items():
        got = ps[name].detach()
        if not ps[name].requires_grad:
            assert torch.equal(got, torch.from_numpy(np.asarray(
                from_jax_params(params)[name]))), name
            continue
        assert not torch.equal(got, from_jax_params(params)[name]), name
        np.testing.assert_allclose(got.numpy(), r.numpy(), rtol=1e-6, atol=1e-9, err_msg=name)
    again, opt2 = port()
    with torch.no_grad():
        for n, p in again.items():
            p.copy_(saved[n])
    opt2.load_state_dict(opt_state)
    for name, p in again.items():
        if p.requires_grad:
            p.grad = grad_of[2][name].clone()
    opt2.step()
    for name, p in again.items():
        assert torch.equal(p.detach(), ps[name].detach()), name


def test_adamw_state_survives_a_checkpoint(tmp_path):
    """Two AdamW steps, ``save_checkpoint``, a fresh model and optimizer
    ``restore_checkpoint``-ed: the third step gives the uninterrupted run's
    bits (the moments and count in the checkpoint)."""
    rs = np.random.RandomState(1)
    grads = [[torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in ((6, 4), (6,))]
             for _ in range(3)]

    def make():
        net = torch.nn.Linear(4, 6)
        with torch.no_grad():
            net.weight.copy_(torch.from_numpy(np.linspace(-1, 1, 24, dtype=np.float32)
                                              .reshape(6, 4)))
            net.bias.zero_()
        return net, t_train.make_optimizer(net.parameters(), lambda s: 1e-3, weight_decay=0.05,
                                           opt_type="adamw")

    def step(net, opt, g):
        for p, gp in zip(net.parameters(), g):
            p.grad = gp.clone()
        opt.step()

    net, opt = make()
    for g in grads[:2]:
        step(net, opt, g)
    save_checkpoint(str(tmp_path / "ckpt"), net, opt, step=2)
    step(net, opt, grads[2])
    again, opt2 = make()
    assert restore_checkpoint(str(tmp_path / "ckpt"), again, opt2)["step"] == 2
    assert opt2.adamw.count == 2 and opt2.step_count == 2
    step(again, opt2, grads[2])
    for a, b in zip(net.parameters(), again.parameters()):
        assert torch.equal(a, b)


# ------------------------------------------------- the tiny Swin Mask R-CNN
def _tiny_swin(load):
    mc = load(config_path(SWIN_T)).model.to_dict()
    mc["backbone"].update(embed_dims=16, depths=[2, 1, 1, 1], num_heads=[1, 2, 4, 8])
    mc["neck"]["in_channels"] = [16, 32, 64, 128]
    mc = shrink_heads(mc, num_classes=4)
    mc["roi_head"]["bbox_roi_extractor"]["out_channels"] = 32
    mc["roi_head"]["mask_roi_extractor"]["out_channels"] = 32
    mc["roi_head"]["mask_head"].update(in_channels=32, conv_out_channels=16, num_classes=4)
    return mc


def _masks(rs, batch):
    return {"gt_mask_crops": np.stack([np.stack([_ellipse(rs) for _ in range(6)])
                                       for _ in range(2)])}


@pytest.fixture(scope="module")
def run():
    # the config's AdamW: lr 1e-4 (then 1.5e-5), weight decay 0.05.  Seed 1:
    # at seed 0 one detection's box sits 1.3e-3 px from JAX's (a float32
    # edge), at seed 2 JAX's jitted loss rounds the 0.5 ties of its gt-box
    # RoIs' mask targets the other way (tests/test_torch_c4_dc5.py::
    # eager_mask_targets; JAX's own eager mask gradient there is the port's
    # within 1.8e-6, the jitted one 0.8% apart)
    return run_pair(_tiny_swin, seed=1, frozen_stages=-1, targets=_masks, base_lr=2e-4,
                    optimizer=dict(opt_type="adamw", weight_decay=0.05))


def test_tiny_swin_is_the_runner_shrink():
    mc = shrink_model(load_config(config_path(SWIN_T)).model.to_dict())
    assert mc["backbone"]["embed_dims"] == 16 and list(mc["backbone"]["depths"]) == [2, 1, 1, 1]
    net = build_detector(mc, device="cpu").net
    assert net.backbone.stage0_block1.shift == 3
    assert net.backbone.out_channels == (16, 32, 64, 128)


def test_swin_mask_rcnn_predict_matches_jax(run):
    check_predict({"j_pred": run["j_pred"][:3], "t_pred": run["t_pred"][:3]})
    masks, ref = run["t_pred"][3], np.asarray(run["j_pred"][3])
    np.testing.assert_allclose(masks.numpy(), ref, rtol=0, atol=1e-4)


def test_swin_mask_rcnn_losses_match_jax(run):
    check_losses(run, MASK_LOSSES)


def test_swin_mask_rcnn_gradients_match_jax(run):
    check_gradients(run, frozen_names=())
    table = run["t_grads"]["backbone.stage0_block1.attn.relative_position_bias_table"]
    assert table.abs().max() > 0


# AdamW's first update of an element is ``g / (|g| + 1e-8)``: where a step's
# gradient is rounding of 0 (a median 4.7e-10, the two packages' sums apart
# by more than that), its update follows the rounding, up to a whole step;
# such elements (262 and 235 of the model's 488,600 at the two steps, every
# gradient below 2.3e-7) are held to AdamW's bound, the others to the harness
ADAM_QUIET = 1e-6  # |g| under which an update may follow the gradient's rounding
ADAM_QUIET_SHARE = 1e-3  # most elements that may be so


def check_adamw_step(run, step, wd=0.05):
    """Step ``step`` of the tiny Swin Mask R-CNN, the port from JAX's state
    before it: the metrics as ``check_step`` holds them (rtol 1e-4); the
    gradients the port's optimizer was given against JAX's
    (``check_gradients``'s tolerances); the port's parameters equal to
    optax's AdamW chain (JAX ``make_optimizer(opt_type="adamw")``: clip,
    adamw, no mask) on the port's gradients from JAX's state (parameters,
    moments, count), within 1e-6 of each value plus 1e-6 of the step's
    learning rate; against JAX's parameters every element within twice the
    learning rate times ``1 + wd * |p|`` (AdamW's bound on an update), and
    every one within the harness's tolerance (``check_step``'s, of the
    step's own update) but where JAX's gradient is under ``ADAM_QUIET``
    (at most ``ADAM_QUIET_SHARE`` of the model)."""
    j_params, t_params, j_metrics, t_metrics = run["steps"][step]
    for k in ("loss", "grad_norm", *MASK_LOSSES):
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), rtol=1e-4,
                                   err_msg=k)
    j_grads, t_grads = run["step_grads"][step], run["t_step_grads"][step]
    g_max = max(g.abs().max().item() for g in j_grads.values())
    for name, ref in j_grads.items():
        got = t_grads[name]
        np.testing.assert_allclose(got.numpy(), ref.reshape(got.shape).numpy(), rtol=0,
                                   atol=1e-3 * ref.abs().max().item() + 1e-6 * g_max,
                                   err_msg=f"step {step} gradient {name}")
    lr = run["lr"][step]
    start, count, mu, nu = run["starts"][step]
    start = {n: v.reshape(t_params[n].shape).numpy() for n, v in start.items()}
    tx = j_train.make_optimizer(lambda c: jnp.float32(lr), weight_decay=wd, opt_type="adamw")
    state = tx.init(start)
    adam = optax.ScaleByAdamState(
        count=jnp.int32(count), mu={n: v.reshape(start[n].shape).numpy() for n, v in mu.items()},
        nu={n: v.reshape(start[n].shape).numpy() for n, v in nu.items()})
    state = jax.tree.map(lambda x: adam if isinstance(x, optax.ScaleByAdamState) else x, state,
                         is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    shadow = jax.jit(lambda g, st, p: optax.apply_updates(p, tx.update(g, st, p)[0]))(
        {n: g.numpy() for n, g in t_grads.items()}, state, start)
    past = total = 0
    for name, ref in j_params.items():
        got, p0 = t_params[name], torch.from_numpy(start[name])
        np.testing.assert_allclose(got.numpy(), np.asarray(shadow[name]), rtol=1e-6,
                                   atol=1e-6 * lr, err_msg=f"optax on the port's gradients: {name}")
        ref = ref.reshape(got.shape)
        err = (got - ref).abs()
        assert bool((err <= 2 * lr * (1 + wd * ref.abs())).all()), name
        atol = 1e-3 * (ref - p0).abs().max().item() + 1e-7 * ref.abs().max().item()
        quiet = j_grads[name].reshape(got.shape).abs() < ADAM_QUIET
        assert not bool((err > atol)[~quiet].any()), name
        past += int((err > atol).sum())
        total += got.numel()
    assert past <= ADAM_QUIET_SHARE * total, (past, total)


@pytest.mark.parametrize("step", [0, 1])
def test_swin_mask_rcnn_adamw_steps_match_jax(run, step):
    check_adamw_step(run, step)


# ------------------------------------------------------------- mmdet weights
def _mmdet_swin(rs, embed=16, depths=(2, 1, 1, 1), heads=(1, 2, 4, 8), ws=7):
    """An mmdet Swin backbone state dict (``backbone.*``) of random values."""
    sd = {"backbone.patch_embed.projection.weight": rs.randn(embed, 3, 4, 4),
          "backbone.patch_embed.projection.bias": rs.randn(embed),
          "backbone.patch_embed.norm.weight": rs.randn(embed),
          "backbone.patch_embed.norm.bias": rs.randn(embed)}
    c = embed
    for s, depth in enumerate(depths):
        for b in range(depth):
            k = f"backbone.stages.{s}.blocks.{b}."
            sd.update({k + "norm1.weight": rs.randn(c), k + "norm1.bias": rs.randn(c),
                       k + "attn.w_msa.relative_position_bias_table":
                           rs.randn((2 * ws - 1) ** 2, heads[s]),
                       k + "attn.w_msa.relative_position_index":
                           rs.randint(0, 10, (ws * ws, ws * ws)),
                       k + "attn.w_msa.qkv.weight": rs.randn(3 * c, c),
                       k + "attn.w_msa.qkv.bias": rs.randn(3 * c),
                       k + "attn.w_msa.proj.weight": rs.randn(c, c),
                       k + "attn.w_msa.proj.bias": rs.randn(c),
                       k + "norm2.weight": rs.randn(c), k + "norm2.bias": rs.randn(c),
                       k + "ffn.layers.0.0.weight": rs.randn(4 * c, c),
                       k + "ffn.layers.0.0.bias": rs.randn(4 * c),
                       k + "ffn.layers.1.weight": rs.randn(c, 4 * c),
                       k + "ffn.layers.1.bias": rs.randn(c)})
        if s < len(depths) - 1:
            k = f"backbone.stages.{s}.downsample."
            sd.update({k + "norm.weight": rs.randn(4 * c), k + "norm.bias": rs.randn(4 * c),
                       k + "reduction.weight": rs.randn(2 * c, 4 * c)})
        sd[f"backbone.norm{s}.weight"], sd[f"backbone.norm{s}.bias"] = rs.randn(c), rs.randn(c)
        c *= 2
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}


def test_mmdet_swin_weights_match_the_jax_converter():
    sd = _mmdet_swin(np.random.RandomState(4))
    got = from_mmdet_state_dict(sd)
    params, _ = convert_swin_backbone({k[len("backbone."):]: v for k, v in sd.items()})
    ref = from_jax_params({"params": {"backbone": params}})
    assert set(got) == set(ref)
    for name, r in ref.items():
        assert torch.equal(got[name], r), name
    # they load into the port's Swin (strict on the backbone), the merges
    # permuted: the reduction's columns and the norm's rows alike
    det = build_detector(_tiny_swin(load_config), device="cpu")
    own = {k for k in det.net.state_dict() if k.startswith("backbone.")}
    assert own == set(got)
    det.net.load_state_dict(got, strict=False)
    perm = np.asarray([c * 4 + {0: 0, 1: 2, 2: 1, 3: 3}[blk] for blk in range(4)
                       for c in range(16)])
    np.testing.assert_array_equal(
        got["backbone.merge0.reduction.weight"].numpy(),
        sd["backbone.stages.0.downsample.reduction.weight"].numpy()[:, perm])


def test_mmdet_absolute_pos_embed_raises():
    sd = _mmdet_swin(np.random.RandomState(5))
    sd["backbone.absolute_pos_embed"] = torch.zeros(1, 56 * 56, 16)
    with pytest.raises(NotImplementedError, match="absolute_pos_embed"):
        from_mmdet_state_dict(sd)


# ------------------------------------------------------------------ configs
@pytest.fixture
def seeded_init_skipped():
    """Full-width builds without the seeded draws: the checks read the
    built detectors' structure and optimizer, never their weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_layers, "lecun_normal_", lambda weight, fan_in, gen: None)
        for name in ("kaiming_uniform_", "uniform_", "trunc_normal_"):
            mp.setattr(torch.nn.init, name, lambda tensor, *a, **k: tensor)
        yield


@pytest.mark.usefixtures("seeded_init_skipped")
@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p)[:-3] for p in CONFIGS])
def test_swin_configs_build_at_full_width_with_adamw(path):
    cfg = load_config(path)
    det = build_detector(cfg.model.to_dict(), device="cpu")
    net = det.net
    depths = tuple(cfg.model.backbone.depths)
    assert isinstance(net.backbone, t_swin.SwinTransformer) and net.backbone.depths == depths
    assert net.backbone.out_channels == (96, 192, 384, 768)
    assert hasattr(net.backbone, f"stage2_block{depths[2] - 1}")
    opt = build_trainer(cfg, det, steps_per_epoch=1000).optimizer
    assert opt.opt_type == "adamw" and opt.adamw.weight_decay == 0.05
    assert opt.lr_schedule(10 ** 6) < opt.lr_schedule(500) == np.float32(1e-4)


@pytest.mark.usefixtures("seeded_init_skipped")
def test_swin_unread_keys_raise():
    mc = load_config(config_path(SWIN_T)).model.to_dict()
    mc["backbone"]["drop_path_rate"] = 0.2
    with pytest.raises(NotImplementedError, match="drop_path_rate"):
        build_detector(mc, device="cpu")
