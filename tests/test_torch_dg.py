"""The port's domain-generalisation slice against the JAX package, on the
CPU: SUO-DAC's domain labels, the style transfer, the loader's
``domain_file`` / ``dgaug`` / ``jigsaw`` targets, the gradient reversal,
the DG classifiers, the EM attention units, ``HiddenMixupResNet``, and the
four tiny detectors (``DGFasterRCNN``, ``JiGENFasterRCNN``,
``DGaugFasterRCNN``, ``EMAFasterRCNN``).

The detectors go through ``tests/test_torch_boosting_detectors.py``'s
harness at its tolerances (``run_pair`` with the DG targets in the
batch): numpy weights from a seed carried by ``weights.from_jax_params``,
JAX's ``train_sample`` and RPN draws fed to both packages, then the
losses, every gradient and two optimizer steps, with the classifiers'
Adam group and the ``mu`` / ``count`` buffers.  The EMA model's
``predict`` is held against JAX's; the three DG detectors predict through
the Faster R-CNN path, which their ``predict`` is held to bit for bit
(``tests/test_torch_faster_rcnn.py`` holds it against JAX).
"""
import json
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

from boosting_rcnn_tpu.builder import build_hidden_mixup_resnet  # noqa: E402
from boosting_rcnn_tpu.data.coco import CocoDataset as JCoco  # noqa: E402
from boosting_rcnn_tpu.data.loader import DetDataLoader as JLoader  # noqa: E402
from boosting_rcnn_tpu.data import style_transfer as j_style  # noqa: E402
from boosting_rcnn_tpu.data.suodac import DomainMap as JDomainMap  # noqa: E402
from boosting_rcnn_tpu.models.detectors import dg as j_dg  # noqa: E402
from boosting_rcnn_tpu.models import thesis_extras as j_te  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.data.coco import CocoDataset as TCoco  # noqa: E402
from boosting_rcnn_tpu_torch.data.loader import DetDataLoader as TLoader  # noqa: E402
from boosting_rcnn_tpu_torch.data import style_transfer as t_style  # noqa: E402
from boosting_rcnn_tpu_torch.data.suodac import DomainMap  # noqa: E402
from boosting_rcnn_tpu_torch.data.synthetic import generate  # noqa: E402
from boosting_rcnn_tpu_torch.models.backbones.resnet import ResNet  # noqa: E402
from boosting_rcnn_tpu_torch.models.detectors import dg as t_dg  # noqa: E402
from boosting_rcnn_tpu_torch.models import thesis_extras as t_te  # noqa: E402
from boosting_rcnn_tpu_torch.weights import from_jax_params  # noqa: E402
from test_torch_boosting_detectors import (  # noqa: E402
    FROZEN,
    _random_variables,
    check_gradients,
    check_losses,
    check_predict,
    check_step,
    config_path,
    one_torch_thread,  # noqa: F401 (a module fixture)
    run_pair,
    shrink_heads,
)

CANVAS = (128, 160)
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox")
NUM_DOMAINS = 3
JIG_CLASSES = 31


def _close(got, ref, rel=1e-5, err=""):
    """``got`` within ``rel`` of ``ref``'s largest magnitude."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, err
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-30),
                               err_msg=err)


# ----------------------------------------------------------- domain labels
def _write_domain_files(root):
    stems = [f"img_{i}" for i in range(7)]
    dirs = os.path.join(root, "lists")
    os.makedirs(dirs, exist_ok=True)
    layout = {"b_murky": stems[:3], "a_clear": stems[3:5] + [stems[0]], "c_deep": stems[5:6]}
    for name, names in layout.items():
        with open(os.path.join(dirs, name + ".txt"), "w") as f:
            f.write("\n".join(names + [""]))
    with open(os.path.join(root, "lists.json"), "w") as f:
        json.dump(layout, f)
    with open(os.path.join(root, "ids.json"), "w") as f:
        json.dump({s: i % 3 for i, s in enumerate(stems[:6])}, f)
    return {"dir": dirs, "lists": os.path.join(root, "lists.json"),
            "ids": os.path.join(root, "ids.json")}, stems


@pytest.mark.parametrize("layout", ["dir", "lists", "ids"])
def test_domain_map_layouts_match_jax(tmp_path, layout):
    files, stems = _write_domain_files(str(tmp_path))
    t, j = DomainMap(files[layout]), JDomainMap(files[layout])
    assert t.domains == j.domains and t.num_domains == j.num_domains == 3
    for stem in stems + ["unlisted"]:
        path = f"/data/x/{stem}.jpg"
        assert t.domain_of(path) == j.domain_of(path)
        one = t.one_hot(path)
        assert one.dtype == np.float32 and np.array_equal(one, j.one_hot(path))


@pytest.mark.parametrize("method", ["reinhard", "hist"])
def test_stylize_is_byte_equal_to_jax(method):
    rs = np.random.RandomState(4)
    content, style = rs.rand(20, 28, 3), rs.rand(9, 7, 3) * 0.6
    t_rng, j_rng = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(3):
        got = t_style.stylize(content, style, method=method, rng=t_rng)
        ref = j_style.stylize(content, style, method=method, rng=j_rng)
        assert got.dtype == ref.dtype == np.float64 and np.array_equal(got, ref)
    assert np.array_equal(t_style.hist_match(content, style), j_style.hist_match(content, style))
    assert t_rng.randint(1 << 30) == j_rng.randint(1 << 30)  # the streams in step


# ------------------------------------------------------------- the loader
@pytest.fixture(scope="module")
def suodac_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("suodac"))
    generate(root, n_train=7, n_val=0, seed=5, frame_sizes=[(80, 64), (72, 60)], n_portrait=2,
             object_scale=0.5)
    with open(os.path.join(root, "train.json")) as f:
        stems = [im["file_name"].rsplit(".", 1)[0] for im in json.load(f)["images"]]
    domains = {s: (i * 2) % NUM_DOMAINS for i, s in enumerate(stems)}
    with open(os.path.join(root, "domains.json"), "w") as f:
        json.dump(domains, f)
    ann, img = os.path.join(root, "train.json"), os.path.join(root, "train")
    return dict(t=TCoco(ann, img), j=JCoco(ann, img_prefix=img),
                domains=os.path.join(root, "domains.json"))


LOADER_CASES = {
    "domains+jigsaw": dict(domain=True, jigsaw=JIG_CLASSES),
    "domains+dgaug": dict(domain=True, dgaug=True),
    "dgaug+jigsaw": dict(dgaug=True, jigsaw=8, mstrain_range=(48, 64)),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_dg_loader_matches_jax_over_two_epochs(suodac_set, case):
    kw = dict(LOADER_CASES[case])
    if kw.pop("domain", False):
        kw["domain_file"] = suodac_set["domains"]
    base = dict(batch_size=2, canvas=(64, 80), train=True, seed=2, **kw)
    tl = TLoader(suodac_set["t"], scale=(80, 64), **base)
    jl = JLoader(suodac_set["j"], **base)
    assert len(tl) == len(jl)
    for epoch in range(2):
        tb, jb = list(tl.epoch_iter(epoch)), list(jl.epoch_iter(epoch))
        assert len(tb) == len(jb) == len(tl)
        for t, j in zip(tb, jb):
            assert set(t) == set(j)
            for key in j:
                if torch.is_tensor(t[key]):
                    np.testing.assert_allclose(t[key].numpy(), j[key], rtol=0, atol=1e-4,
                                               err_msg=key)
                else:
                    assert t[key].dtype == j[key].dtype, key
                    np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    if "jigsaw" in kw:
        assert (tl.jig_perms == jl.jig_perms).all() and (tl.jig_perms[0] == np.arange(9)).all()
    tail = list(tl.epoch_iter(1, start=1))  # a resumed epoch replays the draws
    full = list(tl.epoch_iter(1))
    for a, b in zip(tail, full[1:]):
        for key in ("images", "img_aug", "img_puzzle"):
            if key in a:
                assert torch.equal(a[key], b[key]), key


def test_fake_loader_dg_targets_match_jax():
    """``FakeDetLoader(num_domains=, jigsaw=)``: the batches (the upside-down
    puzzle, the drawn one-hot labels) equal to the JAX fake loader's."""
    from boosting_rcnn_tpu.data.loader import FakeDetLoader as JFake
    from boosting_rcnn_tpu_torch.data.loader import FakeDetLoader

    kw = dict(batch_size=2, canvas=(48, 64), num_classes=4, max_gt=5, seed=3, num_batches=2,
              num_domains=NUM_DOMAINS, jigsaw=7)
    for t, j in zip(FakeDetLoader(**kw).epoch_iter(1), JFake(**kw).epoch_iter(1)):
        assert set(t) == set(j)
        for key, ref in j.items():
            got = t[key].numpy() if torch.is_tensor(t[key]) else t[key]
            assert np.array_equal(got, ref), key


# ------------------------------------------------------------- the modules
def test_grad_reverse_value_and_gradient_are_exact():
    x = torch.tensor([1.5, -2.25, 3.0], requires_grad=True)
    alpha = torch.tensor(0.375, requires_grad=True)
    y = t_dg.grad_reverse(x, alpha)
    g = torch.tensor([0.5, 1.0, -4.0])
    y.backward(g)
    jy, vjp = jax.vjp(lambda v: j_dg.grad_reverse(v, jnp.float32(0.375)), jnp.asarray(x.detach()))
    assert np.array_equal(y.detach().numpy(), np.asarray(jy))
    assert np.array_equal(x.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    assert alpha.grad is None


def _module_pair(jmod, tmod, inputs, rs, count=None, **apply_kw):
    """``jmod`` (random variables) and ``tmod`` (the same through
    ``from_jax_params``) in train mode on ``inputs`` (JAX layouts) and a
    random cotangent: outputs, input and parameter gradients, and the
    moved ``batch_stats``."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *inputs, **apply_kw))
    variables = _random_variables(shapes, rs)
    if count is not None:
        variables["batch_stats"]["count"] = np.float32(count)
    tmod.load_state_dict(from_jax_params(variables), strict=True)
    tmod.train()

    def j_out(params, xs):
        out, upd = jmod.apply({"params": params, "batch_stats": variables.get("batch_stats", {})},
                              *xs, mutable=["batch_stats"], **apply_kw)
        return out, upd.get("batch_stats", {})

    j_inputs = jax.tree.map(jnp.asarray, list(inputs))
    out_shapes = jax.tree.leaves(jax.eval_shape(j_out, variables["params"], j_inputs)[0])
    cots = [np.asarray(rs.randn(*o.shape), np.float32) for o in out_shapes]

    def j_loss(params, xs):
        out, st = j_out(params, xs)
        return sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip(jax.tree.leaves(out), cots)), (out, st)

    (_, (ref, stats)), (j_gp, j_gx) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(variables["params"], j_inputs)
    flat_ref = jax.tree.leaves(ref)
    return variables, flat_ref, cots, stats, j_gp, j_gx


def _nchw(x):
    return torch.tensor(np.asarray(x)).permute(0, 3, 1, 2).contiguous().requires_grad_(True)


def _hold(tmod, t_out, t_inputs, flat_ref, cots, j_gp, j_gx):
    """The port's outputs (NCHW maps read back as NHWC) and gradients
    against JAX's, within 1e-5 of each tensor's largest."""
    outs = [o.permute(0, 2, 3, 1) if o.dim() == 4 else o for o in t_out]
    assert len(outs) == len(flat_ref)
    for i, (o, r) in enumerate(zip(outs, flat_ref)):
        _close(o.detach().numpy(), r, err=f"output {i}")
    sum((o.float() * torch.tensor(c)).sum() for o, c in zip(outs, cots)).backward()
    for i, (x, g) in enumerate(zip(t_inputs, j_gx)):
        _close(x.grad.permute(0, 2, 3, 1).numpy(), g, err=f"input {i}")
    ref = from_jax_params(jax.tree.map(np.asarray, j_gp))
    for name, p in tmod.named_parameters():
        _close(p.grad.numpy(), ref[name].reshape(p.shape).numpy(), err=name)


def test_domain_classifier_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(3, 15, 17, 16).astype(np.float32)
    jm = j_dg.DomainClassifier(num_domains=NUM_DOMAINS, total_img=20.0)
    tm = t_dg.DomainClassifier(16, torch.Generator().manual_seed(0), NUM_DOMAINS, 20.0)
    variables, flat_ref, cots, stats, j_gp, j_gx = _module_pair(jm, tm, [x], rs, count=4.0)
    xt = _nchw(x)
    _hold(tm, [tm(xt)], [xt], flat_ref, cots, j_gp, j_gx)
    assert float(tm.count) == float(stats["count"]) == 7.0  # advanced by the batch
    alpha = 2.0 / (1.0 + np.exp(-10.0 * 7.0 / 20.0)) - 1.0
    assert 0.5 < alpha < 1.0  # the reversed gradient above is scaled by it
    tm.eval()
    tm(xt)
    assert float(tm.count) == 7.0  # an eval forward leaves it


def test_jigsaw_classifier_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 5, 6, 24).astype(np.float32)
    jm = j_dg.JigsawClassifier(jig_classes=JIG_CLASSES)
    tm = t_dg.JigsawClassifier(24, torch.Generator().manual_seed(0), JIG_CLASSES)
    _, flat_ref, cots, _, j_gp, j_gx = _module_pair(jm, tm, [x], rs)
    xt = _nchw(x)
    _hold(tm, [tm(xt)], [xt], flat_ref, cots, j_gp, j_gx)


@pytest.mark.parametrize("pyramid", [False, True], ids=["emau", "fpemau"])
def test_em_attention_matches_jax(pyramid):
    rs = np.random.RandomState(3)
    shapes = [(2, 9, 11, 16), (2, 5, 6, 16), (2, 3, 3, 16)] if pyramid else [(2, 9, 11, 16)]
    xs = [rs.randn(*s).astype(np.float32) for s in shapes]
    gen = torch.Generator().manual_seed(0)
    if pyramid:
        jm, tm = j_te.FPEMAU(k=8), t_te.FPEMAU(16, 8, gen)
        inputs = [tuple(xs)]
    else:
        jm, tm = j_te.EMAU(k=8), t_te.EMAU(16, 8, gen)
        inputs = xs
    variables, flat_ref, cots, stats, j_gp, j_gx = _module_pair(jm, tm, inputs, rs)
    if pyramid:
        j_gx = list(j_gx[0])
    t_in = [_nchw(x) for x in xs]
    outs, mu = tm(t_in) if pyramid else tm(t_in[0])
    outs = list(outs) if pyramid else [outs]
    _hold(tm, outs + [mu], t_in, flat_ref, cots, j_gp, j_gx)
    np.testing.assert_allclose(tm.mu.numpy(), np.asarray(stats["mu"]), rtol=0, atol=1e-6)
    assert not np.allclose(np.asarray(stats["mu"]), variables["batch_stats"]["mu"])


@pytest.mark.parametrize("views", [1, 2])
def test_hidden_mixup_resnet_matches_jax(views):
    rs = np.random.RandomState(4)
    cfg = dict(type="HiddenMixupResNet", depth=18, base_channels=8)
    jm = build_hidden_mixup_resnet(cfg)
    tm = t_te.HiddenMixupResNet(ResNet(torch.Generator().manual_seed(0), depth=18,
                                       base_channels=8))
    xs = [rs.randn(2, 40, 48, 3).astype(np.float32) for _ in range(views)]
    key = jax.random.PRNGKey(5)
    kw = dict(mix_rng=key, train=True) if views == 2 else {}
    _, flat_ref, cots, _, j_gp, j_gx = _module_pair(jm, tm, xs, rs, **kw)
    t_in = [_nchw(x) for x in xs]
    if views == 2:
        lams = [float(jax.random.beta(r, 2.0, 2.0)) for r in jax.random.split(key, 4)]
        outs, contrastive = tm(t_in[0], t_in[1], mix_lams=lams, train=True)
        outs = list(outs) + [contrastive]
    else:
        outs = list(tm(t_in[0]))
    _hold(tm, outs, t_in, flat_ref, cots, j_gp, j_gx)


def test_contrastive_losses_match_jax():
    rs = np.random.RandomState(6)
    a, b = rs.randn(2, 8, 12, 16).astype(np.float32), rs.randn(2, 8, 12, 16).astype(np.float32)
    for t_f, j_f in ((t_te.spatial_contrastive_loss, j_te.spatial_contrastive_loss),
                     (t_te.channel_contrastive_loss, j_te.channel_contrastive_loss)):
        _close(t_f(torch.tensor(a), torch.tensor(b)).item(), float(j_f(a, b)), rel=1e-6)


# ------------------------------------------------------------ the detectors
def _tiny_suodac(name, **model):
    def make(load):
        mc = load(config_path(name)).model.to_dict()
        mc["backbone"].update(depth=18, base_channels=8)
        mc["neck"]["in_channels"] = [8, 16, 32, 64]
        mc["roi_head"]["bbox_roi_extractor"]["out_channels"] = 32
        mc.update(model)
        return shrink_heads(mc, num_classes=4)
    return make


def _dg_targets(rs, batch):
    b = batch["images"].shape[0]
    return {"domain_label": np.eye(NUM_DOMAINS, dtype=np.float32)[[2, 0][:b]],
            "img_puzzle": np.ascontiguousarray(batch["images"][:, ::-1]),
            "jig_labels": np.eye(JIG_CLASSES, dtype=np.float32)[rs.randint(0, JIG_CLASSES, b)],
            "img_aug": (batch["images"] * 0.8 + 0.1 * rs.randn(*batch["images"].shape)).astype(
                np.float32)}


DETECTORS = {
    "dg": (_tiny_suodac("suodac/dg_faster_rcnn_r50_fpn_1x.py", num_domains=NUM_DOMAINS,
                        total_img=16), ("loss_domain",), FROZEN),
    "jigen": (_tiny_suodac("suodac/jigen_faster_rcnn_r50_fpn_1x.py", jig_classes=JIG_CLASSES),
              ("loss_jig",), FROZEN),
    "dgaug": (_tiny_suodac("suodac/DMC_faster_rcnn_r50_fpn_1x.py"), (),
              tuple(f.replace("backbone.", "backbone.resnet.") for f in FROZEN)),
    "ema": (_tiny_suodac("roiattention/EMAfaster_rcnn_r50_fpn_1x_coco.py", k=8), (), FROZEN),
}


@pytest.fixture(scope="module", params=sorted(DETECTORS))
def dg_run(request):
    make, aux, frozen = DETECTORS[request.param]
    run = run_pair(make, targets=_dg_targets, predict=request.param == "ema")
    return request.param, run, LOSSES + aux, frozen


def test_dg_detector_predicts(dg_run):
    """EMA against JAX's ``predict``; a DG detector's ``predict`` is the
    Faster R-CNN path, bit for bit."""
    name, run, _, _ = dg_run
    if name == "ema":
        check_predict(run)
        return
    mc = _tiny_suodac("suodac/faster_rcnn_r50_fpn_1x.py")(load_config)
    plain = build_detector(mc, device="cpu")
    state = {k.replace("backbone.resnet.", "backbone."): v
             for k, v in run["tdet"].net.state_dict().items()
             if not k.startswith(("domain_head.", "jig_head."))}
    plain.net.load_state_dict(state, strict=True)
    anchors, nla = plain.anchors_for(CANVAS)
    got = run["tdet"].predict(run["batch"], anchors, nla)
    ref = plain.predict(run["batch"], anchors, nla)
    assert int(ref[2].sum()) >= 20
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_dg_detector_losses_match_jax(dg_run):
    _, run, names, _ = dg_run
    check_losses(run, names)


def test_dg_detector_gradients_match_jax(dg_run):
    name, run, _, frozen = dg_run
    check_gradients(run, frozen)
    if name in ("dg", "jigen"):  # the reversed or jigsaw gradient reaches the backbone
        head = "domain_head" if name == "dg" else "jig_head"
        assert any(k.startswith(head) and g.abs().max() > 0 for k, g in run["t_grads"].items())


@pytest.mark.parametrize("step", [0, 1])
def test_dg_detector_steps_match_jax(dg_run, step):
    """The parameters (the classifiers' Adam group among them), the metrics
    and the ``mu`` / ``count`` buffers after each step."""
    name, run, names, frozen = dg_run
    check_step(run, step, names, frozen_names=frozen)
    j_buf, t_buf = run["buffers"][step]
    for key in ("emau.mu", "domain_head.count"):
        if key in t_buf:
            np.testing.assert_allclose(t_buf[key].numpy(), j_buf[key].numpy(), rtol=0,
                                       atol=1e-6, err_msg=key)
    if name == "dg":  # advanced by each step's 2 images, in float32
        count = np.float32(run["variables"]["batch_stats"]["domain_head"]["count"])
        for _ in range(step + 1):
            count = np.float32(count + np.float32(2.0))
        assert float(t_buf["domain_head.count"]) == float(count)
    if name == "ema":
        assert not torch.equal(t_buf["emau.mu"], torch.tensor(run["variables"]["batch_stats"]
                                                              ["emau"]["mu"]))
    if name in ("dg", "jigen"):  # the Adam group moved by about its learning rate
        head = "domain_head." if name == "dg" else "jig_head."
        t_params, p0 = run["steps"][step][1], run["p0"]
        moved = max((t_params[k] - p0[k]).abs().max().item() for k in t_params
                    if k.startswith(head))
        assert 0.5e-3 < moved <= 2.0e-3 * (step + 1)


# ------------------------------------------------- configs, CLI and weights
DG_CONFIG_FILES = ["suodac/dg_faster_rcnn_r50_fpn_1x.py", "suodac/jigen_faster_rcnn_r50_fpn_1x.py",
                   "suodac/DMC_faster_rcnn_r50_fpn_1x.py", "suodac/faster_rcnn_r50_fpn_1x.py",
                   "roiattention/EMAfaster_rcnn_r50_fpn_1x_coco.py"]


@pytest.mark.parametrize("name", DG_CONFIG_FILES)
def test_dg_config_builds_and_trains_tiny(name, tmp_path, monkeypatch):
    """Each SUODAC config and the EMA config builds at full width with its
    part, and ``--tiny --fake-data`` trains it 2 iterations through the
    port's train CLI (the DG detectors' fake targets drawn as the JAX tool
    draws them)."""
    from boosting_rcnn_tpu_torch.models import layers as t_layers
    from boosting_rcnn_tpu_torch.tools import train as train_cli

    path = config_path(name)
    with monkeypatch.context() as m:  # the seeded draws skipped: the structure is checked
        m.setattr(t_layers, "lecun_normal_", lambda weight, fan_in, gen: None)
        for init in ("kaiming_uniform_", "uniform_"):  # torch's own inits, overwritten
            m.setattr(torch.nn.init, init, lambda tensor, *a, **k: tensor)
        net = build_detector(load_config(path).model.to_dict(), device="cpu").net
    parts = {"dg_": "domain_head", "jigen_": "jig_head", "EMA": "emau"}
    for prefix, part in parts.items():
        assert (getattr(net, part) is not None) == os.path.basename(name).startswith(prefix)
    assert isinstance(net.backbone, t_te.HiddenMixupResNet) == name.startswith("suodac/DMC")
    summary = train_cli.main([path, "--device", "cpu", "--tiny", "--fake-data", "--iters", "2",
                              "--work-dir", str(tmp_path), "--cfg-options",
                              "model.backbone.init_cfg=None"])
    m = summary["last_metrics"]
    assert summary["steps"] == 2 and np.isfinite(m["loss"])
    assert ("loss_domain" in m) == ("dg_" in name) and ("loss_jig" in m) == ("jigen" in name)


def test_mmdet_weights_of_the_dg_parts_raise_and_the_resnet_nests():
    from boosting_rcnn_tpu_torch.weights import from_mmdet_state_dict, nest_backbone

    for key in ("domain_cls.conv1.weight", "jig_cls.fc.weight", "emau.mu"):
        with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
            from_mmdet_state_dict({key: torch.zeros(1)})
    mc = _tiny_suodac("suodac/DMC_faster_rcnn_r50_fpn_1x.py")(load_config)
    net = build_detector(mc, device="cpu").net
    plain = {k.replace("backbone.resnet.", "backbone."): v for k, v in net.state_dict().items()}
    assert nest_backbone(plain, net).keys() == net.state_dict().keys()
