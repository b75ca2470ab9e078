"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs are made from seeds with numpy and go through both packages in
float32.  Box ops, anchors, top-k and NMS: exact selections and orders,
coordinates within 1e-6 relative.  RoIAlign: the port's plain version
against the JAX package's vmapped ``multilevel_roi_align_fast`` and the
Pallas kernel ``_kernel_flat`` in interpret mode, atol 1e-5; the kernels'
per-sample geometry (``sample_taps``) against the JAX package's
``_batched_geometry``, levels and origins equal, weights within 1e-6; the
gradient kernel's tile lists against a brute-force overlap list, exact.  Also: the
port and ``chip_smoke.py`` import no JAX, and entry points refuse to fall
back to the CPU silently.
"""
import os
import subprocess
import sys

os.environ["JAX_COMPILATION_CACHE_DIR"] = ""  # no compile-cache writes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from boosting_rcnn_tpu.ops import anchors as j_anchors  # noqa: E402
from boosting_rcnn_tpu.ops import box_ops as j_box  # noqa: E402
from boosting_rcnn_tpu.ops import nms as j_nms  # noqa: E402
from boosting_rcnn_tpu.ops import roi_align as j_roi  # noqa: E402
from boosting_rcnn_tpu_torch.ops import anchors as t_anchors  # noqa: E402
from boosting_rcnn_tpu_torch.ops import box_ops as t_box  # noqa: E402
from boosting_rcnn_tpu_torch.ops import nms as t_nms  # noqa: E402
from boosting_rcnn_tpu_torch.ops import roi_align as t_roi  # noqa: E402
from boosting_rcnn_tpu_torch.ops.roi_align_kernel import (  # noqa: E402
    RoIAlignForward,
    batched_multilevel_roi_align,
)
from boosting_rcnn_tpu_torch.ops.topk import select_topk  # noqa: E402

STRIDES = (8, 16, 32, 64, 128)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _boxes(rs, n, extent=200.0):
    xy = rs.uniform(0, extent, (n, 2))
    wh = rs.uniform(2, extent / 3, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ----------------------------------------------------------------- box ops


@pytest.mark.parametrize("mode", ["iou", "iof", "giou"])
def test_bbox_overlaps_matches_jax(mode):
    rs = np.random.RandomState(0)
    a, b = _boxes(rs, 40), _boxes(rs, 30)
    ref = np.asarray(j_box.bbox_overlaps(jnp.asarray(a), jnp.asarray(b), mode=mode))
    got = t_box.bbox_overlaps(_t(a), _t(b), mode=mode).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_delta2bbox_clamp_and_clip_match_jax():
    """Class-wise deltas with log-ratios beyond the clamp, clipped to a
    per-image shape in a batch."""
    rs = np.random.RandomState(1)
    rois = np.stack([_boxes(rs, 20), _boxes(rs, 20)])
    deltas = rs.randn(2, 20, 16).astype(np.float32) * 3.0  # |dw| > log(1000/16)
    shapes = np.array([[150.0, 180.0], [120.0, 90.0]], np.float32)
    means, stds = (0.0, 0.0, 0.0, 0.0), (0.1, 0.1, 0.2, 0.2)
    ref = np.asarray(jax.vmap(
        lambda r, d, s: j_box.delta2bbox(r, d, means, stds, max_shape=s)
    )(jnp.asarray(rois), jnp.asarray(deltas), jnp.asarray(shapes)))
    got = t_box.delta2bbox(_t(rois), _t(deltas), means, stds, max_shape=_t(shapes))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-4)
    clipped = t_box.clip_boxes(_t(rois[0]) * 2.0, _t(shapes[0])).numpy()
    ref_c = np.asarray(j_box.clip_boxes(jnp.asarray(rois[0]) * 2.0, jnp.asarray(shapes[0])))
    np.testing.assert_array_equal(clipped, ref_c)


def test_take_small_table_is_a_gather():
    rs = np.random.RandomState(2)
    table = rs.randn(7, 4).astype(np.float32)
    idx = rs.randint(0, 7, 50)
    ref = np.asarray(j_box.take_small_table(jnp.asarray(table), jnp.asarray(idx)))
    np.testing.assert_allclose(t_box.take_small_table(_t(table), _t(idx)).numpy(), ref,
                               rtol=1e-6)


@pytest.mark.parametrize("canvas", [(128, 160), (800, 1344)])
def test_anchor_generator_matches_jax(canvas):
    kw = dict(octave_base_scale=4, scales_per_octave=3, ratios=[0.5, 1.0, 2.0],
              strides=list(STRIDES))
    ja, ta = j_anchors.AnchorGenerator(**kw), t_anchors.AnchorGenerator(**kw)
    sizes = [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in STRIDES]
    np.testing.assert_array_equal(ta.flat_anchors(sizes), ja.flat_anchors(sizes))
    assert ta.num_base_anchors == ja.num_base_anchors


# ------------------------------------------------------------------- top-k


@pytest.mark.parametrize("k", [1, 17, 64, 200])
def test_select_topk_ties_match_lax_top_k(k):
    """Scores drawn from 9 values: most are tied, and the tie order (lower
    index first) must match ``lax.top_k`` exactly."""
    rs = np.random.RandomState(3)
    scores = rs.randint(0, 9, (3, 150)).astype(np.float32) / 8.0
    vals, idx = select_topk(_t(scores), k)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(scores), min(k, 150))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))


# --------------------------------------------------------------------- NMS


def _clustered(rs, n, n_centres=12):
    centres = _boxes(rs, n_centres)
    boxes = centres[rs.randint(0, n_centres, n)] + rs.randn(n, 4).astype(np.float32) * 3.0
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1.0)
    scores = np.round(rs.rand(n), 2).astype(np.float32)  # many ties
    return boxes, scores


@pytest.mark.parametrize("n,max_out,tile", [(300, 100, 256), (300, 600, 256),
                                            (90, 40, 32), (5, 16, 256)])
def test_nms_padded_keeps_jax_set_and_order(n, max_out, tile):
    rs = np.random.RandomState(n + max_out)
    boxes, scores = _clustered(rs, n)
    valid = rs.rand(n) > 0.1
    ref = j_nms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores), 0.5, max_out,
                           jnp.asarray(valid), tile)
    got = t_nms.nms_padded(_t(boxes), _t(scores), 0.5, max_out, _t(valid), tile)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_multiclass_nms_matches_jax():
    rs = np.random.RandomState(4)
    n, c = 64, 4
    base, _ = _clustered(rs, n)
    boxes = base[:, None, :] + rs.randn(n, c, 4).astype(np.float32)
    boxes[..., 2:] = np.maximum(boxes[..., 2:], boxes[..., :2] + 1.0)
    scores = np.round(rs.rand(n, c) * 0.5, 2).astype(np.float32)
    valid = rs.rand(n) > 0.15
    ref = j_nms.multiclass_nms_padded(
        jnp.asarray(boxes), jnp.asarray(scores), 0.05, 0.5, 50,
        valid=jnp.asarray(valid), pre_nms_top_k=128)
    got = t_nms.multiclass_nms_padded(_t(boxes), _t(scores), 0.05, 0.5, 50,
                                      valid=_t(valid), pre_nms_top_k=128)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# --------------------------------------------------------------- RoIAlign


def _pyramid(rs, b, c, canvas=(200, 264)):
    hw = [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in STRIDES]
    return [rs.randn(b, h, w, c).astype(np.float32) for h, w in hw]


def _rois(rs, b, canvas=(200, 264)):
    """Mixed RoIs: random ones on every level; elongated ones wider than the
    24-cell window on their level; big ones at the right and bottom edge
    (P7); degenerate ones; the last two per image invalid."""
    H, W = canvas
    rand = []
    for _ in range(b):
        xy = rs.uniform(0, [W - 10, H - 10], (10, 2))
        wh = rs.uniform(4, [W, H], (10, 2))
        rand.append(np.concatenate([xy, np.minimum(xy + wh, [W, H])], -1))
    special = np.array([
        [2.0, 10.0, 250.0, 22.0],          # 31 cells wide on P3
        [5.0, 3.0, 17.0, 198.0],           # 24+ cells tall on P3
        [W - 250.0, H - 190.0, W, H],      # reaches the bottom-right corner
        [0.0, 0.0, W, H],                  # whole canvas: P7 edge to edge
        [100.0, 60.0, 100.0, 60.0],        # zero size
        [30.0, 30.0, 90.0, 80.0],
    ], np.float32)
    rois = np.stack([np.concatenate([r, special]) for r in rand]).astype(np.float32)
    valid = np.ones(rois.shape[:2], bool)
    valid[:, -2:] = False
    return rois, valid


def _jax_fast(feats, rois, valid):
    fn = jax.jit(jax.vmap(
        lambda fl, rb, vb: j_roi.multilevel_roi_align_fast(fl, rb, vb, STRIDES)))
    return np.asarray(fn(tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois),
                         jnp.asarray(valid)))


@pytest.mark.parametrize("c", [32, 128])
def test_plain_roi_align_matches_jax_fast(c):
    rs = np.random.RandomState(c)
    feats = _pyramid(rs, 2, c)
    rois, valid = _rois(rs, 2)
    ref = _jax_fast(feats, rois, valid)
    got = t_roi.multilevel_roi_align_fast(
        [_t(f) for f in feats], _t(rois), _t(valid), STRIDES).numpy()
    assert got.shape == (2, rois.shape[1], 7, 7, c)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert np.all(got[:, -2:] == 0.0)


def test_roi_levels_match_jax():
    rs = np.random.RandomState(6)
    rois, _ = _rois(rs, 2)
    ref = np.asarray(j_roi.map_roi_levels(jnp.asarray(rois), 5))
    np.testing.assert_array_equal(t_roi.map_roi_levels(_t(rois), 5).numpy(), ref)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper returns the plain version and launches
    nothing; the folded interpolation matrices give the same pooling."""
    rs = np.random.RandomState(7)
    feats = [_t(f) for f in _pyramid(rs, 2, 16)]
    rois, valid = _rois(rs, 2)
    wrapper = RoIAlignForward()
    got = wrapper(feats, _t(rois), _t(valid), STRIDES)
    ref = t_roi.multilevel_roi_align_fast(feats, _t(rois), _t(valid), STRIDES)
    assert torch.equal(got, ref) and wrapper.launches == 0

    # what the kernels compute from the RoIs: each RoI's level, window and
    # pool-folded taps (``sample_taps``) applied to its level in place; the
    # window may run past the level's end only where the weights are zero
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    rf = _t(rois).reshape(-1, 4)
    taps = t_roi.sample_taps(rf, level_hw, STRIDES)
    win_w = min(24, max(w for _, w in level_hw))
    wy = t_roi.fold_pool(t_roi.taps_to_dense(taps.ky, taps.wy, 24), 7, 2)
    wx = t_roi.fold_pool(t_roi.taps_to_dense(taps.kx, taps.wx, win_w), 7, 2)
    pooled = []
    for n in range(rf.shape[0]):
        y0, x0 = int(taps.wy0[n]), int(taps.wx0[n])
        win = feats[int(taps.level[n])][n // rois.shape[1], y0:y0 + 24, x0:x0 + win_w]
        k, m = win.shape[:2]
        assert not wy[n, :, k:].any() and not wx[n, :, m:].any()
        pooled.append(torch.einsum("ik,kmc,jm->ijc", wy[n, :, :k], win, wx[n, :, :m]))
    folded = torch.stack(pooled) * _t(valid).reshape(-1)[:, None, None, None]
    np.testing.assert_allclose(folded.reshape(got.shape).numpy(), got.numpy(),
                               rtol=0, atol=1e-5)


def _boundary_rois():
    """RoIs whose sqrt(w*h) is 112, 224 or 448 px (where the level changes),
    exactly and one float32 ulp either side, at two origins."""
    out = []
    for side in (112, 224, 448):
        for v in (np.nextafter(np.float32(side), np.float32(0)), np.float32(side),
                  np.nextafter(np.float32(side), np.float32(1e9))):
            out += [[0, 0, v, v], [16, 8, np.float32(16) + v, np.float32(8) + v]]
    return np.array(out, np.float32)


@pytest.mark.parametrize("canvas", [(200, 264), (120, 100)])
def test_sample_taps_match_jax_interp_matrix(canvas):
    """The kernels' per-sample geometry (``sample_taps``, the plain mirror
    of ``csrc/roi_geometry.cuh``) against the JAX package's
    ``_batched_geometry``: levels, window origins and image rows equal; the
    taps scattered into the window equal ``_interp_matrix`` within 1e-6,
    before and after the pool fold.  Random, clamped, edge, degenerate and
    level-boundary RoIs; the second canvas is narrower than the window."""
    from boosting_rcnn_tpu.ops.pallas_roi_align import _batched_geometry

    rs = np.random.RandomState(21)
    feats = _pyramid(rs, 2, 4, canvas)
    rois, _ = _rois(rs, 2, canvas)
    rois = np.concatenate([rois, np.broadcast_to(_boundary_rois(), (2, 18, 4))], 1)
    rf = rois.reshape(-1, 4)
    level_hw = [f.shape[1:3] for f in feats]
    win_w = min(24, max(w for _, w in level_hw))
    rows_img = sum(h for h, _ in level_hw) + 24
    row0, wx0, wy, wx = _batched_geometry(feats, jnp.asarray(rf), 5, STRIDES, 56, 7, 2, 24,
                                          win_w, rows_img)
    taps = t_roi.sample_taps(_t(rf), level_hw, STRIDES)
    level = taps.level.numpy()
    np.testing.assert_array_equal(level, np.asarray(j_roi.map_roi_levels(jnp.asarray(rf), 5)))
    np.testing.assert_array_equal(taps.wx0.numpy(), np.asarray(wx0))
    row_off = np.cumsum([0] + [h for h, _ in level_hw])[level]
    img = np.arange(rf.shape[0]) // rois.shape[1]
    np.testing.assert_array_equal(taps.wy0.numpy() + row_off + img * rows_img, np.asarray(row0))
    dense_y = t_roi.taps_to_dense(taps.ky, taps.wy, 24)
    dense_x = t_roi.taps_to_dense(taps.kx, taps.wx, win_w)
    np.testing.assert_allclose(dense_y.numpy(), np.asarray(wy), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dense_x.numpy(), np.asarray(wx), rtol=0, atol=1e-6)
    pool = np.repeat(np.eye(7, dtype=np.float32), 2, axis=1) / 2
    np.testing.assert_allclose(t_roi.fold_pool(dense_y, 7, 2).numpy(),
                               np.einsum("ok,rkw->row", pool, np.asarray(wy)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_roi.fold_pool(dense_x, 7, 2).numpy(),
                               np.einsum("ok,rkw->row", pool, np.asarray(wx)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("canvas", [(200, 264), (120, 100), (600, 1000)])
def test_tile_lists_match_brute_force(canvas):
    """The gradient kernel's tile lists (the plain mirror ``tile_keys``,
    through ``tile_lists``) against a brute-force overlap list: every
    (RoI, tile) pair whose tile meets the bounding box of the RoI's nonzero
    interpolation weights (from the dense ``batched_geometry``) appears
    once, RoIs ascending within each tile; invalid RoIs, and the third
    image whose RoIs are all invalid, appear nowhere."""
    rs = np.random.RandomState(22)
    b = 3
    rois, valid = _rois(rs, b, canvas)
    rois = np.concatenate([rois, np.broadcast_to(_boundary_rois(), (b, 18, 4))], 1)
    valid = np.concatenate([valid, np.ones((b, 18), bool)], 1)
    valid[2] = False
    r = rois.shape[1]
    level_hw = [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in STRIDES]
    rf, vf = _t(rois.reshape(-1, 4)), _t(valid.reshape(-1))
    base, per_row, per_img = t_roi.tile_grid(level_hw)
    tile_rois, tile_start = t_roi.tile_lists(
        t_roi.tile_keys(rf, vf, level_hw, r, STRIDES), b * per_img)

    g = t_roi.batched_geometry(level_hw, rf, b, STRIDES)
    level = t_roi.map_roi_levels(rf, 5).numpy()
    row_off = np.cumsum([0] + [h for h, _ in level_hw])
    rows_img = row_off[-1] + 24
    expect = {t: [] for t in range(b * per_img)}
    for n in np.flatnonzero(valid.reshape(-1)):
        img, lv = n // r, level[n]
        y0 = int(g.row0[n]) - img * rows_img - row_off[lv]
        ys = y0 + np.flatnonzero(g.wy[n].numpy().any(0))
        xs = int(g.x0[n]) + np.flatnonzero(g.wx[n].numpy().any(0))
        h, w = level_hw[lv]
        for ty in range(-(-h // t_roi.TILE)):
            for tx in range(per_row[lv]):
                t0y, t0x = ty * t_roi.TILE, tx * t_roi.TILE
                if (t0y <= ys.max() and ys.min() < t0y + t_roi.TILE
                        and t0x <= xs.max() and xs.min() < t0x + t_roi.TILE):
                    expect[img * per_img + base[lv] + ty * per_row[lv] + tx].append(n)
    assert int(tile_start[-1]) == sum(len(v) for v in expect.values()) > 0
    for t, want in expect.items():
        np.testing.assert_array_equal(tile_rois[tile_start[t]:tile_start[t + 1]].numpy(), want)


def test_kernel_wrapper_rejects_other_devices():
    feats = [torch.zeros((1, 4, 4, 8), device="meta")]
    with pytest.raises(ValueError, match="cpu or cuda"):
        batched_multilevel_roi_align(feats, torch.zeros((1, 2, 4), device="meta"),
                                     torch.ones((1, 2), dtype=torch.bool, device="meta"),
                                     (8,))


def test_plain_roi_align_matches_pallas_interpret():
    """Against the TPU kernel itself (``_kernel_flat`` in interpret mode),
    C=128, B=2, a small 3-level pyramid."""
    from boosting_rcnn_tpu.ops.pallas_roi_align import (
        batched_multilevel_roi_align_pallas,
    )

    rs = np.random.RandomState(8)
    strides = (8, 16, 32)
    feats = [rs.randn(2, h, w, 128).astype(np.float32)
             for h, w in [(24, 32), (12, 16), (6, 8)]]
    cx, cy = rs.uniform(12, 230, (2, 6)), rs.uniform(12, 170, (2, 6))
    bw, bh = rs.uniform(8, 180, (2, 6)), rs.uniform(8, 150, (2, 6))
    rois = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    rois = rois.astype(np.float32)
    valid = np.ones((2, 6), bool)
    valid[:, -1] = False
    ref = np.asarray(batched_multilevel_roi_align_pallas(
        tuple(jnp.asarray(f) for f in feats), jnp.asarray(rois), jnp.asarray(valid),
        strides, interpret=True))
    got = t_roi.multilevel_roi_align_fast(
        [_t(f) for f in feats], _t(rois), _t(valid), strides).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the CUDA kernel against the plain version on the same
    CUDA tensors, atol 1e-5 (float32, different summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rs = np.random.RandomState(9)
    feats = [_t(f).cuda() for f in _pyramid(rs, 2, 96)]
    rois, valid = _rois(rs, 2)
    rois, valid = _t(rois).cuda(), _t(valid).cuda()
    wrapper = RoIAlignForward()
    got = wrapper(feats, rois, valid, STRIDES)
    ref = t_roi.multilevel_roi_align_fast(feats, rois, valid, STRIDES)
    torch.cuda.synchronize()
    assert wrapper.launches == 1
    assert (got - ref).abs().max().item() <= 1e-5


# ------------------------------------------------------- imports, devices


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port, and chip_smoke.py, import with jax, flax,
    torchvision and the JAX package made unimportable."""
    code = f"""
import importlib, importlib.util, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "torchvision", "boosting_rcnn_tpu"):
    sys.modules[name] = None
sys.path.insert(0, {REPO!r})
import boosting_rcnn_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, "boosting_rcnn_tpu_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", {os.path.join(REPO, 'chip_smoke.py')!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "boosting_rcnn_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_build_detector_needs_gpu_unless_cpu_given(monkeypatch):
    from boosting_rcnn_tpu_torch.builder import build_detector
    from boosting_rcnn_tpu_torch.config import load_config

    mc = load_config(os.path.join(
        REPO, "configs/boosting_rcnn/boosting_rcnn_r50_pafpn_1x_utdac.py")).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"].update(in_channels=[8, 16, 32, 64], out_channels=32)
    mc["rpn_head"].update(feat_channels=32, stacked_convs=1)
    mc["roi_head"]["bbox_head"]["fc_out_channels"] = 16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_detector(mc)
    det = build_detector(mc, device="cpu")
    assert det.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in det.net.parameters())
    mc["neck"].update(type="FPN", add_extra_convs="on_input")  # FPN itself is ported
    with pytest.raises(NotImplementedError, match="FPN"):
        build_detector(mc, device="cpu")
