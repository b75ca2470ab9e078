"""Drive the PyTorch port's flagship inference and training on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of the port from ``boosting_rcnn_tpu_torch/csrc``
with ``nvcc`` (sm_90a, one process per source, started together), builds
the full-width flagship Boosting R-CNN (ResNet-50 with frozen stem and
stage 1, PAFPN 256, ATSS RPN 256 x 4, Shared2FC 1024, 4 classes) with
seeded random weights, and drives three paths, each with the kernels'
launch counts set to 0 just before it and read just after:

  * predict: three requests of two 800 x 1344 images through
    ``TwoStageDetector.predict`` (RoIAlign forward kernel);
  * train: four SGD steps of ``engine.train.make_train_step`` at the
    config's batch of 4 and its learning-rate schedule, on synthetic
    images with seeded ground-truth boxes (RoIAlign forward kernel, tile-key
    kernel and gradient kernel, once per step each);
  * per image: the batch-of-one RoIAlign entry forward and backward on
    each image of the train batch.

It checks the outputs (detections finite and inside the image, repeatable;
losses finite and positive, the frozen stages bit-identical and every
other part moved), that each kernel ran on its path, that each kernel
agrees with its plain PyTorch version at the predict and train shapes and
at an odd shape with level-boundary, clamped, degenerate and invalid RoIs
(the tile lists equal to the plain mirror's; invalid RoIs add nothing to
the gradient), that the gradient is bitwise repeatable (two launches, and
two backward passes of the train path's RoIAlign), and that the tiny
flagship predicts and takes a train step on the GPU as on the CPU.  Then
it times each kernel alone and its whole call (NHWC copies, tile lists) at
both shapes, its plain version, ``predict`` and the train step.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Any failure raises and the exit
code is not 0; without a CUDA device it exits with code 2 and prints no
result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from boosting_rcnn_tpu_torch import cuda_build
from boosting_rcnn_tpu_torch.builder import build_detector
from boosting_rcnn_tpu_torch.config import load_config
from boosting_rcnn_tpu_torch.engine.train import (
    make_optimizer,
    make_train_step,
    step_lr_schedule,
)
from boosting_rcnn_tpu_torch.ops import roi_align
from boosting_rcnn_tpu_torch.ops.roi_align_kernel import (
    batched_multilevel_roi_align,
    multilevel_roi_align,
    roi_align_bwd_plain,
)

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs/boosting_rcnn/boosting_rcnn_r50_pafpn_1x_utdac.py")
CANVAS = (800, 1344)
IMG_SHAPE = (800.0, 1333.0)
BATCH = 2
REQUESTS = 3
TRAIN_BATCH = 4  # the config's samples_per_gpu
TRAIN_STEPS = 4  # step 0 warms up, steps 1-3 are timed
GT_PER_IMAGE = 8
STEPS_PER_EPOCH = 1000  # only places the decay epochs (8, 11), far beyond these steps
ATOL = 1e-5  # forward: float32, kernel and plain version sum in different orders
BWD_RTOL = 1e-5  # gradient: atol = BWD_RTOL * max|plain|; kernel and plain version sum in other orders
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, float32 outside tensor cores
KERNELS = ("roi_align_fwd", "roi_align_bwd")
STRIDES = (8, 16, 32, 64, 128)


def say(*parts) -> None:
    print(*parts, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean milliseconds of the device work of ``fn``: captured once in a
    CUDA graph and replayed ``iters`` times, so that no Python runs between
    the launches (the wrappers' host work, checks and allocations, is not
    in the figure; ``cuda_ms`` of the call has it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def counters():
    """Every kernel's launch count, by name: (wrapper, attribute)."""
    per_image = multilevel_roi_align.batched
    return {
        "roi_align_fwd": (batched_multilevel_roi_align, "launches"),
        "roi_align_bwd": (batched_multilevel_roi_align.backward, "launches"),
        "roi_tile_keys": (batched_multilevel_roi_align.backward, "tile_launches"),
        "roi_align_fwd_per_image": (per_image, "launches"),
        "roi_align_bwd_per_image": (per_image.backward, "launches"),
        "roi_tile_keys_per_image": (per_image.backward, "tile_launches"),
    }


def reset_counts() -> None:
    for wrapper, attr in counters().values():
        setattr(wrapper, attr, 0)


def read_counts():
    return {name: getattr(wrapper, attr) for name, (wrapper, attr) in counters().items()}


def requests(seed: int):
    """Seeded request batches: normalised-image-like noise, the flagship's
    padded canvas and its valid image shape."""
    rs = np.random.RandomState(seed)
    for _ in range(REQUESTS):
        yield {
            "images": torch.from_numpy(
                rs.randn(BATCH, *CANVAS, 3).astype(np.float32)).cuda(),
            "img_shape": torch.tensor([IMG_SHAPE] * BATCH).cuda(),
            "scale_factor": torch.ones((BATCH, 4)).cuda(),
        }


def train_batch(seed: int, b: int, canvas, img_shape, n_gt: int, sides=(16.0, 256.0)):
    """Seeded synthetic train batch: image noise and, per image, between
    ``n_gt // 2`` and ``n_gt`` gt boxes of UTDAC-like sides (16-256 px at
    the full canvas) inside the valid shape, labels in 0..3."""
    rs = np.random.RandomState(seed)
    h, w = img_shape
    wh = rs.uniform(*sides, (b, n_gt, 2))
    xy = rs.uniform(0, 1, (b, n_gt, 2)) * ([w, h] - wh)
    gts = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    gt_mask = np.arange(n_gt)[None, :] < rs.randint(n_gt // 2, n_gt + 1, (b, 1))
    return {
        "images": rs.randn(b, *canvas, 3).astype(np.float32),
        "gt_bboxes": np.where(gt_mask[..., None], gts, 0.0).astype(np.float32),
        "gt_labels": rs.randint(0, 4, (b, n_gt)),
        "gt_mask": gt_mask,
        "img_shape": np.array([img_shape] * b, np.float32),
    }


def check_dets(dets, labels, valid) -> int:
    if not (torch.isfinite(dets).all() and dets.shape == (BATCH, 100, 5)):
        raise AssertionError(f"bad detections: shape {tuple(dets.shape)}")
    boxes = dets[valid][:, :4]
    h, w = IMG_SHAPE
    inside = (boxes[:, 0] >= 0) & (boxes[:, 1] >= 0) & (boxes[:, 2] <= w) & (boxes[:, 3] <= h)
    if not inside.all():
        raise AssertionError("detections outside the image")
    if not ((labels[valid] >= 0) & (labels[valid] < 4)).all():
        raise AssertionError("labels outside the 4 classes")
    return int(valid.sum())


def _taps(feats, rois, valid, strides, out_size=7, sample_num=2):
    """What the RoIAlign function needs of these inputs: the pyramid cells
    that some valid RoI weights, and the operations of its two separable
    contractions counted on the nonzero taps of the pool-folded ``wy`` and
    ``wx`` only, in the cheapest of three orders (rows then columns,
    columns then rows, or all 2-D taps).  The gradient is the transpose
    and has the same taps."""
    b = rois.shape[0]
    c = feats[0].shape[-1]
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    g = roi_align.batched_geometry(level_hw, rois.reshape(-1, 4), b, strides)
    stacked_rows = sum(h for h, _ in level_hw) + roi_align.WIN
    max_w = max(w for _, w in level_hw)
    v = valid.reshape(-1)
    win_w = g.wx.shape[-1]
    wy = roi_align.fold_pool(g.wy, out_size, sample_num)[v] != 0  # (n_valid, out, WIN)
    wx = roi_align.fold_pool(g.wx, out_size, sample_num)[v] != 0  # (n_valid, out, win_w)
    used_rows = (g.wy.abs().sum(1) > 0) & v[:, None]  # (n, WIN)
    used_cols = (g.wx.abs().sum(1) > 0) & v[:, None]  # (n, win_w)
    rows = g.row0.long()[:, None] + torch.arange(roi_align.WIN, device=rois.device)
    cols = g.x0.long()[:, None] + torch.arange(win_w, device=rois.device)
    flat = rows[:, :, None] * max_w + cols[:, None, :]
    used = torch.zeros(b * stacked_rows * max_w, dtype=torch.bool, device=rois.device)
    used[flat[used_rows[:, :, None] & used_cols[:, None, :]]] = True
    nnz_y, nnz_x = wy.sum((1, 2)), wx.sum((1, 2))
    rows_y, cols_x = wy.any(1).sum(1), wx.any(1).sum(1)
    per_roi = torch.minimum(torch.minimum(rows_y * nnz_x + out_size * nnz_y,
                                          cols_x * nnz_y + out_size * nnz_x),
                            nnz_y * nnz_x)
    flops = 2 * c * int(per_roi.sum())
    return int(used.sum()), flops, int(v.sum())


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def roi_bound(feats, rois, valid, strides, out_size=7):
    """Least time of the RoIAlign forward on these inputs: the bytes it
    must move (every pyramid cell that some valid RoI weights, once; the
    RoIs; the output, once) at the HBM rate, against its float32
    operations (nonzero taps only) at the float32 rate."""
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    cells, flops, _ = _taps(feats, rois, valid, strides, out_size)
    nbytes = cells * c * 4 + rois.numel() * 4 + valid.numel() + b * r * out_size ** 2 * c * 4
    return (*_bound(nbytes, flops), nbytes, flops)


def roi_bwd_bound(feats, rois, valid, strides, out_size=7):
    """Least time of the RoIAlign feature gradient on these inputs: the
    cotangent of the valid RoIs, the RoIs and the valid mask read once and
    the dense gradient of every level written once, at the HBM rate,
    against its float32 operations (nonzero taps only)."""
    c = feats[0].shape[-1]
    _, flops, n_valid = _taps(feats, rois, valid, strides, out_size)
    level_bytes = sum(f.numel() for f in feats) * 4
    nbytes = n_valid * out_size ** 2 * c * 4 + rois.numel() * 4 + valid.numel() + level_bytes
    return (*_bound(nbytes, flops), nbytes, flops)


def flat(rois, valid):
    """The kernels' flat RoIs ``(B*R, 4)`` float32 and valid mask ``(B*R,)``
    uint8."""
    return (rois.reshape(-1, 4).float().contiguous(),
            valid.reshape(-1).to(torch.uint8).contiguous())


def kernel_vs_plain(feats, rois, valid, strides) -> float:
    """The forward kernel, through the entry point, against the plain
    forward; returns the max abs error."""
    with torch.no_grad():
        got = batched_multilevel_roi_align(feats, rois, valid, strides)
        ref = roi_align.multilevel_roi_align_fast(feats, rois, valid, strides)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not err <= ATOL or got.shape != ref.shape:
        raise AssertionError(f"RoIAlign kernel disagrees with its plain version: {err}")
    return err


def tiles_vs_plain(feats, rois, valid, strides) -> str:
    """The tile-key kernel's bitmap against the plain mirror's, equal;
    returns how many (tile, RoI) pairs it marks, and the most on one tile."""
    shapes = [tuple(f.shape) for f in feats]
    level_hw = [s[1:3] for s in shapes]
    rf, vf = flat(rois, valid)
    got = batched_multilevel_roi_align.backward.tile_lists(shapes, rf, vf, strides)
    keys = roi_align.tile_keys(rf, vf, level_hw, rois.shape[1], strides)
    ref = roi_align.tile_bitmap(keys, shapes[0][0] * roi_align.tile_grid(level_hw)[2])
    if not torch.equal(got.bitmap.long() & 0xFFFFFFFF, ref):
        raise AssertionError("the tile-key kernel's bitmap differs from the plain mirror's")
    per_tile = torch.bincount(keys[keys != roi_align.NO_TILE].long())
    return f"{int(per_tile.sum())} (tile, RoI) pairs, at most {int(per_tile.max())} on one tile"


def bwd_vs_plain(g, feats, rois, valid, strides, what: str):
    """The gradient kernels against ``roi_align_bwd_plain``, every level
    within ``BWD_RTOL`` of the largest plain value; a second launch gives
    the same bits, and a cotangent on the invalid RoIs only adds nothing.
    Returns the max abs error and the largest plain value."""
    shapes = [tuple(f.shape) for f in feats]
    rf, vf = flat(rois, valid)
    bwd = batched_multilevel_roi_align.backward
    got = bwd.launch(g, shapes, rf, vf, strides)
    again = bwd.launch(g, shapes, rf, vf, strides)
    leaked = bwd.launch(g * (vf == 0)[:, None, None, None], shapes, rf, vf, strides)
    ref = roi_align_bwd_plain(g, feats, rois, valid, strides)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"RoIAlign gradient kernel is not bitwise repeatable ({what})")
    if any(torch.count_nonzero(d).item() for d in leaked):
        raise AssertionError(f"invalid RoIs added to the level gradients ({what})")
    scale = max(r.abs().max().item() for r in ref)
    err = max((a - r).abs().max().item() for a, r in zip(got, ref))
    if not (scale > 0 and err <= BWD_RTOL * scale):
        raise AssertionError(f"RoIAlign gradient kernel disagrees with its plain version "
                             f"({what}): max abs err {err}, largest value {scale}")
    return err, scale


def odd_case(seed: int):
    """C=200 (no multiple of 32), a 600 x 1000 canvas, three images (the
    last with no valid RoI): random RoIs on every level, RoIs wider than
    the window (clamped), at the right and bottom edges, empty, reversed
    (x2 < x1), outside the image, and RoIs whose sqrt(w*h) is 112, 224 or
    448 px (the level boundaries), exactly and one float32 ulp either side."""
    rs = np.random.RandomState(seed)
    H, W = 600, 1000
    feats = [torch.from_numpy((rs.randn(3, -(-H // s), -(-W // s), 200) * 4).astype(np.float32)).cuda()
             for s in STRIDES]
    xy = rs.uniform(0, [W - 10, H - 10], (3, 31, 2))
    wh = rs.uniform(4, [W, H], (3, 31, 2))
    rand = np.concatenate([xy, np.minimum(xy + wh, [W, H])], -1)
    edge = [[W - 300, H - 200, W, H], [0, 0, W, H], [2, 10, 400, 25], [W - 40, 0, W, H],
            [0, H - 30, W, H], [5, 5, 5, 5], [50, 60, 40, 70], [W + 200, 10, W + 300, 90],
            [-100, -50, -10, -5]]
    for side in (112, 224, 448):
        for v in (np.nextafter(np.float32(side), np.float32(0)), np.float32(side),
                  np.nextafter(np.float32(side), np.float32(1e9))):
            edge += [[0, 0, v, v], [64, 32, np.float32(64) + v, np.float32(32) + v]]
    edge = np.array(edge, np.float32)
    rois = np.concatenate([rand, np.broadcast_to(edge, (3,) + edge.shape)], 1).astype(np.float32)
    valid = np.ones(rois.shape[:2], bool)
    valid[:, [3, 20, 36]] = False
    valid[2] = False
    return feats, torch.from_numpy(rois).cuda(), torch.from_numpy(valid).cuda(), STRIDES


def tiny_config():
    mc = load_config(CONFIG).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"].update(in_channels=[8, 16, 32, 64], out_channels=32)
    mc["rpn_head"].update(feat_channels=32, stacked_convs=2)
    mc["roi_head"]["bbox_head"]["fc_out_channels"] = 64
    mc["train_cfg"]["rpn_proposal"].update(nms_pre=200, max_per_img=64)
    mc["train_cfg"]["rcnn"]["sampler"]["num"] = 32
    mc["test_cfg"]["rpn"].update(nms_pre=100, max_per_img=32)
    return mc


def tiny_gpu_matches_cpu(seed: int) -> int:
    """The tiny flagship predicts on the GPU (CUDA kernel) what it predicts
    on the CPU (the plain version, held against the JAX package by the CPU
    tests): labels and validity equal, detections within 1e-3."""
    mc = tiny_config()
    rs = np.random.RandomState(seed)
    batch = {"images": rs.randn(2, 128, 160, 3).astype(np.float32),
             "img_shape": np.array([[128.0, 150.0], [116.0, 160.0]], np.float32),
             "scale_factor": np.array([[1.0] * 4, [1.25] * 4], np.float32)}
    outs = []
    for device in ("cpu", "cuda"):
        det = build_detector(mc, device=device, seed=seed)
        anchors, nla = det.anchors_for((128, 160))
        outs.append([x.cpu() for x in det.predict(batch, anchors, nla)])
    (d0, l0, v0), (d1, l1, v1) = outs
    if not (torch.equal(v0, v1) and torch.equal(l0, l1) and v0.any()):
        raise AssertionError("tiny flagship: GPU and CPU detections differ")
    err = (d0 - d1).abs().max().item()
    if err > 1e-3:
        raise AssertionError(f"tiny flagship: GPU and CPU boxes differ by {err}")
    return int(v0.sum())


def tiny_train_gpu_matches_cpu(seed: int):
    """One train step of the tiny flagship on the GPU (CUDA kernels) and on
    the CPU (plain versions, held against the JAX package by the CPU
    tests), on the same weights, batch and ``RoISample`` (drawn on the
    CPU), at a constant learning rate of 0.01: the losses and the gradient
    norm within rtol 1e-4, every updated parameter within ``1e-3 *
    max|p - p0| + 1e-7 * max|p|`` of the tensor plus ``1e-6`` of the
    largest update in the network (float32 sums in other orders; the last
    term covers tensors whose update is a near-cancelling sum, such as the
    P6 and P7 convs' biases).  The CPU backward runs on one thread (torch's threaded CPU
    convolution backward was seen to be non-repeatable)."""
    mc = tiny_config()
    batch = train_batch(seed, 2, (128, 160), (128.0, 150.0), 5, sides=(12.0, 70.0))
    dets = {d: build_detector(mc, device=d, seed=seed) for d in ("cpu", "cuda")}
    anchors, nla = dets["cpu"].anchors_for((128, 160))
    sample = dets["cpu"].train_sample(batch, anchors, nla,
                                      generator=torch.Generator().manual_seed(seed))
    dets["cuda again"] = build_detector(mc, device="cuda", seed=seed)
    p0 = {k: v.detach().clone() for k, v in dets["cpu"].net.named_parameters()}
    metrics, params = {}, {}
    threads = torch.get_num_threads()
    for device, det in dets.items():
        torch.set_num_threads(1 if device == "cpu" else threads)
        a, n = det.anchors_for((128, 160))
        step = make_train_step(det, a, n, make_optimizer(det.net.parameters(), lambda s: 0.01))
        metrics[device] = {k: float(v) for k, v in step(batch, sample).items()}
        params[device] = {k: v.detach().cpu() for k, v in det.net.named_parameters()}
    torch.set_num_threads(threads)
    for k, ref in metrics["cpu"].items():
        if not (math.isfinite(ref) and abs(metrics["cuda"][k] - ref) <= 1e-4 * abs(ref)):
            raise AssertionError(f"tiny train step: {k} GPU {metrics['cuda'][k]} CPU {ref}")
    worst, moved = 0.0, 0
    delta_max = max((ref - p0[name]).abs().max().item() for name, ref in params["cpu"].items())
    for name, ref in params["cpu"].items():
        delta = (ref - p0[name]).abs().max().item()
        moved += delta > 0
        err = (params["cuda"][name] - ref).abs().max().item()
        tol = 1e-3 * delta + 1e-7 * ref.abs().max().item() + 1e-6 * delta_max
        if err > tol:
            raise AssertionError(f"tiny train step: {name} GPU and CPU differ by {err} > {tol}")
        worst = max(worst, err / max(tol, 1e-30))
    if moved < 50:
        raise AssertionError(f"tiny train step moved only {moved} tensors")
    repeat = all(torch.equal(params["cuda"][k], params["cuda again"][k]) for k in params["cuda"])
    return metrics["cuda"], worst, repeat


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    gpu = card()
    say(gpu)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; float32 convs and "
        "matmuls with TF32 off")

    t0 = time.perf_counter()
    build_s = cuda_build.build_all(KERNELS)
    for name in KERNELS:
        log = cuda_build.build_log(name).splitlines()
        ptxas = [f"{ln.split('_kernel')[0].split('_')[-1]}: " + nxt.split('info    : ')[-1]
                 for ln, nxt in zip(log, log[3:]) if "Compiling entry function" in ln]
        spills = sorted({ln.strip().split(", ", 1)[-1] for ln in log if "spill" in ln})
        say(f"built {name} in {build_s[name]:.1f} s: {' | '.join(ptxas)}; {' | '.join(spills)}")
    say(f"nvcc builds, in parallel: {time.perf_counter() - t0:.1f} s wall")

    mc = load_config(CONFIG).model.to_dict()
    t0 = time.perf_counter()
    det = build_detector(mc, seed=0)
    n_params = sum(p.numel() for p in det.net.parameters())
    say(f"flagship built in {time.perf_counter() - t0:.1f} s: {n_params} parameters on "
        f"{det.device}")
    anchors, nla = det.anchors_for(CANVAS)
    strides = det.net.roi_strides

    # ------------------------------------------------------------ predict path
    batches = list(requests(seed=1))
    torch.cuda.synchronize()
    reset_counts()
    results = [det.predict(b, anchors, nla) for b in batches]
    torch.cuda.synchronize()
    predict_counts = read_counts()
    n_dets = [check_dets(*r) for r in results]
    say(f"predict: {REQUESTS} requests of {BATCH} images at {CANVAS[0]}x{CANVAS[1]}: "
        f"{n_dets} valid detections, launches {predict_counts}")
    if predict_counts["roi_align_fwd"] < 1:
        raise AssertionError("kernel roi_align_fwd was not launched on the predict path")
    again = det.predict(batches[0], anchors, nla)
    if not all(torch.equal(a, b) for a, b in zip(again, results[0])):
        raise AssertionError("the same request gave different detections")
    say("repeat of request 0: identical detections")

    # the forward kernel against its plain version at the predict path's shapes
    feats, boxes, scores, valid = det.proposals(
        batches[0]["images"], batches[0]["img_shape"], anchors, nla)
    err_main = kernel_vs_plain(feats, boxes, valid, strides)
    odd = odd_case(seed=2)
    err_odd = kernel_vs_plain(*odd)
    pairs = (tiles_vs_plain(feats, boxes, valid, strides), tiles_vs_plain(*odd))
    say(f"roi_align_fwd vs plain: max abs err {err_main:.3g} at B*R={boxes.shape[0] * boxes.shape[1]} "
        f"C={feats[0].shape[-1]}, {err_odd:.3g} at C=200 odd shape with level-boundary, clamped, "
        f"degenerate and invalid RoIs (atol {ATOL}); tile bitmaps equal the plain mirror's "
        f"({pairs[0]}; {pairs[1]})")
    n_tiny = tiny_gpu_matches_cpu(seed=3)
    say(f"tiny flagship: GPU predict matches CPU predict ({n_tiny} detections)")

    fwd, bwd = batched_multilevel_roi_align, batched_multilevel_roi_align.backward
    levels = [f.contiguous() for f in feats]
    shapes = [tuple(f.shape) for f in levels]
    rf, vf = flat(boxes, valid)
    with torch.inference_mode():
        kernel_ms = graph_ms(lambda: fwd.launch(levels, rf, vf, strides), 50)
        fn_ms = cuda_ms(lambda: fwd(feats, boxes, valid, strides), 20)
        plain_ms = cuda_ms(lambda: roi_align.multilevel_roi_align_fast(feats, boxes, valid, strides), 5)
    bound_ms, bound_by, nbytes, flops = roi_bound(feats, boxes, valid, strides)
    say(f"roi_align_fwd at the predict shapes ({gpu}): kernel {kernel_ms:.4f} ms, call with the "
        f"NHWC copies {fn_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by} ({nbytes} B, {flops} FLOP)")
    # the gradient kernels at the predict shapes, on a seeded cotangent
    gp = torch.from_numpy(np.random.RandomState(8).randn(
        rf.shape[0], 7, 7, feats[0].shape[-1]).astype(np.float32)).cuda()
    tiles = bwd.tile_lists(shapes, rf, vf, strides)
    bwd_p = {
        "kernel": graph_ms(lambda: bwd.launch(gp, shapes, rf, vf, strides, tiles=tiles), 50),
        "call": cuda_ms(lambda: bwd.launch(gp, shapes, rf, vf, strides), 20),
        "plain": cuda_ms(lambda: roi_align_bwd_plain(gp, feats, boxes, valid, strides), 5),
        "bound": roi_bwd_bound(feats, boxes, valid, strides)[0],
    }
    say(f"roi_align_bwd at the predict shapes ({gpu}): kernel {bwd_p['kernel']:.4f} ms, call with "
        f"the tile lists {bwd_p['call']:.4f} ms, plain {bwd_p['plain']:.4f} ms, bound "
        f"{bwd_p['bound']:.4f} ms")
    del levels, gp, tiles

    pred_ms = cuda_ms(lambda: det.predict(batches[1], anchors, nla), 5, warmup=1)
    stage = {}
    with torch.inference_mode():
        x = batches[1]
        stage["features"] = cuda_ms(lambda: det.net.features(x["images"]), 5, 1)
        fts = det.net.features(x["images"])
        stage["rpn_head"] = cuda_ms(lambda: det.net.rpn_out(fts), 5, 1)
        stage["features+rpn+proposals"] = cuda_ms(
            lambda: det.proposals(x["images"], x["img_shape"], anchors, nla), 5, 1)
        _, pb, ps, pv = det.proposals(x["images"], x["img_shape"], anchors, nla)
        stage["roi_stage"] = cuda_ms(lambda: det.roi_predict(
            fts, pb, ps, pv, x["img_shape"], x["scale_factor"]), 5, 1)
    say(f"predict: {pred_ms:.2f} ms per batch of {BATCH}, "
        f"{BATCH * 1e3 / pred_ms:.2f} images/s; stages (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage.items()))
    say(f"predict peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"wall {time.perf_counter() - t_start:.1f} s")
    del feats, boxes, scores, valid, fts, pb, ps, pv, results, again

    # -------------------------------------------------------------- train path
    cfg = load_config(CONFIG)
    opt_cfg, lr_cfg = cfg.get("optimizer"), cfg.get("lr_config")
    schedule = step_lr_schedule(opt_cfg["lr"], STEPS_PER_EPOCH, lr_cfg["step"],
                                warmup_iters=lr_cfg["warmup_iters"],
                                warmup_ratio=lr_cfg["warmup_ratio"])
    optimizer = make_optimizer(det.net.parameters(), schedule, opt_cfg["momentum"],
                               opt_cfg["weight_decay"],
                               cfg.get("optimizer_config")["grad_clip"]["max_norm"])
    step = make_train_step(det, anchors, nla, optimizer)
    tb = train_batch(4, TRAIN_BATCH, CANVAS, IMG_SHAPE, GT_PER_IMAGE)
    tb = {k: torch.as_tensor(v).cuda() for k, v in tb.items()}
    before = {k: v.detach().clone() for k, v in det.net.named_parameters()}
    # the RoIs that step 0 samples: the same weights and generator seed
    sample0 = det.train_sample(tb, anchors, nla,
                               generator=torch.Generator(device="cuda").manual_seed(5))
    gen = torch.Generator(device="cuda").manual_seed(5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step(tb, generator=gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    train_counts = read_counts()
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    for i, m in enumerate(metrics):
        say(f"train step {i}: {step_ms[i]:.1f} ms, " + ", ".join(f"{k} {v:.5g}" for k, v in m.items()))
    say(f"train: launches {train_counts}")
    for i, m in enumerate(metrics):
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"train step {i}: non-finite metrics {m}")
    if not all(metrics[0][k] > 0 for k in metrics[0] if k.startswith("loss")):
        raise AssertionError(f"train step 0: a loss is not positive: {metrics[0]}")
    for name in ("roi_align_fwd", "roi_align_bwd", "roi_tile_keys"):
        if train_counts[name] != TRAIN_STEPS:
            raise AssertionError(f"kernel {name} launched {train_counts[name]} times in "
                                 f"{TRAIN_STEPS} train steps, not once per step")
    after = dict(det.net.named_parameters())
    frozen = [k for k in before if k.startswith(("backbone.conv1.", "backbone.bn1.",
                                                 "backbone.layer1_"))]
    if not frozen or not all(torch.equal(before[k], after[k]) for k in frozen):
        raise AssertionError("a frozen parameter (stem or layer1) moved")
    parts = ("backbone.layer2_", "backbone.layer3_", "backbone.layer4_", "neck.", "rpn.",
             "bbox_head.")
    moved = {p: sum(not torch.equal(before[k], after[k]) for k in before if k.startswith(p))
             for p in parts}
    if not all(moved.values()):
        raise AssertionError(f"some part did not move in training: {moved}")
    say(f"frozen stem and layer1: {len(frozen)} tensors bit-identical; tensors moved per part: "
        f"{moved}")
    train_ms = float(np.mean(step_ms[1:]))
    say(f"train: {train_ms:.1f} ms per step of {TRAIN_BATCH} images (mean of steps 1-"
        f"{TRAIN_STEPS - 1}), {TRAIN_BATCH * 1e3 / train_ms:.2f} images/s; peak device memory "
        f"{train_peak:.2f} GiB")
    del before

    # where the step's time goes: the forward without gradient, the
    # proposals with sampling, and a step on a given sample
    def host_ms(fn, iters=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    @torch.no_grad()
    def rpn_forward():
        return det._rpn_flat(det.net.features(tb["images"]))

    rpn_outs = rpn_forward()
    parts_ms = {
        "forward (features + RPN), no gradient": host_ms(rpn_forward),
        "train proposals + sampling": host_ms(
            lambda: det.sample_from_rpn_outs(rpn_outs, tb, anchors, nla, generator=gen)),
        "step on a given sample": host_ms(
            lambda: make_train_step(det, anchors, nla, optimizer)(tb, sample0)),
    }
    del rpn_outs
    say("train step parts (ms): " + ", ".join(f"{k} {v:.1f}" for k, v in parts_ms.items()))

    # both kernels against their plain versions at the train path's shapes
    with torch.no_grad():
        feats = det.net.features(tb["images"])
    rois, rvalid = sample0.boxes, sample0.valid
    c = feats[0].shape[-1]
    rs = np.random.RandomState(6)
    n = rois.shape[0] * rois.shape[1]
    g = torch.from_numpy(rs.randn(n, 7, 7, c).astype(np.float32)).cuda()
    err_fwd_train = kernel_vs_plain(feats, rois, rvalid, strides)
    pairs_train = tiles_vs_plain(feats, rois, rvalid, strides)
    err_bwd_main = bwd_vs_plain(g, feats, rois, rvalid, strides, "train path")
    ofeats, orois, ovalid, _ = odd
    og = torch.from_numpy(rs.randn(orois.shape[0] * orois.shape[1], 7, 7, ofeats[0].shape[-1])
                          .astype(np.float32)).cuda()
    err_bwd_odd = bwd_vs_plain(og, ofeats, orois, ovalid, STRIDES, "odd shape")
    # the train path's RoIAlign, forward and backward through autograd, twice
    repeat = []
    for _ in range(2):
        lv = [f.detach().requires_grad_() for f in feats]
        batched_multilevel_roi_align(lv, rois, rvalid, strides).backward(g.reshape(*rois.shape[:2], 7, 7, c))
        repeat.append([f.grad for f in lv])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*repeat)):
        raise AssertionError("two backward passes of the train path's RoIAlign differ")
    del repeat, lv
    say(f"roi_align_fwd vs plain at B*R={n} C={c}: max abs err {err_fwd_train:.3g}; tile lists "
        f"equal the plain mirror's ({pairs_train}); roi_align_bwd vs plain: max abs err "
        f"{err_bwd_main[0]:.3g} (max|plain| {err_bwd_main[1]:.3g}, {int(rvalid.sum())} valid), "
        f"{err_bwd_odd[0]:.3g} (max|plain| {err_bwd_odd[1]:.3g}) at C={ofeats[0].shape[-1]} odd "
        f"shape (atol {BWD_RTOL} x max|plain|); invalid RoIs add nothing; two launches, and two "
        "backward passes of the train path's RoIAlign, bitwise equal")

    levels = [f.contiguous() for f in feats]
    shapes = [tuple(f.shape) for f in levels]
    rf, vf = flat(rois, rvalid)
    tiles = bwd.tile_lists(shapes, rf, vf, strides)
    bwd_kernel_ms = graph_ms(lambda: bwd.launch(g, shapes, rf, vf, strides, tiles=tiles), 50)
    no_rois = tiles._replace(bitmap=torch.zeros_like(tiles.bitmap))
    bwd_floor_ms = graph_ms(lambda: bwd.launch(g, shapes, rf, vf, strides, tiles=no_rois), 50)
    tile_ms = graph_ms(lambda: bwd.tile_lists(shapes, rf, vf, strides), 50)
    bwd_ms = cuda_ms(lambda: bwd.launch(g, shapes, rf, vf, strides), 20)
    bwd_plain_ms = cuda_ms(lambda: roi_align_bwd_plain(g, feats, rois, rvalid, strides), 5)
    bwd_bound_ms, bwd_bound_by, bwd_bytes, bwd_flops = roi_bwd_bound(feats, rois, rvalid, strides)
    say(f"roi_align_bwd at the train shapes ({gpu}): kernel {bwd_kernel_ms:.4f} ms (on an empty "
        f"bitmap, the stores alone: {bwd_floor_ms:.4f} ms), tile-key kernel with its zeroing "
        f"{tile_ms:.4f} ms (kernels by CUDA-graph replay), call "
        f"with the tile lists {bwd_ms:.4f} ms, plain {bwd_plain_ms:.4f} ms, bound "
        f"{bwd_bound_ms:.4f} ms by {bwd_bound_by} ({bwd_bytes} B, {bwd_flops} FLOP)")
    with torch.inference_mode():
        fwd_train = {
            "kernel": graph_ms(lambda: fwd.launch(levels, rf, vf, strides), 50),
            "call": cuda_ms(lambda: fwd(feats, rois, rvalid, strides), 20),
            "plain": cuda_ms(lambda: roi_align.multilevel_roi_align_fast(feats, rois, rvalid, strides), 5),
        }
    fwd_train_bound = roi_bound(feats, rois, rvalid, strides)
    say(f"roi_align_fwd at the train shapes ({gpu}): kernel {fwd_train['kernel']:.4f} ms, call "
        f"with the NHWC copies {fwd_train['call']:.4f} ms, plain {fwd_train['plain']:.4f} ms, "
        f"bound {fwd_train_bound[0]:.4f} ms by {fwd_train_bound[1]}")
    del levels, tiles

    # ---------------------------------------------------------- per-image path
    levels = [f.detach().requires_grad_() for f in feats]
    g_img = g.reshape(TRAIN_BATCH, -1, 7, 7, c)
    torch.cuda.synchronize()
    reset_counts()
    for i in range(TRAIN_BATCH):
        out = multilevel_roi_align([f[i] for f in levels], rois[i], rvalid[i], strides)
        out.backward(g_img[i])
    torch.cuda.synchronize()
    image_counts = read_counts()
    say(f"per-image path: launches {image_counts}")
    for name in ("roi_align_fwd_per_image", "roi_align_bwd_per_image", "roi_tile_keys_per_image"):
        if image_counts[name] != TRAIN_BATCH:
            raise AssertionError(f"kernel {name} launched {image_counts[name]} times for "
                                 f"{TRAIN_BATCH} images")
    feats0 = [f[0].detach().contiguous() for f in feats]
    one = [f[None] for f in feats0]
    shapes1 = [tuple(f.shape) for f in one]
    rf1, vf1 = flat(rois[:1], rvalid[:1])
    g0 = g_img[0].contiguous()
    fwd1 = multilevel_roi_align.batched
    with torch.no_grad():
        got = multilevel_roi_align(feats0, rois[0], rvalid[0], strides)
        ref = roi_align.multilevel_roi_align_fast(one, rois[:1], rvalid[:1], strides)[0]
    err_img_fwd = (got - ref).abs().max().item()
    if not err_img_fwd <= ATOL:
        raise AssertionError(f"per-image forward disagrees with its plain version: {err_img_fwd}")
    d_got = fwd1.backward.launch(g0, shapes1, rf1, vf1, strides)
    d_ref = roi_align_bwd_plain(g0, one, rois[:1], rvalid[:1], strides)
    err_img_bwd = max((a - b).abs().max().item() for a, b in zip(d_got, d_ref))
    img_scale = max(b.abs().max().item() for b in d_ref)
    if not err_img_bwd <= BWD_RTOL * img_scale:
        raise AssertionError(f"per-image gradient disagrees with its plain version: {err_img_bwd}")
    say(f"per-image entry vs plain: forward max abs err {err_img_fwd:.3g}, gradient max abs "
        f"err {err_img_bwd:.3g} (max|plain| {img_scale:.3g})")
    img_fwd_kernel_ms = graph_ms(lambda: fwd1.launch(one, rf1, vf1, strides), 50)
    with torch.inference_mode():
        img_fwd_ms = cuda_ms(lambda: multilevel_roi_align(feats0, rois[0], rvalid[0], strides), 20)
        img_fwd_plain_ms = cuda_ms(lambda: roi_align.multilevel_roi_align_fast(
            one, rois[:1], rvalid[:1], strides), 5)
    img_bwd_ms = cuda_ms(lambda: fwd1.backward.launch(g0, shapes1, rf1, vf1, strides), 20)
    img_bwd_plain_ms = cuda_ms(lambda: roi_align_bwd_plain(g0, one, rois[:1], rvalid[:1], strides), 5)
    img_fwd_bound = roi_bound(one, rois[:1], rvalid[:1], strides)
    img_bwd_bound = roi_bwd_bound(one, rois[:1], rvalid[:1], strides)
    say(f"per-image forward ({gpu}): kernel {img_fwd_kernel_ms:.4f} ms, call {img_fwd_ms:.4f} ms, "
        f"plain {img_fwd_plain_ms:.4f} ms, bound {img_fwd_bound[0]:.4f} ms by {img_fwd_bound[1]}; "
        f"per-image gradient: call with the tile lists {img_bwd_ms:.4f} ms, plain "
        f"{img_bwd_plain_ms:.4f} ms, bound {img_bwd_bound[0]:.4f} ms by {img_bwd_bound[1]}")
    del levels, out, feats

    tiny_metrics, tiny_worst, tiny_repeat = tiny_train_gpu_matches_cpu(seed=7)
    say(f"tiny flagship: a GPU train step matches the CPU one (loss {tiny_metrics['loss']:.6g}, "
        f"worst parameter error {tiny_worst:.3g} of its tolerance); two GPU steps from the same "
        f"state give the same bits: {tiny_repeat} (cuDNN's algorithms are not pinned)")
    say(f"wall {time.perf_counter() - t_start:.1f} s")

    src = "boosting_rcnn_tpu_torch/csrc/"
    tpu = "boosting_rcnn_tpu/ops/pallas_roi_align.py"
    records = [
        {"name": "roi_align_fwd", "route": "cuda", "source": src + "roi_align_fwd.cu",
         "replaces": f"{tpu}:586", "tpu_kernel": "pallas_roi_align.py:586 _kernel_flat (K1)",
         "launches": predict_counts["roi_align_fwd"] + train_counts["roi_align_fwd"],
         "launches_by_path": {"predict": predict_counts["roi_align_fwd"],
                              "train": train_counts["roi_align_fwd"]},
         "max_abs_err": max(err_main, err_odd, err_fwd_train), "ms": fn_ms,
         "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None,
         "train_shapes": {"call_ms": fwd_train["call"], "kernel_ms": fwd_train["kernel"],
                          "plain_ms": fwd_train["plain"], "bound_ms": fwd_train_bound[0]}},
        {"name": "roi_align_bwd", "route": "cuda", "source": src + "roi_align_bwd.cu",
         "replaces": f"{tpu}:244", "tpu_kernel": "pallas_roi_align.py:244 _bwd_kernel via :828 (K4)",
         "launches": train_counts["roi_align_bwd"],
         "launches_by_path": {"predict": predict_counts["roi_align_bwd"],
                              "train": train_counts["roi_align_bwd"]},
         "tile_key_launches": train_counts["roi_tile_keys"],
         "max_abs_err": max(err_bwd_main[0], err_bwd_odd[0]),
         "max_abs_plain": max(err_bwd_main[1], err_bwd_odd[1]), "bitwise_repeatable": True,
         "ms": bwd_ms, "kernel_ms": bwd_kernel_ms, "tile_key_kernel_ms": tile_ms,
         "empty_bitmap_kernel_ms": bwd_floor_ms, "plain_ms": bwd_plain_ms,
         "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by, "library_ms": None,
         "predict_shapes": {"call_ms": bwd_p["call"], "kernel_ms": bwd_p["kernel"],
                            "plain_ms": bwd_p["plain"], "bound_ms": bwd_p["bound"]}},
        {"name": "roi_align_fwd_per_image", "route": "cuda", "source": src + "roi_align_fwd.cu",
         "replaces": f"{tpu}:52", "tpu_kernel": "pallas_roi_align.py:52 _kernel via :121 (K2), B=1 of K1",
         "launches": image_counts["roi_align_fwd_per_image"],
         "max_abs_err": err_img_fwd, "ms": img_fwd_ms, "kernel_ms": img_fwd_kernel_ms,
         "plain_ms": img_fwd_plain_ms, "bound_ms": img_fwd_bound[0], "bound_by": img_fwd_bound[1],
         "library_ms": None},
        {"name": "roi_align_bwd_per_image", "route": "cuda", "source": src + "roi_align_bwd.cu",
         "replaces": f"{tpu}:244", "tpu_kernel": "pallas_roi_align.py:244 _bwd_kernel via :405 (K3), B=1 of K4",
         "launches": image_counts["roi_align_bwd_per_image"],
         "tile_key_launches": image_counts["roi_tile_keys_per_image"],
         "max_abs_err": err_img_bwd, "ms": img_bwd_ms, "plain_ms": img_bwd_plain_ms,
         "bound_ms": img_bwd_bound[0], "bound_by": img_bwd_bound[1], "library_ms": None},
    ]
    for record in records:
        timings = [v for part in (record, record.get("train_shapes", {}),
                                  record.get("predict_shapes", {}))
                   for k, v in part.items() if k.endswith("_ms") and v is not None]
        if not all(math.isfinite(v) and v > 0 for v in timings):
            raise AssertionError(f"non-finite timing in {record}")
    say(json.dumps({"kernels": records}))
    say(gpu)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
