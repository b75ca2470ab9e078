"""Drive the PyTorch port's flagship inference on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of the port from ``boosting_rcnn_tpu_torch/csrc``
with ``nvcc`` (sm_90a), builds the full-width flagship Boosting R-CNN
(ResNet-50, PAFPN 256, ATSS RPN 256 x 4, Shared2FC 1024, 4 classes) with
seeded random weights, and answers three requests of two 800 x 1344 images
through ``TwoStageDetector.predict``.  It checks the outputs (finite, boxes
inside the image, detections present, repeatable), that the RoIAlign
kernel ran on that path, that each kernel agrees with its plain PyTorch
version at the path's shapes and at an odd shape, and that the tiny
flagship predicts on the GPU what it predicts on the CPU.  Then it times
each kernel, its plain version and ``predict``.

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
from boosting_rcnn_tpu_torch.ops import roi_align
from boosting_rcnn_tpu_torch.ops.roi_align_kernel import batched_multilevel_roi_align

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs/boosting_rcnn/boosting_rcnn_r50_pafpn_1x_utdac.py")
CANVAS = (800, 1344)
IMG_SHAPE = (800.0, 1333.0)
BATCH = 2
REQUESTS = 3
ATOL = 1e-5  # float32, kernel and plain version sum in different orders
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, float32 outside tensor cores
KERNELS = ("roi_align_fwd",)


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


def roi_bound(feats, rois, valid, strides, out_size=7, sample_num=2):
    """Least time of the RoIAlign function on these inputs: the bytes it
    must move (every pyramid cell that some valid RoI weights, once; the
    RoIs; the output, once) at the HBM rate, against its float32 operations
    at the float32 rate.  Operations count only the nonzero taps of the
    pool-folded ``wy`` and ``wx`` of this run's RoIs, in the cheapest of
    three orders: rows then columns, columns then rows, or all 2-D taps."""
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    g = roi_align.batched_geometry(level_hw, rois.reshape(-1, 4), b, strides)
    stacked_rows, max_w = sum(h for h, _ in level_hw) + roi_align.WIN, max(w for _, w in level_hw)
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
    cells = int(used.sum())
    nbytes = cells * c * 4 + rois.numel() * 4 + valid.numel() + b * r * out_size ** 2 * c * 4
    nnz_y, nnz_x = wy.sum((1, 2)), wx.sum((1, 2))
    rows_y, cols_x = wy.any(1).sum(1), wx.any(1).sum(1)
    per_roi = torch.minimum(torch.minimum(rows_y * nnz_x + out_size * nnz_y,
                                          cols_x * nnz_y + out_size * nnz_x),
                            nnz_y * nnz_x)
    flops = 2 * c * int(per_roi.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def kernel_vs_plain(feats, rois, valid, strides) -> float:
    got = batched_multilevel_roi_align(feats, rois, valid, strides)
    ref = roi_align.multilevel_roi_align_fast(feats, rois, valid, strides)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    if not err <= ATOL or got.shape != ref.shape:
        raise AssertionError(f"RoIAlign kernel disagrees with its plain version: {err}")
    return err


def odd_case(seed: int):
    """C=200 (no multiple of 32), a 600 x 1000 canvas, RoIs on every level,
    wider than the window, at the right and bottom edges, invalid ones."""
    rs = np.random.RandomState(seed)
    strides = (8, 16, 32, 64, 128)
    H, W = 600, 1000
    feats = [torch.from_numpy((rs.randn(2, -(-H // s), -(-W // s), 200) * 4).astype(np.float32)).cuda()
             for s in strides]
    xy = rs.uniform(0, [W - 10, H - 10], (2, 31, 2))
    wh = rs.uniform(4, [W, H], (2, 31, 2))
    rand = np.concatenate([xy, np.minimum(xy + wh, [W, H])], -1)
    edge = np.array([[W - 300, H - 200, W, H], [0, 0, W, H], [2, 10, 400, 25],
                     [W - 40, 0, W, H], [0, H - 30, W, H], [5, 5, 5, 5]], np.float32)
    rois = np.concatenate([rand, np.broadcast_to(edge, (2, 6, 4))], 1).astype(np.float32)
    valid = np.ones((2, 37), bool)
    valid[:, [3, 20, 36]] = False
    return feats, torch.from_numpy(rois).cuda(), torch.from_numpy(valid).cuda(), strides


def tiny_gpu_matches_cpu(seed: int) -> int:
    """The tiny flagship predicts on the GPU (CUDA kernel) what it predicts
    on the CPU (the plain version, held against the JAX package by the CPU
    tests): labels and validity equal, detections within 1e-3."""
    mc = load_config(CONFIG).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"].update(in_channels=[8, 16, 32, 64], out_channels=32)
    mc["rpn_head"].update(feat_channels=32, stacked_convs=2)
    mc["roi_head"]["bbox_head"]["fc_out_channels"] = 64
    mc["test_cfg"]["rpn"].update(nms_pre=100, max_per_img=32)
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

    for name in KERNELS:
        build_s = cuda_build.build(name)
        ptxas = [ln.strip() for ln in cuda_build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        say(f"built {name} in {build_s:.1f} s: {' | '.join(ptxas[-2:])}")

    mc = load_config(CONFIG).model.to_dict()
    t0 = time.perf_counter()
    det = build_detector(mc, seed=0)
    n_params = sum(p.numel() for p in det.net.parameters())
    say(f"flagship built in {time.perf_counter() - t0:.1f} s: {n_params} parameters on "
        f"{det.device}")
    anchors, nla = det.anchors_for(CANVAS)

    batches = list(requests(seed=1))
    torch.cuda.synchronize()
    batched_multilevel_roi_align.launches = 0
    results = [det.predict(b, anchors, nla) for b in batches]
    torch.cuda.synchronize()
    launches = {"roi_align_fwd": batched_multilevel_roi_align.launches}
    n_dets = [check_dets(*r) for r in results]
    say(f"predict: {REQUESTS} requests of {BATCH} images at {CANVAS[0]}x{CANVAS[1]}: "
        f"{n_dets} valid detections, launches {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    again = det.predict(batches[0], anchors, nla)
    if not all(torch.equal(a, b) for a, b in zip(again, results[0])):
        raise AssertionError("the same request gave different detections")
    say("repeat of request 0: identical detections")

    # the kernel against its plain version at the main path's shapes
    feats, boxes, scores, valid = det.proposals(
        batches[0]["images"], batches[0]["img_shape"], anchors, nla)
    strides = det.net.roi_strides
    err_main = kernel_vs_plain(feats, boxes, valid, strides)
    odd = odd_case(seed=2)
    err_odd = kernel_vs_plain(*odd)
    say(f"roi_align_fwd vs plain: max abs err {err_main:.3g} at B*R={boxes.shape[0] * boxes.shape[1]} "
        f"C={feats[0].shape[-1]}, {err_odd:.3g} at C=200 odd shape (atol {ATOL})")
    n_tiny = tiny_gpu_matches_cpu(seed=3)
    say(f"tiny flagship: GPU predict matches CPU predict ({n_tiny} detections)")

    # timings at the main path's shapes
    level_hw = [(f.shape[1], f.shape[2]) for f in feats]
    b, r = boxes.shape[:2]
    stacked, _ = roi_align.batched_stack(feats, len(feats))
    g = roi_align.batched_geometry(level_hw, boxes.reshape(-1, 4), b, strides)
    prepared = (stacked, g.row0, g.x0, roi_align.fold_pool(g.wy, 7, 2).contiguous(),
                roi_align.fold_pool(g.wx, 7, 2).contiguous(),
                valid.reshape(-1).to(torch.uint8))
    with torch.inference_mode():
        kernel_ms = cuda_ms(lambda: batched_multilevel_roi_align.launch(*prepared), 50)
        fn_ms = cuda_ms(lambda: batched_multilevel_roi_align(feats, boxes, valid, strides), 20)
        plain_ms = cuda_ms(lambda: roi_align.multilevel_roi_align_fast(feats, boxes, valid, strides), 5)
    bound_ms, bound_by, nbytes, flops = roi_bound(feats, boxes, valid, strides)
    say(f"roi_align_fwd: kernel {kernel_ms:.4f} ms, with geometry {fn_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B, {flops} FLOP)")

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
    say(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"wall {time.perf_counter() - t_start:.1f} s")

    record = {
        "name": "roi_align_fwd",
        "route": "cuda",
        "source": "boosting_rcnn_tpu_torch/csrc/roi_align_fwd.cu",
        "replaces": "boosting_rcnn_tpu/ops/pallas_roi_align.py:586",
        "tpu_kernel": "pallas_roi_align.py:586 _kernel_flat",
        "launches": launches["roi_align_fwd"],
        "max_abs_err": max(err_main, err_odd),
        "ms": fn_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes this function
    }
    if not all(math.isfinite(record[k]) for k in ("ms", "kernel_ms", "plain_ms", "bound_ms")):
        raise AssertionError(f"non-finite timing in {record}")
    say(json.dumps({"kernels": [record]}))
    say(gpu)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
