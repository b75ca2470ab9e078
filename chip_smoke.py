"""Drive the PyTorch port's flagship and Mask R-CNN inference and training on
one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of the port from ``boosting_rcnn_tpu_torch/csrc``
with ``nvcc`` (sm_90a, one process per source, started together), builds
the full-width flagship Boosting R-CNN (ResNet-50 with frozen stem and
stage 1, PAFPN 256, ATSS RPN 256 x 4, Shared2FC 1024, 4 classes) with
seeded random weights, in float32 and again in bfloat16 (the JAX entry's
full-size compute dtype: float32 parameters, explicit casts), and in each
dtype drives three paths, each with the kernels' launch counts set to 0
just before it and read just after:

  * predict: three requests of two 800 x 1344 images through
    ``TwoStageDetector.predict`` (RoIAlign forward kernel of the dtype);
  * train: four SGD steps of ``engine.train.make_train_step`` at the
    config's batch of 4 and its learning-rate schedule, on synthetic
    images with seeded ground-truth boxes (RoIAlign forward kernel, tile-key
    kernel and gradient kernel, once per step each);
  * per image: the batch-of-one RoIAlign entry forward and backward on
    each image of the train batch.

It then builds Mask R-CNN R50-FPN at full width
(``configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py``: FPN 256, RPN 256,
Shared2FC 1024, 80 classes, a 4 x 256 conv FCN mask head with a 2x
deconvolution, 28 x 28 masks; seeded random weights) in the same two
dtypes and drives, again with the counts set to 0 before each path and
read after:

  * predict: three requests of two 800 x 1344 images (the box RoIAlign at
    7 x 7 and the mask RoIAlign at 14 x 14, once a request each), masks
    (2, 100, 28, 28) finite, in [0, 1] and repeatable;
  * train: three SGD steps at the config's batch of 2 with its learning
    rate (0.02), warmup and no gradient clip, on images with seeded gt
    boxes and a different ellipse mask per gt (every 7 x 7 and 14 x 14
    kernel and both tile-key kernels once a step), ``loss_mask`` positive,
    the mask head and the FPN moved;
  * per image: the batch-of-one entry at 14 x 14 on each train image;

and holds the 14 x 14 kernels against their plain versions at the mask
predict shapes (the detections), the train shapes (all sampled slots,
the positive ones valid) and the odd case, with the 7 x 7 kernels'
tolerances, and the 7 x 7 kernels at the box branch's shapes (the 2000
proposals of a request, the 1024 sampled slots of a step); it checks
that the level past the four route levels (P6) gets no RoIAlign
gradient.  A tiny Mask R-CNN predicts and takes a train step on the GPU
as on the CPU in both dtypes, and takes part in the repeatability check.

In each dtype it checks the outputs (detections finite and inside the
image, repeatable; losses finite and positive, the frozen stages
bit-identical and every other part moved), that each kernel of the dtype
ran on its path and no kernel of the other dtype did, that each kernel
agrees with its plain PyTorch version at the predict and train shapes and
at an odd shape with level-boundary, clamped, degenerate and invalid RoIs
(the tile lists equal to the plain mirror's; invalid RoIs add nothing to
the gradient), and that the gradient is bitwise repeatable (two launches,
and two backward passes of the train path's RoIAlign).  float32 kernels
are held within an absolute tolerance of their plain versions; bfloat16
ones (against the Pallas kernels' arithmetic), on levels and cotangents
scaled by ``c + 1`` along the channels: the forward bit-equal, the
gradient within 1 ulp of every plain value plus 1e-5 of the largest, with
at most 1% of the values not bit-equal.  Then the tiny flagship predicts
and takes a train step on the
GPU as on the CPU, in both dtypes, and the repeatability check (ROADMAP
C.2) takes two tiny train steps from one saved state on the same batch
and sample in each dtype and asserts that the losses, every gradient and
every parameter are bit-identical (cuDNN pinned by the train step; the
same steps without the pin are reported, and two more run under
``torch.use_deterministic_algorithms``, which raises on an op that has no
deterministic form).  Timings, per dtype: each kernel alone by CUDA-graph
replay and its whole call at the predict, train and per-image shapes,
its plain version and its bound (for the gradient also its tile-key
kernel and the kernel on an empty bitmap, the stores alone), the 7 x 7
kernels also at Mask R-CNN's box shapes; ``predict`` and its stages; the
train
step and its parts, a step with and without the cuDNN pin; peak device
memory; a ``torch.profiler`` view of one ``predict`` and one step; for
Mask R-CNN also its mask branch in ``predict`` and the mask branch's
forward and backward over the train step's slots.  It prints each
kernel's registers, spills and shared memory (``ptxas -v``), the forward's
launch (the built library's plan, its grid held within the blocks the card
holds at once) at the predict and train shapes of both sizes, the 14 x 14
kernel on one 16-byte vector of channels beside the tile-key kernel (its
geometry against a pass of its own), and at the train shapes the
gradient's RoIs per tile, per level.

Then the user's entry points, in float32 and again in bfloat16, on
synthetic COCO-format sets written to a temporary directory
(``data/synthetic.py``, PPM images): 24 train and 9 val images at UTDAC's
frame sizes (1920 x 1080, 720 x 405, 586 x 480; 2 portrait frames each),
and the 200 + 50 image shapes set of ``scripts/make_synthetic_coco.py``.
At full width, from ``apis.init_detector`` with seeded random weights,
``train_detector`` takes 8 steps at batch 4 (counts set to 0 before, read
after: the 7 x 7 forward and gradient kernels of the dtype ran); a run
stopped after 6 steps, inside epoch 0, writes a checkpoint that, restored
into a fresh model, gives every tensor of the model's and optimizer's
``state_dict`` and the generator's state ``torch.equal``, and
``train_detector(resume_from=)`` from it (the portrait batch on its own
canvas and anchors, then epoch 1's first) ends bit-equal to the
uninterrupted run; the test CLI's function evaluates each of the 9 val
images once (counts again: the forward kernel ran), every bbox stat
finite.  Then ``scripts/e2e_ap_check.py``'s recipe through the port's
train and test CLIs: the tiny flagship from scratch on the shapes set, 24
epochs (the epochs of the JAX script's recorded passes) at batch 8 with
the script's batch-2 learning rate and warmup scaled linearly (lr 0.01,
warmup 50), step decay at epochs 16 and 22, no validation, then the test
CLI: bbox mAP at least 0.8 (the JAX
script's threshold).  It prints train
images/s (loading included), the loader-wait share, eval images/s, peak
memory, the kernels' launches and the mAP with its wall time.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Any failure raises and the exit
code is not 0; without a CUDA device it exits with code 2 and prints no
result.
"""
from __future__ import annotations

import copy
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# cuBLAS needs a fixed workspace to run under torch.use_deterministic_algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

from boosting_rcnn_tpu_torch import cuda_build  # noqa: E402
from boosting_rcnn_tpu_torch.apis import init_detector, train_detector  # noqa: E402
from boosting_rcnn_tpu_torch.builder import build_detector  # noqa: E402
from boosting_rcnn_tpu_torch.config import load_config  # noqa: E402
from boosting_rcnn_tpu_torch.data.synthetic import generate  # noqa: E402
from boosting_rcnn_tpu_torch.engine.checkpoint import restore_checkpoint  # noqa: E402
from boosting_rcnn_tpu_torch.engine.runner import build_trainer  # noqa: E402
from boosting_rcnn_tpu_torch.engine.train import (  # noqa: E402
    make_optimizer,
    make_train_step,
    step_lr_schedule,
)
from boosting_rcnn_tpu_torch.tools.test import main as test_cli  # noqa: E402
from boosting_rcnn_tpu_torch.tools.train import main as train_cli  # noqa: E402
from boosting_rcnn_tpu_torch.ops import roi_align  # noqa: E402
from boosting_rcnn_tpu_torch.ops.roi_align_kernel import (  # noqa: E402
    batched_multilevel_roi_align,
    multilevel_roi_align,
    roi_align_bwd_plain,
)

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs/boosting_rcnn/boosting_rcnn_r50_pafpn_1x_utdac.py")
MASK_CONFIG = os.path.join(REPO, "configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py")
CANVAS = (800, 1344)
IMG_SHAPE = (800.0, 1333.0)
BATCH = 2
REQUESTS = 3
TRAIN_BATCH = 4  # the config's samples_per_gpu
TRAIN_STEPS = 4  # step 0 warms up, steps 1-3 are timed
GT_PER_IMAGE = 8
MASK_TRAIN_BATCH = 2  # the Mask R-CNN config's samples_per_gpu
MASK_TRAIN_STEPS = 3  # step 0 warms up, steps 1-2 are timed
MASK_CROP = 28  # the loader's box-relative gt mask crop (data/loader.py mask_crop_size)
STEPS_PER_EPOCH = 1000  # only places the decay epochs (8, 11), far beyond these steps
ATOL = 1e-5  # forward: float32, kernel and plain version sum in different orders
BWD_RTOL = 1e-5  # gradient: atol = BWD_RTOL * max|plain|; kernel and plain version sum in other orders
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, float32 outside tensor cores
KERNELS = ("roi_align_fwd", "roi_align_bwd")
STRIDES = (8, 16, 32, 64, 128)
BF16 = torch.bfloat16
BF16_SHARE = 0.01  # most values a bfloat16 kernel may leave not bit-equal to its plain version
# the bfloat16 stage tolerances of tests/test_torch_bf16.py, as fractions
BF16_TOL = {"levels": 0.025, "roi": 0.015, "loss": 0.015, "device_step": 0.35}


def say(*parts) -> None:
    print(*parts, flush=True)


def ptxas_report(log: str):
    """Registers, spills and static shared memory of each kernel
    instantiation in an ``nvcc -Xptxas=-v`` log, by kernel (any
    ``roi_*_kernel``: the 7 x 7 forwards (the bfloat16 one
    ``roi_align_fwd_bins``), the 14 x 14 row-item forward, the gradient,
    the tile keys), element type (float32 or bfloat16 levels; the tile-key
    kernel by its weights' rounding) and pooled size."""
    lines = log.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" not in ln:
            continue
        name = ln.split("'")[1]
        found = re.search(r"(roi_[a-z_]*?_kernel)", name)
        base = found.group(1) if found else name
        kind = ("bf16" if "bfloat16" in name or "ILb1E" in name else
                "f32" if "IfL" in name or "ILb0E" in name else "?")
        kind += " 14x14" if "Li14E" in name else " 7x7"
        regs = lines[i + 3].split("info    : ")[-1] if i + 3 < len(lines) else ""
        spill = lines[i + 2].strip() if i + 2 < len(lines) else ""
        out.append(f"{base.replace('_kernel', '')} {kind}: {regs}; {spill}")
    return out


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
    """Every kernel entry point's launch count, by name: (wrapper,
    attribute).  Names: ``roi_align_{fwd,bwd}[_bf16][_o14][_per_image]``
    and ``roi_tile_keys[_o14][_per_image]`` (``_o14``: the 14 x 14
    entries)."""
    out = {}
    for where, fwd in (("", batched_multilevel_roi_align),
                       ("_per_image", multilevel_roi_align.batched)):
        for o in ("", "_o14"):
            pre = o[1:] + "_" if o else ""
            out[f"roi_tile_keys{o}{where}"] = (fwd.backward, pre + "tile_launches")
            for dt in ("", "_bf16"):
                attr = (dt[1:] + "_" if dt else "") + pre + "launches"
                out[f"roi_align_fwd{dt}{o}{where}"] = (fwd, attr)
                out[f"roi_align_bwd{dt}{o}{where}"] = (fwd.backward, attr)
    return out


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


def train_batch(seed: int, b: int, canvas, img_shape, n_gt: int, sides=(16.0, 256.0),
                num_classes: int = 4):
    """Seeded synthetic train batch: image noise and, per image, between
    ``n_gt // 2`` and ``n_gt`` gt boxes of UTDAC-like sides (16-256 px at
    the full canvas) inside the valid shape, labels in 0..num_classes-1."""
    rs = np.random.RandomState(seed)
    h, w = img_shape
    wh = rs.uniform(*sides, (b, n_gt, 2))
    xy = rs.uniform(0, 1, (b, n_gt, 2)) * ([w, h] - wh)
    gts = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    gt_mask = np.arange(n_gt)[None, :] < rs.randint(n_gt // 2, n_gt + 1, (b, 1))
    return {
        "images": rs.randn(b, *canvas, 3).astype(np.float32),
        "gt_bboxes": np.where(gt_mask[..., None], gts, 0.0).astype(np.float32),
        "gt_labels": rs.randint(0, num_classes, (b, n_gt)),
        "gt_mask": gt_mask,
        "img_shape": np.array([img_shape] * b, np.float32),
    }


def check_dets(dets, labels, valid, num_classes: int = 4) -> int:
    if not (torch.isfinite(dets).all() and dets.shape == (BATCH, 100, 5)):
        raise AssertionError(f"bad detections: shape {tuple(dets.shape)}")
    boxes = dets[valid][:, :4]
    h, w = IMG_SHAPE
    inside = (boxes[:, 0] >= 0) & (boxes[:, 1] >= 0) & (boxes[:, 2] <= w) & (boxes[:, 3] <= h)
    if not inside.all():
        raise AssertionError("detections outside the image")
    if not ((labels[valid] >= 0) & (labels[valid] < num_classes)).all():
        raise AssertionError(f"labels outside the {num_classes} classes")
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
    g = roi_align.batched_geometry(level_hw, rois.reshape(-1, 4), b, strides,
                                   out_size=out_size, s=sample_num)
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
    must move (every pyramid cell that some valid RoI weights, once, in the
    levels' element size; the float32 RoIs; the output, once, in the
    levels' dtype) at the HBM rate, against its float32 operations (nonzero
    taps only) at the float32 rate."""
    b, r = rois.shape[:2]
    c, esize = feats[0].shape[-1], feats[0].element_size()
    cells, flops, _ = _taps(feats, rois, valid, strides, out_size)
    nbytes = (cells * c * esize + rois.numel() * 4 + valid.numel()
              + b * r * out_size ** 2 * c * esize)
    return (*_bound(nbytes, flops), nbytes, flops)


def roi_bwd_bound(feats, rois, valid, strides, out_size=7, g_esize=None):
    """Least time of the RoIAlign feature gradient on these inputs: the
    cotangent of the valid RoIs (``g_esize`` bytes an element, the levels'
    by default), the float32 RoIs and the valid mask read once and the
    dense gradient of every level written once in the levels' dtype, at the
    HBM rate, against its float32 operations (nonzero taps only)."""
    c, esize = feats[0].shape[-1], feats[0].element_size()
    _, flops, n_valid = _taps(feats, rois, valid, strides, out_size)
    level_bytes = sum(f.numel() for f in feats) * esize
    nbytes = (n_valid * out_size ** 2 * c * (g_esize or esize) + rois.numel() * 4
              + valid.numel() + level_bytes)
    return (*_bound(nbytes, flops), nbytes, flops)


def flat(rois, valid):
    """The kernels' flat RoIs ``(B*R, 4)`` float32 and valid mask ``(B*R,)``
    uint8."""
    return (rois.reshape(-1, 4).float().contiguous(),
            valid.reshape(-1).to(torch.uint8).contiguous())


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at ``|x|`` (8 significant bits)."""
    x = x.float().abs()
    _, e = torch.frexp(x)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def channel_scaled(x: torch.Tensor, dtype=BF16) -> torch.Tensor:
    """``x`` times ``c + 1`` along the channels, in ``dtype``: a lane that
    swaps two channels changes the result."""
    scale = torch.arange(1, x.shape[-1] + 1, device=x.device, dtype=torch.float32)
    return (x.float() * scale).to(dtype)


def close(got, ref, what: str, atol: float):
    """A kernel's result against its plain version: float32 within
    ``atol``; bfloat16 within 1 ulp of the plain value plus ``atol``, and at
    most ``BF16_SHARE`` of the values not bit-equal.  Returns (max abs err,
    share not bit-equal)."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} against {ref.dtype} "
                             f"{tuple(ref.shape)}")
    err = (got.float() - ref.float()).abs()
    share = (got != ref).float().mean().item()
    if got.dtype == BF16:
        past = (err - bf16_ulp(ref) - atol).max().item()
        if past > 0 or share > BF16_SHARE:
            raise AssertionError(f"{what}: max abs err {err.max().item()}, {past} past 1 ulp + "
                                 f"{atol}; {share:.4%} of the values not bit-equal")
    elif not err.max().item() <= atol:
        raise AssertionError(f"{what}: max abs err {err.max().item()} > {atol}")
    return err.max().item(), share


def kernels_vs_plain(feats, rois, valid, strides, g, dtype, what: str):
    """Both kernels in ``dtype`` against their plain versions: the forward
    through the entry point, the gradient through its wrapper on the
    cotangent ``g`` ``(B*R, k, k, C)``, at its pooled size ``k`` (7 or
    14).  float32: the forward within ``ATOL``, the gradient within
    ``BWD_RTOL`` of the largest plain value (the plain versions sum in other
    orders).  bfloat16, on levels and a cotangent scaled by ``c + 1`` along
    the channels: the forward bit-equal, the gradient within 1 ulp plus
    ``BWD_RTOL`` of the largest plain value.  In both, a second launch of
    the gradient gives the same bits and a cotangent on the invalid RoIs
    only adds nothing.  Returns {"fwd": (err, share),
    "bwd": (err, share, max|plain|)}."""
    if dtype == BF16:
        levels, g = [channel_scaled(f) for f in feats], channel_scaled(g)
    else:
        levels = list(feats)
    out = g.shape[1]
    with torch.no_grad():
        got = batched_multilevel_roi_align(levels, rois, valid, strides, out_size=out)
        ref = roi_align.multilevel_roi_align_fast(levels, rois, valid, strides, out_size=out)
    fwd = close(got, ref, f"roi_align_fwd ({dtype}, {what})", ATOL if dtype != BF16 else 0.0)
    if dtype == BF16 and not torch.equal(got, ref):
        raise AssertionError(f"roi_align_fwd ({dtype}, {what}) is not bit-equal to its plain "
                             f"version ({fwd[1]:.4%} of the values differ)")
    shapes = [tuple(f.shape) for f in levels]
    rf, vf = flat(rois, valid)
    bwd = batched_multilevel_roi_align.backward
    d_got = bwd.launch(g, shapes, rf, vf, strides)
    d_again = bwd.launch(g, shapes, rf, vf, strides)
    leaked = bwd.launch(g * (vf == 0)[:, None, None, None], shapes, rf, vf, strides)
    d_ref = roi_align_bwd_plain(g, levels, rois, valid, strides)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(d_got, d_again)):
        raise AssertionError(f"roi_align_bwd ({dtype}, {what}) is not bitwise repeatable")
    if any(torch.count_nonzero(d).item() for d in leaked):
        raise AssertionError(f"invalid RoIs added to the level gradients ({dtype}, {what})")
    scale = max(r.float().abs().max().item() for r in d_ref)
    if not scale > 0:
        raise AssertionError(f"roi_align_bwd ({dtype}, {what}): the plain gradient is zero")
    res = [close(a, r, f"roi_align_bwd ({dtype}, {what})", BWD_RTOL * scale)
           for a, r in zip(d_got, d_ref)]
    return {"fwd": fwd, "bwd": (max(e for e, _ in res), max(sh for _, sh in res), scale)}


def tiles_vs_plain(feats, rois, valid, strides, out_size: int = 7) -> str:
    """The tile-key kernel's bitmap at ``out_size`` against the plain
    mirror's, equal; returns how many (tile, RoI) pairs it marks, and the
    most on one tile."""
    shapes = [tuple(f.shape) for f in feats]
    level_hw = [s[1:3] for s in shapes]
    rf, vf = flat(rois, valid)
    got = batched_multilevel_roi_align.backward.tile_lists(shapes, rf, vf, strides,
                                                          out_size=out_size)
    keys = roi_align.tile_keys(rf, vf, level_hw, rois.shape[1], strides, out_size=out_size)
    ref = roi_align.tile_bitmap(keys, shapes[0][0] * roi_align.tile_grid(level_hw)[2])
    if not torch.equal(got.bitmap.long() & 0xFFFFFFFF, ref):
        raise AssertionError("the tile-key kernel's bitmap differs from the plain mirror's")
    per_tile = torch.bincount(keys[keys != roi_align.NO_TILE].long())
    return f"{int(per_tile.sum())} (tile, RoI) pairs, at most {int(per_tile.max())} on one tile"


def tile_spread(feats, rois, valid, strides, out_size: int = 7) -> list:
    """The RoIs on each gradient tile, per level, read off the tile-key
    kernel's bitmap: the tiles, those with any RoI, their mean and the
    largest list length (``roi_align.tile_spread``)."""
    shapes = [tuple(f.shape) for f in feats]
    rf, vf = flat(rois, valid)
    tiles = batched_multilevel_roi_align.backward.tile_lists(
        shapes, rf, vf, strides, out_size=out_size, dtype=feats[0].dtype)
    return roi_align.tile_spread(roi_align.tile_counts(tiles.bitmap),
                                 [s[1:3] for s in shapes])


def say_spread(spread: list, what: str) -> None:
    say(f"{what}: RoIs per gradient tile by level (tiles, with RoIs, mean list, largest): "
        + "; ".join(f"L{i} {x['tiles']}, {x['with_rois']}, {x['mean']:.1f}, {x['max']}"
                    for i, x in enumerate(spread)))


def fwd_launch(dtype, out_size: int, n_rois: int, c: int, what: str) -> dict:
    """The forward entry point's launch for these RoIs (the built
    library's plan), its grid held within the blocks the card holds at
    once (one block per RoI where the plan names no such bound), and
    printed."""
    grid, block, smem, per_sm = batched_multilevel_roi_align.plan(dtype, out_size, n_rois, c)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if not (1 <= grid <= sms * per_sm if per_sm else grid == n_rois):
        raise AssertionError(f"forward grid {grid} outside 1..{sms} SMs x {per_sm} blocks")
    say(f"{what}: forward launch grid {grid}, block {block}, dynamic shared memory {smem} B "
        f"({per_sm} blocks an SM, {sms} SMs; {n_rois} RoI slots, C={c})")
    return {"grid": grid, "block": block, "dynamic_smem": smem, "blocks_per_sm": per_sm}


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


def tiny_mask_config():
    """Mask R-CNN at the CPU tests' size (tests/test_torch_mask_rcnn.py):
    R18 at width 8, FPN 32, RPN 32, FC 16, mask convs 16, 4 classes."""
    mc = load_config(MASK_CONFIG).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"].update(in_channels=[8, 16, 32, 64], out_channels=32)
    mc["rpn_head"].update(in_channels=32, feat_channels=32)
    roi = mc["roi_head"]
    roi["bbox_roi_extractor"]["out_channels"] = 32
    roi["mask_roi_extractor"]["out_channels"] = 32
    roi["bbox_head"].update(in_channels=32, fc_out_channels=16, num_classes=4)
    roi["mask_head"].update(in_channels=32, conv_out_channels=16, num_classes=4)
    mc["train_cfg"]["rpn_proposal"].update(nms_pre=200, max_per_img=64)
    mc["train_cfg"]["rcnn"]["sampler"]["num"] = 32
    mc["test_cfg"]["rpn"].update(nms_pre=100, max_per_img=32)
    return mc


def tiny_train_inputs(seed: int, mc, anchors):
    """The tiny models' train batch (with gt mask crops for a mask head) and
    the step's keyword arguments: for the plain RPN, its anchor sampler's
    uniforms made with numpy, so that every device and run samples alike."""
    masks = bool(mc["roi_head"].get("mask_head"))
    batch = (mask_train_batch if masks else train_batch)(
        seed, 2, (128, 160), (128.0, 150.0), 5, sides=(12.0, 70.0), **(
            {"num_classes": 4} if masks else {}))
    kw = {}
    if mc["rpn_head"]["type"] == "RPNHead":
        kw["rpn_uniforms"] = np.random.RandomState(seed).rand(2, 2, anchors.shape[0]).astype(
            np.float32)
    return batch, kw


def tiny_mask_gpu_matches_cpu(seed: int, dtype=torch.float32):
    """The tiny Mask R-CNN predicts on the GPU (CUDA kernels at 7 and 14)
    what it predicts on the CPU (the plain versions, held against the JAX
    package by tests/test_torch_mask_rcnn.py).  float32: labels and
    validity equal, detections within 1e-3, masks within 1e-4.  bfloat16,
    at tests/test_torch_bf16.py's tolerances: the neck's levels within 2.5%
    of each level's largest value; on the CPU's levels and proposals, at
    least 90% of the kept detections matched (boxes within 0.5 px, scores
    within 0.01); on the CPU's levels and detections, the mask logits
    within 1.5% of the largest (the RoI-head tolerance).  Returns the
    errors."""
    mc = tiny_mask_config()
    rs = np.random.RandomState(seed)
    batch = {"images": rs.randn(2, 128, 160, 3).astype(np.float32),
             "img_shape": np.array([[128.0, 150.0], [116.0, 160.0]], np.float32),
             "scale_factor": np.array([[1.0] * 4, [1.25] * 4], np.float32)}
    dets = {d: build_detector(mc, device=d, seed=seed, dtype=dtype) for d in ("cpu", "cuda")}
    anchors, nla = dets["cpu"].anchors_for((128, 160))
    if dtype == torch.float32:
        outs = {d: [x.cpu() for x in det.predict(batch, anchors, nla)] for d, det in dets.items()}
        (d0, l0, v0, m0), (d1, l1, v1, m1) = outs["cpu"], outs["cuda"]
        if not (torch.equal(v0, v1) and torch.equal(l0, l1) and v0.any()):
            raise AssertionError("tiny Mask R-CNN: GPU and CPU detections differ")
        errs = ((d0 - d1).abs().max().item(), (m0 - m1).abs().max().item())
        if errs[0] > 1e-3 or errs[1] > 1e-4:
            raise AssertionError(f"tiny Mask R-CNN: GPU and CPU boxes, masks differ by {errs}")
        return {"detections": int(v0.sum()), "box_err": errs[0], "mask_err": errs[1]}
    levels = {}
    for d, det in dets.items():
        with torch.inference_mode():
            levels[d] = list(det.net.features(torch.from_numpy(batch["images"]).to(d)))
    level_errs = [rel_err(g, r) for g, r in zip(levels["cuda"], levels["cpu"])]
    if max(level_errs) > BF16_TOL["levels"]:
        raise AssertionError(f"tiny bfloat16 Mask R-CNN levels: GPU against CPU {level_errs}")
    img_shape = torch.from_numpy(batch["img_shape"])
    scale = torch.from_numpy(batch["scale_factor"])
    feats, boxes, scores, valid = dets["cpu"].proposals(batch["images"], img_shape, anchors, nla)
    outs, logits = {}, {}
    for d, det in dets.items():
        fd = [f.to(d) for f in feats]
        outs[d] = det.roi_predict(fd, boxes.to(d), scores.to(d), valid.to(d), img_shape.to(d),
                                  scale.to(d))
        dd, _, vd = (x.to(d) for x in outs["cpu"])
        with torch.inference_mode():
            logits[d] = det.net.mask_out(fd, dd[..., :4] * scale.to(d)[:, None, :], vd)
    match = matched_dets(*outs["cuda"], outs["cpu"])
    if not (match[0] >= 0.9 * match[1] > 0 and match[2] <= 0.5 and match[3] <= 0.01):
        raise AssertionError(f"tiny bfloat16 Mask R-CNN roi_predict: GPU against CPU {match}")
    mask_err = rel_err(logits["cuda"], logits["cpu"])
    if mask_err > BF16_TOL["roi"]:
        raise AssertionError(f"tiny bfloat16 Mask R-CNN mask logits: GPU against CPU {mask_err}")
    return {"level_errs": level_errs, "match": match, "mask_logit_err": mask_err}


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


def tiny_train_gpu_matches_cpu(seed: int, dtype=torch.float32, config=tiny_config):
    """One train step of the tiny flagship (or the tiny model of
    ``config``; Mask R-CNN's with its gt masks and its RPN's draws given)
    on the GPU (CUDA kernels) and on
    the CPU (plain versions, held against the JAX package by the CPU
    tests), on the same weights, batch and ``RoISample`` (drawn on the
    CPU), at a constant learning rate of 0.01.  float32: the losses and the
    gradient norm within rtol 1e-4, every updated parameter within ``1e-3 *
    max|p - p0| + 1e-7 * max|p|`` of the tensor plus ``1e-6`` of the
    largest update in the network (float32 sums in other orders; the last
    term covers tensors whose update is a near-cancelling sum, such as the
    P6 and P7 convs' biases).  bfloat16, held as tests/test_torch_bf16.py
    holds the port against JAX: the metrics within 1.5%; (a) each
    parameter within 35% of its update (a rounding that lands one ulp
    apart, cuDNN's sums against the CPU's, grows through the backward: on
    an H100 a frozen-BN scale, whose gradient sums the whole map, was seen
    24% of its update apart); (b) for at least 90% of the tensors, closer
    to the CPU's bfloat16 step than the CPU's float32 step is.  The CPU
    backward runs on one thread (torch's threaded CPU convolution backward
    was seen to be non-repeatable).  Returns the GPU's metrics, the worst
    error as a share of its tolerance, whether a second GPU run gave the
    same bits, and the median error as a share of the update."""
    rtol, step_tol = (1e-4, 1e-3) if dtype == torch.float32 else (BF16_TOL["loss"],
                                                                    BF16_TOL["device_step"])
    mc = config()
    dets = {d: build_detector(mc, device=d, seed=seed, dtype=dtype) for d in ("cpu", "cuda")}
    anchors, nla = dets["cpu"].anchors_for((128, 160))
    batch, kw = tiny_train_inputs(seed, mc, anchors)
    sample = dets["cpu"].train_sample(batch, anchors, nla,
                                      generator=torch.Generator().manual_seed(seed))
    dets["cuda again"] = build_detector(mc, device="cuda", seed=seed, dtype=dtype)
    if dtype != torch.float32:
        dets["cpu float32"] = build_detector(mc, device="cpu", seed=seed)
    p0 = {k: v.detach().clone() for k, v in dets["cpu"].net.named_parameters()}
    metrics, params = {}, {}
    threads = torch.get_num_threads()
    for device, det in dets.items():
        torch.set_num_threads(1 if device.startswith("cpu") else threads)
        a, n = det.anchors_for((128, 160))
        step = make_train_step(det, a, n, make_optimizer(det.net.parameters(), lambda s: 0.01))
        metrics[device] = {k: float(v) for k, v in step(batch, sample, **kw).items()}
        params[device] = {k: v.detach().cpu() for k, v in det.net.named_parameters()}
    torch.set_num_threads(threads)
    for k, ref in metrics["cpu"].items():
        if not (math.isfinite(ref) and abs(metrics["cuda"][k] - ref) <= rtol * abs(ref)):
            raise AssertionError(f"tiny train step: {k} GPU {metrics['cuda'][k]} CPU {ref}")
    worst, moved, rel, closer = 0.0, 0, [], 0
    delta_max = max((ref - p0[name]).abs().max().item() for name, ref in params["cpu"].items())
    for name, ref in params["cpu"].items():
        delta = (ref - p0[name]).abs().max().item()
        moved += delta > 0
        err = (params["cuda"][name] - ref).abs().max().item()
        tol = step_tol * delta + 1e-7 * ref.abs().max().item() + 1e-6 * delta_max
        if err > tol:
            raise AssertionError(f"tiny train step: {name} GPU and CPU differ by {err} > {tol}")
        worst = max(worst, err / max(tol, 1e-30))
        if delta > 0:
            rel.append(err / delta)
            if "cpu float32" in params:
                closer += err <= (params["cpu float32"][name] - ref).abs().max().item()
    if moved < 50:
        raise AssertionError(f"tiny train step moved only {moved} tensors")
    if dtype != torch.float32 and closer < 0.9 * len(rel):
        raise AssertionError(f"tiny bf16 train step: only {closer} of {len(rel)} tensors closer "
                             "to the CPU's bfloat16 step than its float32 step is")
    repeat = all(torch.equal(params["cuda"][k], params["cuda again"][k]) for k in params["cuda"])
    return metrics["cuda"], worst, repeat, float(np.median(rel))


def rel_err(got, ref) -> float:
    """max |got - ref| as a fraction of max |ref| (float32 arithmetic)."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    return (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)


def matched_dets(dets, labels, valid, ref):
    """Detections kept by both (the same label, boxes within 1 px): (matched,
    smaller kept count, max box error px, max score error)."""
    rd, rl, rv = (x.cpu() for x in ref)
    dets, labels, valid = dets.cpu(), labels.cpu(), valid.cpu()
    n_match = n_min = 0
    box_err = score_err = 0.0
    for i in range(dets.shape[0]):
        got, glab = dets[i][valid[i]], labels[i][valid[i]]
        want, wlab = rd[i][rv[i]], rl[i][rv[i]]
        n_min += min(len(got), len(want))
        for d, lab in zip(got, glab):
            if not len(want):
                break
            dist = (want[:, :4] - d[:4]).abs().max(1).values
            ok = (wlab == lab) & (dist < 1.0)
            if ok.any():
                j = int(torch.where(ok, dist, torch.inf).argmin())
                n_match += 1
                box_err = max(box_err, dist[j].item())
                score_err = max(score_err, abs(want[j, 4] - d[4]).item())
    return n_match, n_min, box_err, score_err


def tiny_bf16_gpu_matches_cpu(seed: int):
    """The tiny flagship in bfloat16 on the GPU (cuDNN, cuBLAS, the bfloat16
    kernels) against the same on the CPU (the plain versions, held against
    the JAX package's bfloat16 build by tests/test_torch_bf16.py), at that
    file's tolerances: C2-C5 and P3-P7 within 2.5% of each level's largest
    value (C2 is the stem: cuDNN's 7x7/s2 bfloat16 convolution against the
    CPU's, which equals the JAX package's space-to-depth stem bit for bit
    there); ``roi_predict`` on the CPU's levels and proposals: at least 90%
    of the kept detections matched, boxes within 0.5 px, scores within
    0.01.  Returns the levels' errors and the match."""
    mc = tiny_config()
    rs = np.random.RandomState(seed)
    batch = {"images": rs.randn(2, 128, 160, 3).astype(np.float32),
             "img_shape": np.array([[128.0, 150.0], [116.0, 160.0]], np.float32),
             "scale_factor": np.array([[1.0] * 4, [1.25] * 4], np.float32)}
    dets = {d: build_detector(mc, device=d, seed=seed, dtype=BF16) for d in ("cpu", "cuda")}
    levels = {}
    for d, det in dets.items():
        with torch.inference_mode():
            x = torch.from_numpy(batch["images"]).to(d)
            levels[d] = [c.permute(0, 2, 3, 1) for c in det.net.backbone(x.permute(0, 3, 1, 2))]
            levels[d] += list(det.net.features(x))
    errs = [rel_err(g, r) for g, r in zip(levels["cuda"], levels["cpu"])]
    if not all(levels["cuda"][i].dtype == BF16 for i in range(len(errs))) or \
            max(errs) > BF16_TOL["levels"]:
        raise AssertionError(f"tiny bfloat16 levels: GPU against CPU {errs}")
    anchors, nla = dets["cpu"].anchors_for((128, 160))
    img_shape = torch.from_numpy(batch["img_shape"])
    feats, boxes, scores, valid = dets["cpu"].proposals(batch["images"], img_shape, anchors, nla)
    outs = {}
    for d, det in dets.items():
        outs[d] = det.roi_predict([f.to(d) for f in feats], boxes.to(d), scores.to(d),
                                  valid.to(d), img_shape.to(d),
                                  torch.from_numpy(batch["scale_factor"]).to(d))
    match = matched_dets(*outs["cuda"], outs["cpu"])
    if not (match[0] >= 0.9 * match[1] > 0 and match[2] <= 0.5 and match[3] <= 0.01):
        raise AssertionError(f"tiny bfloat16 roi_predict: GPU against CPU {match}")
    return errs, match


def repeatable_step(seed: int, dtype, deterministic: bool = True, flagged: bool = False,
                    config=tiny_config):
    """Two tiny train steps (of the model of ``config``) on the GPU from one
    saved state, on the same batch, ``RoISample`` and RPN draws: whether
    the metrics, every gradient and every parameter are bit-identical, and
    how many tensors differ.  With ``flagged`` the steps run under
    ``torch.use_deterministic_algorithms``, which raises on an op that has
    no deterministic form."""
    mc = config()
    det = build_detector(mc, device="cuda", seed=seed, dtype=dtype)
    anchors, nla = det.anchors_for((128, 160))
    batch, kw = tiny_train_inputs(seed, mc, anchors)
    sample = det.train_sample(batch, anchors, nla,
                              generator=torch.Generator(device="cuda").manual_seed(seed))
    state = {k: v.clone() for k, v in det.net.state_dict().items()}
    runs = []
    torch.use_deterministic_algorithms(flagged)
    try:
        for _ in range(2):
            det.net.load_state_dict(state)
            opt = make_optimizer(det.net.parameters(), lambda s: 0.01)
            metrics = make_train_step(det, anchors, nla, opt, deterministic=deterministic)(
                batch, sample, **kw)
            runs.append({**{f"metric {k}": v for k, v in metrics.items()},
                         **{f"grad {k}": p.grad.clone() for k, p in det.net.named_parameters()
                            if p.grad is not None},
                         **{f"param {k}": p.detach().clone()
                            for k, p in det.net.named_parameters()}})
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    differ = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
    return not differ, differ, len(runs[0])


def step_timing(det, anchors, nla, tb, sample, deterministic: bool, steps: int = 3) -> float:
    """Milliseconds of a train step on a given sample (forward, losses,
    backward, clip, SGD at a small learning rate), mean of ``steps`` after
    one warm-up step."""
    opt = make_optimizer(det.net.parameters(), lambda s: 1e-5)
    step = make_train_step(det, anchors, nla, opt, deterministic=deterministic)
    step(tb, sample)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(tb, sample)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def profile(fn, what: str) -> str:
    """One call of ``fn`` under ``torch.profiler`` (CUDA activity): device
    kernel time against the wall time of the call, the largest kernels, and
    the layout kernels (NCHW <-> NHWC conversions, transposes, channel
    padding).  'not measured' when the profiler records no device time."""
    try:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = [(e.device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_time_total > 0]
    except Exception as exc:  # the profiler is untried on this machine
        return f"{what}: profile not measured ({type(exc).__name__}: {exc})"
    if not kernels:
        return f"{what}: profile not measured (no device time recorded)"
    busy = sum(r[0] for r in kernels)
    layout = [r for r in kernels if any(w in r[2].lower() for w in (
        "tonhwc", "tonchw", "transpose", "addpadding"))]
    top = sorted(kernels, reverse=True)[:8]
    return (f"{what}: device kernels {busy:.2f} ms in a {wall:.2f} ms call (idle share "
            f"{max(0.0, 1 - busy / wall):.1%}); layout kernels: "
            + (", ".join(f"{k[:60]} x{n} {ms:.3f} ms" for ms, n, k in layout) or "none")
            + "; largest: " + "; ".join(f"{k[:70]} x{n} {ms:.3f} ms" for ms, n, k in top))


def train_setup(det, anchors, nla, config: str = CONFIG, tb=None):
    """The config's optimizer and schedule on ``det`` (its gradient clip,
    or none), its train step (cuDNN pinned), the seeded train batch on the
    card (the flagship's unless ``tb`` is given) and the RoIs that step 0
    samples (the same weights and sampler seed)."""
    cfg = load_config(config)
    opt_cfg, lr_cfg = cfg.get("optimizer"), cfg.get("lr_config")
    schedule = step_lr_schedule(opt_cfg["lr"], STEPS_PER_EPOCH, lr_cfg["step"],
                                warmup_iters=lr_cfg["warmup_iters"],
                                warmup_ratio=lr_cfg["warmup_ratio"])
    clip = (cfg.get("optimizer_config") or {}).get("grad_clip")
    optimizer = make_optimizer(det.net.parameters(), schedule, opt_cfg["momentum"],
                               opt_cfg["weight_decay"], clip["max_norm"] if clip else None)
    step = make_train_step(det, anchors, nla, optimizer)
    if tb is None:
        tb = train_batch(4, TRAIN_BATCH, CANVAS, IMG_SHAPE, GT_PER_IMAGE)
    tb = {k: torch.as_tensor(v).cuda() for k, v in tb.items()}
    sample0 = det.train_sample(tb, anchors, nla,
                               generator=torch.Generator(device="cuda").manual_seed(5))
    return step, tb, sample0


def run_steps(step, tb, what: str, steps: int = TRAIN_STEPS):
    """``steps`` steps with the samplers seeded, counts reset before and
    read after; returns (metrics, ms per step, launch counts, peak GiB)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = step(tb, generator=gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, m in enumerate(metrics):
        say(f"{what} step {i}: {step_ms[i]:.1f} ms, "
            + ", ".join(f"{k} {v:.5g}" for k, v in m.items()))
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{what} step {i}: non-finite metrics {m}")
    if not all(metrics[0][k] > 0 for k in metrics[0] if k.startswith("loss")):
        raise AssertionError(f"{what} step 0: a loss is not positive: {metrics[0]}")
    return metrics, step_ms, counts, peak


def check_moved(before, det, what: str, heads=("bbox_head.",)) -> dict:
    """The frozen stem and layer1 bit-identical, every other part (the
    unfrozen stages, the neck, the RPN and ``heads``) moved."""
    after = dict(det.net.named_parameters())
    frozen = [k for k in before if k.startswith(("backbone.conv1.", "backbone.bn1.",
                                                 "backbone.layer1_"))]
    if not frozen or not all(torch.equal(before[k], after[k]) for k in frozen):
        raise AssertionError(f"{what}: a frozen parameter (stem or layer1) moved")
    parts = ("backbone.layer2_", "backbone.layer3_", "backbone.layer4_", "neck.", "rpn.",
             *heads)
    moved = {p: sum(not torch.equal(before[k], after[k]) for k in before if k.startswith(p))
             for p in parts}
    if not all(moved.values()):
        raise AssertionError(f"{what}: some part did not move in training: {moved}")
    say(f"{what}: frozen stem and layer1: {len(frozen)} tensors bit-identical; tensors moved "
        f"per part: {moved}")
    return moved


def host_ms(fn, iters: int = 3) -> float:
    """Milliseconds of ``fn`` on the host's clock, synchronised, mean of
    ``iters`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def timed_kernels(fwd, call, feats, rois, valid, strides, g, dtype) -> dict:
    """Each kernel alone by CUDA-graph replay and its whole call eagerly
    (``call()`` for the forward: checks, NHWC copies; the gradient with its
    tile lists), the plain versions, and the bounds, on these inputs in
    ``dtype`` at the cotangent ``g``'s pooled size; ``fwd`` is the forward
    wrapper, its ``backward`` the gradient's."""
    bwd = fwd.backward
    out = g.shape[1]
    levels = [f.contiguous() for f in feats]
    shapes = [tuple(f.shape) for f in levels]
    rf, vf = flat(rois, valid)
    g = g.to(dtype).contiguous()
    tiles = bwd.tile_lists(shapes, rf, vf, strides, dtype=dtype, out_size=out)
    no_rois = tiles._replace(bitmap=torch.zeros_like(tiles.bitmap))
    with torch.inference_mode():
        t_fwd = {
            "kernel": graph_ms(lambda: fwd.launch(levels, rf, vf, strides, out_size=out), 50),
            "call": cuda_ms(call, 20),
            "plain": cuda_ms(lambda: roi_align.multilevel_roi_align_fast(
                feats, rois, valid, strides, out_size=out), 5),
            "bound": roi_bound(feats, rois, valid, strides, out)}
    t_bwd = {
        "kernel": graph_ms(lambda: bwd.launch(g, shapes, rf, vf, strides, tiles=tiles), 50),
        "tile_keys": graph_ms(lambda: bwd.tile_lists(shapes, rf, vf, strides, dtype=dtype,
                                                     out_size=out), 50),
        "empty": graph_ms(lambda: bwd.launch(g, shapes, rf, vf, strides, tiles=no_rois), 50),
        "call": cuda_ms(lambda: bwd.launch(g, shapes, rf, vf, strides), 20),
        "plain": cuda_ms(lambda: roi_align_bwd_plain(g, feats, rois, valid, strides), 5),
        "bound": roi_bwd_bound(feats, rois, valid, strides, out)}
    return {"fwd": t_fwd, "bwd": t_bwd}


def say_timed(t: dict, what: str, gpu: str) -> None:
    f, b = t["fwd"], t["bwd"]
    say(f"roi_align_fwd {what} ({gpu}): kernel {f['kernel']:.4f} ms (CUDA-graph replay), call "
        f"{f['call']:.4f} ms, plain {f['plain']:.4f} ms, bound {f['bound'][0]:.4f} ms by "
        f"{f['bound'][1]} ({f['bound'][2]} B, {f['bound'][3]} FLOP)")
    say(f"roi_align_bwd {what} ({gpu}): kernel {b['kernel']:.4f} ms (on an empty bitmap, the "
        f"stores alone: {b['empty']:.4f} ms; tile-key kernel with its zeroing "
        f"{b['tile_keys']:.4f} ms), call with the tile lists {b['call']:.4f} ms, plain "
        f"{b['plain']:.4f} ms, bound {b['bound'][0]:.4f} ms by {b['bound'][1]} "
        f"({b['bound'][2]} B, {b['bound'][3]} FLOP)")


def run_paths(mc, dtype, gpu: str, odd) -> dict:
    """The full-width flagship in ``dtype`` through its predict, train and
    per-image paths, each with the launch counts set to 0 just before it
    and read just after; both kernels against their plain versions at each
    path's shapes and on the odd case; the timings.  Returns what the
    kernel records and the summary need."""
    tag = "f32" if dtype == torch.float32 else "bf16"
    sfx, other = ("", "_bf16") if dtype == torch.float32 else ("_bf16", "")
    r = {}
    t0 = time.perf_counter()
    det = build_detector(mc, seed=0, dtype=dtype)
    n_params = sum(p.numel() for p in det.net.parameters())
    say(f"{tag} flagship built in {time.perf_counter() - t0:.1f} s: {n_params} float32 "
        f"parameters on {det.device}, computing in {dtype}")
    anchors, nla = det.anchors_for(CANVAS)
    strides = det.net.roi_strides

    # ------------------------------------------------------------ predict path
    batches = list(requests(seed=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results = [det.predict(b, anchors, nla) for b in batches]
    torch.cuda.synchronize()
    r["predict_counts"] = counts = read_counts()
    r["predict_peak"] = torch.cuda.max_memory_allocated() / 2**30
    n_dets = [check_dets(*x) for x in results]
    say(f"{tag} predict: {REQUESTS} requests of {BATCH} images at {CANVAS[0]}x{CANVAS[1]}: "
        f"{n_dets} valid detections, launches {ran(counts)}")
    if counts["roi_align_fwd" + sfx] < 1 or any(v for k, v in counts.items()
                                                 if k != "roi_align_fwd" + sfx):
        raise AssertionError(f"the {tag} predict path did not run roi_align_fwd{sfx} alone")
    again = det.predict(batches[0], anchors, nla)
    if not all(torch.equal(a, b) for a, b in zip(again, results[0])):
        raise AssertionError(f"{tag}: the same request gave different detections")
    say(f"{tag} repeat of request 0: identical detections")
    feats, boxes, scores, valid = det.proposals(
        batches[0]["images"], batches[0]["img_shape"], anchors, nla)
    if feats[0].dtype != dtype:
        raise AssertionError(f"the {tag} detector's levels are {feats[0].dtype}")
    c = feats[0].shape[-1]
    rs = np.random.RandomState(8)
    gp = torch.from_numpy(rs.randn(boxes.shape[0] * boxes.shape[1], 7, 7, c)
                          .astype(np.float32)).cuda()
    r["check_predict"] = kernels_vs_plain(feats, boxes, valid, strides, gp, dtype,
                                          "predict shapes")
    ofeats, orois, ovalid, _ = odd
    og = torch.from_numpy(rs.randn(orois.shape[0] * orois.shape[1], 7, 7, ofeats[0].shape[-1])
                          .astype(np.float32)).cuda()
    r["check_odd"] = kernels_vs_plain(ofeats, orois, ovalid, STRIDES, og, dtype, "odd case")
    pairs = (tiles_vs_plain(feats, boxes, valid, strides), tiles_vs_plain(*odd))
    say(f"{tag} kernels vs plain{' (levels and cotangent x (c + 1))' if sfx else ''}: "
        f"predict shapes (B*R={boxes.shape[0] * boxes.shape[1]}, C={c}) {r['check_predict']}, "
        f"odd case (C={ofeats[0].shape[-1]}, level-boundary, clamped, degenerate and invalid "
        f"RoIs) {r['check_odd']} ((max abs err, share not bit-equal[, max|plain|]); forward atol "
        f"{ATOL if not sfx else '1 ulp'}, gradient {BWD_RTOL} x max|plain|"
        f"{' + 1 ulp' if sfx else ''}); gradient bitwise equal across two launches, invalid RoIs "
        f"add nothing; tile bitmaps equal the plain mirror's ({pairs[0]}; {pairs[1]})")
    r["predict_shapes"] = timed_kernels(
        batched_multilevel_roi_align,
        lambda: batched_multilevel_roi_align(feats, boxes, valid, strides),
        feats, boxes, valid, strides, gp, dtype)
    say_timed(r["predict_shapes"], f"{tag} at the predict shapes", gpu)
    r["fwd_launch"] = fwd_launch(dtype, 7, boxes.shape[0] * boxes.shape[1], c,
                                 f"{tag} predict shapes")
    del gp, og
    r["predict_ms"] = cuda_ms(lambda: det.predict(batches[1], anchors, nla), 5, warmup=1)
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
    r["predict_stages"] = stage
    say(f"{tag} predict ({gpu}): {r['predict_ms']:.2f} ms per batch of {BATCH}, "
        f"{BATCH * 1e3 / r['predict_ms']:.2f} images/s; stages (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage.items())
        + f"; peak device memory over the {REQUESTS} requests {r['predict_peak']:.2f} GiB")
    say(profile(lambda: det.predict(batches[1], anchors, nla), f"{tag} predict profile ({gpu})"))
    del feats, boxes, scores, valid, fts, pb, ps, pv, results, again

    # -------------------------------------------------------------- train path
    step, tb, sample0 = train_setup(det, anchors, nla)
    before = {k: v.detach().clone() for k, v in det.net.named_parameters()}
    metrics, step_ms, counts, r["train_peak"] = run_steps(step, tb, f"{tag} train")
    r["train_counts"] = counts
    say(f"{tag} train: launches {ran(counts)}")
    for name in ("roi_align_fwd" + sfx, "roi_align_bwd" + sfx, "roi_tile_keys"):
        if counts[name] != TRAIN_STEPS:
            raise AssertionError(f"kernel {name} launched {counts[name]} times in "
                                 f"{TRAIN_STEPS} {tag} train steps, not once per step")
    if counts["roi_align_fwd" + other] or counts["roi_align_bwd" + other] or any(
            v for k, v in counts.items() if "_o14" in k):
        raise AssertionError(f"a RoIAlign kernel of the other dtype or size ran on the {tag} "
                             "train path")
    check_moved(before, det, f"{tag} train")
    del before
    r["train_ms"] = float(np.mean(step_ms[1:]))
    say(f"{tag} train ({gpu}): {r['train_ms']:.1f} ms per step of {TRAIN_BATCH} images (mean "
        f"of steps 1-{TRAIN_STEPS - 1}), {TRAIN_BATCH * 1e3 / r['train_ms']:.2f} images/s; "
        f"peak device memory {r['train_peak']:.2f} GiB")

    # where the step's time goes: the forward without gradient, the
    # proposals with sampling, a step on a given sample with and without
    # the cuDNN pin
    @torch.no_grad()
    def rpn_forward():
        return det._rpn_flat(det.net.features(tb["images"]))

    rpn_outs = rpn_forward()
    gen = torch.Generator(device="cuda").manual_seed(5)
    r["train_parts"] = {
        "forward (features + RPN), no gradient": host_ms(rpn_forward),
        "train proposals + sampling": host_ms(
            lambda: det.sample_from_rpn_outs(rpn_outs, tb, anchors, nla, generator=gen)),
        "step on a given sample, cuDNN pinned": step_timing(det, anchors, nla, tb, sample0, True),
        "step on a given sample, not pinned": step_timing(det, anchors, nla, tb, sample0, False),
    }
    del rpn_outs
    say(f"{tag} train step parts ({gpu}, ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in r["train_parts"].items()))
    say(profile(lambda: step(tb, sample0), f"{tag} train step profile ({gpu})"))

    # both kernels against their plain versions at the train path's shapes
    with torch.no_grad():
        feats = det.net.features(tb["images"])
    rois, rvalid = sample0.boxes, sample0.valid
    n = rois.shape[0] * rois.shape[1]
    g = torch.from_numpy(np.random.RandomState(6).randn(n, 7, 7, c).astype(np.float32)).cuda()
    r["check_train"] = kernels_vs_plain(feats, rois, rvalid, strides, g, dtype, "train shapes")
    pairs = tiles_vs_plain(feats, rois, rvalid, strides)
    repeat = []
    for _ in range(2):  # the train path's RoIAlign, forward and backward through autograd
        lv = [f.detach().requires_grad_() for f in feats]
        batched_multilevel_roi_align(lv, rois, rvalid, strides).backward(
            g.to(dtype).reshape(*rois.shape[:2], 7, 7, c))
        repeat.append([f.grad for f in lv])
    torch.cuda.synchronize()
    if not all(a.dtype == dtype and torch.equal(a, b) for a, b in zip(*repeat)):
        raise AssertionError(f"two {tag} backward passes of the train path's RoIAlign differ")
    del repeat, lv
    say(f"{tag} kernels vs plain at the train shapes (B*R={n}, {int(rvalid.sum())} valid): "
        f"{r['check_train']}; tile lists equal the plain mirror's ({pairs}); two backward "
        f"passes of the train path's RoIAlign bitwise equal, {dtype} level gradients")
    r["train_shapes"] = timed_kernels(
        batched_multilevel_roi_align,
        lambda: batched_multilevel_roi_align(feats, rois, rvalid, strides),
        feats, rois, rvalid, strides, g, dtype)
    say_timed(r["train_shapes"], f"{tag} at the train shapes", gpu)
    r["train_spread"] = tile_spread(feats, rois, rvalid, strides)
    say_spread(r["train_spread"], f"{tag} train shapes (B*R={n})")
    r["train_fwd_launch"] = fwd_launch(dtype, 7, n, c, f"{tag} train shapes")

    # ---------------------------------------------------------- per-image path
    lv = [f.detach().requires_grad_() for f in feats]
    g_img = g.to(dtype).reshape(TRAIN_BATCH, -1, 7, 7, c)
    torch.cuda.synchronize()
    reset_counts()
    for i in range(TRAIN_BATCH):
        multilevel_roi_align([f[i] for f in lv], rois[i], rvalid[i], strides).backward(g_img[i])
    torch.cuda.synchronize()
    r["image_counts"] = counts = read_counts()
    say(f"{tag} per-image path: launches {ran(counts)}")
    for name in ("roi_align_fwd" + sfx + "_per_image", "roi_align_bwd" + sfx + "_per_image",
                 "roi_tile_keys_per_image"):
        if counts[name] != TRAIN_BATCH:
            raise AssertionError(f"kernel {name} launched {counts[name]} times for "
                                 f"{TRAIN_BATCH} {tag} images")
    one = [(channel_scaled(f[:1]) if sfx else f[:1]).contiguous() for f in feats]
    g0 = channel_scaled(g[:rois.shape[1]]) if sfx else g[:rois.shape[1]].contiguous()
    entry = multilevel_roi_align.batched
    with torch.no_grad():
        got = multilevel_roi_align([f[0] for f in one], rois[0], rvalid[0], strides)
        ref = roi_align.multilevel_roi_align_fast(one, rois[:1], rvalid[:1], strides)[0]
    r["check_image_fwd"] = close(got, ref, f"per-image forward ({tag})", ATOL if not sfx else 0.0)
    if sfx and not torch.equal(got, ref):
        raise AssertionError(f"per-image forward ({tag}) is not bit-equal to its plain version")
    rf1, vf1 = flat(rois[:1], rvalid[:1])
    d_got = entry.backward.launch(g0, [tuple(f.shape) for f in one], rf1, vf1, strides)
    d_ref = roi_align_bwd_plain(g0, one, rois[:1], rvalid[:1], strides)
    scale = max(x.float().abs().max().item() for x in d_ref)
    res = [close(a, b, f"per-image gradient ({tag})", BWD_RTOL * scale)
           for a, b in zip(d_got, d_ref)]
    r["check_image_bwd"] = (max(e for e, _ in res), max(sh for _, sh in res), scale)
    r["image"] = timed_kernels(
        entry, lambda: multilevel_roi_align([f[0] for f in one], rois[0], rvalid[0], strides),
        one, rois[:1], rvalid[:1], strides, g0, dtype)
    say(f"{tag} per-image entry vs plain: forward {r['check_image_fwd']}, gradient "
        f"{r['check_image_bwd']}")
    say_timed(r["image"], f"{tag} per image (one train image)", gpu)
    del det, lv, feats, g, g_img, one, g0
    torch.cuda.empty_cache()
    return r


def ellipses(rs, b: int, g: int, s: int = MASK_CROP) -> np.ndarray:
    """``(b, g, s, s)`` uint8 box-relative gt masks: each an ellipse of its
    own centre and radii, so that a wrong gt index changes the mask loss."""
    cy, cx = (rs.uniform(0.3, 0.7, (b, g, 1, 1)) * s for _ in range(2))
    ry, rx = (rs.uniform(0.15, 0.5, (b, g, 1, 1)) * s for _ in range(2))
    y, x = np.mgrid[:s, :s] + 0.5
    return ((((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2) <= 1.0).astype(np.uint8)


def mask_train_batch(seed: int, b: int, canvas, img_shape, n_gt: int, num_classes: int,
                     sides=(16.0, 256.0)):
    """``train_batch`` with ``num_classes`` labels and, per gt, its
    ``MASK_CROP`` x ``MASK_CROP`` mask relative to its box (``ellipses``)."""
    tb = train_batch(seed, b, canvas, img_shape, n_gt, sides, num_classes)
    tb["gt_mask_crops"] = ellipses(np.random.RandomState(seed + 1), b, n_gt)
    return tb


def check_masks(masks, n: int = 100) -> None:
    if not (masks.dtype == torch.float32 and tuple(masks.shape) == (BATCH, n, 28, 28)
            and torch.isfinite(masks).all() and masks.min() >= 0 and masks.max() <= 1):
        raise AssertionError(f"bad masks: {masks.dtype} {tuple(masks.shape)}")


def ran(counts) -> dict:
    """The entry points that launched, with their counts."""
    return {k: v for k, v in counts.items() if v}


def run_mask_paths(mc, dtype, gpu: str, odd) -> dict:
    """The full-width Mask R-CNN R50-FPN in ``dtype`` through its predict,
    train and per-image paths, each with the launch counts set to 0 just
    before it and read just after: predict runs the 7 x 7 (box) and the
    14 x 14 (mask) forward kernels once a request; a train step those and
    both gradient kernels with their tile keys once each.  The 14 x 14
    kernels against their plain versions at the predict, train and odd
    shapes; the timings.  Returns what the kernel records and the summary
    need, for the 14 x 14 kernels."""
    tag = ("f32" if dtype == torch.float32 else "bf16") + " mask_rcnn"
    sfx = "" if dtype == torch.float32 else "_bf16"
    r = {}
    t0 = time.perf_counter()
    det = build_detector(mc, seed=0, dtype=dtype)
    n_params = sum(p.numel() for p in det.net.parameters())
    say(f"{tag} built in {time.perf_counter() - t0:.1f} s: {n_params} float32 parameters on "
        f"{det.device}, computing in {dtype}; RPN {det.rpn_type}, neck "
        f"{type(det.net.neck).__name__}, mask RoIAlign {det.net.mask_roi_out_size} x "
        f"{det.net.mask_roi_out_size}")
    anchors, nla = det.anchors_for(CANVAS)
    strides = det.net.roi_strides
    nl = len(strides)
    num_classes = det.bbox_cfg.num_classes

    # ------------------------------------------------------------ predict path
    batches = list(requests(seed=21))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results = [det.predict(b, anchors, nla) for b in batches]
    torch.cuda.synchronize()
    r["predict_counts"] = counts = read_counts()
    r["predict_peak"] = torch.cuda.max_memory_allocated() / 2**30
    n_dets = [check_dets(*x[:3], num_classes=num_classes) for x in results]
    for x in results:
        check_masks(x[3])
    path = {f"roi_align_fwd{sfx}": REQUESTS, f"roi_align_fwd{sfx}_o14": REQUESTS}
    say(f"{tag} predict: {REQUESTS} requests of {BATCH} images at {CANVAS[0]}x{CANVAS[1]}: "
        f"{n_dets} valid detections, masks (2, 100, 28, 28) float32 in [0, 1]; launches "
        f"{ran(counts)}")
    if ran(counts) != path:
        raise AssertionError(f"the {tag} predict path ran {ran(counts)}, not {path}")
    again = det.predict(batches[0], anchors, nla)
    if not all(torch.equal(a, b) for a, b in zip(again, results[0])):
        raise AssertionError(f"{tag}: the same request gave different detections or masks")
    say(f"{tag} repeat of request 0: identical detections and masks")
    x = batches[0]
    feats, boxes, scores, valid = det.proposals(x["images"], x["img_shape"], anchors, nla)
    dets, labels, dvalid = det.roi_predict(feats, boxes, scores, valid, x["img_shape"],
                                           x["scale_factor"])
    mrois = (dets[..., :4] * x["scale_factor"][:, None, :]).contiguous()
    route = list(feats[:nl])
    c = feats[0].shape[-1]
    rs = np.random.RandomState(18)
    gp = torch.from_numpy(rs.randn(mrois.shape[0] * mrois.shape[1], 14, 14, c)
                          .astype(np.float32)).cuda()
    r["check_predict"] = kernels_vs_plain(route, mrois, dvalid, strides, gp, dtype,
                                          "mask predict shapes")
    ofeats, orois, ovalid, _ = odd
    og = torch.from_numpy(rs.randn(orois.shape[0] * orois.shape[1], 14, 14, ofeats[0].shape[-1])
                          .astype(np.float32)).cuda()
    r["check_odd"] = kernels_vs_plain(ofeats, orois, ovalid, STRIDES, og, dtype,
                                      "odd case at 14")
    pairs = (tiles_vs_plain(route, mrois, dvalid, strides, 14), tiles_vs_plain(*odd, 14))
    say(f"{tag} 14 x 14 kernels vs plain{' (levels and cotangent x (c + 1))' if sfx else ''}: "
        f"predict shapes ({mrois.shape[0] * mrois.shape[1]} detections, "
        f"{int(dvalid.sum())} valid, {nl} route levels, C={c}) {r['check_predict']}, odd case "
        f"{r['check_odd']}; gradient bitwise equal across two launches, invalid RoIs add "
        f"nothing; tile bitmaps equal the plain mirror's ({pairs[0]}; {pairs[1]})")
    r["predict_shapes"] = timed_kernels(
        batched_multilevel_roi_align,
        lambda: batched_multilevel_roi_align(route, mrois, dvalid, strides, out_size=14),
        route, mrois, dvalid, strides, gp, dtype)
    # the box branch's 7 x 7 kernels at its predict shapes: the proposals
    g7 = torch.from_numpy(np.random.RandomState(28).randn(
        boxes.shape[0] * boxes.shape[1], 7, 7, c).astype(np.float32)).cuda()
    r["check_box_predict"] = kernels_vs_plain(route, boxes, valid, strides, g7, dtype,
                                              "box predict shapes")
    r["box_predict"] = timed_kernels(
        batched_multilevel_roi_align,
        lambda: batched_multilevel_roi_align(route, boxes, valid, strides),
        route, boxes, valid, strides, g7, dtype)
    say(f"{tag} 7 x 7 kernels vs plain at the box predict shapes "
        f"({boxes.shape[0] * boxes.shape[1]} proposals, {int(valid.sum())} valid): "
        f"{r['check_box_predict']}")
    say_timed(r["box_predict"], f"{tag} 7 x 7 at the box predict shapes", gpu)
    del g7
    say_timed(r["predict_shapes"], f"{tag} 14 x 14 at the predict shapes", gpu)
    r["fwd_launch"] = fwd_launch(dtype, 14, mrois.shape[0] * mrois.shape[1], c,
                                 f"{tag} 14 x 14 predict shapes")
    # the geometry in the kernel against a pass of its own: the kernel on one
    # 16-byte vector of channels (the valid scan, each run's geometry and
    # the launch, next to no loads or stores) beside the tile-key kernel
    narrow = [f[..., :16 // f.element_size()] for f in route]
    rf, vf = flat(mrois, dvalid)
    r["geometry_ms"] = graph_ms(lambda: batched_multilevel_roi_align.launch(
        narrow, rf, vf, strides, out_size=14), 50)
    say(f"{tag} 14 x 14 geometry ({gpu}): the forward kernel on {narrow[0].shape[-1]} channels "
        f"{r['geometry_ms']:.4f} ms; a geometry pass, the tile-key kernel at 14 (which also "
        f"stores each Geom<14> and marks the bitmap) {r['predict_shapes']['bwd']['tile_keys']:.4f}"
        " ms")
    del gp, og, narrow
    r["predict_ms"] = cuda_ms(lambda: det.predict(batches[1], anchors, nla), 5, warmup=1)
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
        out = det.roi_predict(fts, pb, ps, pv, x["img_shape"], x["scale_factor"])
        stage["mask_branch"] = cuda_ms(lambda: det.mask_predict(fts, *out, x["scale_factor"]),
                                       5, 1)
    r["predict_stages"] = stage
    say(f"{tag} predict ({gpu}): {r['predict_ms']:.2f} ms per batch of {BATCH}, "
        f"{BATCH * 1e3 / r['predict_ms']:.2f} images/s; stages (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage.items())
        + f"; peak device memory over the {REQUESTS} requests {r['predict_peak']:.2f} GiB")
    say(profile(lambda: det.predict(batches[1], anchors, nla), f"{tag} predict profile ({gpu})"))
    del feats, boxes, scores, valid, fts, pb, ps, pv, out, results, again, dets, labels

    # -------------------------------------------------------------- train path
    tb = mask_train_batch(4, MASK_TRAIN_BATCH, CANVAS, IMG_SHAPE, GT_PER_IMAGE, num_classes)
    step, tb, sample0 = train_setup(det, anchors, nla, MASK_CONFIG, tb)
    before = {k: v.detach().clone() for k, v in det.net.named_parameters()}
    metrics, step_ms, counts, r["train_peak"] = run_steps(step, tb, f"{tag} train",
                                                          MASK_TRAIN_STEPS)
    r["train_counts"] = counts
    path = {k: MASK_TRAIN_STEPS for k in (
        f"roi_align_fwd{sfx}", f"roi_align_fwd{sfx}_o14", f"roi_align_bwd{sfx}",
        f"roi_align_bwd{sfx}_o14", "roi_tile_keys", "roi_tile_keys_o14")}
    say(f"{tag} train: launches {ran(counts)}")
    if ran(counts) != path:
        raise AssertionError(f"the {tag} train path ran {ran(counts)}, not {path}")
    if not all(m["loss_mask"] > 0 for m in metrics):
        raise AssertionError(f"{tag}: loss_mask not positive: {[m['loss_mask'] for m in metrics]}")
    check_moved(before, det, f"{tag} train", ("bbox_head.", "mask_head."))
    del before
    r["train_ms"] = float(np.mean(step_ms[1:]))
    say(f"{tag} train ({gpu}): {r['train_ms']:.1f} ms per step of {MASK_TRAIN_BATCH} images "
        f"(mean of steps 1-{MASK_TRAIN_STEPS - 1}), "
        f"{MASK_TRAIN_BATCH * 1e3 / r['train_ms']:.2f} images/s; peak device memory "
        f"{r['train_peak']:.2f} GiB")

    with torch.no_grad():
        feats = det.net.features(tb["images"])
        rpn_outs = det._rpn_flat(feats)
    rois = sample0.boxes
    mvalid = sample0.valid & sample0.is_pos
    b, n_slots = rois.shape[0], rois.shape[0] * rois.shape[1]
    lv = [f.detach().requires_grad_() for f in feats]
    cot = torch.from_numpy(np.random.RandomState(7).randn(n_slots, 28, 28, num_classes)
                           .astype(np.float32)).cuda()

    @torch.no_grad()
    def mask_forward():
        return det.net.mask_out(feats, rois, mvalid)

    def mask_forward_backward():
        det.net.mask_out(lv, rois, mvalid).backward(cot)

    gen = torch.Generator(device="cuda").manual_seed(5)
    r["train_parts"] = {
        "forward (features + RPN), no gradient": host_ms(
            torch.no_grad()(lambda: det._rpn_flat(det.net.features(tb["images"])))),
        "train proposals + sampling": host_ms(
            lambda: det.sample_from_rpn_outs(rpn_outs, tb, anchors, nla, generator=gen)),
        "step on a given sample, cuDNN pinned": step_timing(det, anchors, nla, tb, sample0, True),
        f"mask branch forward ({n_slots} slots), no gradient": host_ms(mask_forward),
        "mask branch forward + backward": host_ms(mask_forward_backward),
    }
    det.net.zero_grad(set_to_none=True)
    say(f"{tag} train step parts ({gpu}, ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in r["train_parts"].items()))
    say(profile(lambda: step(tb, sample0), f"{tag} train step profile ({gpu})"))
    del rpn_outs, cot, lv

    # the 14 x 14 kernels against their plain versions at the train shapes
    route = list(feats[:nl])
    g = torch.from_numpy(np.random.RandomState(6).randn(n_slots, 14, 14, c)
                         .astype(np.float32)).cuda()
    r["check_train"] = kernels_vs_plain(route, rois, mvalid, strides, g, dtype,
                                        "mask train shapes")
    pairs = tiles_vs_plain(route, rois, mvalid, strides, 14)
    repeat = []
    for _ in range(2):  # through autograd, on all five levels: P6 is no route level
        lv = [f.detach().requires_grad_() for f in feats]
        batched_multilevel_roi_align(lv, rois, mvalid, strides, out_size=14,
                                     num_route_levels=nl).backward(
            g.to(dtype).reshape(b, -1, 14, 14, c))
        if any(f.grad is not None for f in lv[nl:]):
            raise AssertionError(f"{tag}: a level past the route levels got a RoIAlign gradient")
        repeat.append([f.grad for f in lv[:nl]])
    torch.cuda.synchronize()
    if not all(a.dtype == dtype and torch.equal(a, b_) for a, b_ in zip(*repeat)):
        raise AssertionError(f"two {tag} backward passes of the mask RoIAlign differ")
    del repeat, lv
    say(f"{tag} 14 x 14 kernels vs plain at the train shapes ({n_slots} slots, "
        f"{int(mvalid.sum())} positive and valid): {r['check_train']}; tile lists equal the "
        f"plain mirror's ({pairs}); two backward passes through autograd bitwise equal, "
        f"{dtype} gradients of the {nl} route levels and none of P6")
    r["train_shapes"] = timed_kernels(
        batched_multilevel_roi_align,
        lambda: batched_multilevel_roi_align(route, rois, mvalid, strides, out_size=14),
        route, rois, mvalid, strides, g, dtype)
    say_timed(r["train_shapes"], f"{tag} 14 x 14 at the train shapes", gpu)
    r["train_spread"] = tile_spread(route, rois, mvalid, strides, 14)
    say_spread(r["train_spread"], f"{tag} 14 x 14 train shapes ({n_slots} slots)")
    r["train_fwd_launch"] = fwd_launch(dtype, 14, n_slots, c, f"{tag} 14 x 14 train shapes")
    # the box branch's 7 x 7 kernels at its train shapes: every sampled slot
    g7 = torch.from_numpy(np.random.RandomState(29).randn(n_slots, 7, 7, c)
                          .astype(np.float32)).cuda()
    r["check_box_train"] = kernels_vs_plain(route, rois, sample0.valid, strides, g7, dtype,
                                            "box train shapes")
    r["box_train"] = timed_kernels(
        batched_multilevel_roi_align,
        lambda: batched_multilevel_roi_align(route, rois, sample0.valid, strides),
        route, rois, sample0.valid, strides, g7, dtype)
    say(f"{tag} 7 x 7 kernels vs plain at the box train shapes ({n_slots} slots, "
        f"{int(sample0.valid.sum())} valid): {r['check_box_train']}")
    say_timed(r["box_train"], f"{tag} 7 x 7 at the box train shapes", gpu)
    del g7

    # ---------------------------------------------------- per-image path at 14
    lv = [f.detach().requires_grad_() for f in route]
    g_img = g.to(dtype).reshape(b, -1, 14, 14, c)
    torch.cuda.synchronize()
    reset_counts()
    for i in range(b):
        multilevel_roi_align([f[i] for f in lv], rois[i], mvalid[i], strides,
                             out_size=14).backward(g_img[i])
    torch.cuda.synchronize()
    r["image_counts"] = counts = read_counts()
    path = {k + "_per_image": b for k in (f"roi_align_fwd{sfx}_o14", f"roi_align_bwd{sfx}_o14",
                                          "roi_tile_keys_o14")}
    say(f"{tag} per-image path at 14: launches {ran(counts)}")
    if ran(counts) != path:
        raise AssertionError(f"the {tag} per-image path ran {ran(counts)}, not {path}")
    one = [(channel_scaled(f[:1]) if sfx else f[:1]).contiguous() for f in route]
    g0 = channel_scaled(g[:rois.shape[1]]) if sfx else g[:rois.shape[1]].contiguous()
    entry = multilevel_roi_align.batched
    with torch.no_grad():
        got = multilevel_roi_align([f[0] for f in one], rois[0], mvalid[0], strides, out_size=14)
        ref = roi_align.multilevel_roi_align_fast(one, rois[:1], mvalid[:1], strides,
                                                  out_size=14)[0]
    r["check_image_fwd"] = close(got, ref, f"per-image forward at 14 ({tag})",
                                 ATOL if not sfx else 0.0)
    if sfx and not torch.equal(got, ref):
        raise AssertionError(f"per-image forward at 14 ({tag}) is not bit-equal to its plain "
                             "version")
    rf1, vf1 = flat(rois[:1], mvalid[:1])
    d_got = entry.backward.launch(g0, [tuple(f.shape) for f in one], rf1, vf1, strides)
    d_ref = roi_align_bwd_plain(g0, one, rois[:1], mvalid[:1], strides)
    scale = max(v.float().abs().max().item() for v in d_ref)
    res = [close(a, v, f"per-image gradient at 14 ({tag})", BWD_RTOL * scale)
           for a, v in zip(d_got, d_ref)]
    r["check_image_bwd"] = (max(e for e, _ in res), max(sh for _, sh in res), scale)
    r["image"] = timed_kernels(
        entry, lambda: multilevel_roi_align([f[0] for f in one], rois[0], mvalid[0], strides,
                                            out_size=14),
        one, rois[:1], mvalid[:1], strides, g0, dtype)
    say(f"{tag} per-image entry at 14 vs plain: forward {r['check_image_fwd']}, gradient "
        f"{r['check_image_bwd']}")
    say_timed(r["image"], f"{tag} 14 x 14 per image (one train image)", gpu)
    del det, lv, feats, route, g, g_img, one, g0
    torch.cuda.empty_cache()
    return r


# ------------------------------------------------------------ entry points
UTDAC_FRAMES = ((1920, 1080), (720, 405), (586, 480))  # UTDAC2020's frame sizes
# full-width train_detector steps before the checkpoint: one short of the
# epoch's 7 batches (6 landscape, then the portrait one), so that the resumed
# run takes the portrait batch, then epoch 1's first
ENTRY_STEPS = 6
# scripts/e2e_ap_check.py's recipe at the epochs of its recorded passes
# (docs/TRAIN_PERF.md: 24, decay at 16 and 22; at its default of 8 the JAX
# package itself ends below the threshold on the CPU), at batch 8 with its
# learning rate and warmup scaled linearly from batch 2 (lr 0.0025, 200
# iterations): a quarter of the host-bound steps
E2E_EPOCHS = 24
E2E_BATCH = 8
E2E_LR = 0.0025 * E2E_BATCH / 2
E2E_WARMUP = 200 * 2 // E2E_BATCH
E2E_MIN_MAP = 0.8  # scripts/e2e_ap_check.py's threshold


def data_options(root: str, dtype, **more) -> dict:
    """``--cfg-options`` pointing the flagship config's splits at the
    synthetic set under ``root`` (val doubles as test), random backbone
    weights, the compute dtype."""
    opts = {f"data.{split}.{key}": f"{root}/{name}{ext}"
            for split, name in (("train", "train"), ("val", "val"), ("test", "val"))
            for key, ext in (("ann_file", ".json"), ("img_prefix", ""))}
    opts.update({"model.backbone.init_cfg": "None",
                 "compute_dtype": "float32" if dtype == torch.float32 else "bfloat16"})
    opts.update({k: str(v) for k, v in more.items()})
    return opts


def cli_options(opts: dict) -> list:
    return ["--cfg-options", *[f"{k}={v}" for k, v in opts.items()]]


def trainer_state(trainer) -> dict:
    """A copy of what a checkpoint holds: the model's and the optimizer's
    ``state_dict`` and the sampler generator's state."""
    return copy.deepcopy({"model": trainer.detector.net.state_dict(),
                          "optimizer": trainer.optimizer.state_dict(),
                          "generator": trainer.generator.get_state()})


def differing(a, b, path: str = "") -> list:
    """Where two nested states differ (tensors by ``torch.equal``)."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return [f"{path} keys"]
        return [d for k in a for d in differing(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in differing(x, y, f"{path}/{i}")]
    if torch.is_tensor(a):
        return [] if torch.equal(a, b) else [path]
    return [] if a == b else [path]


def entry_points(dtype, gpu: str, utdac: str, work: str) -> dict:
    """The user's entry points at full width in ``dtype``, from
    ``init_detector`` with seeded random weights at the config's batch of 4
    on the UTDAC-sized set: ``train_detector`` for ENTRY_STEPS + 2 steps (the
    counts set to 0 before, read after); the same for ENTRY_STEPS steps,
    stopped inside epoch 0, its checkpoint restored into a fresh model
    (every tensor of the state ``torch.equal``) and resumed through
    ``train_detector(resume_from=)`` for the 2 steps left (the portrait
    batch on its own canvas and anchors, then epoch 1's first): it ends
    bit-equal to the uninterrupted run; then the test CLI's function over
    the 9 val images (counts again)."""
    tag = "f32" if dtype == torch.float32 else "bf16"
    cfg = load_config(CONFIG)
    cfg.merge_from_options(data_options(utdac, dtype))
    steps = ENTRY_STEPS + 2
    handle = init_detector(cfg, device="cuda", seed=21)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    summary = train_detector(handle, os.path.join(work, f"whole_{tag}"), max_iters=steps,
                             validate=False)
    train_counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if summary["steps"] != steps or summary["images"] != steps * TRAIN_BATCH:
        raise AssertionError(f"{tag} entry train: {summary['steps']} steps, "
                             f"{summary['images']} images")
    loss = summary["last_metrics"]["loss"]
    if not math.isfinite(loss):
        raise AssertionError(f"{tag} entry train: loss {loss}")
    end, ckpt_end = trainer_state(summary["trainer"]), summary["checkpoints"][-1]
    del handle, summary["trainer"]

    first = train_detector(init_detector(cfg, device="cuda", seed=21),
                           os.path.join(work, f"first_{tag}"), max_iters=ENTRY_STEPS,
                           validate=False)
    ckpt = first["checkpoints"][-1]
    saved = trainer_state(first["trainer"])
    del first["trainer"]
    fresh = init_detector(cfg, device="cuda", seed=22)
    restored = build_trainer(cfg, fresh.detector, ENTRY_STEPS + 1, seed=0)
    meta = restore_checkpoint(ckpt, fresh.detector.net, restored.optimizer, restored.generator)
    bad = differing(trainer_state(restored), saved)
    if (meta["step"], meta["epoch"], meta["iter"]) != (ENTRY_STEPS, 0, ENTRY_STEPS) or bad:
        raise AssertionError(f"{tag}: restored checkpoint differs in {bad[:6]} (meta {meta})")
    del restored, fresh
    rest = train_detector(init_detector(cfg, device="cuda", seed=22),
                          os.path.join(work, f"rest_{tag}"), resume_from=ckpt, max_iters=steps,
                          validate=False)
    names = [os.path.basename(c) for c in rest["checkpoints"]]
    bad = differing(trainer_state(rest["trainer"]), end)
    if rest["steps"] != 2 or names != ["epoch_1", f"iter_{steps}"] or bad:
        raise AssertionError(f"{tag}: the run resumed from {ckpt} ({rest['steps']} steps, "
                             f"checkpoints {names}) differs from the uninterrupted run in "
                             f"{len(bad)} tensors: {bad[:6]}")
    say(f"{tag} entry points: train_detector {steps} steps at batch {TRAIN_BATCH} on "
        f"UTDAC-sized frames, loss {loss:.5g}; a run stopped after {ENTRY_STEPS} steps: its "
        f"checkpoint restored into a fresh model is torch.equal in every tensor, and "
        f"train_detector resumed from it (the portrait batch, then epoch 1's first) ends "
        f"bit-equal to the uninterrupted run (every tensor of the model's and optimizer's "
        f"state_dict and the generator's state)")
    del rest["trainer"]

    torch.cuda.synchronize()
    reset_counts()
    metrics = test_cli([CONFIG, ckpt_end, "--device", "cuda", "--classwise",
                        *cli_options(data_options(utdac, dtype))])
    eval_counts = read_counts()
    stats = [v for k, v in metrics.items() if k.startswith("bbox_")]
    stats += list(metrics["classwise"].values())
    if metrics["num_results"] != 9 or len(stats) != 10 or not all(map(math.isfinite, stats)):
        raise AssertionError(f"{tag} test CLI: {metrics['num_results']} results, stats "
                             f"{stats}")
    fwd, bwd = "roi_align_fwd" + ("" if tag == "f32" else "_bf16"), "roi_align_bwd" + (
        "" if tag == "f32" else "_bf16")
    if not (train_counts[fwd] and train_counts[bwd] and eval_counts[fwd]):
        raise AssertionError(f"{tag} entry points: kernels not launched: train "
                             f"{ran(train_counts)}, eval {ran(eval_counts)}")
    out = {"train_images_per_s": summary["images_per_s"],
           "loader_wait_share": summary["loader_wait_share"],
           "eval_images_per_s": metrics["eval_stats"]["images_per_s"],
           "train_peak_gib": peak, "train_counts": ran(train_counts),
           "eval_counts": ran(eval_counts), "val_results": metrics["num_results"],
           "bbox_stats": {k: v for k, v in metrics.items() if k.startswith("bbox_")}}
    say(f"{tag} entry points ({gpu}): " + json.dumps(out))
    return out


def e2e_trains(dtype, gpu: str, synth: str, work: str) -> dict:
    """``scripts/e2e_ap_check.py``'s recipe through the port's CLIs: the tiny
    flagship from scratch on the 200-image shapes set, E2E_EPOCHS epochs at
    batch E2E_BATCH, lr E2E_LR, warmup E2E_WARMUP, decay at 2/3 of the
    epochs and 2 before the end, no validation; then the test CLI on the 50
    val images: bbox mAP at least E2E_MIN_MAP."""
    tag = "f32" if dtype == torch.float32 else "bf16"
    opts = cli_options(data_options(
        synth, dtype, **{"data.samples_per_gpu": E2E_BATCH, "runner.max_epochs": E2E_EPOCHS,
                         "optimizer.lr": E2E_LR, "lr_config.warmup_iters": E2E_WARMUP,
                         "lr_config.step": f"[{2 * E2E_EPOCHS // 3},{E2E_EPOCHS - 2}]",
                         "model.backbone.frozen_stages": -1}))
    wd = os.path.join(work, f"e2e_{tag}")
    t0 = time.perf_counter()
    reset_counts()
    summary = train_cli([CONFIG, "--device", "cuda", "--tiny", "--no-validate", "--seed", "0",
                         "--work-dir", wd, *opts])
    counts = read_counts()
    train_s = time.perf_counter() - t0
    metrics = test_cli([CONFIG, os.path.join(wd, f"epoch_{E2E_EPOCHS}"), "--device", "cuda",
                        "--tiny", *opts])
    wall = time.perf_counter() - t0
    out = {"bbox_mAP": metrics["bbox_mAP"], "bbox_mAP_50": metrics["bbox_mAP_50"],
           "steps": summary["steps"], "train_images_per_s": summary["images_per_s"],
           "loader_wait_share": summary["loader_wait_share"], "train_s": train_s,
           "eval_images_per_s": metrics["eval_stats"]["images_per_s"], "wall_s": wall,
           "counts": ran(counts)}
    say(f"{tag} e2e shapes set ({gpu}): " + json.dumps(out))
    if not metrics["bbox_mAP"] >= E2E_MIN_MAP:
        raise AssertionError(f"{tag} e2e: bbox mAP {metrics['bbox_mAP']} < {E2E_MIN_MAP}")
    return out


def kernel_records(r: dict, dtype, o: str = "", box: dict | None = None) -> list:
    """The ``{"kernels": [...]}`` records of one dtype's kernels at one
    pooled size (``o``: '' for 7 x 7, '_o14' for 14 x 14): K1, K4 and their
    batch-of-one forms K2, K3; ``box``, Mask R-CNN's run of the same dtype,
    adds the 7 x 7 kernels at its box shapes."""
    sfx, note = ("", "") if dtype == torch.float32 else ("_bf16", ", bfloat16")
    note += ", 14 x 14" if o else ""
    src = "boosting_rcnn_tpu_torch/csrc/"
    tpu = "boosting_rcnn_tpu/ops/pallas_roi_align.py"
    pc, tc, ic = r["predict_counts"], r["train_counts"], r["image_counts"]
    checks = [r["check_predict"], r["check_odd"], r["check_train"]]
    if box:
        checks += [box["check_box_predict"], box["check_box_train"]]
    fp, bp = r["predict_shapes"]["fwd"], r["predict_shapes"]["bwd"]
    ft, bt = r["train_shapes"]["fwd"], r["train_shapes"]["bwd"]
    fi, bi = r["image"]["fwd"], r["image"]["bwd"]

    def times(t):
        return {"ms": t["call"], "kernel_ms": t["kernel"], "plain_ms": t["plain"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1], "library_ms": None}

    def shapes(t):
        out = {"call_ms": t["call"], "kernel_ms": t["kernel"], "plain_ms": t["plain"],
               "bound_ms": t["bound"][0]}
        if "tile_keys" in t:  # the gradient's parts
            out.update({"tile_key_kernel_ms": t["tile_keys"], "empty_bitmap_kernel_ms": t["empty"]})
        return out

    def at_box(part):
        return ({"box_shapes": {"predict": shapes(box["box_predict"][part]),
                                "train": shapes(box["box_train"][part])}} if box else {})

    fwd, bwd, keys = "roi_align_fwd" + sfx + o, "roi_align_bwd" + sfx + o, "roi_tile_keys" + o
    return [
        {"name": fwd, "route": "cuda", "source": src + "roi_align_fwd.cu",
         "replaces": f"{tpu}:586", "tpu_kernel": f"pallas_roi_align.py:586 _kernel_flat (K1){note}",
         "launches": pc[fwd] + tc[fwd], "launches_by_path": {"predict": pc[fwd], "train": tc[fwd]},
         "max_abs_err": max(x["fwd"][0] for x in checks),
         "share_not_bit_equal": max(x["fwd"][1] for x in checks),
         **times(fp), "train_shapes": shapes(ft), **at_box("fwd"),
         "launch": {"predict": r["fwd_launch"], "train": r["train_fwd_launch"]},
         **({"geometry_only_kernel_ms": r["geometry_ms"]} if o else {})},
        {"name": bwd, "route": "cuda", "source": src + "roi_align_bwd.cu",
         "replaces": f"{tpu}:244",
         "tpu_kernel": f"pallas_roi_align.py:244 _bwd_kernel via :828 (K4){note}",
         "launches": tc[bwd], "launches_by_path": {"predict": pc[bwd], "train": tc[bwd]},
         "tile_key_launches": tc[keys], "tile_spread_train": r["train_spread"],
         "max_abs_err": max(x["bwd"][0] for x in checks),
         "share_not_bit_equal": max(x["bwd"][1] for x in checks),
         "max_abs_plain": max(x["bwd"][2] for x in checks), "bitwise_repeatable": True,
         **times(bt), "tile_key_kernel_ms": bt["tile_keys"], "empty_bitmap_kernel_ms": bt["empty"],
         "predict_shapes": shapes(bp), **at_box("bwd")},
        {"name": fwd + "_per_image", "route": "cuda", "source": src + "roi_align_fwd.cu",
         "replaces": f"{tpu}:52",
         "tpu_kernel": f"pallas_roi_align.py:52 _kernel via :121 (K2), B=1 of K1{note}",
         "launches": ic[fwd + "_per_image"], "max_abs_err": r["check_image_fwd"][0],
         "share_not_bit_equal": r["check_image_fwd"][1], **times(fi)},
        {"name": bwd + "_per_image", "route": "cuda", "source": src + "roi_align_bwd.cu",
         "replaces": f"{tpu}:244",
         "tpu_kernel": f"pallas_roi_align.py:244 _bwd_kernel via :405 (K3), B=1 of K4{note}",
         "launches": ic[bwd + "_per_image"], "tile_key_launches": ic[keys + "_per_image"],
         "max_abs_err": r["check_image_bwd"][0], "share_not_bit_equal": r["check_image_bwd"][1],
         **times(bi)},
    ]


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
        say(f"built {name} in {build_s[name]:.1f} s: "
            + " | ".join(ptxas_report(cuda_build.build_log(name))))
    say(f"nvcc builds, in parallel: {time.perf_counter() - t0:.1f} s wall")

    mc = load_config(CONFIG).model.to_dict()
    mask_mc = load_config(MASK_CONFIG).model.to_dict()
    odd = odd_case(seed=2)
    runs, mask_runs = {}, {}
    for dtype in (torch.float32, BF16):
        runs[dtype] = run_paths(mc, dtype, gpu, odd)
        say(f"wall {time.perf_counter() - t_start:.1f} s")
        mask_runs[dtype] = run_mask_paths(mask_mc, dtype, gpu, odd)
        say(f"wall {time.perf_counter() - t_start:.1f} s")

    # ------------------------------------------------ tiny flagship, GPU vs CPU
    n_tiny = tiny_gpu_matches_cpu(seed=3)
    say(f"tiny flagship: GPU predict matches CPU predict ({n_tiny} detections)")
    tiny_metrics, tiny_worst, tiny_repeat, _ = tiny_train_gpu_matches_cpu(seed=7)
    say(f"tiny flagship: a GPU train step matches the CPU one (loss {tiny_metrics['loss']:.6g}, "
        f"worst parameter error {tiny_worst:.3g} of its tolerance); two GPU steps from the same "
        f"state give the same bits: {tiny_repeat}")
    level_errs, match = tiny_bf16_gpu_matches_cpu(seed=3)
    say("tiny bf16 flagship, GPU against CPU: C2-C5, P3-P7 max rel err "
        + ", ".join(f"{e:.3g}" for e in level_errs)
        + f" (tolerance {BF16_TOL['levels']}); roi_predict on the CPU's levels and proposals: "
        f"{match[0]} of {match[1]} detections matched, boxes within {match[2]:.3g} px, scores "
        f"within {match[3]:.3g}")
    b16_metrics, b16_worst, _, b16_median = tiny_train_gpu_matches_cpu(seed=7, dtype=BF16)
    say(f"tiny bf16 flagship: a GPU train step matches the CPU one (loss "
        f"{b16_metrics['loss']:.6g}, worst parameter error {b16_worst:.3g} of its tolerance, "
        f"median tensor {b16_median:.3g} of its update)")

    # ---------------------------------------------- tiny Mask R-CNN, GPU vs CPU
    for dtype in (torch.float32, BF16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        say(f"tiny {tag} Mask R-CNN: GPU predict matches CPU predict: "
            f"{tiny_mask_gpu_matches_cpu(seed=3, dtype=dtype)}")
        m, worst, repeat, median = tiny_train_gpu_matches_cpu(seed=7, dtype=dtype,
                                                              config=tiny_mask_config)
        say(f"tiny {tag} Mask R-CNN: a GPU train step matches the CPU one (loss {m['loss']:.6g}, "
            f"loss_mask {m['loss_mask']:.6g}, worst parameter error {worst:.3g} of its "
            f"tolerance, median tensor {median:.3g} of its update); two GPU steps from the "
            f"same state give the same bits: {repeat}")

    # ---------------------------------- ROADMAP C.2: a bitwise repeatable step
    repeat_report = {}
    for dtype, (name, config) in [(d, c) for c in (("flagship", tiny_config),
                                                   ("mask_rcnn", tiny_mask_config))
                                  for d in (torch.float32, BF16)]:
        tag = ("f32" if dtype == torch.float32 else "bf16") + " " + name
        unpinned, differ, n_tensors = repeatable_step(11, dtype, deterministic=False,
                                                      config=config)
        say(f"C.2 {tag}: two tiny steps from one state without the cuDNN pin: bit-identical "
            f"{unpinned} ({len(differ)} of {n_tensors} metrics, gradients and parameters "
            f"differ{': ' + ', '.join(differ[:4]) if differ else ''})")
        same, differ, _ = repeatable_step(11, dtype, config=config)
        if not same:
            raise AssertionError(f"C.2 {tag}: two pinned train steps from one state differ in "
                                 f"{len(differ)} tensors: {differ[:6]}")
        try:
            flagged, differ, _ = repeatable_step(11, dtype, flagged=True, config=config)
        except RuntimeError as exc:
            raise AssertionError(f"C.2 {tag}: an op of the train path has no deterministic "
                                 f"form: {exc}") from exc
        if not flagged:
            raise AssertionError(f"C.2 {tag}: steps under use_deterministic_algorithms differ "
                                 f"in {differ[:6]}")
        repeat_report[tag] = {"unpinned_identical": unpinned, "pinned_identical": True}
        say(f"C.2 {tag}: with the pin, the losses, every gradient and every parameter of two "
            f"steps are bit-identical; under torch.use_deterministic_algorithms(True) no op "
            f"raised and the steps are bit-identical")

    # ------------------ entry points: COCO-format data, train / test CLIs, e2e
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        utdac, synth = os.path.join(work, "utdac_like"), os.path.join(work, "shapes")
        generate(utdac, n_train=24, n_val=9, seed=0, frame_sizes=UTDAC_FRAMES, n_portrait=2,
                 object_scale=0.3)
        generate(synth, n_train=200, n_val=50, seed=0)
        say(f"synthetic COCO sets written in {time.perf_counter() - t0:.1f} s: 24 + 9 "
            f"UTDAC-sized frames {UTDAC_FRAMES} (2 portrait each), 200 + 50 shapes images")
        entry, e2e = {}, {}
        for dtype in (torch.float32, BF16):
            entry[dtype] = entry_points(dtype, gpu, utdac, work)
            say(f"wall {time.perf_counter() - t_start:.1f} s")
        for dtype in (torch.float32, BF16):
            e2e[dtype] = e2e_trains(dtype, gpu, synth, work)
            say(f"wall {time.perf_counter() - t_start:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    r32, r16 = runs[torch.float32], runs[BF16]
    m32, m16 = mask_runs[torch.float32], mask_runs[BF16]
    say("summary (" + gpu + "): " + json.dumps({
        "entry_points": {("f32" if d == torch.float32 else "bf16"): {**entry[d], "e2e": e2e[d]}
                         for d in (torch.float32, BF16)},
        "mask_rcnn": {
            "predict_ms": {"f32": m32["predict_ms"], "bf16": m16["predict_ms"]},
            "predict_images_per_s": {"f32": BATCH * 1e3 / m32["predict_ms"],
                                     "bf16": BATCH * 1e3 / m16["predict_ms"]},
            "train_step_ms": {"f32": m32["train_ms"], "bf16": m16["train_ms"]},
            "train_images_per_s": {"f32": MASK_TRAIN_BATCH * 1e3 / m32["train_ms"],
                                   "bf16": MASK_TRAIN_BATCH * 1e3 / m16["train_ms"]},
            "peak_gib": {"predict_f32": m32["predict_peak"], "predict_bf16": m16["predict_peak"],
                         "train_f32": m32["train_peak"], "train_bf16": m16["train_peak"]},
            "train_parts_ms": {"f32": m32["train_parts"], "bf16": m16["train_parts"]},
            "predict_stages_ms": {"f32": m32["predict_stages"], "bf16": m16["predict_stages"]}},
        "predict_ms": {"f32": r32["predict_ms"], "bf16": r16["predict_ms"]},
        "predict_images_per_s": {"f32": BATCH * 1e3 / r32["predict_ms"],
                                 "bf16": BATCH * 1e3 / r16["predict_ms"]},
        "train_step_ms": {"f32": r32["train_ms"], "bf16": r16["train_ms"]},
        "train_images_per_s": {"f32": TRAIN_BATCH * 1e3 / r32["train_ms"],
                               "bf16": TRAIN_BATCH * 1e3 / r16["train_ms"]},
        "peak_gib": {"predict_f32": r32["predict_peak"], "predict_bf16": r16["predict_peak"],
                     "train_f32": r32["train_peak"], "train_bf16": r16["train_peak"]},
        "train_parts_ms": {"f32": r32["train_parts"], "bf16": r16["train_parts"]},
        "predict_stages_ms": {"f32": r32["predict_stages"], "bf16": r16["predict_stages"]},
        "repeatable_step": repeat_report,
        "wall_s": time.perf_counter() - t_start}))
    records = (kernel_records(r32, torch.float32, box=m32) + kernel_records(r16, BF16, box=m16)
               + kernel_records(m32, torch.float32, "_o14") + kernel_records(m16, BF16, "_o14"))
    for record in records:  # the entry points' paths launch the 7 x 7 kernels too
        for dtype in (torch.float32, BF16):
            for path, counts in (("entry_train", entry[dtype]["train_counts"]),
                                 ("entry_eval", entry[dtype]["eval_counts"]),
                                 ("e2e_train", e2e[dtype]["counts"])):
                n = counts.get(record["name"], 0)
                if n:
                    record.setdefault("launches_by_path", {})[path] = n
    for record in records:
        timings = [v for part in (record, record.get("train_shapes", {}),
                                  record.get("predict_shapes", {}),
                                  *record.get("box_shapes", {}).values())
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
