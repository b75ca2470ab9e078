"""Drive the PyTorch port's flagship, Mask R-CNN, Boosting R-CNN family,
Cascade R-CNN, Cascade Mask R-CNN / HTC, the fork's remaining heads
(the ensemble configs, Dynamic R-CNN) and a caffe-style Faster R-CNN
inference and training, the flagship's flip and multi-scale test-time
augmentation, and its entry points with boxes, instance masks and stuff
maps, on one NVIDIA GPU.

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

Then the phase "boosting family": ResNeXt-101 32x4d UTDAC
(``boosting_rcnn_x101_32x4d_pafpn_1x_utdac.py``) at full width with
seeded random weights, in float32 and in bfloat16, through three requests
of two 800 x 1344 images and three train steps at batch 4 with the
config's schedule (counts set to 0 before each path and read after: the
7 x 7 forward once a request, forward, tile keys and gradient once a
step), both kernels against their plain versions at its predict and train
shapes, its ``predict`` stages, step time and a step with the cuDNN pin,
peak memory and profiles; then each of the family's six other configs
(the COCO R50 FPN and PAFPN, ResNeXt-101 64x4d, the three Res2Net-101
ones, the DCN one with its offset convs given small seeded weights) at
full width in bfloat16: one ``predict`` of two images and one train step
at batch 2 (valid detections of its classes; soft-NMS scores
non-increasing and at most the pre-NMS ones; finite losses, the frozen
stages bit-identical, every other part moved); and a tiny ResNeXt, a
tiny Res2Net-DCN (soft-NMS, ``reg_norm='mean'``) and a tiny Res2Net-DCN
with CIoU on the RPN's encoded deltas predict on the GPU as on the CPU,
and take a train step on the GPU as on the CPU in both dtypes (the third's
RPN box loss is ill-conditioned, ``CIOU_BF16_UNHELD``), and all three join
the repeatability check.  Every tiny bfloat16 GPU step, the flagship's
and Mask R-CNN's too, is held by one rule set from readings over seeds
7-16 (``bf16_step_rule``: the losses, every moved tensor moved, and the
GPU error over the float32 step's distance, its median at most
``FAMILY_BF16_RATIO`` and its 90th percentile at most
``BF16_RATIO_P90``); the run checks that the rule breaks on a
deliberately wrong step (level 0's K4 gradient dropped) of the flagship,
Mask R-CNN and the ProbCascade.

Then the phase "cascade": the fork's ProbCascade UTDAC
(``configs/ensemble/prob_cascade_rcnn_r50_pafpn_1x_utdac.py``: the
flagship's R50, PAFPN 256 and ATSS RPN, three class-agnostic Shared2FC
1024 stages at IoU 0.5 / 0.6 / 0.7, boosting with gamma 0.5, prior
fusion) at full width with seeded random weights in float32 and in
bfloat16: three requests of two 800 x 1344 images (256 proposals an
image, 512 RoIs a stage; K1 of the dtype once a stage and request, no
other kernel), then three train steps at batch 4 with the config's
schedule (512 slots an image a stage; K1, the tile keys and K4 once a
stage and step), counts set to 0 before each path and read after;
detections finite, inside the image and repeatable, losses finite, every
stage head and every unfrozen part moved, the frozen stages
bit-identical; K1 and K4 against their plain versions at stage 2's RoIs
(refined twice, some clamped to the image) of a request and of a step,
and timed there.  Cascade R-CNN R50-FPN COCO
(``configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py``: the plain
RPN, 80 classes, 1000 proposals an image) in bfloat16: one ``predict`` of
two images (2000 RoIs a stage) and one train step at batch 2, K1 and K4
at its stage 2's predict RoIs.  The tiny ProbCascade predicts and takes a
train step on the GPU as on the CPU in both dtypes (its stages sampled
from the same numpy uniforms) and joins the repeatability check.

Then the phase "htc": HTC R50-FPN with the semantic branch
(``configs/htc/htc_r50_fpn_1x_coco.py``: FPN 256, the plain RPN, three
class-agnostic Shared2FC 1024 stages, three 4 x 256 conv HTC mask heads
with information flow, the fused semantic head over the five neck levels
with 183 stuff classes, 80 classes) at full width with seeded random
weights in float32 and bfloat16: three requests of two 800 x 1344 images
(K1 at 7 six times a request: each stage on the pyramid and on the
semantic level; at 14 twice: the detections' masks on both), then three
train steps at batch 2 with ellipse gt masks and a seeded stuff map (K1,
K4 and the tile keys at 7 and at 14 six times a step each: the box
branch and HTC's interleaved mask branch of every stage, each on both),
counts set to 0 before each path and read after, exact; masks (2, 100,
28, 28) in [0, 1] of detections that reached the mask branch, repeatable;
every box, mask and semantic head moved, the mask heads' ``conv_res``
too; K1 and K4 at 7 and 14 on the one semantic level (every RoI routed
to it) against their plain versions at a request's proposals and
detections and a step's stage-0 slots and mask slots, timed there, with
the gradient's RoIs per tile.  Cascade Mask R-CNN R50-FPN (neither
interleaved nor with information flow) in bfloat16: one ``predict`` of
two images and one train step at batch 2.  The tiny HTC predicts and
takes a train step on the GPU as on the CPU in both dtypes (its stages'
and mask branches' samplers fed the same numpy uniforms) and joins the
repeatability check.  Each phase prints its wall time.

Then the phase "fork heads", with seeded random weights and nothing cut
(each path with the counts set to 0 before and read after, exact):
Dynamic R-CNN R50-FPN (``configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_coco.py``,
4 classes, its state in the box head) in float32 and bfloat16, three
requests of two 800 x 1344 images (K1 once a request) and three train
steps at batch 2 (K1, the tile keys and K4 once a step), then its state:
three ring slots finite, the IoU threshold and beta still 0.4 and 1.0 (no
boundary of the config's 100-step ring); ``configs/ensemble/
cascade_atss_r50_fpn_1x_coco.py`` (ATSS assignment in the RPN over the
201,600 anchors of the canvas, GIoU, three ProbCascade stages) in both
dtypes, one request and one step (K1 and K4 three times each), the ATSS
``gt_inds`` of the step's gts equal on the card and on the CPU; both held
to the plain K1 and K4 at their last stage's predict RoIs; and in
bfloat16 one request and one step of ``cascade_atss_s2``,
``cascade_retinanet`` (four stacked RPN convs, focal objectness),
``cascade_retinanet_s2`` and ``ensemble/boosting_rcnn`` (``BoostRoIHead``
on the focal RPN).  It prints each one's times and peaks beside the
card's name and power limit.  The tiny Dynamic R-CNN (a ring of 2 steps)
and ``cascade_atss`` predict on the GPU as on the CPU; ``cascade_atss``'s
ATSS ``gt_inds`` are equal on both and its float32 step holds
``f32_step_rule``; the tiny Dynamic R-CNN's four float32 steps each hold
it from the CPU's parameters, its state after each within 1e-6 plus rtol
1e-4 of the CPU's, ``dyn_count`` equal; both join the repeatability
check, which compares every buffer (the state) too.

Then the phase "tta + caffe", with seeded random weights and nothing cut:
the flagship's test-time augmentation in float32 and bfloat16, at batch 2
on two seeded 640 x 480 frames resized on the card as the test pipeline
resizes them: ``aug_predict`` (short side 800 and its mirror, canvas 800 x
1344) and ``aug_predict_multi`` over short sides 600, 800 and 1000 with
flip (canvases 608, 800 and 1024 x 1344: six views), two calls each with
the counts set to 0 before and read after (K1 of the dtype exactly 2 and
6 times a call), detections finite, inside the frame (along x up to the
canvas's width: a flipped view's boxes are clipped before they are
mirrored, as in the JAX package) and the same on every call; each one's
ms after its first call, its peak and the merged proposals kept; K1 and
K4 against their plain versions on the flipped view's pyramid and RoIs.
Then ``faster_rcnn_r50_caffe_fpn_1x_coco.py``
(the caffe-style ResNet-50: each stage's stride on its first 1x1; FPN,
80 classes) in both dtypes: one ``predict`` of two 800 x 1344 images and
one step at batch 2 with cuDNN pinned (launches exact; K1 and K4 against
their plain versions at its predict RoIs).  The tiny flagship's TTA (both
functions, float32) matches the CPU's; the tiny caffe Faster R-CNN
predicts as on the CPU, its float32 step holds ``f32_step_rule`` and it
joins the repeatability check in both dtypes.  The phase "entry points"
also runs the test CLI with ``--tta --tta-scales 600 800 1000`` on its 9
val images (K1 six times a batch).

Then the phase "norms + plugins", with seeded random weights and nothing
cut: ``configs/gcnet/mask_rcnn_r50_fpn_syncbn-backbone_r4_gcb_c3-c5_1x_coco.py``
(Mask R-CNN R50-FPN, 80 classes; its backbone's BN on batch statistics in
the train step, ``norm_eval=False``, and a ContextBlock after conv3 of
every bottleneck in stages 2-4) in float32 and bfloat16, 3 requests of two
800 x 1344 images and 3 steps at batch 2 with ellipse gt masks, the
counts set to 0 before and read after each path (K1 at 7 and 14 once a
request; K1, K4 and the tile keys at 7 and 14 once a step), ``predict``
leaving the running statistics as they are and the steps moving every
one of them, finite; K1 and K4 at 7 and 14 against their plain versions at
its box proposals, its detections' mask RoIs and its train slots.  Then in
bfloat16 one ``predict`` and one step each of the GN-all Mask R-CNN
(``Shared4Conv1FCBBoxHead``), the GN+WS Faster R-CNN and the
empirical-attention Faster R-CNN (``GeneralizedAttention`` after conv2 in
stages 3-4, all four energy terms).  The tiny GCNet model (``--tiny``'s
shrink, each bottleneck's last norm scaled by ``TINY_RESIDUAL_SCALE``, as
the CPU tests run it) predicts as on the CPU, its float32 step holds
``f32_step_rule`` with its running statistics within 1e-6 plus rtol 1e-4
of the CPU's, and it joins the repeatability check in both dtypes (every
buffer compared).

Every tiny float32 GPU step is held by a rule set from readings over
seeds 7-16 (``f32_step_rule``: the losses within rtol 1e-4, the gradient
norm within ``F32_GRAD_NORM_RTOL``, each tensor within ``F32_TENSOR_TOL``
times the per-tensor bound, the median tensor within
``F32_MEDIAN_OF_UPDATE`` of its update), and the run checks that it breaks
on a step with level 0's K4 gradient dropped for the flagship, Mask
R-CNN, the ProbCascade and the HTC.

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
train and test CLIs: the tiny flagship from scratch on the shapes set at
batch 8 with the script's batch-2 learning rate and warmup scaled
linearly (lr 0.01, warmup 50), no validation, the 7 x 7 kernels launched
once a step, then the test CLI, bbox mAP in [0, 1]; in bfloat16 (the
CLIs' default dtype) the whole recipe, 24 epochs (the epochs of the JAX
script's recorded passes), step decay at epochs 16 and 22: bbox mAP at
least 0.8 (the JAX script's threshold); in float32 the same path for 1
epoch (``E2E_EPOCHS_OF``), no decay.  It prints train images/s
(loading included), the loader-wait share, eval images/s, the kernels'
launches and the mAP with its wall time.

Then the phase "mask entry": a COCO-format set written to a temporary
directory (6 + 4 PPM frames at UTDAC2020's and COCO's sizes, portrait and
landscape, the shapes' polygons, an uncompressed-RLE ring and a crowd box
with compressed counts, an 8-bit PNG stuff map a frame under
``seg_prefix``, its rows under all five PNG filter types); full-width
Mask R-CNN and HTC with its semantic branch in bfloat16 from
``init_detector``'s seeded weights through
``train_detector`` (2 steps at batch 2, the loader rasterising the
112 x 112 crops and reading the stuff maps; counts set to 0 before, read
after: K1, K4 and the tile keys at 7 and 14 once a step, HTC's six times;
every stage's ``loss_mask`` and ``loss_semantic_seg`` finite and positive
at every step; the mask and semantic heads moved), then the test CLI's
``--eval bbox segm`` on the 4 val frames (one result a frame, the segm
stats present, K1 at 7 and 14 exact); and, in a child process (below),
``scripts/e2e_ap_check.py --segm``'s recipe through the port's CLIs: the
tiny Mask R-CNN (4 classes) from scratch on the shapes set, 24 epochs at
batch 8 with the batch-2 learning rate and warmup scaled linearly, K1 and
K4 at 7 and 14 once a step, to bbox and segm mAP at least 0.8.  It prints the loader's
wait share, images/s, peaks and the mAPs.

In the whole run the order is: the flagship and Mask R-CNN, the boosting
family, "cascade", "htc", "fork heads", "tta + caffe" and "norms + plugins" at full width
(full-width work beside the children delays them by about its own
time: they share the card); then the two
host-bound bfloat16 e2e trainings (the flagship's and the tiny Mask R-CNN's) start
in child processes on the same card (``--e2e-child``, each with its own
launch counts, read and checked in the child, on 2 PyTorch threads), and
the parent meanwhile runs, on the host's other threads, the entry points
and "mask entry" at full width (their images/s and wait shares are taken
beside the children), the float32 e2e and every tiny-model check (GPU
against CPU, the step rules' teeth, C.2; the ProbCascade's, HTC's, the
fork heads', "tta + caffe"'s and "norms + plugins"'s too), none of which is timed, then waits
for the children.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Any failure raises and the exit
code is not 0; without a CUDA device it exits with code 2 and prints no
result.  ``python3 chip_smoke.py --step-readings`` builds the kernels and
only prints the tiny models' GPU-against-CPU train steps over ten seeds
(``step_readings``), the readings behind the two step rules, with the
float32 edge reports, and the rules on deliberately wrong steps
(``--step-readings f32 htc`` picks a dtype and models); ``--cascade``,
``--htc``, ``--fork-heads``, ``--tta-caffe``, ``--norms-plugins`` and
``--mask-entry`` run only the phase "cascade", "htc", "fork heads", "tta +
caffe", "norms + plugins" or "mask entry"
(the last with 12
full-width steps a model and nothing beside them, then its e2e in the
child process).
"""
from __future__ import annotations

import contextlib
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
from boosting_rcnn_tpu_torch.data.coco import CocoDataset  # noqa: E402
from boosting_rcnn_tpu_torch.data.image_io import write_png_gray  # noqa: E402
from boosting_rcnn_tpu_torch.data.pipeline import rescale_size  # noqa: E402
from boosting_rcnn_tpu_torch.data.synthetic import generate  # noqa: E402
from boosting_rcnn_tpu_torch.engine.checkpoint import restore_checkpoint  # noqa: E402
from boosting_rcnn_tpu_torch.engine.runner import build_trainer, shrink_model  # noqa: E402
from boosting_rcnn_tpu_torch.models.detectors import two_stage  # noqa: E402
from boosting_rcnn_tpu_torch.models.detectors.cascade import CascadeDetector  # noqa: E402
from boosting_rcnn_tpu_torch.models.detectors.two_stage import DynamicRCNNDetector  # noqa: E402
from boosting_rcnn_tpu_torch.models.layers import DeformConv  # noqa: E402
from boosting_rcnn_tpu_torch.models.roi_heads.cascade_roi_head import (  # noqa: E402
    refine_boxes,
    stage_head_cfg,
)
from boosting_rcnn_tpu_torch.models.roi_heads.prob_roi_head import (  # noqa: E402
    prob_fuse_scores,
)
from boosting_rcnn_tpu_torch.engine.train import (  # noqa: E402
    make_optimizer,
    make_train_step,
    step_lr_schedule,
)
from boosting_rcnn_tpu_torch.tools.test import main as test_cli  # noqa: E402
from boosting_rcnn_tpu_torch.tools.train import main as train_cli  # noqa: E402
from boosting_rcnn_tpu_torch.ops import roi_align  # noqa: E402
from boosting_rcnn_tpu_torch.ops.assigners import atss_assign  # noqa: E402
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
BF16_TOL = {"levels": 0.025, "roi": 0.015, "loss": 0.015}


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
    """Seeded request batches: normalised-image-like noise drawn on the card
    (a host draw of a full-size batch with numpy takes longer than the
    ``predict`` it feeds), the flagship's padded canvas and its valid image
    shape."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for _ in range(REQUESTS):
        yield {
            "images": torch.randn((BATCH, *CANVAS, 3), generator=gen, device="cuda"),
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


def check_dets(dets, labels, valid, num_classes: int = 4, max_per_img: int = 100) -> int:
    if not (torch.isfinite(dets).all() and dets.shape == (BATCH, max_per_img, 5)):
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


def is_cascade(mc) -> bool:
    return mc["type"] in ("CascadeRCNN", "HybridTaskCascade")


def is_dynamic(mc) -> bool:
    return mc["roi_head"]["type"] == "DynamicRoIHead"


def samples_in_loss(mc) -> bool:
    """A cascade samples its stages inside its loss, Dynamic R-CNN at its
    state's threshold: neither takes an external ``RoISample``."""
    return is_cascade(mc) or is_dynamic(mc)


def tiny_train_inputs(seed: int, mc, anchors):
    """The tiny models' train batch (with gt mask crops for a mask head) and
    the step's keyword arguments, made with numpy so that every device and
    run samples alike: for the plain RPN its anchor sampler's uniforms, for
    a cascade each stage's RoI sampler's (over the gt boxes and the train
    proposals, then the gt boxes and the slots sampled before), for Dynamic
    R-CNN its RoI sampler's (over the gt boxes and the train proposals)."""
    masks = bool(mc["roi_head"].get("mask_head"))
    batch = (mask_train_batch if masks else train_batch)(
        seed, 2, (128, 160), (128.0, 150.0), 5, sides=(12.0, 70.0), **(
            {"num_classes": 4} if masks else {}))
    sem = mc["roi_head"].get("semantic_head")
    if sem:
        batch["gt_semantic_seg"] = stuff_map(seed, 2, (128, 160), sem["num_classes"])
    kw = {}
    rs = np.random.RandomState(seed)
    if mc["rpn_head"]["type"] == "RPNHead":
        kw["rpn_uniforms"] = rs.rand(2, 2, anchors.shape[0]).astype(np.float32)
    if is_cascade(mc):
        g = batch["gt_bboxes"].shape[1]
        rcnn = mc["train_cfg"]["rcnn"]
        slots = g + rcnn[0]["sampler"]["num"]
        stages = mc["roi_head"]["num_stages"]
        sizes = [g + mc["train_cfg"]["rpn_proposal"]["max_per_img"]] + [slots] * (stages - 1)
        kw["roi_uniforms"] = [rs.rand(2, 2, n).astype(np.float32) for n in sizes]
        if mc["type"] == "HybridTaskCascade":  # its mask branch samples each stage again
            kw["mask_uniforms"] = [rs.rand(2, 2, slots).astype(np.float32)
                                   for _ in range(stages)]
    if is_dynamic(mc):
        g = batch["gt_bboxes"].shape[1]
        kw["roi_uniforms"] = rs.rand(
            2, 2, g + mc["train_cfg"]["rpn_proposal"]["max_per_img"]).astype(np.float32)
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


def tiny_gpu_matches_cpu(seed: int, config=tiny_config) -> int:
    """The tiny flagship (or the tiny model of ``config``, deformable
    offsets seeded alike) predicts on the GPU (CUDA kernel) what it
    predicts on the CPU (the plain version, held against the JAX package by
    the CPU tests): labels and validity equal, detections within 1e-3."""
    mc = config()
    rs = np.random.RandomState(seed)
    batch = {"images": rs.randn(2, 128, 160, 3).astype(np.float32),
             "img_shape": np.array([[128.0, 150.0], [116.0, 160.0]], np.float32),
             "scale_factor": np.array([[1.0] * 4, [1.25] * 4], np.float32)}
    outs = []
    for device in ("cpu", "cuda"):
        det = build(mc, device=device, seed=seed)
        anchors, nla = det.anchors_for((128, 160))
        outs.append([x.cpu() for x in det.predict(batch, anchors, nla)])
    (d0, l0, v0, *m0), (d1, l1, v1, *m1) = outs
    if not (torch.equal(v0, v1) and torch.equal(l0, l1) and v0.any()):
        raise AssertionError(f"tiny {config.__name__}: GPU and CPU detections differ")
    err = (d0 - d1).abs().max().item()
    if err > 1e-3:
        raise AssertionError(f"tiny {config.__name__}: GPU and CPU boxes differ by {err}")
    if m0:  # masks within 1e-4
        mask_err = (m0[0] - m1[0]).abs().max().item()
        if mask_err > 1e-4:
            raise AssertionError(f"tiny {config.__name__}: GPU and CPU masks differ by "
                                 f"{mask_err}")
    return int(v0.sum())


def step_report(seed: int, dtype, config, again: bool = True) -> dict:
    """One train step of the tiny flagship (or the tiny model of ``config``;
    Mask R-CNN's with its gt masks and its RPN's draws given) in ``dtype``
    on the CPU (one thread: torch's threaded CPU convolution backward was
    seen to be non-repeatable), twice on the GPU and, for bfloat16, on the
    CPU in float32, from the same seeded weights, batch and ``RoISample``
    (drawn on the CPU; a cascade samples its stages in the step, from the
    same uniforms), at a constant learning rate of 0.01.  Returns each
    run's metrics, and per parameter tensor the GPU's error against the
    CPU's step, the CPU's update, the CPU's largest value, the float32
    step's distance from the CPU's and the GPU's update; whether the two
    GPU runs gave the same bits (None without ``again``, which skips the
    second); each run's buffers after its step.  A ContextBlock's
    attention-pooling bias (``SHIFT_INVARIANT``) is reported apart, under
    ``shift_invariant``: it shifts every logit of its softmax alike, so its
    gradient is 0 but for rounding (exactly 0 on the card at some blocks,
    where the CPU's moves it by 1e-10)."""
    mc = config()
    devices = {"cpu": ("cpu", dtype), "cuda": ("cuda", dtype)}
    if again:
        devices["cuda again"] = ("cuda", dtype)
    if dtype != torch.float32:
        devices["cpu float32"] = ("cpu", torch.float32)
    dets = {k: build(mc, device=d, seed=seed, dtype=t) for k, (d, t) in devices.items()}
    anchors, nla = dets["cpu"].anchors_for((128, 160))
    batch, kw = tiny_train_inputs(seed, mc, anchors)
    sample = None if samples_in_loss(mc) else dets["cpu"].train_sample(
        batch, anchors, nla, generator=torch.Generator().manual_seed(seed))
    p0 = {k: v.detach().clone() for k, v in dets["cpu"].net.named_parameters()}
    metrics, params, buffers = {}, {}, {}
    threads = torch.get_num_threads()
    for device, det in dets.items():
        torch.set_num_threads(1 if device.startswith("cpu") else threads)
        a, n = det.anchors_for((128, 160))
        step = make_train_step(det, a, n, make_optimizer(det.net.parameters(), lambda s: 0.01))
        metrics[device] = {k: float(v) for k, v in step(batch, sample, **kw).items()}
        params[device] = {k: v.detach().cpu() for k, v in det.net.named_parameters()}
        buffers[device] = {k: v.detach().cpu() for k, v in det.net.named_buffers()}
    torch.set_num_threads(threads)
    f32 = params.get("cpu float32")
    tensors = {name: ((params["cuda"][name] - ref).abs().max().item(),
                      (ref - p0[name]).abs().max().item(), ref.abs().max().item(),
                      (f32[name] - ref).abs().max().item() if f32 else math.inf,
                      (params["cuda"][name] - p0[name]).abs().max().item())
               for name, ref in params["cpu"].items()}
    repeat = (all(torch.equal(params["cuda"][k], params["cuda again"][k]) for k in params["cuda"])
              if again else None)
    shift = {k: tensors.pop(k) for k in list(tensors) if k.endswith(SHIFT_INVARIANT)}
    return {"metrics": metrics, "tensors": tensors, "repeat": repeat, "inputs": (batch, kw),
            "buffers": buffers, "shift_invariant": shift}


def sample_flips(mc, seed: int, dtype, batch, kw) -> list:
    """Per stage of a cascade's loss (then per stage of HTC's mask branch),
    from the same seeded weights and uniforms on the CPU and the GPU: how
    many slots differ in whether they are valid or positive or in their
    matched gt, and the largest difference of the boxes of the slots valid
    on both (px)."""
    samples = {}
    for device in ("cpu", "cuda"):
        det = build(mc, device=device, seed=seed, dtype=dtype)
        a, n = det.anchors_for((128, 160))
        stages = det.stage_samples(batch, a, n, roi_uniforms=kw["roi_uniforms"])
        if "mask_uniforms" in kw:  # HTC's mask branch samples each stage again
            stages += det.mask_samples(batch, a, n, roi_uniforms=kw["roi_uniforms"],
                                       mask_uniforms=kw["mask_uniforms"])
        samples[device] = [s._replace(**{k: v.cpu() for k, v in s._asdict().items()})
                           for s in stages]
    out = []
    for c, g in zip(samples["cpu"], samples["cuda"]):
        differ = (c.valid != g.valid) | (c.is_pos != g.is_pos) | (c.gt_idx != g.gt_idx)
        both = c.valid & g.valid
        out.append({"slots_differ": int(differ.sum()),
                    "box_err": (c.boxes - g.boxes)[both].abs().max().item() if both.any()
                    else 0.0})
    return out


def step_summary(rep: dict) -> dict:
    """``step_report`` in a few numbers: each metric's relative gap, GPU
    against CPU (and, for bfloat16, the CPU's float32 step against its
    bfloat16 one); over the tensors the CPU's step moved: how many, how
    many the GPU's moved too, the share of its update that a per-tensor
    bound (``1e-7 * max|p| + 1e-6 * max update`` besides) needs at most,
    the median GPU error as a share of the update, how many are closer to
    the CPU's step than the float32 step is, and the GPU error over the
    float32 step's distance (median, 90th percentile, largest)."""
    m = rep["metrics"]
    delta_max = max(t[1] for t in rep["tensors"].values())
    moved = [t for t in rep["tensors"].values() if t[1] > 0]

    def gaps(other):
        return {k: abs(m[other][k] - v) / max(abs(v), 1e-30) for k, v in m["cpu"].items()}

    out = {"gaps": gaps("cuda")}
    if "cpu float32" in m:
        out["f32_gaps"] = gaps("cpu float32")
    out.update({
        "moved": len(moved), "gpu_moved": sum(gpu > 0 for *_, gpu in moved),
        "needed_tol": max(max(err - 1e-7 * top - 1e-6 * delta_max, 0.0) / delta
                          for err, delta, top, _, _ in moved),
        "median_of_update": float(np.median([err / delta for err, delta, *_ in moved])),
        "closer": sum(err <= f32 for err, _, _, f32, _ in moved)})
    if "cpu float32" in m:
        ratios = [err / max(f32, 1e-30) for err, _, _, f32, _ in moved]
        out.update({"ratio_median": float(np.median(ratios)),
                    "ratio_p90": float(np.quantile(ratios, 0.9)), "ratio_max": max(ratios)})
    # the tensors furthest past the float32 step's per-tensor tolerance
    worst = sorted(((err / (1e-3 * delta + 1e-7 * top + 1e-6 * delta_max), name, err / delta)
                    for name, (err, delta, top, _, _) in rep["tensors"].items() if delta > 0),
                   reverse=True)[:3]
    out["worst_of_f32_tol"] = [[name, of_tol, of_update] for of_tol, name, of_update in worst]
    if "sample_flips" in rep:
        out["sample_flips"] = rep["sample_flips"]
    return out


# the deliberately wrong bfloat16 gradients ``step_readings`` holds the
# rule to: level 0's K4 gradient 5% too large, half again, and dropped;
# the run checks that the rule breaks on the last (``wrong_step_broken``)
WRONG_K4_SCALES = (1.05, 1.5, 0.0)
WRONG_K4_CAUGHT = 0.0


@contextlib.contextmanager
def wrong_k4(scale: float = 1.05, level: int = 0, dtype=BF16):
    """A deliberately wrong gradient kernel of ``dtype`` inside the block:
    the gradient of route level ``level`` times ``scale`` (the rules'
    teeth in ``step_readings``)."""
    bwd = batched_multilevel_roi_align.backward
    right = bwd.launch

    def launch(g, *args, **kw):
        grads = right(g, *args, **kw)
        if g.dtype == dtype:
            grads[level] = grads[level] * scale
        return grads

    bwd.launch = launch
    try:
        yield
    finally:
        del bwd.launch


def step_readings(gpu: str, seeds=tuple(range(7, 17)), dtypes=None, names=None) -> None:
    """``step_summary`` of the tiny models' steps (the flagship, the family's
    three, Mask R-CNN, the ProbCascade) in both dtypes over ``seeds``,
    printed and not held: the readings that ``f32_step_rule`` and
    ``bf16_step_rule`` are set from (``python3 chip_smoke.py
    --step-readings [f32|bf16] [model ...]``, which picks dtypes and models
    by name); then each rule on a deliberately wrong step of the dtype of
    each model but the CIoU one (``wrong_k4``: level 0's gradient times
    each of ``WRONG_K4_SCALES``), reporting where it breaks."""
    models = [(name, config) for name, config in (
        ("flagship", tiny_config), *TINY_FAMILY, ("mask_rcnn", tiny_mask_config),
        ("prob_cascade", tiny_cascade_config), ("htc", tiny_htc_config),
        ("faster_caffe", tiny_caffe_config), ("gcnet", tiny_norms_config))
        if not names or name in names]
    dtypes = dtypes or (torch.float32, BF16)
    for name, config in models:
        for dtype in dtypes:
            for seed in seeds:
                rep = step_report(seed, dtype, config)
                if is_cascade(config()):
                    rep["sample_flips"] = sample_flips(config(), seed, dtype, *rep["inputs"])
                summary = step_summary(rep)
                if any(k.endswith(RUNNING) for k in rep["buffers"]["cpu"]):
                    summary["running_stats_of_tol"] = running_stats_share(rep)
                broken = step_rule(rep, summary, config, dtype)
                say(f"step readings ({gpu}) {name} {'f32' if dtype == torch.float32 else 'bf16'}"
                    f" seed {seed}: " + json.dumps(summary) + " -> the rule "
                    + ("breaks: " + "; ".join(broken) if broken else "holds"))
    configs = dict(models)
    if torch.float32 in dtypes:
        for name, seed in EDGE_CASES:
            if name in configs:
                say(f"edge report ({gpu}) {name} f32 seed {seed}: "
                    + json.dumps(edge_report(seed, configs[name])))
    for dtype in dtypes:
        tag = "f32" if dtype == torch.float32 else "bf16"
        for scale in WRONG_K4_SCALES:
            caught = []
            for name, config in models:
                if config is tiny_r2dcn_ciou_config:
                    continue
                with wrong_k4(scale, dtype=dtype):
                    rep = step_report(seeds[0], dtype, config)
                summary = step_summary(rep)
                broken = step_rule(rep, summary, config, dtype)
                if broken:
                    caught.append(name)
                say(f"step readings ({gpu}) {name} {tag} seed {seeds[0]}, level 0's K4 gradient "
                    f"x {scale}: " + json.dumps(summary) + " -> the rule "
                    + ("breaks: " + "; ".join(broken) if broken else "holds"))
            say(f"the {tag} step rule caught the steps with level 0's K4 gradient x {scale} of: "
                + (", ".join(caught) or "none"))


# the float32 readings that were past the old per-tensor bound, and a
# clean one beside them
EDGE_CASES = (("mask_rcnn", 16), ("prob_cascade", 14), ("mask_rcnn", 7), ("faster_caffe", 7))


def edge_report(seed: int, config) -> dict:
    """Where a tiny model's float32 loss forward on the GPU leaves the CPU's
    on an edge, from the same seeded weights, batch, ``RoISample`` and
    draws: per convolution or linear layer, how many outputs have the other
    sign on the other device (a ReLU that passes on one and not the
    other), the layers with the most; and, with a mask head, how many mask
    target cells differ."""
    mc = config()
    outs, targets = {}, {}
    batch = kw = sample = None
    for device in ("cpu", "cuda"):
        det = build(mc, device=device, seed=seed)
        anchors, nla = det.anchors_for((128, 160))
        if batch is None:
            batch, kw = tiny_train_inputs(seed, mc, anchors)
            sample = None if is_cascade(mc) else det.train_sample(
                batch, anchors, nla, generator=torch.Generator().manual_seed(seed))
        seen, hooks = outs.setdefault(device, {}), []
        for name, m in det.net.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear, torch.nn.ConvTranspose2d)):
                hooks.append(m.register_forward_hook(
                    lambda mod, args, out, name=name: seen.setdefault(name, []).append(
                        out.detach().cpu())))
        mask_loss = two_stage.mask_loss

        def spy(logits, t, *args, **kwargs):
            targets.setdefault(device, []).append(t.detach().cpu())
            return mask_loss(logits, t, *args, **kwargs)

        two_stage.mask_loss = spy
        try:
            with torch.no_grad():
                det.loss(batch, anchors, nla, sample=sample, **kw)
        finally:
            two_stage.mask_loss = mask_loss
            for h in hooks:
                h.remove()
    flips = {}
    for name, cpu in outs["cpu"].items():
        n = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(cpu, outs["cuda"][name]))
        if n:
            flips[name] = n
    report = {"sign_flips": dict(sorted(flips.items(), key=lambda kv: -kv[1])[:6]),
              "layers_with_flips": len(flips)}
    if targets:
        report["mask_target_cells_differ"] = sum(
            int((a != b).sum()) for a, b in zip(targets["cpu"], targets["cuda"]))
    return report


def step_rule(rep: dict, summary: dict, config, dtype) -> list:
    """What a tiny GPU step breaks of its dtype's rule (``f32_step_rule``
    or ``bf16_step_rule``); an empty list where it holds."""
    if dtype == torch.float32:
        if config is tiny_norms_config:
            return live_bn_step_rule(rep, summary)
        return f32_step_rule(rep, summary)
    return bf16_step_rule(summary, rep["metrics"], config)


# a tiny model's float32 step on the GPU sums in other orders than the
# CPU's.  Over seeds 7-16 on an H100 (``--step-readings f32``, PERF.md §6)
# the losses read within 1.6e-5 of the CPU's, the gradient norm within
# 1.01e-4 (the ProbCascade at seed 14), each tensor within 3.15 times
# ``1e-3 * max|p - p0| + 1e-7 * max|p| + 1e-6 * the largest update`` (Mask
# R-CNN's first mask conv at seed 16; no other reading past 1.21), and the
# median tensor within 1.4e-4 of its update; no stage's sample differed.
# Held (``f32_step_rule``): the losses within rtol 1e-4, the gradient norm
# within F32_GRAD_NORM_RTOL, each tensor within F32_TENSOR_TOL times that
# bound and the median within F32_MEDIAN_OF_UPDATE of its update.  Level
# 0's K4 gradient 5% too large reads 7.1e-3 and more on the gradient norm,
# 34-76 times the per-tensor bound and a median of 1.5e-2 and more, for
# every model
F32_GRAD_NORM_RTOL = 3e-4
F32_TENSOR_TOL = 5.0
F32_MEDIAN_OF_UPDATE = 1e-3


def f32_step_rule(rep: dict, summary: dict, grad_norm_rtol: float = F32_GRAD_NORM_RTOL,
                  tensor_tol: float = F32_TENSOR_TOL,
                  median_of_update: float = F32_MEDIAN_OF_UPDATE) -> list:
    """What a tiny float32 GPU step breaks of its rule, set from readings
    over seeds 7-16 (above): the metrics finite, the losses within rtol 1e-4
    and the gradient norm within ``F32_GRAD_NORM_RTOL`` of the CPU's; every
    updated parameter within ``F32_TENSOR_TOL`` times ``1e-3 * max|p - p0|
    + 1e-7 * max|p|`` of the tensor plus ``1e-6`` of the largest update in
    the network (float32 sums in other orders; the last term covers
    tensors whose update is a near-cancelling sum, such as the P6 and P7
    convs' biases); the median tensor's error within
    ``F32_MEDIAN_OF_UPDATE`` of its update; at least 50 tensors moved by
    the CPU's step and each of them by the GPU's.  The bounds are arguments
    for ``live_bn_step_rule``."""
    broken = []
    for k, ref in rep["metrics"]["cpu"].items():
        got = rep["metrics"]["cuda"][k]
        rtol = grad_norm_rtol if k == "grad_norm" else 1e-4
        if not (math.isfinite(ref) and math.isfinite(got)) or abs(got - ref) > rtol * abs(ref):
            broken.append(f"{k}: GPU {got} CPU {ref}")
    worst = summary["worst_of_f32_tol"]
    if worst and worst[0][1] > tensor_tol:
        broken.append(f"{worst[0][0]}: GPU and CPU differ by {worst[0][1]:.4g} times the "
                      f"per-tensor bound (> {tensor_tol})")
    if summary["median_of_update"] > median_of_update:
        broken.append(f"the median tensor differs by {summary['median_of_update']:.4g} of its "
                      f"update (> {median_of_update})")
    if summary["moved"] < 50 or summary["gpu_moved"] < summary["moved"]:
        broken.append(f"the CPU's step moved {summary['moved']} tensors, the GPU's "
                      f"{summary['gpu_moved']} of them")
    return broken


# the tiny GCNet model's float32 step (53 BNs on batch statistics) on the
# card against the CPU's: each such BN divides its input's float32 rounding
# by the input's spread, so the two steps part further than the frozen-BN
# models' (``--step-readings f32 gcnet`` over seeds 7-16, PERF.md §6): the
# losses within rtol 1e-4 at every seed, the gradient norm within 0.86%,
# each tensor within 42.8 times the per-tensor bound, the median tensor
# within 0.0153 of its update, and so ``f32_step_rule`` broke at 5 of the
# 10 seeds (not only through cuDNN: with it off they part as far at other
# seeds).  Level 0's K4 gradient x 1.05 read
# 4.5% on the gradient norm (x 1.5: 47%, the median 0.11; x 0: 82%).  Held
# (``live_bn_step_rule``): the losses within rtol 1e-4, the gradient norm
# within LIVE_BN_GRAD_NORM_RTOL, each tensor within LIVE_BN_TENSOR_TOL
# times the bound and the median within LIVE_BN_MEDIAN_OF_UPDATE
LIVE_BN_GRAD_NORM_RTOL = 0.02
LIVE_BN_TENSOR_TOL = 100.0
LIVE_BN_MEDIAN_OF_UPDATE = 0.03
# the running statistics after that step, as a share of 1e-6 + rtol 1e-4 of
# the CPU's (Dynamic R-CNN's state tolerance): the same readings read
# 0.375-1.41 of it, 0.657 at seed 7, where ``norms_tiny`` holds the step
LIVE_BN_STATS_TOL = 1.0


def live_bn_step_rule(rep: dict, summary: dict) -> list:
    """``f32_step_rule`` with the live-BN bounds above."""
    return f32_step_rule(rep, summary, LIVE_BN_GRAD_NORM_RTOL, LIVE_BN_TENSOR_TOL,
                         LIVE_BN_MEDIAN_OF_UPDATE)


def running_stats_share(rep: dict) -> float:
    """The largest difference between the card's and the CPU's BN running
    statistics after ``step_report``'s step, as a share of 1e-6 + rtol
    1e-4 of the CPU's."""
    cpu, cuda = rep["buffers"]["cpu"], rep["buffers"]["cuda"]
    return max(((cuda[k] - cpu[k]).abs() / (1e-6 + 1e-4 * cpu[k].abs())).max().item()
               for k in cpu if k.endswith(RUNNING))


def bf16_step_rule(summary: dict, metrics: dict, config) -> list:
    """What a tiny bfloat16 GPU step of the model of ``config`` breaks of
    the rule its readings back (PERF.md §6): the losses within
    ``BF16_TOL["loss"]`` of the CPU's (not the gradient norm, nor the
    CIoU-on-deltas model's ``CIOU_BF16_UNHELD``, the ProbCascade's
    ``CASCADE_BF16_UNHELD`` or the HTC's ``HTC_BF16_UNHELD``), every tensor
    the CPU's step moved moved, and the GPU's distance from the CPU's step
    over the CPU float32 step's, over the moved tensors, with a median at
    most ``FAMILY_BF16_RATIO`` and a 90th percentile at most
    ``BF16_RATIO_P90`` (the HTC's ``HTC_BF16_RATIO_P90``; not for the CIoU
    model).  An empty list where it holds."""
    ciou = config is tiny_r2dcn_ciou_config
    unheld = (CIOU_BF16_UNHELD if ciou else
              CASCADE_BF16_UNHELD if config is tiny_cascade_config else
              HTC_BF16_UNHELD if config is tiny_htc_config else ())
    broken = []
    for k, ref in metrics["cpu"].items():
        got = metrics["cuda"][k]
        if not (math.isfinite(ref) and math.isfinite(got)):
            broken.append(f"{k} not finite: GPU {got} CPU {ref}")
        elif (k != "grad_norm" and k not in unheld
              and abs(got - ref) > BF16_TOL["loss"] * abs(ref)):
            broken.append(f"{k}: GPU {got} CPU {ref}")
    if summary["moved"] < 50 or summary["gpu_moved"] < summary["moved"]:
        broken.append(f"the CPU's step moved {summary['moved']} tensors, the GPU's "
                      f"{summary['gpu_moved']} of them")
    p90 = HTC_BF16_RATIO_P90 if config is tiny_htc_config else BF16_RATIO_P90
    for key, bound in (("ratio_median", FAMILY_BF16_RATIO), ("ratio_p90", p90)):
        if not ciou and summary[key] > bound:
            broken.append(f"the GPU's error over the float32 step's distance, {key} "
                          f"{summary[key]:.4g} > {bound}")
    return broken


def wrong_step_broken(config, scale: float, seed: int = 7, dtype=BF16) -> list:
    """The step rule of ``dtype`` on the step of ``config`` with a wrong K4
    (``wrong_k4(scale)``): what it breaks."""
    with wrong_k4(scale, dtype=dtype):
        rep = step_report(seed, dtype, config)
    return step_rule(rep, step_summary(rep), config, dtype)


def tiny_train_gpu_matches_cpu(seed: int, dtype=torch.float32, config=tiny_config):
    """``step_report``'s GPU step (CUDA kernels) against its CPU step (plain
    versions, held against the JAX package by the CPU tests), each dtype by
    its rule set from readings over seeds 7-16 (``--step-readings``):
    float32 by ``f32_step_rule``, bfloat16 by ``bf16_step_rule`` (at the
    tiny size a bfloat16 step's rounding noise is as large as its update,
    so no per-tensor bound holds across seeds).  Returns the GPU's
    metrics, the worst float32 error as a share of the per-tensor bound
    before ``F32_TENSOR_TOL`` (0 in bfloat16), whether a second GPU run
    gave the same bits, and ``step_summary``."""
    rep = step_report(seed, dtype, config)
    summary = step_summary(rep)
    metrics = rep["metrics"]
    broken = step_rule(rep, summary, config, dtype)
    if broken:
        raise AssertionError(f"tiny {'f32' if dtype == torch.float32 else 'bf16'} train step "
                             f"({config.__name__}): " + "; ".join(broken))
    worst = summary["worst_of_f32_tol"][0][1] if dtype == torch.float32 else 0.0
    return metrics["cuda"], worst, rep["repeat"], summary


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


def tiny_bf16_gpu_matches_cpu(seed: int, config=tiny_config):
    """The tiny flagship in bfloat16 on the GPU (cuDNN, cuBLAS, the bfloat16
    kernels) against the same on the CPU (the plain versions, held against
    the JAX package's bfloat16 build by tests/test_torch_bf16.py), at that
    file's tolerances: C2-C5 and P3-P7 within 2.5% of each level's largest
    value (C2 is the stem: cuDNN's 7x7/s2 bfloat16 convolution against the
    CPU's, which equals the JAX package's space-to-depth stem bit for bit
    there); ``roi_predict`` on the CPU's levels and proposals: at least 90%
    of the kept detections matched, boxes within 0.5 px, scores within
    0.01.  The same for the tiny model of ``config``.  Returns the levels'
    errors and the match."""
    mc = config()
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
    the metrics, every gradient, every parameter and every buffer (Dynamic
    R-CNN's state among them) are bit-identical, and how many tensors
    differ.  With ``flagged`` the steps run under
    ``torch.use_deterministic_algorithms``, which raises on an op that has
    no deterministic form."""
    mc = config()
    det = build(mc, device="cuda", seed=seed, dtype=dtype)
    anchors, nla = det.anchors_for((128, 160))
    batch, kw = tiny_train_inputs(seed, mc, anchors)
    sample = None if samples_in_loss(mc) else det.train_sample(
        batch, anchors, nla, generator=torch.Generator(device="cuda").manual_seed(seed))
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
                            for k, p in det.net.named_parameters()},
                         **{f"buffer {k}": b.clone() for k, b in det.net.named_buffers()}})
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    differ = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
    return not differ, differ, len(runs[0])


def step_timing(det, anchors, nla, tb, sample, deterministic: bool, steps: int = 2) -> float:
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
    """One call of ``fn``, which the caller has run before, under
    ``torch.profiler`` (CUDA activity): device kernel time against the wall
    time of the call, the largest kernels, and the layout kernels (NCHW <->
    NHWC conversions, transposes, channel padding).  'not measured' when the
    profiler records no device time."""
    try:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

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
    samples (the same weights and sampler seed; None for a cascade, which
    samples its stages inside the step)."""
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
    sample0 = None if isinstance(det, (CascadeDetector, DynamicRCNNDetector)) else (
        det.train_sample(tb, anchors, nla, generator=torch.Generator(device="cuda").manual_seed(5)))
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


# ---------------------------------------------------------- boosting family
FAMILY = os.path.join(REPO, "configs/boosting_rcnn")
X101_CONFIG = os.path.join(FAMILY, "boosting_rcnn_x101_32x4d_pafpn_1x_utdac.py")
# the family's other configs the port builds (the flagship UTDAC and VOC
# ones run above and in the entry points)
FAMILY_OTHERS = ("boosting_rcnn_r50_fpn_1x_coco.py", "boosting_rcnn_r50_pafpn_mstrain_2x_coco.py",
                 "boosting_rcnn_x101_pafpn_mstrain_3x_coco.py",
                 "boosting_rcnn_r2_101_pafpn_mstrain_2x_coco.py",
                 "boosting_rcnn_r2_101_fpn_mstrain_3x_coco.py",
                 "boosting_rcnn_r2_101_dcn_pafpn_mstrain_3x_coco.py")
# one of the two configs with DCN is profiled: both read host-bound on the
# gather (PR 12), and each profile costs 3-4 s of the script's time limit
DCN_PROFILED = "boosting_rcnn_r2_101_dcn_pafpn_mstrain_3x_coco.py"
FAMILY_STEPS = 3  # X101's train steps: step 0 warms up, steps 1-2 are timed
FAMILY_BATCH = 2  # the other configs' one step and predict
OFFSET_SCALE = 0.1  # seeded offset-conv weights: 0.1 of LeCun's scale
# a tiny model's bfloat16 step on the GPU is another bfloat16 rounding of
# the CPU's: over seeds 7-16 on an H100 (``--step-readings``, PERF.md §6)
# a per-tensor share of the update needed up to 1.61 and the "closer than
# float32" count fell to 23%: bounds that held at one seed and not across
# seeds.  Held instead (``bf16_step_rule``): the losses within
# BF16_TOL["loss"] (largest reading 0.79%, the flagship's; not the
# gradient norm, up to 38% apart), and over the moved tensors the GPU's
# distance from the CPU's step over the CPU's float32 step's: its median
# at most FAMILY_BF16_RATIO (readings 0.04-1.27 over the flagship, the
# family's ResNeXt and Res2Net-DCN, Mask R-CNN and the ProbCascade) and
# its 90th percentile at most BF16_RATIO_P90 (readings 0.09-2.61).  A
# wrong K4 with level 0's gradient dropped breaks the latter for the
# flagship, Mask R-CNN, Res2Net-DCN and the ProbCascade (7.6, 50.4, 17.9,
# 5.5), not for ResNeXt (2.78); one 5% too large breaks neither: the
# kernels' own gates (1 ulp) hold that
FAMILY_BF16_RATIO = 2.0
BF16_RATIO_P90 = 3.0
# what the tiny ProbCascade's bfloat16 step does not hold: each device
# samples its stages 1 and 2 on its own refined boxes, and a box that
# rounds across a stage's IoU threshold changes the sample; its stage
# losses read up to 19.1% apart over seeds 7-16, the total up to 1.52%
# (its RPN losses within 0.79%)
CASCADE_BF16_UNHELD = ("loss",) + tuple(f"s{i}.loss_{k}" for i in range(3)
                                        for k in ("cls", "bbox"))
CIOU_BF16_UNHELD = ("loss", "loss_rpn_bbox")
# the tiny HTC's likewise, its mask losses too: its stages and their mask
# branches each pool the device's own refined boxes, which in bfloat16
# differ by a rounding of the deltas (its stage losses read up to 14.6%
# apart over seeds 7-16).  For the same reason its later heads' steps sit
# further from the CPU's than the float32 step's distance: the 90th
# percentile read 0.03-4.51 (4.15 and 4.51 at seeds 13 and 14, the median
# 0.01-1.40), so it is held at HTC_BF16_RATIO_P90; level 0's K4 gradient
# x 1.5 reads 13.1 and x 0 26.3
HTC_BF16_UNHELD = CASCADE_BF16_UNHELD + tuple(f"s{i}.loss_mask" for i in range(3))
HTC_BF16_RATIO_P90 = 6.0


def seed_offsets(det, seed: int, scale: float = OFFSET_SCALE) -> int:
    """Give every deformable conv's zero-initialised offset conv small
    seeded weights (normal, ``scale / sqrt(fan_in)``, drawn on the CPU, so
    every device gets the same), or the deformable convs would sample the
    plain grid; returns how many.  No-op without a deformable conv."""
    gen = torch.Generator().manual_seed(seed)
    n = 0
    with torch.no_grad():
        for name, m in det.net.named_modules():
            if isinstance(m, DeformConv):
                w = m.conv_offset.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
                w.copy_((torch.randn(w.shape, generator=gen) * scale / math.sqrt(fan_in))
                        .to(w.device))
                n += 1
    return n


def build(mc, device=None, seed: int = 0, dtype=torch.float32):
    """``build_detector`` with any deformable conv's offsets seeded
    (``seed_offsets``); a ``residual_scale`` beside the model's keys (the
    tiny live-BN model's, ``tiny_norms_config``) scales each bottleneck's
    last norm."""
    mc = dict(mc)
    scale = mc.pop("residual_scale", None)
    det = build_detector(mc, device=device, seed=seed, dtype=dtype)
    seed_offsets(det, seed)
    if scale is not None:
        with torch.no_grad():
            for name, m in det.net.backbone.named_modules():
                if name.endswith(".bn3"):
                    m.weight.mul_(scale)
    return det


def tiny_x101_config():
    """``boosting_rcnn_x101_32x4d_pafpn_1x_utdac.py`` at the CPU tests' size
    (tests/test_torch_boosting_detectors.py): ResNeXt-50 of 2 groups of
    base width 4 at 8 base channels, PAFPN 32, RPN 32 x 2, FC 64."""
    mc = load_config(X101_CONFIG).model.to_dict()
    mc["backbone"].update(depth=50, groups=2, base_width=4, base_channels=8)
    mc["neck"].update(in_channels=[32, 64, 128, 256], out_channels=32)
    return _tiny_heads(mc)


def _tiny_res2net(name: str):
    """The family config ``name`` with Res2Net at depth 18's block counts,
    4 scales of base width 8 at 8 base channels, and the tiny heads."""
    mc = load_config(os.path.join(FAMILY, name)).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8, base_width=8)
    mc["neck"].update(in_channels=[32, 64, 128, 256], out_channels=32)
    return _tiny_heads(mc)


def tiny_r2dcn_config():
    """``boosting_rcnn_r2_101_fpn_mstrain_3x_coco.py`` (Res2Net with DCNv2 in
    stages 2-4, soft-NMS, ``reg_norm='mean'``, the RPN's IoU loss on decoded
    boxes, 80 classes), tiny (``_tiny_res2net``)."""
    return _tiny_res2net("boosting_rcnn_r2_101_fpn_mstrain_3x_coco.py")


def tiny_r2dcn_ciou_config():
    """``boosting_rcnn_r2_101_dcn_pafpn_mstrain_3x_coco.py`` (the same
    backbone, soft-NMS, and the RPN's CIoU on its encoded deltas), tiny."""
    return _tiny_res2net("boosting_rcnn_r2_101_dcn_pafpn_mstrain_3x_coco.py")


# the tiny family models checked on the GPU against the CPU and for a
# bitwise repeatable step; the CIoU-on-deltas one's bfloat16 step holds
# less (``CIOU_BF16_UNHELD``): that loss divides by an enclosing box's
# squared diagonal that degenerates to its eps (1e-7) for deltas read as
# boxes (the reference's loss, copied; in float32 the GPU's and the CPU's
# steps agree)
TINY_FAMILY = (("resnext", tiny_x101_config), ("res2net_dcn", tiny_r2dcn_config),
               ("res2net_dcn_ciou", tiny_r2dcn_ciou_config))


def _tiny_heads(mc):
    mc["rpn_head"].update(feat_channels=32, stacked_convs=2)
    mc["roi_head"]["bbox_head"]["fc_out_channels"] = 64
    mc["train_cfg"]["rpn_proposal"].update(nms_pre=200, max_per_img=64)
    mc["train_cfg"]["rcnn"]["sampler"]["num"] = 32
    mc["test_cfg"]["rpn"].update(nms_pre=100, max_per_img=32)
    return mc


def kernel_launches(counts, dtype, what: str, fwd: int, bwd: int = 0) -> None:
    """The 7 x 7 kernels of ``dtype`` launched ``fwd`` and ``bwd`` times
    (the tile keys with the gradient) and no other RoIAlign entry."""
    sfx = "" if dtype == torch.float32 else "_bf16"
    want = {"roi_align_fwd" + sfx: fwd, "roi_align_bwd" + sfx: bwd, "roi_tile_keys": bwd}
    got = ran(counts)
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def soft_nms_checks(det, batch, anchors, nla, dets, labels, valid) -> int:
    """The soft-NMS detections of ``batch``: per image the kept scores do
    not increase, and each is at most the largest pre-NMS (fused) score of
    its class over the image's RoIs.  Returns the detections checked."""
    feats, boxes, scores, pvalid = det.proposals(batch["images"], batch["img_shape"], anchors,
                                                 nla)
    with torch.inference_mode():
        cls_s, _ = det.net.roi_out(feats, boxes, pvalid)
    b, r = boxes.shape[:2]
    fused = prob_fuse_scores(cls_s.reshape(b, r, -1), scores)
    fused = torch.where(pvalid[..., None], fused, torch.zeros_like(fused))
    n = 0
    for i in range(b):
        kept = dets[i][valid[i]]
        if (kept[1:, 4] > kept[:-1, 4]).any():
            raise AssertionError("soft-NMS scores increase along the kept detections")
        bound = fused[i].max(0).values[labels[i][valid[i]]]
        if (kept[:, 4] > bound + 1e-6).any():
            raise AssertionError("a soft-NMS score is above its class's pre-NMS scores")
        n += len(kept)
    return n


def run_x101(dtype, gpu: str) -> dict:
    """ResNeXt-101 32x4d UTDAC at full width in ``dtype``: three requests
    of two 800 x 1344 images through ``predict``, then ``FAMILY_STEPS``
    train steps at the config's batch of 4 and its schedule, each path with
    the launch counts set to 0 just before it and read just after; K1 and
    K4 against their plain versions at both paths' shapes; timings, stages
    and peak memory."""
    tag = ("f32" if dtype == torch.float32 else "bf16") + " X101"
    r = {}
    mc = load_config(X101_CONFIG).model.to_dict()
    t0 = time.perf_counter()
    det = build(mc, seed=0, dtype=dtype)
    say(f"{tag} built in {time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in det.net.parameters())} float32 parameters")
    anchors, nla = det.anchors_for(CANVAS)
    strides = det.net.roi_strides
    batches = list(requests(seed=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results = [det.predict(b, anchors, nla) for b in batches]
    torch.cuda.synchronize()
    r["predict_counts"] = counts = read_counts()
    r["predict_peak"] = torch.cuda.max_memory_allocated() / 2**30
    kernel_launches(counts, dtype, f"{tag} predict", REQUESTS)
    n_dets = [check_dets(*x) for x in results]
    again = det.predict(batches[0], anchors, nla)
    if not all(torch.equal(a, b) for a, b in zip(again, results[0])):
        raise AssertionError(f"{tag}: the same request gave different detections")
    say(f"{tag} predict: {REQUESTS} requests of {BATCH} images: {n_dets} valid detections, "
        f"launches {ran(counts)}; the repeat of request 0 identical")
    feats, boxes, _, valid = det.proposals(batches[0]["images"], batches[0]["img_shape"],
                                           anchors, nla)
    c = feats[0].shape[-1]
    rs = np.random.RandomState(8)
    gp = torch.from_numpy(rs.randn(boxes.shape[0] * boxes.shape[1], 7, 7, c)
                          .astype(np.float32)).cuda()
    r["check_predict"] = kernels_vs_plain(feats, boxes, valid, strides, gp, dtype,
                                          f"{tag} predict shapes")
    del gp, feats, boxes, valid, results, again
    x = batches[1]
    r["predict_ms"] = cuda_ms(lambda: det.predict(x, anchors, nla), 5, warmup=1)
    stage = {}
    with torch.inference_mode():
        stage["features"] = cuda_ms(lambda: det.net.features(x["images"]), 5, 1)
        fts = det.net.features(x["images"])
        stage["rpn_head"] = cuda_ms(lambda: det.net.rpn_out(fts), 5, 1)
        stage["features+rpn+proposals"] = cuda_ms(
            lambda: det.proposals(x["images"], x["img_shape"], anchors, nla), 5, 1)
        _, pb, ps, pv = det.proposals(x["images"], x["img_shape"], anchors, nla)
        stage["roi_stage"] = cuda_ms(lambda: det.roi_predict(
            fts, pb, ps, pv, x["img_shape"], x["scale_factor"]), 5, 1)
    r["predict_stages"] = stage
    del fts, pb, ps, pv
    say(f"{tag} predict ({gpu}): {r['predict_ms']:.2f} ms per batch of {BATCH}; stages (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage.items())
        + f"; peak device memory {r['predict_peak']:.2f} GiB; "
        f"kernels vs plain at the predict shapes {r['check_predict']}")
    say(profile(lambda: det.predict(x, anchors, nla), f"{tag} predict profile ({gpu})"))

    step, tb, sample0 = train_setup(det, anchors, nla, X101_CONFIG)
    before = {k: v.detach().clone() for k, v in det.net.named_parameters()}
    metrics, step_ms, counts, r["train_peak"] = run_steps(step, tb, f"{tag} train",
                                                          FAMILY_STEPS)
    r["train_counts"] = counts
    kernel_launches(counts, dtype, f"{tag} train", FAMILY_STEPS, FAMILY_STEPS)
    check_moved(before, det, f"{tag} train")
    del before
    r["train_ms"] = float(np.mean(step_ms[1:]))
    r["train_parts"] = {
        "step on a given sample, cuDNN pinned": step_timing(det, anchors, nla, tb, sample0, True,
                                                            steps=2)}
    with torch.no_grad():
        feats = det.net.features(tb["images"])
    n = sample0.boxes.shape[0] * sample0.boxes.shape[1]
    g = torch.from_numpy(np.random.RandomState(6).randn(n, 7, 7, c).astype(np.float32)).cuda()
    r["check_train"] = kernels_vs_plain(feats, sample0.boxes, sample0.valid, strides, g, dtype,
                                        f"{tag} train shapes")
    say(f"{tag} train ({gpu}): {r['train_ms']:.1f} ms per step of {TRAIN_BATCH} images (mean "
        f"of steps 1-{FAMILY_STEPS - 1}), {TRAIN_BATCH * 1e3 / r['train_ms']:.2f} images/s; "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in r["train_parts"].items())
        + f"; peak device memory {r['train_peak']:.2f} GiB; kernels vs plain at the train "
        f"shapes (B*R={n}) {r['check_train']}")
    say(profile(lambda: step(tb, sample0), f"{tag} train step profile ({gpu})"))
    del det, feats, g, step, tb, sample0
    torch.cuda.empty_cache()
    return r


def run_family_config(name: str, gpu: str, seed: int = 0) -> dict:
    """One of the family's other configs at full width in bfloat16: one
    ``predict`` of ``FAMILY_BATCH`` 800 x 1344 images and one train step at
    that batch with the config's schedule, each with the counts set to 0
    before and read after; valid detections of its classes, soft-NMS
    scores non-increasing and at most the pre-NMS ones, finite losses,
    the frozen stages bit-identical and every other part moved."""
    path = os.path.join(FAMILY, name)
    tag = "bf16 " + name[len("boosting_rcnn_"):-3]
    mc = load_config(path).model.to_dict()
    num_classes = mc["roi_head"]["bbox_head"]["num_classes"]
    t0 = time.perf_counter()
    det = build(mc, seed=seed, dtype=BF16)
    n_dcn = sum(isinstance(m, DeformConv) for m in det.net.modules())
    r = {"build_s": time.perf_counter() - t0, "deform_convs": n_dcn}
    anchors, nla = det.anchors_for(CANVAS)
    batch = next(requests(seed=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    dets, labels, valid = det.predict(batch, anchors, nla)
    torch.cuda.synchronize()
    r["predict_first_ms"] = (time.perf_counter() - t0) * 1e3
    r["predict_counts"] = counts = read_counts()
    r["predict_peak"] = torch.cuda.max_memory_allocated() / 2**30
    kernel_launches(counts, BF16, f"{tag} predict", 1)
    r["detections"] = check_dets(dets, labels, valid, num_classes,
                                 det.rcnn_test_cfg.max_per_img)
    if det.rcnn_test_cfg.nms_type == "soft_nms":
        r["soft_nms_checked"] = soft_nms_checks(det, batch, anchors, nla, dets, labels, valid)
    r["predict_ms"] = cuda_ms(lambda: det.predict(batch, anchors, nla), 2, warmup=0)
    if name == DCN_PROFILED:
        say(profile(lambda: det.predict(batch, anchors, nla), f"{tag} predict profile ({gpu})"))
    tb = train_batch(9, FAMILY_BATCH, CANVAS, IMG_SHAPE, GT_PER_IMAGE, num_classes=num_classes)
    step, tb, _ = train_setup(det, anchors, nla, path, tb)
    before = {k: v.detach().clone() for k, v in det.net.named_parameters()}
    metrics, step_ms, counts, r["train_peak"] = run_steps(step, tb, f"{tag} train", 1)
    r["train_counts"] = counts
    kernel_launches(counts, BF16, f"{tag} train", 1, 1)
    r["moved"] = check_moved(before, det, f"{tag} train")
    if n_dcn and not any(not torch.equal(before[k], v) for k, v in det.net.named_parameters()
                         if "conv_offset" in k):
        raise AssertionError(f"{tag}: no offset conv moved")
    r["train_first_ms"] = step_ms[0]
    r["losses"] = metrics[0]
    say(f"{tag} ({gpu}): built in {r['build_s']:.1f} s ({n_dcn} deformable convs, offsets "
        f"seeded); predict of {BATCH} images {r['predict_first_ms']:.0f} ms first call, "
        f"{r['predict_ms']:.1f} ms after, {r['detections']} valid detections"
        + (f", {r['soft_nms_checked']} soft-NMS scores checked" if "soft_nms_checked" in r
           else "")
        + f", peak {r['predict_peak']:.2f} GiB; one train step at batch {FAMILY_BATCH} "
        f"{step_ms[0]:.0f} ms (first call), peak {r['train_peak']:.2f} GiB")
    del det, step, tb, before
    torch.cuda.empty_cache()
    return r


def c2_check(name: str, config, dtype, unpinned: bool = False) -> dict:
    """ROADMAP C.2 for the tiny model of ``config`` in ``dtype``: two tiny
    steps from one state with the cuDNN pin (bit-identical, or the run
    fails) and under ``torch.use_deterministic_algorithms`` (no op raises,
    bit-identical); with ``unpinned`` also without the pin (reported: the
    flagship's, whose float32 steps differ without it)."""
    tag = ("f32" if dtype == torch.float32 else "bf16") + " " + name
    out = {"pinned_identical": True}
    if unpinned:
        out["unpinned_identical"], differ, n_tensors = repeatable_step(
            11, dtype, deterministic=False, config=config)
        say(f"C.2 {tag}: two tiny steps from one state without the cuDNN pin: bit-identical "
            f"{out['unpinned_identical']} ({len(differ)} of {n_tensors} metrics, gradients "
            f"and parameters differ{': ' + ', '.join(differ[:4]) if differ else ''})")
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
    say(f"C.2 {tag}: with the pin, the losses, every gradient, parameter and buffer of two "
        f"steps are bit-identical; under torch.use_deterministic_algorithms(True) no op "
        f"raised and the steps are bit-identical")
    return {tag: out}


# ------------------------------------------------------------------ cascade
CASCADE_CONFIG = os.path.join(REPO, "configs/ensemble/prob_cascade_rcnn_r50_pafpn_1x_utdac.py")
CASCADE_COCO_CONFIG = os.path.join(REPO, "configs/cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py")
CASCADE_STEPS = 3  # the ProbCascade's train steps: step 0 warms up, steps 1-2 are timed


def tiny_cascade_config():
    """The ProbCascade as ``--tiny`` shrinks it (``engine.runner.
    shrink_model``): ResNet-18 at width 8, PAFPN 32, ATSS RPN 32 x 2, FC 64
    in each stage, 32 RoIs a stage."""
    return shrink_model(load_config(CASCADE_CONFIG).model.to_dict())


def cascade_stage_rois(det, feats, boxes, valid, img_shape, stage: int):
    """The RoIs that stage ``stage`` of ``predict`` pools: the proposals
    refined by each stage before it (boxes clamped to the image, some
    degenerate)."""
    b, r = boxes.shape[:2]
    rois = boxes
    with torch.inference_mode():
        for s in range(stage):
            cls_s, reg_s = det.net.roi_out(feats, rois, valid, s)
            rois = refine_boxes(stage_head_cfg(det.bbox_cfg, s), rois,
                                cls_s.reshape(b, r, -1).float(), reg_s.reshape(b, r, -1).float(),
                                img_shape)
    return rois


def edge_rois(rois, valid) -> str:
    """How many valid RoIs are degenerate (no width or height) and how many
    touch the image's border, of how many."""
    v = rois[valid]
    flat_ = ((v[:, 2] <= v[:, 0]) | (v[:, 3] <= v[:, 1])).sum().item()
    h, w = IMG_SHAPE
    border = ((v[:, 0] <= 0) | (v[:, 1] <= 0) | (v[:, 2] >= w) | (v[:, 3] >= h)).sum().item()
    return f"{len(v)} valid RoIs, {flat_} degenerate, {border} on the image's border"


def run_cascade(dtype, gpu: str) -> dict:
    """The ProbCascade UTDAC at full width in ``dtype``: three requests of
    two 800 x 1344 images through ``predict`` (K1 of the dtype once a stage
    and request), then ``CASCADE_STEPS`` train steps at the config's batch
    of 4 and its schedule (K1, the tile keys and K4 once a stage and step),
    each path with the launch counts set to 0 just before it and read just
    after; K1 and K4 against their plain versions at stage 2's RoIs (twice
    refined) of a request and of a step, and timed there; times, stages and
    peak memory."""
    tag = ("f32" if dtype == torch.float32 else "bf16") + " ProbCascade"
    r = {}
    mc = load_config(CASCADE_CONFIG).model.to_dict()
    t0 = time.perf_counter()
    det = build(mc, seed=0, dtype=dtype)
    n = det.cascade_cfg.num_stages
    say(f"{tag} built in {time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in det.net.parameters())} float32 parameters, {n} stages")
    anchors, nla = det.anchors_for(CANVAS)
    strides = det.net.roi_strides
    batches = list(requests(seed=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results = [det.predict(b, anchors, nla) for b in batches]
    torch.cuda.synchronize()
    r["predict_counts"] = counts = read_counts()
    r["predict_peak"] = torch.cuda.max_memory_allocated() / 2**30
    kernel_launches(counts, dtype, f"{tag} predict", n * REQUESTS)
    n_dets = [check_dets(*x) for x in results]
    again = det.predict(batches[0], anchors, nla)
    if not all(torch.equal(a, b) for a, b in zip(again, results[0])):
        raise AssertionError(f"{tag}: the same request gave different detections")
    x = batches[0]
    feats, boxes, _, valid = det.proposals(x["images"], x["img_shape"], anchors, nla)
    rois2 = cascade_stage_rois(det, feats, boxes, valid, x["img_shape"], 2)
    c = feats[0].shape[-1]
    m = rois2.shape[0] * rois2.shape[1]
    gp = torch.from_numpy(np.random.RandomState(8).randn(m, 7, 7, c).astype(np.float32)).cuda()
    route = list(feats[:len(strides)])
    r["check_predict"] = kernels_vs_plain(route, rois2, valid, strides, gp, dtype,
                                          f"{tag} stage-2 predict shapes")
    r["predict_shapes"] = timed_kernels(
        batched_multilevel_roi_align,
        lambda: batched_multilevel_roi_align(route, rois2, valid, strides),
        route, rois2, valid, strides, gp, dtype)
    say(f"{tag} predict: {REQUESTS} requests of {BATCH} images: {n_dets} valid detections, "
        f"launches {ran(counts)}; the repeat of request 0 identical; stage 2's RoIs "
        f"(B*R={m}: {edge_rois(rois2, valid)}) kernels vs plain {r['check_predict']}")
    say_timed(r["predict_shapes"], f"{tag} at stage 2's predict shapes", gpu)
    del feats, route, boxes, valid, rois2, gp, results, again
    x = batches[1]
    r["predict_ms"] = cuda_ms(lambda: det.predict(x, anchors, nla), 5, warmup=1)
    stage = {}
    with torch.inference_mode():
        stage["features+rpn+proposals"] = cuda_ms(
            lambda: det.proposals(x["images"], x["img_shape"], anchors, nla), 5, 1)
        fts, pb, ps, pv = det.proposals(x["images"], x["img_shape"], anchors, nla)
        stage["roi_stages"] = cuda_ms(lambda: det.roi_predict(
            fts, pb, ps, pv, x["img_shape"], x["scale_factor"]), 5, 1)
    r["predict_stages"] = stage
    del fts, pb, ps, pv
    say(f"{tag} predict ({gpu}): {r['predict_ms']:.2f} ms per batch of {BATCH}; stages (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage.items())
        + f"; peak device memory over the requests {r['predict_peak']:.2f} GiB")

    step, tb, _ = train_setup(det, anchors, nla, CASCADE_CONFIG)
    before = {k: v.detach().clone() for k, v in det.net.named_parameters()}
    metrics, step_ms, counts, r["train_peak"] = run_steps(step, tb, f"{tag} train",
                                                          CASCADE_STEPS)
    r["train_counts"] = counts
    kernel_launches(counts, dtype, f"{tag} train", n * CASCADE_STEPS, n * CASCADE_STEPS)
    r["moved"] = check_moved(before, det, f"{tag} train",
                             heads=tuple(f"bbox_heads.{i}." for i in range(n)))
    del before
    r["train_ms"] = float(np.mean(step_ms[1:]))
    samples = det.stage_samples(tb, anchors, nla,
                                generator=torch.Generator(device="cuda").manual_seed(5))
    with torch.no_grad():
        feats = list(det.net.features(tb["images"])[:len(strides)])
    s2 = samples[2]
    m = s2.boxes.shape[0] * s2.boxes.shape[1]
    g = torch.from_numpy(np.random.RandomState(6).randn(m, 7, 7, c).astype(np.float32)).cuda()
    r["check_train"] = kernels_vs_plain(feats, s2.boxes, s2.valid, strides, g, dtype,
                                        f"{tag} stage-2 train shapes")
    r["train_shapes"] = timed_kernels(
        batched_multilevel_roi_align,
        lambda: batched_multilevel_roi_align(feats, s2.boxes, s2.valid, strides),
        feats, s2.boxes, s2.valid, strides, g, dtype)
    say(f"{tag} train ({gpu}): {r['train_ms']:.1f} ms per step of {TRAIN_BATCH} images (mean "
        f"of steps 1-{CASCADE_STEPS - 1}), {TRAIN_BATCH * 1e3 / r['train_ms']:.2f} images/s; "
        f"peak device memory {r['train_peak']:.2f} GiB; stage 2's sampled slots (B*R={m}: "
        f"{edge_rois(s2.boxes, s2.valid)}, {int(s2.is_pos.sum())} positive) kernels vs "
        f"plain {r['check_train']}")
    say_timed(r["train_shapes"], f"{tag} at stage 2's train shapes", gpu)
    del det, feats, g, step, tb, samples, s2
    torch.cuda.empty_cache()
    return r


def run_cascade_coco(gpu: str, seed: int = 0) -> dict:
    """Cascade R-CNN R50-FPN COCO at full width in bfloat16: one ``predict``
    of ``FAMILY_BATCH`` 800 x 1344 images (1000 proposals an image, so 2000
    RoIs a stage) and one train step at that batch with the config's
    schedule, each with the counts set to 0 before and read after; K1 and
    K4 against their plain versions at stage 2's predict RoIs."""
    tag = "bf16 Cascade R-CNN COCO"
    mc = load_config(CASCADE_COCO_CONFIG).model.to_dict()
    t0 = time.perf_counter()
    det = build(mc, seed=seed, dtype=BF16)
    n = det.cascade_cfg.num_stages
    r = {"build_s": time.perf_counter() - t0}
    anchors, nla = det.anchors_for(CANVAS)
    batch = next(requests(seed=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    dets, labels, valid = det.predict(batch, anchors, nla)
    torch.cuda.synchronize()
    r["predict_first_ms"] = (time.perf_counter() - t0) * 1e3
    r["predict_counts"] = counts = read_counts()
    r["predict_peak"] = torch.cuda.max_memory_allocated() / 2**30
    kernel_launches(counts, BF16, f"{tag} predict", n)
    r["detections"] = check_dets(dets, labels, valid, 80, det.rcnn_test_cfg.max_per_img)
    r["predict_ms"] = cuda_ms(lambda: det.predict(batch, anchors, nla), 2, warmup=0)
    feats, boxes, _, pvalid = det.proposals(batch["images"], batch["img_shape"], anchors, nla)
    rois2 = cascade_stage_rois(det, feats, boxes, pvalid, batch["img_shape"], 2)
    m = rois2.shape[0] * rois2.shape[1]
    gp = torch.from_numpy(np.random.RandomState(8).randn(m, 7, 7, feats[0].shape[-1])
                          .astype(np.float32)).cuda()
    strides = det.net.roi_strides
    r["check_predict"] = kernels_vs_plain(list(feats[:len(strides)]), rois2, pvalid, strides, gp,
                                          BF16, f"{tag} stage-2 predict shapes")
    edges = edge_rois(rois2, pvalid)
    del feats, boxes, pvalid, gp, rois2
    tb = train_batch(9, FAMILY_BATCH, CANVAS, IMG_SHAPE, GT_PER_IMAGE, num_classes=80)
    step, tb, _ = train_setup(det, anchors, nla, CASCADE_COCO_CONFIG, tb)
    before = {k: v.detach().clone() for k, v in det.net.named_parameters()}
    metrics, step_ms, counts, r["train_peak"] = run_steps(step, tb, f"{tag} train", 1)
    r["train_counts"] = counts
    kernel_launches(counts, BF16, f"{tag} train", n, n)
    r["moved"] = check_moved(before, det, f"{tag} train",
                             heads=tuple(f"bbox_heads.{i}." for i in range(n)))
    r["train_first_ms"] = step_ms[0]
    r["losses"] = metrics[0]
    say(f"{tag} ({gpu}): built in {r['build_s']:.1f} s; predict of {BATCH} images "
        f"{r['predict_first_ms']:.0f} ms first call, {r['predict_ms']:.1f} ms after, "
        f"{r['detections']} valid detections, peak {r['predict_peak']:.2f} GiB; stage 2's "
        f"RoIs (B*R={m}: {edges}) kernels vs plain {r['check_predict']}; one train step at "
        f"batch {FAMILY_BATCH} {step_ms[0]:.0f} ms (first call), peak {r['train_peak']:.2f} GiB")
    del det, step, tb, before
    torch.cuda.empty_cache()
    return r


def cascade_phase(gpu: str) -> dict:
    """The phase "cascade" at full width: the ProbCascade UTDAC in float32
    and bfloat16 (``run_cascade``) and Cascade R-CNN COCO in bfloat16
    (``run_cascade_coco``); its tiny checks are ``cascade_tiny``'s."""
    t0 = time.perf_counter()
    out = {"utdac": {d: run_cascade(d, gpu) for d in (torch.float32, BF16)},
           "coco": run_cascade_coco(gpu)}
    out["wall_s"] = time.perf_counter() - t0
    say(f"phase cascade: {out['wall_s']:.1f} s")
    return out


def cascade_tiny() -> dict:
    """The phase "cascade"'s checks without timings: the tiny
    ProbCascade's ``predict`` and train step on the GPU against the CPU in
    both dtypes, each step rule's teeth, and its C.2 check."""
    tiny = {"predict_detections": tiny_gpu_matches_cpu(3, tiny_cascade_config)}
    errs, match = tiny_bf16_gpu_matches_cpu(3, tiny_cascade_config)
    tiny["bf16_predict"] = {"level_errs": errs, "match": match}
    for dtype in (torch.float32, BF16):
        m, worst, repeat, summary = tiny_train_gpu_matches_cpu(7, dtype, tiny_cascade_config)
        tiny["f32" if dtype == torch.float32 else "bf16"] = {
            "loss": m["loss"], "worst_of_tolerance": worst, **summary,
            "repeat_identical": repeat}
    tiny["wrong_step_breaks"] = wrong_step_broken(tiny_cascade_config, WRONG_K4_CAUGHT)
    tiny["wrong_f32_step_breaks"] = wrong_step_broken(tiny_cascade_config, WRONG_K4_CAUGHT,
                                                      dtype=torch.float32)
    for tag in ("wrong_step_breaks", "wrong_f32_step_breaks"):
        if not tiny[tag]:
            raise AssertionError(f"the step rule holds for the tiny ProbCascade's step with "
                                 f"level 0's K4 gradient x {WRONG_K4_CAUGHT} ({tag})")
    say(f"tiny ProbCascade: GPU predict matches CPU predict ({tiny['predict_detections']} "
        f"detections); bf16 levels and roi_predict on the CPU's: {tiny['bf16_predict']}; one "
        f"train step on the GPU against the CPU: f32 {tiny['f32']}, bf16 {tiny['bf16']}; with "
        f"level 0's K4 gradient x {WRONG_K4_CAUGHT} the bf16 step rule breaks: "
        f"{tiny['wrong_step_breaks']}")
    out = {"tiny": tiny, "repeat": {}}
    for dtype in (torch.float32, BF16):
        out["repeat"].update(c2_check("prob_cascade", tiny_cascade_config, dtype))
    return out


# ---------------------------------------------------------------------- HTC
HTC_CONFIG = os.path.join(REPO, "configs/htc/htc_r50_fpn_1x_coco.py")
CASCADE_MASK_CONFIG = os.path.join(REPO, "configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py")
HTC_STEPS = 3  # step 0 warms up, steps 1-2 are timed
SEMANTIC_STRIDE = 8


def stuff_map(seed: int, b: int, canvas, num_classes: int) -> np.ndarray:
    """A seeded ``(b, H/8, W/8)`` stuff map: blocks of 8 x 8 cells of random
    classes, and a band of ignored (255) rows in each image."""
    rs = np.random.RandomState(seed + 2)
    h, w = -(-canvas[0] // SEMANTIC_STRIDE), -(-canvas[1] // SEMANTIC_STRIDE)
    blocks = rs.randint(0, num_classes, (b, -(-h // 8), -(-w // 8)))
    seg = np.repeat(np.repeat(blocks, 8, 1), 8, 2)[:, :h, :w].astype(np.int64)
    for i in range(b):
        top = rs.randint(0, h - 2)
        seg[i, top:top + 2] = 255
    return seg


def htc_train_batch(seed: int, b: int, stuff_classes: int = 0):
    """``mask_train_batch`` at the full canvas with 80 classes and, for a
    semantic head, a stuff map of ``stuff_classes`` (``stuff_map``)."""
    tb = mask_train_batch(seed, b, CANVAS, IMG_SHAPE, GT_PER_IMAGE, num_classes=80)
    if stuff_classes:
        tb["gt_semantic_seg"] = stuff_map(seed, b, CANVAS, stuff_classes)
    return tb


def htc_launches(counts, dtype, what: str, fwd: int, fwd14: int, bwd: int = 0,
                 bwd14: int = 0) -> None:
    """Exactly these launches of the kernels of ``dtype`` at 7 and 14 (the
    tile keys with each gradient) and no other RoIAlign entry."""
    sfx = "" if dtype == torch.float32 else "_bf16"
    want = {f"roi_align_fwd{sfx}": fwd, f"roi_align_fwd{sfx}_o14": fwd14,
            f"roi_align_bwd{sfx}": bwd, f"roi_align_bwd{sfx}_o14": bwd14,
            "roi_tile_keys": bwd, "roi_tile_keys_o14": bwd14}
    want = {k: v for k, v in want.items() if v}
    if ran(counts) != want:
        raise AssertionError(f"{what}: launches {ran(counts)}, expected {want}")


def semantic_kernels(sem, rois, valid, out_size: int, dtype, seed: int, what: str,
                     gpu: str) -> dict:
    """K1 and K4 at ``out_size`` on the one semantic level ``sem`` ``(B, h,
    w, C)`` (every RoI routed to it) against their plain versions, their
    times and bounds, and the gradient's RoIs per tile."""
    strides = (SEMANTIC_STRIDE,)
    m = rois.shape[0] * rois.shape[1]
    g = torch.from_numpy(np.random.RandomState(seed).randn(m, out_size, out_size, sem.shape[-1])
                         .astype(np.float32)).cuda()
    level = [sem.detach().contiguous()]
    check = kernels_vs_plain(level, rois, valid, strides, g, dtype, what)
    timed = timed_kernels(
        batched_multilevel_roi_align,
        lambda: batched_multilevel_roi_align(level, rois, valid, strides, out_size=out_size,
                                             num_route_levels=1),
        level, rois, valid, strides, g, dtype)
    spread = tile_spread(level, rois, valid, strides, out_size)
    say(f"{what}: {m} RoI slots ({int(valid.sum())} valid) on the semantic level "
        f"{tuple(sem.shape)}, kernels vs plain {check}")
    say_timed(timed, what, gpu)
    say_spread(spread, what)
    return {"check": check, "timed": timed, "spread": spread, "rois": m,
            "valid": int(valid.sum()), "level": list(sem.shape)}


def run_htc(dtype, gpu: str) -> dict:
    """HTC R50-FPN with the semantic branch at full width in ``dtype``:
    ``REQUESTS`` requests of two 800 x 1344 images through ``predict``
    (K1 at 7 six times a request: three stages, each on the pyramid and on
    the semantic level; K1 at 14 twice: the detections on both), then
    ``HTC_STEPS`` train steps at the config's batch of 2 with ellipse gt
    masks and a stuff map (K1, K4 and the tile keys at 7 and at 14 six
    times a step each), each path with the counts set to 0 just before it
    and read just after; the masks, the repeat, every head moved; K1 and K4
    at 7 and 14 on the one semantic level against their plain versions at
    the shapes of a request and of a step, and timed there."""
    tag = ("f32" if dtype == torch.float32 else "bf16") + " HTC"
    r = {}
    mc = load_config(HTC_CONFIG).model.to_dict()
    t0 = time.perf_counter()
    det = build(mc, seed=0, dtype=dtype)
    n = det.cascade_cfg.num_stages
    r["build_s"] = time.perf_counter() - t0
    anchors, nla = det.anchors_for(CANVAS)
    batches = list(requests(seed=31))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results = [det.predict(b, anchors, nla) for b in batches]
    torch.cuda.synchronize()
    r["predict_counts"] = counts = read_counts()
    r["predict_peak"] = torch.cuda.max_memory_allocated() / 2**30
    htc_launches(counts, dtype, f"{tag} predict", 2 * n * REQUESTS, 2 * REQUESTS)
    n_dets = [check_dets(*x[:3], num_classes=80) for x in results]
    if not all(n_dets):
        raise AssertionError(f"{tag}: a request kept no detection for the mask branch: {n_dets}")
    for x in results:
        check_masks(x[3])
    again = det.predict(batches[0], anchors, nla)
    if not all(torch.equal(a, b) for a, b in zip(again, results[0])):
        raise AssertionError(f"{tag}: the same request gave different detections or masks")
    say(f"{tag} predict: {REQUESTS} requests of {BATCH} images: {n_dets} valid detections, "
        f"masks (2, 100, 28, 28) float32 in [0, 1]; launches {ran(counts)}; the repeat of "
        "request 0 identical")
    x = batches[0]
    with torch.inference_mode():
        feats, boxes, scores, valid = det.proposals(x["images"], x["img_shape"], anchors, nla)
        sem = det.net.semantic_out(feats)[1]
        dets, _, dvalid = det.roi_predict(feats, boxes, scores, valid, x["img_shape"],
                                          x["scale_factor"], sem_feat=sem)
    mrois = (dets[..., :4] * x["scale_factor"][:, None, :]).contiguous()
    r["sem_predict_7"] = semantic_kernels(sem, boxes, valid, 7, dtype, 32, f"{tag} predict "
                                          "proposals at 7", gpu)
    r["sem_predict_14"] = semantic_kernels(sem, mrois, dvalid, 14, dtype, 33,
                                           f"{tag} predict detections at 14", gpu)
    del feats, boxes, scores, valid, sem, dets, dvalid, mrois, results, again
    x = batches[1]
    r["predict_ms"] = cuda_ms(lambda: det.predict(x, anchors, nla), 3, warmup=1)
    stage = {}
    with torch.inference_mode():
        stage["features+rpn+proposals"] = cuda_ms(
            lambda: det.proposals(x["images"], x["img_shape"], anchors, nla), 3, 1)
        fts, pb, ps, pv = det.proposals(x["images"], x["img_shape"], anchors, nla)
        stage["semantic_head"] = cuda_ms(lambda: det.net.semantic_out(fts), 3, 1)
        sem = det.net.semantic_out(fts)[1]
        stage["roi_stages"] = cuda_ms(lambda: det.roi_predict(
            fts, pb, ps, pv, x["img_shape"], x["scale_factor"], sem_feat=sem), 3, 1)
        dets, _, dvalid = det.roi_predict(fts, pb, ps, pv, x["img_shape"], x["scale_factor"],
                                          sem_feat=sem)
        stage["mask_stages"] = cuda_ms(lambda: det.net.mask_out_all_stages(
            fts, dets[..., :4] * x["scale_factor"][:, None, :], dvalid, sem), 3, 1)
    r["predict_stages"] = stage
    del fts, pb, ps, pv, sem, dets, dvalid
    say(f"{tag} predict ({gpu}): {r['predict_ms']:.2f} ms per batch of {BATCH}; stages (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage.items())
        + f"; peak device memory over the requests {r['predict_peak']:.2f} GiB")

    tb = htc_train_batch(35, MASK_TRAIN_BATCH, mc["roi_head"]["semantic_head"]["num_classes"])
    step, tb, _ = train_setup(det, anchors, nla, HTC_CONFIG, tb)
    before = {k: v.detach().clone() for k, v in det.net.named_parameters()}
    metrics, step_ms, counts, r["train_peak"] = run_steps(step, tb, f"{tag} train", HTC_STEPS)
    r["train_counts"] = counts
    k = 2 * n * HTC_STEPS
    htc_launches(counts, dtype, f"{tag} train", k, k, k, k)
    heads = tuple(f"{h}.{i}." for h in ("bbox_heads", "mask_heads") for i in range(n))
    r["moved"] = check_moved(before, det, f"{tag} train",
                             heads=heads + tuple(f"mask_heads.{i}.conv_res." for i in (1, 2))
                             + ("semantic_head.",))
    del before
    r["train_ms"] = float(np.mean(step_ms[1:]))
    r["losses"] = metrics[-1]
    gen = torch.Generator(device="cuda").manual_seed(5)
    samples = det.stage_samples(tb, anchors, nla, generator=gen)
    msamples = det.mask_samples(tb, anchors, nla, generator=gen)
    with torch.no_grad():
        sem = det.net.semantic_out(det.net.features(tb["images"]))[1]
    s0, m0 = samples[0], msamples[0]
    r["sem_train_7"] = semantic_kernels(sem, s0.boxes, s0.valid, 7, dtype, 36,
                                        f"{tag} stage-0 train slots at 7", gpu)
    r["sem_train_14"] = semantic_kernels(sem, m0.boxes, m0.valid & m0.is_pos, 14, dtype, 37,
                                         f"{tag} stage-0 mask slots at 14", gpu)
    say(f"{tag} train ({gpu}): {r['train_ms']:.1f} ms per step of {MASK_TRAIN_BATCH} images "
        f"(mean of steps 1-{HTC_STEPS - 1}); peak device memory {r['train_peak']:.2f} GiB; "
        f"launches {ran(counts)}")
    del det, step, tb, samples, msamples, sem
    torch.cuda.empty_cache()
    return r


def run_cascade_mask(gpu: str, seed: int = 0) -> dict:
    """Cascade Mask R-CNN R50-FPN at full width in bfloat16 (neither
    interleaved nor with information flow): one ``predict`` of two 800 x
    1344 images (K1 at 7 once a stage, at 14 once) and one train step at
    batch 2 with ellipse gt masks (K1, K4 and the tile keys at 7 and at
    14 once a stage each), counts set to 0 before each and read after."""
    tag = "bf16 Cascade Mask R-CNN"
    mc = load_config(CASCADE_MASK_CONFIG).model.to_dict()
    t0 = time.perf_counter()
    det = build(mc, seed=seed, dtype=BF16)
    n = det.cascade_cfg.num_stages
    r = {"build_s": time.perf_counter() - t0}
    anchors, nla = det.anchors_for(CANVAS)
    batch = next(requests(seed=38))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = det.predict(batch, anchors, nla)
    torch.cuda.synchronize()
    r["predict_first_ms"] = (time.perf_counter() - t0) * 1e3
    r["predict_counts"] = counts = read_counts()
    r["predict_peak"] = torch.cuda.max_memory_allocated() / 2**30
    htc_launches(counts, BF16, f"{tag} predict", n, 1)
    r["detections"] = check_dets(*out[:3], num_classes=80)
    if not r["detections"]:
        raise AssertionError(f"{tag}: no detection reached the mask branch")
    check_masks(out[3])
    r["predict_ms"] = cuda_ms(lambda: det.predict(batch, anchors, nla), 2, warmup=0)
    tb = htc_train_batch(39, MASK_TRAIN_BATCH)
    step, tb, _ = train_setup(det, anchors, nla, CASCADE_MASK_CONFIG, tb)
    before = {k: v.detach().clone() for k, v in det.net.named_parameters()}
    metrics, step_ms, counts, r["train_peak"] = run_steps(step, tb, f"{tag} train", 1)
    r["train_counts"] = counts
    htc_launches(counts, BF16, f"{tag} train", n, n, n, n)
    r["moved"] = check_moved(before, det, f"{tag} train", heads=tuple(
        f"{h}.{i}." for h in ("bbox_heads", "mask_heads") for i in range(n)))
    r["train_first_ms"] = step_ms[0]
    r["losses"] = metrics[0]
    say(f"{tag} ({gpu}): built in {r['build_s']:.1f} s; predict of {BATCH} images "
        f"{r['predict_first_ms']:.0f} ms first call, {r['predict_ms']:.1f} ms after, "
        f"{r['detections']} valid detections with masks, peak {r['predict_peak']:.2f} GiB; one "
        f"train step at batch {MASK_TRAIN_BATCH} {step_ms[0]:.0f} ms (first call), peak "
        f"{r['train_peak']:.2f} GiB")
    del det, step, tb, before
    torch.cuda.empty_cache()
    return r


def tiny_htc_config():
    """HTC with the semantic branch at the CPU tests' size
    (tests/test_torch_htc.py, the JAX package's own tiny HTC): ResNet-18
    at width 8, FPN and RPN 16, FC 16, 4 classes, one 8-channel conv a mask
    head, the semantic head 16 channels, one conv, 6 stuff classes; 32
    train and 16 test proposals, 8 RoIs a stage."""
    mc = load_config(HTC_CONFIG).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"].update(in_channels=[8, 16, 32, 64], out_channels=16)
    mc["rpn_head"].update(feat_channels=16)
    for h in mc["roi_head"]["bbox_head"]:
        h.update(fc_out_channels=16, num_classes=4)
    for h in mc["roi_head"]["mask_head"]:
        h.update(num_classes=4, conv_out_channels=8, num_convs=1)
    mc["roi_head"]["semantic_head"].update(num_classes=6, conv_out_channels=16, num_convs=1)
    mc["train_cfg"]["rpn_proposal"].update(nms_pre=64, max_per_img=32)
    for rc in mc["train_cfg"]["rcnn"]:
        rc["sampler"]["num"] = 8
    mc["test_cfg"]["rpn"].update(nms_pre=48, max_per_img=16)
    return mc


def htc_phase(gpu: str) -> dict:
    """The phase "htc" at full width: HTC with the semantic branch in
    float32 and bfloat16 (``run_htc``) and Cascade Mask R-CNN in bfloat16
    (``run_cascade_mask``); its tiny checks are ``htc_tiny``'s."""
    t0 = time.perf_counter()
    out = {"htc": {d: run_htc(d, gpu) for d in (torch.float32, BF16)},
           "cascade_mask": run_cascade_mask(gpu)}
    out["wall_s"] = time.perf_counter() - t0
    say(f"phase htc: {out['wall_s']:.1f} s")
    return out


def htc_tiny() -> dict:
    """The phase "htc"'s checks without timings: the tiny HTC's
    ``predict`` and float32 and bfloat16 train steps on the GPU against the
    CPU, the float32 step rule's teeth (level 0's K4 gradient dropped
    breaks it), and its C.2 check."""
    tiny = {"predict_detections": tiny_gpu_matches_cpu(3, tiny_htc_config)}
    for dtype in (torch.float32, BF16):
        m, worst, repeat, summary = tiny_train_gpu_matches_cpu(7, dtype, tiny_htc_config)
        tiny["f32" if dtype == torch.float32 else "bf16"] = {
            "loss": m["loss"], "worst_of_tolerance": worst, **summary,
            "repeat_identical": repeat}
    tiny["wrong_f32_step_breaks"] = wrong_step_broken(tiny_htc_config, WRONG_K4_CAUGHT,
                                                      dtype=torch.float32)
    if not tiny["wrong_f32_step_breaks"]:
        raise AssertionError(f"the f32 step rule holds for the tiny HTC's step with level 0's "
                             f"K4 gradient x {WRONG_K4_CAUGHT}")
    say(f"tiny HTC: GPU predict matches CPU predict ({tiny['predict_detections']} detections, "
        f"masks within 1e-4); one train step on the GPU against the CPU: f32 {tiny['f32']}, "
        f"bf16 {tiny['bf16']}; with level 0's K4 gradient x {WRONG_K4_CAUGHT} the f32 step rule "
        f"breaks: {tiny['wrong_f32_step_breaks'][:3]}")
    out = {"tiny": tiny, "repeat": {}}
    for dtype in (torch.float32, BF16):
        out["repeat"].update(c2_check("htc", tiny_htc_config, dtype))
    return out


# --------------------------------------------------------------- fork heads
DYNAMIC_CONFIG = os.path.join(REPO, "configs/dynamic_rcnn/dynamic_rcnn_r50_fpn_1x_coco.py")
ATSS_CONFIG = os.path.join(REPO, "configs/ensemble/cascade_atss_r50_fpn_1x_coco.py")
# the fork's other ensemble configs, each one predict and one step in bfloat16
FORK_BF16 = tuple(os.path.join(REPO, "configs", n) for n in (
    "ensemble/cascade_atss_s2_r50_fpn_1x_coco.py", "ensemble/cascade_retinanet_r50_fpn_1x_coco.py",
    "ensemble/cascade_retinanet_s2_r50_fpn_1x_coco.py",
    "ensemble/boosting_rcnn_r50_fpn_1x_coco.py"))
DYNAMIC_STEPS = 3  # the config as it is: no boundary of its 100-step ring
DYN_STATE = ("dyn_iou_thr", "dyn_beta", "dyn_iou_hist", "dyn_beta_hist", "dyn_count")
TINY_DYN_STEPS = 4
TINY_DYN_INITIAL_IOU = 0.3  # the tiny model's proposals reach IoU 0.25-0.55 (tests)


def stage_count(det) -> int:
    return det.cascade_cfg.num_stages if isinstance(det, CascadeDetector) else 1


def atss_devices_agree(det_gpu, batch, anchors, nla) -> int:
    """ATSS assignment of ``batch``'s gts over ``anchors`` (each level's
    count ``nla``) on the card and on the CPU: ``gt_inds`` equal image by
    image (ties in the levels' distances broken alike).  Returns the
    positives."""
    cfg = det_gpu.rpn_cfg
    pos = 0
    for i in range(len(batch["gt_bboxes"])):
        gi = {}
        for d in ("cpu", "cuda"):
            a = torch.as_tensor(anchors, device=d)
            gi[d] = atss_assign(a, torch.ones_like(a[:, 0], dtype=torch.bool), nla,
                                torch.as_tensor(batch["gt_bboxes"][i], device=d),
                                torch.as_tensor(batch["gt_mask"][i], device=d),
                                topk=cfg.atss_topk).gt_inds.cpu()
        if not torch.equal(gi["cpu"], gi["cuda"]):
            raise AssertionError(f"ATSS gt_inds differ between the card and the CPU at "
                                 f"{int((gi['cpu'] != gi['cuda']).sum())} anchors (image {i})")
        pos += int((gi["cpu"] > 0).sum())
    return pos


def run_fork(path: str, dtype, gpu: str, n_requests: int = 1, n_steps: int = 1,
             check: bool = False) -> dict:
    """The config at ``path`` at full width in ``dtype`` with seeded random
    weights: ``n_requests`` requests of two 800 x 1344 images through
    ``predict`` (K1 of the dtype once a stage and request), then
    ``n_steps`` train steps at batch 2 with its schedule (K1, the tile keys
    and K4 once a stage and step), each path with the counts set to 0
    before and read after, exact; valid detections of its classes, finite
    and positive losses, the frozen stages bit-identical and every other
    part moved.  An ATSS RPN's assignment of the step's gts over the
    full-width anchors is the same on the card as on the CPU.  Dynamic
    R-CNN's state after the steps: ``dyn_count`` the steps, that many ring
    slots finite, the IoU threshold and beta at their initial 0.4 and 1.0
    (no boundary of the config's ring of 100).  With ``check``, K1 and K4
    against their plain versions at the last stage's predict RoIs."""
    name = os.path.relpath(path, os.path.join(REPO, "configs"))
    tag = ("f32 " if dtype == torch.float32 else "bf16 ") + name[:-3]
    mc = load_config(path).model.to_dict()
    t0 = time.perf_counter()
    det = build(mc, seed=0, dtype=dtype)
    n = stage_count(det)
    r = {"build_s": time.perf_counter() - t0, "stages": n}
    anchors, nla = det.anchors_for(CANVAS)
    batches = list(requests(seed=2))[:n_requests]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    predict_ms, results = [], []
    for b in batches:
        t0 = time.perf_counter()
        results.append(det.predict(b, anchors, nla))
        torch.cuda.synchronize()
        predict_ms.append((time.perf_counter() - t0) * 1e3)
    r["predict_counts"] = counts = read_counts()
    r["predict_peak"] = torch.cuda.max_memory_allocated() / 2**30
    kernel_launches(counts, dtype, f"{tag} predict", n * n_requests)
    r["predict_first_ms"], r["predict_ms"] = predict_ms[0], float(np.mean(predict_ms[1:] or
                                                                           predict_ms))
    r["detections"] = [check_dets(*x, det.bbox_cfg.num_classes, det.rcnn_test_cfg.max_per_img)
                       for x in results]
    if check:
        x = batches[0]
        feats, boxes, _, valid = det.proposals(x["images"], x["img_shape"], anchors, nla)
        strides = det.net.roi_strides
        rois = (cascade_stage_rois(det, feats, boxes, valid, x["img_shape"], n - 1)
                if n > 1 else boxes)
        m = rois.shape[0] * rois.shape[1]
        g = torch.from_numpy(np.random.RandomState(8).randn(m, 7, 7, feats[0].shape[-1])
                             .astype(np.float32)).cuda()
        r["check_predict"] = kernels_vs_plain(list(feats[:len(strides)]), rois, valid, strides,
                                              g, dtype, f"{tag} stage-{n - 1} predict shapes")
        r["check_rois"] = edge_rois(rois, valid)
        del feats, boxes, valid, rois, g
    del results
    tb = train_batch(9, FAMILY_BATCH, CANVAS, IMG_SHAPE, GT_PER_IMAGE,
                     num_classes=det.bbox_cfg.num_classes)
    if getattr(det.rpn_cfg, "atss", False):
        r["atss_positives"] = atss_devices_agree(det, tb, anchors, nla)
        r["anchors"] = int(anchors.shape[0])
    step, tb, _ = train_setup(det, anchors, nla, path, tb)
    before = {k: v.detach().clone() for k, v in det.net.named_parameters()}
    metrics, step_ms, counts, r["train_peak"] = run_steps(step, tb, f"{tag} train", n_steps)
    r["train_counts"] = counts
    kernel_launches(counts, dtype, f"{tag} train", n * n_steps, n * n_steps)
    r["moved"] = check_moved(before, det, f"{tag} train", heads=tuple(
        f"bbox_heads.{i}." for i in range(n)) if n > 1 else ("bbox_head.",))
    r["train_first_ms"], r["train_ms"] = step_ms[0], float(np.mean(step_ms[1:] or step_ms))
    r["losses"] = metrics[-1]
    if isinstance(det, DynamicRCNNDetector):
        head = det.net.bbox_head
        state = {k: getattr(head, k).cpu() for k in DYN_STATE}
        filled = state["dyn_iou_hist"][:n_steps], state["dyn_beta_hist"][:n_steps]
        if not (int(state["dyn_count"]) == n_steps
                and all(torch.isfinite(f).all() for f in filled)
                and not state["dyn_iou_hist"][n_steps:].any()
                and state["dyn_iou_thr"].item() == np.float32(0.4)
                and state["dyn_beta"].item() == 1.0
                and state["dyn_iou_thr"].dtype == torch.float32):
            raise AssertionError(f"{tag}: the state after {n_steps} steps is {state}")
        r["state"] = {"count": int(state["dyn_count"]), "iou_hist": filled[0].tolist(),
                      "beta_hist": filled[1].tolist()}
    say(f"{tag} ({gpu}): built in {r['build_s']:.1f} s, {n} stage(s); predict of {BATCH} images "
        f"{predict_ms[0]:.0f} ms first call" + (f", {r['predict_ms']:.1f} ms after"
                                                if n_requests > 1 else "")
        + f", {r['detections']} valid detections, peak {r['predict_peak']:.2f} GiB; train step at "
        f"batch {FAMILY_BATCH} {step_ms[0]:.0f} ms first" + (f", {r['train_ms']:.1f} ms after"
                                                              if n_steps > 1 else "")
        + f", peak {r['train_peak']:.2f} GiB; launches {ran(r['predict_counts'])} / "
        f"{ran(counts)}"
        + (f"; ATSS over {r['anchors']} anchors: {r['atss_positives']} positives, gt_inds equal "
           "on the card and the CPU" if "anchors" in r else "")
        + (f"; state {r['state']}" if "state" in r else "")
        + (f"; K1/K4 vs plain at the stage-{n - 1} predict RoIs ({r['check_rois']}) "
           f"{r['check_predict']}" if check else ""))
    del det, step, tb, before
    torch.cuda.empty_cache()
    return r


def fork_phase(gpu: str) -> dict:
    """The phase "fork heads" at full width: Dynamic R-CNN (R50-FPN, 4
    classes) in float32 and bfloat16, ``REQUESTS`` requests and
    ``DYNAMIC_STEPS`` steps; ``cascade_atss`` (ATSS over 201,600 anchors,
    GIoU, three ProbCascade stages) in both dtypes, one request and one
    step; the other four ensemble configs in bfloat16, one of each.  Its
    tiny checks are ``fork_tiny``'s."""
    t0 = time.perf_counter()
    out = {"dynamic": {}, "atss": {}}
    for dtype in (torch.float32, BF16):
        out["dynamic"][dtype] = run_fork(DYNAMIC_CONFIG, dtype, gpu, REQUESTS, DYNAMIC_STEPS,
                                         check=True)
        out["atss"][dtype] = run_fork(ATSS_CONFIG, dtype, gpu, check=True)
    out["bf16"] = {os.path.basename(p)[:-3]: run_fork(p, BF16, gpu) for p in FORK_BF16}
    out["wall_s"] = time.perf_counter() - t0
    say(f"phase fork heads: {out['wall_s']:.1f} s")
    return out


def tiny_dynamic_config():
    """Dynamic R-CNN as ``--tiny`` shrinks it (ResNet-18 at width 8, FPN and
    RPN 32, FC 64, 64 train proposals, 32 RoIs an image) with a ring of 2
    steps, each image's largest IoU as the IoU statistic and an initial
    threshold of ``TINY_DYN_INITIAL_IOU``, so that the state moves at each
    boundary (``tests/test_torch_dynamic_rcnn.py``'s)."""
    mc = shrink_model(load_config(DYNAMIC_CONFIG).model.to_dict())
    mc["train_cfg"]["rcnn"]["dynamic_rcnn"].update(update_iter_interval=2, iou_topk=1,
                                                   initial_iou=TINY_DYN_INITIAL_IOU)
    return mc


def tiny_atss_config():
    """``cascade_atss`` as ``--tiny`` shrinks it (the ATSS RPN 2 convs deep)."""
    return shrink_model(load_config(ATSS_CONFIG).model.to_dict())


def sync_step_state(det, opt, ref_det, ref_opt) -> None:
    """``det``'s parameters, SGD momentum and step count set to
    ``ref_det``'s and ``ref_opt``'s (the buffers, Dynamic R-CNN's state
    among them, stay ``det``'s own)."""
    with torch.no_grad():
        for p, q in zip(det.net.parameters(), ref_det.net.parameters()):
            p.copy_(q)
    for p, q in zip(opt.params, ref_opt.params):
        if q in ref_opt.sgd.state:
            opt.sgd.state[p]["momentum_buffer"] = (
                ref_opt.sgd.state[q]["momentum_buffer"].to(p.device).clone())
    opt.step_count = ref_opt.step_count


def dynamic_gpu_matches_cpu(seed: int = 7, steps: int = TINY_DYN_STEPS) -> list:
    """The tiny Dynamic R-CNN's ``steps`` float32 train steps on the card
    against the CPU's, the RPN's and RoI samplers fed the same numpy
    uniforms, each card step from the CPU's parameters and momentum before
    it (the state is each device's own): each step held by
    ``f32_step_rule``; after each, the state within 1e-6 plus rtol 1e-4 of
    the CPU's (the losses' tolerance: its statistics are the IoUs and
    encoded ``|dx|`` of the device's own proposals, whose float32 rounding
    differs, 3.8e-6 apart on an IoU of 0.48 on an H100), ``dyn_count``
    equal; the threshold moved at both boundaries."""
    mc = tiny_dynamic_config()
    dets = {d: build(mc, device=d, seed=seed) for d in ("cpu", "cuda")}
    anchors, nla = dets["cpu"].anchors_for((128, 160))
    batch, _ = tiny_train_inputs(seed, mc, anchors)
    opts = {d: make_optimizer(det.net.parameters(), lambda s: 0.01) for d, det in dets.items()}
    steps_ = {d: make_train_step(det, *det.anchors_for((128, 160)), opts[d])
              for d, det in dets.items()}
    threads = torch.get_num_threads()
    out = []
    for k in range(steps):
        _, kw = tiny_train_inputs(seed + 100 * (k + 1), mc, anchors)
        sync_step_state(dets["cuda"], opts["cuda"], dets["cpu"], opts["cpu"])
        p0 = {n: v.detach().clone() for n, v in dets["cpu"].net.named_parameters()}
        metrics, params = {}, {}
        for d in ("cpu", "cuda"):
            torch.set_num_threads(1 if d == "cpu" else threads)
            metrics[d] = {n: float(v) for n, v in steps_[d](batch, **kw).items()}
            params[d] = {n: v.detach().cpu() for n, v in dets[d].net.named_parameters()}
        torch.set_num_threads(threads)
        rep = {"metrics": metrics, "tensors": {
            n: ((params["cuda"][n] - ref).abs().max().item(), (ref - p0[n]).abs().max().item(),
                ref.abs().max().item(), math.inf, (params["cuda"][n] - p0[n]).abs().max().item())
            for n, ref in params["cpu"].items()}}
        summary = step_summary(rep)
        broken = f32_step_rule(rep, summary)
        state = {d: {n: getattr(det.net.bbox_head, n).cpu() for n in DYN_STATE}
                 for d, det in dets.items()}
        for n in DYN_STATE:
            got, ref = state["cuda"][n], state["cpu"][n]
            if n == "dyn_count":
                ok = torch.equal(got, ref) and int(ref) == k + 1
            else:
                ok = bool(((got - ref).abs() <= 1e-6 + 1e-4 * ref.abs()).all())
            if not ok:
                broken.append(f"state {n}: card {got.tolist()} CPU {ref.tolist()}")
        if k % 2 and not state["cpu"]["dyn_iou_thr"].item() > TINY_DYN_INITIAL_IOU + 1e-3:
            broken.append(f"the IoU threshold did not move at step {k}: {state['cpu']}")
        if broken:
            raise AssertionError(f"tiny Dynamic R-CNN step {k}, card against CPU: "
                                 + "; ".join(broken))
        out.append({"loss": metrics["cuda"]["loss"], "median_of_update":
                    summary["median_of_update"], "worst_of_f32_tol": summary["worst_of_f32_tol"][0],
                    "state": {n: v.tolist() for n, v in state["cuda"].items()}})
    return out


def fork_tiny() -> dict:
    """The phase "fork heads"'s checks without timings: the tiny Dynamic
    R-CNN's and ``cascade_atss``'s ``predict`` on the card against the CPU;
    ``cascade_atss``'s ATSS ``gt_inds`` on both and its float32 train step
    by ``f32_step_rule``; the tiny Dynamic R-CNN's four float32 steps with
    its state (``dynamic_gpu_matches_cpu``); the C.2 check of both, the
    state buffers compared with the rest."""
    tiny = {name: {"predict_detections": tiny_gpu_matches_cpu(3, config)}
            for name, config in (("dynamic_rcnn", tiny_dynamic_config),
                                 ("cascade_atss", tiny_atss_config))}
    mc = tiny_atss_config()
    det = build(mc, device="cuda", seed=7)
    anchors, nla = det.anchors_for((128, 160))
    batch, _ = tiny_train_inputs(7, mc, anchors)
    tiny["cascade_atss"]["atss_positives"] = atss_devices_agree(det, batch, anchors.cpu(), nla)
    del det
    m, worst, repeat, summary = tiny_train_gpu_matches_cpu(7, torch.float32, tiny_atss_config)
    tiny["cascade_atss"]["f32"] = {"loss": m["loss"], "worst_of_tolerance": worst, **summary,
                                   "repeat_identical": repeat}
    tiny["dynamic_rcnn"]["f32_steps"] = dynamic_gpu_matches_cpu()
    say(f"tiny fork heads: GPU predict matches CPU predict, ATSS gt_inds equal on both, "
        f"cascade_atss's f32 step and the Dynamic R-CNN's {TINY_DYN_STEPS} f32 steps hold the "
        f"f32 step rule, its state within 1e-6 + rtol 1e-4: {json.dumps(tiny)}")
    out = {"tiny": tiny, "repeat": {}}
    for dtype in (torch.float32, BF16):
        out["repeat"].update(c2_check("dynamic_rcnn", tiny_dynamic_config, dtype))
    out["repeat"].update(c2_check("cascade_atss", tiny_atss_config, torch.float32))
    return out


# ------------------------------------------------------- TTA and caffe style
CAFFE_CONFIG = os.path.join(REPO, "configs/faster_rcnn/faster_rcnn_r50_caffe_fpn_1x_coco.py")
TTA_SCALES = (600, 800, 1000)  # short sides of the multi-scale TTA (mmdet's test-aug example)
TTA_LONG_SIDE = 1333
TTA_FLIP_SIDE = 800  # aug_predict's short side: the test pipeline's
TTA_FRAME = (480, 640)  # (H, W): COCO's most common frame
TTA_CALLS = 2  # the first call, then a timed one


def tta_views(seed: int, sides, canvas_long: int = CANVAS[1]):
    """The same two seeded noise frames of ``TTA_FRAME`` resized on the
    card to each short side of ``sides`` as the test pipeline resizes them
    (``(TTA_LONG_SIDE, s)``, keep-ratio, bilinear), at the top left of the
    canvas ``(ceil(s / 32) * 32, canvas_long)``: ``{side: batch}``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h0, w0 = TTA_FRAME
    frames = torch.randn((BATCH, 3, h0, w0), generator=gen, device="cuda")
    out = {}
    for s in sides:
        nw, nh, _ = rescale_size(w0, h0, (TTA_LONG_SIDE, s))
        images = torch.zeros((BATCH, math.ceil(s / 32) * 32, canvas_long, 3), device="cuda")
        images[:, :nh, :nw] = torch.nn.functional.interpolate(
            frames, size=(nh, nw), mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        out[s] = {"images": images,
                  "img_shape": torch.tensor([[float(nh), float(nw)]] * BATCH, device="cuda"),
                  "scale_factor": torch.tensor([[nw / w0, nh / h0] * 2] * BATCH, device="cuda")}
    return out


def check_tta_dets(dets, labels, valid, num_classes: int, x_max: float, what: str) -> int:
    """Detections of the original ``TTA_FRAME``: finite, of the model's
    classes, inside the frame's height and, along x, inside ``[0, x_max]``:
    a flipped view's boxes are clipped to the resized image's width before
    they are mirrored by the canvas's (the JAX package's order, which the
    port copies), so they may pass the frame's right edge up to the
    canvas's width in the frame.  Returns how many are valid."""
    h, w = TTA_FRAME
    boxes = dets[valid][:, :4]
    if not (torch.isfinite(dets).all() and dets.shape[:2] == (BATCH, 100) and valid.any()):
        raise AssertionError(f"{what}: bad detections ({tuple(dets.shape)}, "
                             f"{int(valid.sum())} valid)")
    tol = 1e-3  # clipped to the resized image, divided by its factor
    if not ((boxes[:, 0] >= 0) & (boxes[:, 1] >= 0) & (boxes[:, 2] <= x_max + tol)
            & (boxes[:, 3] <= h + tol)).all():
        raise AssertionError(f"{what}: detections outside [0, {x_max}] x [0, {h}]: "
                             f"{boxes.max(0).values.tolist()}")
    if not ((labels[valid] >= 0) & (labels[valid] < num_classes)).all():
        raise AssertionError(f"{what}: labels outside the {num_classes} classes")
    return int(valid.sum())


def run_tta(dtype, gpu: str) -> dict:
    """The full-width flagship in ``dtype`` with seeded random weights
    through ``aug_predict`` (the frames at short side 800 and their
    mirror, canvas 800 x 1344) and ``aug_predict_multi`` over short sides
    600, 800 and 1000 with flip (canvases 608, 800 and 1024 x 1344: six
    views), ``TTA_CALLS`` calls each with the counts set to 0 before and
    read after: K1 of the dtype exactly 2 and 6 times a call, nothing else;
    detections finite, inside the frame (``check_tta_dets``), the same on
    every call.  Reports
    each one's ms after its first call, its peak and the merged proposals
    kept; K1 (and K4) against their plain versions on the flipped view's
    pyramid and RoIs at short side 800."""
    tag = "f32" if dtype == torch.float32 else "bf16"
    mc = load_config(CONFIG).model.to_dict()
    det = build(mc, seed=0, dtype=dtype)
    views = tta_views(12, TTA_SCALES)
    anchors = {s: det.anchors_for(tuple(b["images"].shape[1:3])) for s, b in views.items()}
    r = {}
    for name, sides, per_call in (("flip", (TTA_FLIP_SIDE,), 2), ("multi", TTA_SCALES, 6)):
        vs = [(views[s], *anchors[s], f) for s in sides for f in (False, True)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ms, outs = [], []
        for _ in range(TTA_CALLS):
            t0 = time.perf_counter()
            outs.append(two_stage.aug_predict_multi(det, vs) if name == "multi" else
                        two_stage.aug_predict(det, views[TTA_FLIP_SIDE], *anchors[TTA_FLIP_SIDE]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        kernel_launches(counts, dtype, f"{tag} TTA {name}", per_call * TTA_CALLS)
        if not all(torch.equal(a, b) for o in outs[1:] for a, b in zip(o, outs[0])):
            raise AssertionError(f"{tag} TTA {name}: calls on the same views differ")
        _, _, _, kept = two_stage.aug_proposals(det, vs)
        r[name] = {"views": len(vs), "first_ms": ms[0], "ms": float(np.mean(ms[1:])),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "merged_proposals_kept": kept.sum(1).tolist(),
                   "detections": check_tta_dets(*outs[0], det.bbox_cfg.num_classes, max(
                       views[s]["images"].shape[2] / views[s]["scale_factor"][0, 0].item()
                       for s in sides), f"{tag} TTA {name}"),
                   "counts": ran(counts)}
    seen, boxes, _, valid = two_stage.aug_proposals(
        det, [(views[TTA_FLIP_SIDE], *anchors[TTA_FLIP_SIDE], True)])
    feats, _, scale, flip_w = seen[0]
    rois = two_stage.view_rois(boxes, scale, flip_w)
    strides = det.net.roi_strides
    g = torch.from_numpy(np.random.RandomState(13).randn(
        rois.shape[0] * rois.shape[1], 7, 7, feats[0].shape[-1]).astype(np.float32)).cuda()
    r["check_flipped"] = kernels_vs_plain(list(feats[:len(strides)]), rois, valid, strides, g,
                                          dtype, f"{tag} TTA flipped view at short side "
                                          f"{TTA_FLIP_SIDE}")
    say(f"{tag} flagship TTA ({gpu}): aug_predict (2 views) {r['flip']['ms']:.1f} ms after a "
        f"{r['flip']['first_ms']:.0f} ms first call, peak {r['flip']['peak_gib']:.2f} GiB, "
        f"{r['flip']['merged_proposals_kept']} merged proposals kept; aug_predict_multi (short "
        f"sides {TTA_SCALES} with flip, 6 views) {r['multi']['ms']:.1f} ms after "
        f"{r['multi']['first_ms']:.0f} ms, peak {r['multi']['peak_gib']:.2f} GiB, "
        f"{r['multi']['merged_proposals_kept']} kept; launches {r['flip']['counts']} / "
        f"{r['multi']['counts']} over {TTA_CALLS} calls; K1/K4 vs plain on the flipped view "
        f"{r['check_flipped']}")
    del det, views, feats, boxes, rois, g
    torch.cuda.empty_cache()
    return r


def tiny_caffe_config():
    """``faster_rcnn_r50_caffe_fpn_1x_coco.py`` with its caffe ResNet-50 at
    width 8 and ``--tiny``'s heads (FPN and RPN 32, FC 64, 80 classes)."""
    mc = shrink_model(load_config(CAFFE_CONFIG).model.to_dict())
    mc["backbone"].update(depth=50, base_channels=8, style="caffe")
    mc["neck"]["in_channels"] = [32, 64, 128, 256]
    return mc


def tta_gpu_matches_cpu(seed: int = 3) -> dict:
    """The tiny flagship's ``aug_predict`` and ``aug_predict_multi`` (short
    sides 128 and 96, flip) in float32 on the card against the CPU's:
    labels and validity equal, detections within 1e-3."""
    mc = tiny_config()
    rs = np.random.RandomState(seed)
    batches = [{"images": rs.randn(2, *canvas, 3).astype(np.float32),
                "img_shape": np.array(shape, np.float32),
                "scale_factor": np.repeat(np.array(sf, np.float32)[:, None], 4, 1)}
               for canvas, shape, sf in (((128, 160), [[128.0, 150.0], [116.0, 160.0]],
                                          [1.0, 1.25]),
                                         ((96, 128), [[96.0, 112.0], [87.0, 120.0]],
                                          [0.75, 0.9375]))]
    outs = {}
    for device in ("cpu", "cuda"):
        det = build(mc, device=device, seed=seed)
        anchors = [det.anchors_for(tuple(b["images"].shape[1:3])) for b in batches]
        views = [(b, *a, f) for b, a in zip(batches, anchors) for f in (False, True)]
        outs[device] = [[x.cpu() for x in out] for out in (
            two_stage.aug_predict(det, batches[0], *anchors[0]),
            two_stage.aug_predict_multi(det, views))]
    r = {}
    for name, (d0, l0, v0), (d1, l1, v1) in zip(("flip", "multi"), outs["cpu"], outs["cuda"]):
        err = (d0 - d1).abs().max().item()
        if not (torch.equal(v0, v1) and torch.equal(l0, l1) and v0.any() and err <= 1e-3):
            raise AssertionError(f"tiny TTA {name}: GPU and CPU detections differ (boxes by "
                                 f"{err})")
        r[name] = {"detections": int(v0.sum()), "max_abs_err": err}
    return r


def tta_caffe_phase(gpu: str) -> dict:
    """The phase "tta + caffe" at full width: the flagship's TTA
    (``run_tta``) in float32 and bfloat16; ``faster_rcnn_r50_caffe_fpn_1x_coco.py``
    (caffe ResNet-50, FPN, 80 classes) in both dtypes, one ``predict`` of
    two 800 x 1344 images and one step at batch 2 with cuDNN pinned
    (``run_fork``: launches exact, K1 and K4 against their plain versions
    at its predict RoIs).  Its tiny checks are ``tta_caffe_tiny``'s."""
    t0 = time.perf_counter()
    out = {"tta": {}, "caffe": {}}
    for dtype in (torch.float32, BF16):
        out["tta"][dtype] = run_tta(dtype, gpu)
        out["caffe"][dtype] = run_fork(CAFFE_CONFIG, dtype, gpu, check=True)
    out["wall_s"] = time.perf_counter() - t0
    say(f"phase tta + caffe: {out['wall_s']:.1f} s")
    return out


def tta_caffe_tiny() -> dict:
    """The phase "tta + caffe"'s checks without timings: the tiny
    flagship's TTA on the card against the CPU (``tta_gpu_matches_cpu``);
    the tiny caffe Faster R-CNN's ``predict`` on both (labels and validity
    equal, detections within 1e-3) and its float32 train step by
    ``f32_step_rule``; the C.2 check of its step in both dtypes."""
    # at seed 3 two of image 0's detections (80 classes) are 3e-7 apart in
    # score, which the card and the CPU keep in opposite orders (seeds 4-8 tie nowhere)
    tiny = {"tta": tta_gpu_matches_cpu(), "caffe": {
        "predict_detections": tiny_gpu_matches_cpu(4, tiny_caffe_config)}}
    # seed 8: at seed 7 one output of layer3_0's conv2 has the other sign on the card
    # (``--step-readings f32 faster_caffe``'s edge report), and that conv's weight
    # gradient reads 10.8 times the per-tensor bound; seeds 8-16 read at most 0.22
    m, worst, repeat, summary = tiny_train_gpu_matches_cpu(8, torch.float32, tiny_caffe_config)
    tiny["caffe"]["f32"] = {"loss": m["loss"], "worst_of_tolerance": worst, **summary,
                            "repeat_identical": repeat}
    say(f"tiny TTA and caffe: TTA and the caffe Faster R-CNN's predict match the CPU, its f32 "
        f"step holds the f32 step rule: {json.dumps(tiny)}")
    out = {"tiny": tiny, "repeat": {}}
    for dtype in (torch.float32, BF16):
        out["repeat"].update(c2_check("faster_caffe", tiny_caffe_config, dtype))
    return out


# ------------------------------------------------------- norms and plugins
NORMS_CONFIG = os.path.join(
    REPO, "configs/gcnet/mask_rcnn_r50_fpn_syncbn-backbone_r4_gcb_c3-c5_1x_coco.py")
NORMS_BF16 = tuple(os.path.join(REPO, "configs", p) for p in (
    "gn/mask_rcnn_r50_fpn_gn-all_2x_coco.py", "gn+ws/faster_rcnn_r50_fpn_gn_ws-all_1x_coco.py",
    "empirical_attention/faster_rcnn_r50_fpn_attention_1111_1x_coco.py"))
NORMS_STEPS = 3  # the main path's train steps: step 0 warms up, steps 1-2 are timed
# the tiny live-BN model's bottlenecks' last norms, scaled as the CPU tests
# scale them (tests/test_torch_norm_configs.py::_damped): a norm on the
# data's statistics divides its input's float32 rounding by that input's
# spread, and where each residual branch adds as much as the shortcut this
# compounds over ResNet-50's 16 blocks
TINY_RESIDUAL_SCALE = 0.1
SHIFT_INVARIANT = "conv_mask.bias"
RUNNING = ("running_mean", "running_var")


def running_stats(det) -> dict:
    """Every BN's running statistics (the frozen BNs' too), cloned."""
    return {k: v.detach().clone() for k, v in det.net.named_buffers() if k.endswith(RUNNING)}


def live_norms_of(det) -> int:
    return sum(type(m).__name__ == "LiveBatchNorm" for m in det.net.modules())


def run_norms(path: str, dtype, gpu: str, n_requests: int = 1, n_steps: int = 1,
              check: bool = False) -> dict:
    """The config at ``path`` at full width in ``dtype`` with seeded random
    weights: ``n_requests`` requests of two 800 x 1344 images through
    ``predict`` (K1 at 7, and at 14 for a mask head, once a request), then
    ``n_steps`` train steps at batch 2 with its schedule (ellipse gt masks
    for a mask head; K1, K4 and the tile keys at 7, and at 14 for a mask
    head, once a step), each path with the counts set to 0 before and read
    after, exact; valid detections, masks in [0, 1], finite and positive
    losses, the frozen stages bit-identical and every other part moved.
    ``predict`` leaves every running statistic as it is; the steps move
    each live BN's (and no frozen BN's), and all stay finite.  With
    ``check``, K1 and K4 at 7 against their plain versions at the box
    proposals and the train slots, and at 14 at the detections' mask RoIs
    and the positive train slots."""
    name = os.path.relpath(path, os.path.join(REPO, "configs"))
    tag = ("f32 " if dtype == torch.float32 else "bf16 ") + name[:-3]
    sfx = "" if dtype == torch.float32 else "_bf16"
    mc = load_config(path).model.to_dict()
    t0 = time.perf_counter()
    det = build(mc, seed=0, dtype=dtype)
    masks = det.net.mask_head is not None
    o14 = ("", "_o14") if masks else ("",)
    r = {"build_s": time.perf_counter() - t0, "live_bn": live_norms_of(det),
         "modules": sorted({type(m).__name__ for m in det.net.modules()} & {
             "LiveBatchNorm", "GroupNorm", "WSConv", "ContextBlock", "GeneralizedAttention"})}
    anchors, nla = det.anchors_for(CANVAS)
    strides = det.net.roi_strides
    num_classes = det.bbox_cfg.num_classes
    batches = list(requests(seed=31))[:n_requests]
    stats0 = running_stats(det)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    predict_ms, results = [], []
    for b in batches:
        t0 = time.perf_counter()
        results.append(det.predict(b, anchors, nla))
        torch.cuda.synchronize()
        predict_ms.append((time.perf_counter() - t0) * 1e3)
    r["predict_counts"] = counts = read_counts()
    r["predict_peak"] = torch.cuda.max_memory_allocated() / 2**30
    want = {f"roi_align_fwd{sfx}{o}": n_requests for o in o14}
    if ran(counts) != want:
        raise AssertionError(f"the {tag} predict path ran {ran(counts)}, not {want}")
    if not all(torch.equal(v, det.net.get_buffer(k)) for k, v in stats0.items()):
        raise AssertionError(f"{tag}: predict moved a running statistic")
    r["predict_first_ms"] = predict_ms[0]
    r["predict_ms"] = float(np.mean(predict_ms[1:] or predict_ms))
    r["detections"] = [check_dets(*x[:3], num_classes=num_classes) for x in results]
    for x in results[:1] if masks else ():
        check_masks(x[3])
    if check:
        x = batches[0]
        feats, boxes, scores, valid = det.proposals(x["images"], x["img_shape"], anchors, nla)
        route = list(feats[:len(strides)])
        c = feats[0].shape[-1]
        rs = np.random.RandomState(38)
        g = torch.from_numpy(rs.randn(boxes.shape[0] * boxes.shape[1], 7, 7, c)
                             .astype(np.float32)).cuda()
        r["check_box_predict"] = kernels_vs_plain(route, boxes, valid, strides, g, dtype,
                                                  f"{tag} box predict shapes")
        if masks:
            dets, _, dvalid = det.roi_predict(feats, boxes, scores, valid, x["img_shape"],
                                              x["scale_factor"])
            mrois = (dets[..., :4] * x["scale_factor"][:, None, :]).contiguous()
            g = torch.from_numpy(rs.randn(mrois.shape[0] * mrois.shape[1], 14, 14, c)
                                 .astype(np.float32)).cuda()
            r["check_mask_predict"] = kernels_vs_plain(route, mrois, dvalid, strides, g, dtype,
                                                       f"{tag} mask predict shapes")
            del dets, dvalid, mrois
        del feats, boxes, scores, valid, route, g
    del results
    make_batch = mask_train_batch if masks else train_batch
    tb = make_batch(9, FAMILY_BATCH, CANVAS, IMG_SHAPE, GT_PER_IMAGE, num_classes=num_classes)
    step, tb, sample0 = train_setup(det, anchors, nla, path, tb)
    before = {k: v.detach().clone() for k, v in det.net.named_parameters()}
    stats1 = running_stats(det)
    metrics, step_ms, counts, r["train_peak"] = run_steps(step, tb, f"{tag} train", n_steps)
    r["train_counts"] = counts
    want = {f"{k}{sfx}{o}": n_steps for k in ("roi_align_fwd", "roi_align_bwd") for o in o14}
    want.update({f"roi_tile_keys{o}": n_steps for o in o14})
    if ran(counts) != want:
        raise AssertionError(f"the {tag} train path ran {ran(counts)}, not {want}")
    r["moved"] = check_moved(before, det, f"{tag} train",
                             ("bbox_head.", "mask_head.") if masks else ("bbox_head.",))
    after = running_stats(det)
    live = {k for k, m in det.net.named_modules() if type(m).__name__ == "LiveBatchNorm"}
    moved = {k for k, v in after.items() if not torch.equal(v, stats1[k])}
    should = {f"{m}.{s}" for m in live for s in RUNNING}
    if moved != should or not all(torch.isfinite(v).all() for v in after.values()):
        raise AssertionError(f"{tag}: the steps moved {len(moved)} running statistics, not the "
                             f"{len(should)} of its live BNs, or one is not finite")
    var = torch.cat([v for k, v in after.items() if k in should and k.endswith("var")] or
                    [torch.ones(1, device="cuda")])
    r["running_stats"] = {"moved": len(moved), "of": len(after),
                          "var_range": [var.min().item(), var.max().item()]}
    r["train_first_ms"], r["train_ms"] = step_ms[0], float(np.mean(step_ms[1:] or step_ms))
    r["losses"] = metrics[-1]
    if check:
        with torch.no_grad():
            feats = det.net.features(tb["images"])
        route = list(feats[:len(strides)])
        c = feats[0].shape[-1]
        rois, slots = sample0.boxes, sample0.boxes.shape[0] * sample0.boxes.shape[1]
        rs = np.random.RandomState(39)
        g = torch.from_numpy(rs.randn(slots, 7, 7, c).astype(np.float32)).cuda()
        r["check_box_train"] = kernels_vs_plain(route, rois, sample0.valid, strides, g, dtype,
                                                f"{tag} box train shapes")
        if masks:
            g = torch.from_numpy(rs.randn(slots, 14, 14, c).astype(np.float32)).cuda()
            r["check_mask_train"] = kernels_vs_plain(
                route, rois, sample0.valid & sample0.is_pos, strides, g, dtype,
                f"{tag} mask train shapes")
        del feats, route, g
    checks = {k: v for k, v in r.items() if k.startswith("check_")}
    say(f"{tag} ({gpu}): built in {r['build_s']:.1f} s ({', '.join(r['modules'])}; "
        f"{r['live_bn']} live BNs); predict of {BATCH} images {predict_ms[0]:.0f} ms first call"
        + (f", {r['predict_ms']:.1f} ms after" if n_requests > 1 else "")
        + f", {r['detections']} valid detections, peak {r['predict_peak']:.2f} GiB; train step at "
        f"batch {FAMILY_BATCH} {step_ms[0]:.0f} ms first"
        + (f", {r['train_ms']:.1f} ms after" if n_steps > 1 else "")
        + f", peak {r['train_peak']:.2f} GiB; launches {ran(r['predict_counts'])} / "
        f"{ran(counts)}; running statistics {r['running_stats']}"
        + (f"; K1/K4 vs plain {checks}" if checks else ""))
    del det, step, tb, before
    torch.cuda.empty_cache()
    return r


def norms_phase(gpu: str) -> dict:
    """The phase "norms + plugins" at full width: the GCNet SyncBN Mask
    R-CNN (live BN, ContextBlocks) in float32 and bfloat16, ``REQUESTS``
    requests and ``NORMS_STEPS`` steps, K1 and K4 at 7 and 14 against their
    plain versions; the GN-all Mask R-CNN, the GN+WS Faster R-CNN and the
    empirical-attention Faster R-CNN in bfloat16, one of each.  Its tiny
    checks are ``norms_tiny``'s."""
    t0 = time.perf_counter()
    out = {"gcnet": {d: run_norms(NORMS_CONFIG, d, gpu, REQUESTS, NORMS_STEPS, check=True)
                     for d in (torch.float32, BF16)}}
    out["bf16"] = {os.path.basename(p)[:-3]: run_norms(p, BF16, gpu) for p in NORMS_BF16}
    out["wall_s"] = time.perf_counter() - t0
    say(f"phase norms + plugins: {out['wall_s']:.1f} s")
    return out


def tiny_norms_config():
    """The main path's model as ``--tiny`` shrinks it (ResNet-50 at width 8,
    live BN, a ContextBlock in each bottleneck of stages 2-4), each
    bottleneck's last norm scaled by ``TINY_RESIDUAL_SCALE`` (``build``)."""
    mc = shrink_model(load_config(NORMS_CONFIG).model.to_dict())
    mc["residual_scale"] = TINY_RESIDUAL_SCALE
    return mc


def norms_tiny() -> dict:
    """The phase "norms + plugins"'s checks without timings: the tiny GCNet
    model's ``predict`` on the card against the CPU (running statistics);
    its float32 train step (live BN) by ``live_bn_step_rule``, with every
    running statistic after it within ``LIVE_BN_STATS_TOL`` times 1e-6 plus
    rtol 1e-4 of the CPU's and moved, and the ContextBlocks'
    attention-pooling biases (``step_report``'s ``shift_invariant``) within
    1e-6 of the largest update; the C.2 check of its step in both dtypes,
    every buffer compared."""
    t0 = time.perf_counter()
    tiny = {"predict_detections": tiny_gpu_matches_cpu(3, tiny_norms_config)}
    walls = {"predict": time.perf_counter() - t0}
    rep = step_report(7, torch.float32, tiny_norms_config, again=False)  # C.2 holds the repeat
    walls["f32 step"] = time.perf_counter() - t0 - walls["predict"]
    largest = max(v[1] for v in rep["tensors"].values())
    broken = [f"{k}: card and CPU differ by {v[0]:.3g}"
              for k, v in rep["shift_invariant"].items() if not v[0] <= 1e-6 * largest]
    summary = step_summary(rep)
    broken += live_bn_step_rule(rep, summary)
    cpu = rep["buffers"]["cpu"]
    stats = [k for k in cpu if k.endswith(RUNNING)]
    worst = running_stats_share(rep)
    if not worst <= LIVE_BN_STATS_TOL:
        broken.append(f"the running statistics: card and CPU differ by {worst:.3g} times 1e-6 + "
                      f"rtol 1e-4 (> {LIVE_BN_STATS_TOL})")
    unmoved = [k for k in stats if torch.equal(cpu[k], torch.zeros_like(cpu[k]) if "mean" in k
                                               else torch.ones_like(cpu[k]))]
    if unmoved or len(stats) < 100:
        broken.append(f"{len(unmoved)} of {len(stats)} running statistics did not move")
    if broken:
        raise AssertionError("tiny GCNet f32 step, card against CPU: " + "; ".join(broken))
    tiny["f32"] = {"loss": rep["metrics"]["cuda"]["loss"], **summary,
                   "running_stats": len(stats), "stats_worst_of_tolerance": worst}
    say(f"tiny GCNet (live BN, ContextBlocks): GPU predict matches CPU predict, its f32 step "
        f"holds the live-BN step rule, its {len(stats)} running statistics within "
        f"{worst:.3g} times 1e-6 + rtol 1e-4 of the CPU's: {json.dumps(tiny)}")
    out = {"tiny": tiny, "repeat": {}}
    for dtype in (torch.float32, BF16):
        out["repeat"].update(c2_check("gcnet", tiny_norms_config, dtype))
    walls["C.2"] = time.perf_counter() - t0 - sum(walls.values())
    tiny["walls_s"] = walls
    say(f"tiny GCNet checks' walls (s): {walls}")
    return out


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
# the whole recipe, to its mAP threshold, runs in the CLIs' default dtype
# (default_runtime.py: bfloat16); float32 takes the same path through the
# CLIs for 1 epoch only (launches, finite losses and bbox stats): the
# whole recipe in both dtypes took ~130 s, 4 float32 epochs 15.5 s of a run
# over its time limit, and 2 epochs the 25 steps that the mask entry phase
# needed
E2E_EPOCHS_OF = {torch.bfloat16: E2E_EPOCHS, torch.float32: 1}


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
    # the test CLI's flip and multi-scale TTA: six views a batch, each one K1
    torch.cuda.synchronize()
    reset_counts()
    tta = test_cli([CONFIG, ckpt_end, "--device", "cuda", "--tta", "--tta-scales",
                    *map(str, TTA_SCALES), *cli_options(data_options(utdac, dtype))])
    tta_counts = read_counts()
    flags = CocoDataset(os.path.join(utdac, "val.json"), os.path.join(utdac, "val"),
                        test_mode=True).flags
    bs = cfg.data.to_dict().get("samples_per_gpu", 2)
    n_batches = sum(math.ceil(int((flags == f).sum()) / bs) for f in (1, 0))
    if not (tta["num_results"] == tta["eval_stats"]["images"] == 9
            and 0.0 <= tta["bbox_mAP"] <= 1.0):
        raise AssertionError(f"{tag} test CLI --tta: {tta['num_results']} results, bbox mAP "
                             f"{tta['bbox_mAP']}")
    kernel_launches(tta_counts, dtype, f"{tag} test CLI --tta", 2 * len(TTA_SCALES) * n_batches)
    out = {"train_images_per_s": summary["images_per_s"],
           "loader_wait_share": summary["loader_wait_share"],
           "eval_images_per_s": metrics["eval_stats"]["images_per_s"],
           "train_peak_gib": peak, "train_counts": ran(train_counts),
           "eval_counts": ran(eval_counts), "val_results": metrics["num_results"],
           "tta_eval_images_per_s": tta["eval_stats"]["images_per_s"],
           "tta_eval_counts": ran(tta_counts), "tta_val_results": tta["num_results"],
           "tta_bbox_mAP": tta["bbox_mAP"],
           "bbox_stats": {k: v for k, v in metrics.items() if k.startswith("bbox_")}}
    say(f"{tag} entry points ({gpu}): " + json.dumps(out))
    return out


def e2e_trains(dtype, gpu: str, synth: str, work: str) -> dict:
    """``scripts/e2e_ap_check.py``'s recipe through the port's CLIs: the tiny
    flagship from scratch on the 200-image shapes set, ``E2E_EPOCHS_OF[dtype]``
    epochs at batch E2E_BATCH, lr E2E_LR, warmup E2E_WARMUP, decay at 2/3 of
    the epochs and 2 before the end, no validation, the 7 x 7 kernels of
    ``dtype`` launched once a step, the last loss finite; then the test CLI
    on the 50 val images: bbox mAP and mAP@50 in [0, 1], and bbox mAP at
    least E2E_MIN_MAP after the whole recipe's E2E_EPOCHS."""
    tag = "f32" if dtype == torch.float32 else "bf16"
    epochs = E2E_EPOCHS_OF[dtype]
    decay = sorted(e for e in {2 * epochs // 3, epochs - 2} if e > 0)
    opts = cli_options(data_options(
        synth, dtype, **{"data.samples_per_gpu": E2E_BATCH, "runner.max_epochs": epochs,
                         "optimizer.lr": E2E_LR, "lr_config.warmup_iters": E2E_WARMUP,
                         "lr_config.step": "[" + ",".join(map(str, decay)) + "]",
                         "model.backbone.frozen_stages": -1}))
    wd = os.path.join(work, f"e2e_{tag}")
    t0 = time.perf_counter()
    reset_counts()
    summary = train_cli([CONFIG, "--device", "cuda", "--tiny", "--no-validate", "--seed", "0",
                         "--work-dir", wd, *opts])
    counts = read_counts()
    train_s = time.perf_counter() - t0
    metrics = test_cli([CONFIG, os.path.join(wd, f"epoch_{epochs}"), "--device", "cuda",
                        "--tiny", *opts])
    wall = time.perf_counter() - t0
    out = {"epochs": epochs, "bbox_mAP": metrics["bbox_mAP"],
           "bbox_mAP_50": metrics["bbox_mAP_50"], "steps": summary["steps"],
           "last_loss": summary["last_metrics"]["loss"],
           "train_images_per_s": summary["images_per_s"],
           "loader_wait_share": summary["loader_wait_share"], "train_s": train_s,
           "eval_images_per_s": metrics["eval_stats"]["images_per_s"], "wall_s": wall,
           "counts": ran(counts)}
    say(f"{tag} e2e shapes set ({gpu}): " + json.dumps(out))
    kernel_launches(counts, dtype, f"{tag} e2e train", summary["steps"], summary["steps"])
    if not (summary["steps"] and math.isfinite(out["last_loss"])
            and 0 <= out["bbox_mAP"] <= 1 and 0 <= out["bbox_mAP_50"] <= 1):
        raise AssertionError(f"{tag} e2e: {summary['steps']} steps, last loss "
                             f"{out['last_loss']}, bbox mAP {out['bbox_mAP']}, mAP@50 "
                             f"{out['bbox_mAP_50']}")
    if epochs == E2E_EPOCHS and not metrics["bbox_mAP"] >= E2E_MIN_MAP:
        raise AssertionError(f"{tag} e2e: bbox mAP {metrics['bbox_mAP']} < {E2E_MIN_MAP}")
    return out


# -------------------------------------------------------------- mask entry
COCO_FRAMES = ((640, 480), (640, 427))  # COCO's two most common frame sizes
MASK_ENTRY_STEPS = 2  # full-width train_detector steps a model in the whole run
# ... and with --mask-entry, which times the phase with nothing beside it:
# 3 epochs of the 6 train frames' 4 batches, so that the first batch's load
# does not weigh in the loader's wait share
MASK_ENTRY_STEPS_ALONE = 12
STUFF_CLASSES = 183  # COCO-stuff's, the HTC config's semantic classes
# the tiny Mask R-CNN's e2e (scripts/e2e_ap_check.py --segm, whose recorded
# run reached bbox 0.862 and segm 0.861 at 24 epochs of batch 2): 24 epochs
# at batch 8, the batch-2 learning rate and warmup scaled linearly, the
# flagship e2e's recipe, from the CPU readings over seeds 0-3 in both dtypes
# (PERF.md; at batch 16, lr 0.02, the tiny models ended at bbox mAP 0.0-0.75)
MASK_E2E_EPOCHS = 24
MASK_E2E_BATCH = 8
MASK_E2E_LR = 0.0025 * MASK_E2E_BATCH / 2
MASK_E2E_WARMUP = 200 * 2 // MASK_E2E_BATCH
E2E_CHILD_TIMEOUT_S = 400
E2E_CHILD_THREADS = 2  # an e2e child's host threads for PyTorch (its loop is host-bound)
SEGM_KEYS = ("segm_mAP", "segm_mAP_50", "segm_mAP_75", "segm_mAP_s", "segm_mAP_m",
             "segm_mAP_l")


def rle_of(mask: np.ndarray) -> dict:
    """The uncompressed COCO RLE of a binary ``(H, W)`` mask."""
    flat = mask.T.reshape(-1)
    change = np.flatnonzero(np.diff(np.concatenate([[0], flat, [1 - flat[-1]]])))
    return {"size": list(mask.shape), "counts": np.diff(np.concatenate([[0], change])).tolist()}


def mask_coco_set(root: str) -> str:
    """A COCO-format set with instance masks and stuff maps under ``root``:
    6 train and 4 val PPM frames at UTDAC2020's and COCO's sizes (the last
    of each split portrait), the shapes' exact polygons, in each split an
    uncompressed-RLE instance (a ring) and a crowd box with compressed
    counts, and per frame an 8-bit PNG stuff map of 32-pixel blocks of the
    183 COCO-stuff classes with an ignored (255) band under ``stuff/``,
    its rows filtered with each of the five PNG filter types in turn (an
    adaptive writer such as libpng's picks Average and Paeth rows too)."""
    generate(root, n_train=6, n_val=4, seed=4, frame_sizes=UTDAC_FRAMES[:2] + COCO_FRAMES,
             n_portrait=1, object_scale=0.5)
    rs = np.random.RandomState(4)
    os.makedirs(os.path.join(root, "stuff"))
    for split in ("train", "val"):
        path = os.path.join(root, f"{split}.json")
        with open(path) as f:
            coco = json.load(f)
        im = coco["images"][0]
        h, w = im["height"], im["width"]
        yy, xx = np.mgrid[0:h, 0:w]
        r = np.hypot(yy - h * 0.75, xx - w * 0.2)
        ring = ((r < h * 0.15) & (r > h * 0.06)).astype(np.uint8)
        ys, xs = np.nonzero(ring)
        coco["annotations"] += [
            {"id": 9000, "image_id": im["id"], "category_id": 2, "iscrowd": 0,
             "bbox": [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                      int(ys.max() - ys.min() + 1)],
             "area": float(ring.sum()), "segmentation": rle_of(ring)},
            {"id": 9001, "image_id": im["id"], "category_id": 1, "iscrowd": 1,
             "bbox": [w * 0.6, h * 0.1, w * 0.2, h * 0.2], "area": w * h * 0.04,
             "segmentation": {"size": [h, w], "counts": "PPYo0"}}]
        with open(path, "w") as f:
            json.dump(coco, f)
        for im in coco["images"]:
            h, w = im["height"], im["width"]
            stuff = rs.randint(0, STUFF_CLASSES, (h // 32 + 1, w // 32 + 1)).repeat(32, 0)
            stuff = stuff.repeat(32, 1)[:h, :w].astype(np.uint8)
            top = rs.randint(0, h - 8)
            stuff[top:top + 8] = 255
            write_png_gray(os.path.join(root, "stuff", os.path.splitext(im["file_name"])[0]
                                        + ".png"), stuff, filters=(4, 3, 2, 1, 0))
    return root


def mask_options(root: str, **more) -> dict:
    """``--cfg-options`` pointing a config's splits at ``mask_coco_set``'s
    frames and stuff maps, random backbone weights, bfloat16, a log line
    every step."""
    opts = data_options(root, BF16, **{"data.train.seg_prefix": os.path.join(root, "stuff"),
                                       "log_config.interval": 1})
    opts.update({k: str(v) for k, v in more.items()})
    return opts


def mask_entry_train(config: str, root: str, work: str, gpu: str, steps: int) -> dict:
    """``train_detector`` at full width in bfloat16 on ``mask_coco_set``'s
    frames: ``steps`` steps at the config's batch of 2 from
    ``init_detector``'s seeded weights, the loader cropping the instances'
    masks and reading the stuff maps; the counts set to 0 before, read
    after (exact); every stage's ``loss_mask`` and HTC's
    ``loss_semantic_seg`` finite and positive at every step; the mask heads
    and the semantic head moved.  Returns the step's numbers and the
    checkpoint."""
    name = os.path.splitext(os.path.basename(config))[0]
    tag = f"bf16 mask entry {name}"
    cfg = load_config(config)
    cfg.merge_from_options(mask_options(root))
    handle = init_detector(cfg, device="cuda", seed=41)
    net = handle.detector.net
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    summary = train_detector(handle, os.path.join(work, name), max_iters=steps,
                             validate=False)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    # K1, K4 at 7 and 14 once a step; HTC's twice a stage (pyramid, semantic level)
    k = (1 if config == MASK_CONFIG else 6) * steps
    htc_launches(counts, BF16, f"{tag} train", k, k, k, k)
    with open(os.path.join(work, name, "train.log.json")) as f:
        logged = [json.loads(line) for line in f if '"train"' in line]
    losses = (["loss_mask"] if config == MASK_CONFIG else
              [f"s{i}.loss_mask" for i in range(3)] + ["loss_semantic_seg"])
    bad = [(m.get("iter"), key, m.get(key)) for m in logged for key in losses + ["loss"]
           if not (key in m and math.isfinite(m[key]) and m[key] > 0)]
    if len(logged) != steps or bad:
        raise AssertionError(f"{tag}: {len(logged)} logged steps, bad losses {bad}")
    heads = (("mask_head.",) if config == MASK_CONFIG else
             tuple(f"mask_heads.{i}." for i in range(3)) + ("semantic_head.",))
    moved = check_moved(before, handle.detector, f"{tag} train", heads=heads)
    out = {"steps": summary["steps"], "train_images_per_s": summary["images_per_s"],
           "loader_wait_share": summary["loader_wait_share"], "train_peak_gib": peak,
           "losses": {key: logged[-1][key] for key in losses + ["loss"]},
           "counts": ran(counts), "moved": moved, "checkpoint": summary["checkpoints"][-1]}
    say(f"{tag} ({gpu}): " + json.dumps({k: v for k, v in out.items() if k != "moved"}))
    del handle, summary, before
    torch.cuda.empty_cache()
    return out


def mask_entry_eval(config: str, root: str, ckpt: str, gpu: str) -> dict:
    """The test CLI's ``--eval bbox segm`` on ``mask_coco_set``'s val frames
    from ``ckpt``: one result per frame, every bbox and segm stat present
    and a number, K1 at 7 and 14 launched exactly (per batch: once for
    Mask R-CNN, six and twice for HTC)."""
    name = os.path.splitext(os.path.basename(config))[0]
    torch.cuda.synchronize()
    reset_counts()
    metrics = test_cli([config, ckpt, "--device", "cuda", "--eval", "bbox", "segm",
                        *cli_options(mask_options(root))])
    counts = read_counts()
    batches = 3  # the 3 landscape frames at batch 2, then the portrait one
    n = 1 if config == MASK_CONFIG else 6
    htc_launches(counts, BF16, f"bf16 mask entry {name} eval", n * batches,
                 (1 if config == MASK_CONFIG else 2) * batches)
    stats = {k: metrics[k] for k in SEGM_KEYS + ("bbox_mAP", "bbox_mAP_50")}
    if metrics["num_results"] != 4 or not all(isinstance(v, float) for v in stats.values()):
        raise AssertionError(f"{name} test CLI: {metrics['num_results']} results, {stats}")
    out = {"num_results": metrics["num_results"], **stats, "counts": ran(counts),
           "eval_images_per_s": metrics["eval_stats"]["images_per_s"]}
    say(f"bf16 mask entry {name} test CLI ({gpu}): " + json.dumps(out))
    return out


def mask_e2e_trains(gpu: str, synth: str, work: str) -> dict:
    """``scripts/e2e_ap_check.py --segm``'s recipe through the port's CLIs in
    bfloat16: the tiny Mask R-CNN (4 classes) from scratch on the shapes
    set, MASK_E2E_EPOCHS epochs at batch MASK_E2E_BATCH, lr MASK_E2E_LR,
    warmup MASK_E2E_WARMUP, decay at 2/3 of the epochs and 2 before the
    end, no validation, the 7 x 7 and 14 x 14 kernels launched once a step;
    then the test CLI's ``--eval bbox segm`` on the 50 val images (the
    forward kernels at 7 and 14 once a batch): bbox and segm mAP at least
    E2E_MIN_MAP."""
    epochs = MASK_E2E_EPOCHS
    decay = sorted(e for e in {2 * epochs // 3, epochs - 2} if e > 0)
    opts = cli_options(data_options(
        synth, BF16, **{"data.samples_per_gpu": MASK_E2E_BATCH, "runner.max_epochs": epochs,
                        "optimizer.lr": MASK_E2E_LR, "lr_config.warmup_iters": MASK_E2E_WARMUP,
                        "lr_config.step": "[" + ",".join(map(str, decay)) + "]",
                        "model.backbone.frozen_stages": -1,
                        "model.roi_head.bbox_head.num_classes": 4,
                        "model.roi_head.mask_head.num_classes": 4}))
    wd = os.path.join(work, "mask_e2e")
    t0 = time.perf_counter()
    reset_counts()
    summary = train_cli([MASK_CONFIG, "--device", "cuda", "--tiny", "--no-validate", "--seed",
                         "0", "--work-dir", wd, *opts])
    counts = read_counts()
    train_s = time.perf_counter() - t0
    reset_counts()
    metrics = test_cli([MASK_CONFIG, os.path.join(wd, f"epoch_{epochs}"), "--device", "cuda",
                        "--tiny", "--eval", "bbox", "segm", *opts])
    eval_counts = read_counts()
    out = {"epochs": epochs, "batch": MASK_E2E_BATCH, "steps": summary["steps"],
           **{k: metrics[k] for k in ("bbox_mAP", "bbox_mAP_50") + SEGM_KEYS[:2]},
           "last_loss": summary["last_metrics"]["loss"],
           "last_loss_mask": summary["last_metrics"]["loss_mask"],
           "train_images_per_s": summary["images_per_s"],
           "loader_wait_share": summary["loader_wait_share"], "train_s": train_s,
           "eval_images_per_s": metrics["eval_stats"]["images_per_s"],
           "wall_s": time.perf_counter() - t0, "counts": ran(counts),
           "eval_counts": ran(eval_counts)}
    say(f"bf16 mask e2e shapes set ({gpu}): " + json.dumps(out))
    s = summary["steps"]
    htc_launches(counts, BF16, "bf16 mask e2e train", s, s, s, s)
    b = -(-metrics["num_results"] // MASK_E2E_BATCH)  # the val images share one bucket
    htc_launches(eval_counts, BF16, "bf16 mask e2e eval", b, b)
    if not (metrics["bbox_mAP"] >= E2E_MIN_MAP and metrics["segm_mAP"] >= E2E_MIN_MAP):
        raise AssertionError(f"mask e2e: bbox mAP {metrics['bbox_mAP']}, segm mAP "
                             f"{metrics['segm_mAP']}; both must reach {E2E_MIN_MAP}")
    return out


def start_e2e(kind: str, synth: str, work: str):
    """A bf16 e2e training (``kind``: "flagship", ``e2e_trains``, or "mask",
    ``mask_e2e_trains``) in a child process on the same card (``python3
    chip_smoke.py --e2e-child <kind> <synth> <work>``), to run beside the
    parent's timing-free checks: both e2e trainings are host-bound and
    leave the card mostly idle.  Returns the process and its output's path."""
    log = os.path.join(work, f"e2e_{kind}.log")
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--e2e-child", kind,
                                 synth, work], stdout=f, stderr=subprocess.STDOUT, cwd=REPO)
    return proc, log


def finish_e2e(proc, log: str) -> dict:
    """Wait for ``start_e2e``'s child, print its lines but the train log's,
    and return its result; raises with its output's end where it failed."""
    try:
        rc = proc.wait(timeout=E2E_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    with open(log) as f:
        lines = f.read().splitlines()
    result = [line for line in lines if line.startswith("E2E_RESULT ")]
    if rc != 0 or not result:
        raise AssertionError(f"the e2e child ({log}) exited {rc}:\n" + "\n".join(lines[-30:]))
    for line in lines:
        if " - INFO - " not in line and not line.startswith("E2E_RESULT "):
            say(line)
    return json.loads(result[-1][len("E2E_RESULT "):])


def mask_entry_phase(gpu: str, steps: int) -> dict:
    """The phase "mask entry" at full width: Mask R-CNN and HTC (with its
    semantic head) in bfloat16 through ``train_detector`` (``steps`` steps
    each) and the test CLI on ``mask_coco_set``'s frames.  The tiny Mask
    R-CNN's e2e, ``mask_e2e_trains``, runs in a child process
    (``start_e2e``)."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_mask_")
    out = {}
    try:
        frames = mask_coco_set(os.path.join(work, "frames"))
        say(f"mask entry set written in {time.perf_counter() - t0:.1f} s: 6 + 4 frames "
            f"{UTDAC_FRAMES[:2] + COCO_FRAMES} with polygons, an RLE ring, a crowd box and PNG "
            "stuff maps")
        for name, config in (("mask_rcnn", MASK_CONFIG), ("htc", HTC_CONFIG)):
            train = mask_entry_train(config, frames, work, gpu, steps)
            out[name] = {"train": train,
                         "eval": mask_entry_eval(config, frames, train.pop("checkpoint"), gpu)}
            say(f"wall {time.perf_counter() - t0:.1f} s of the phase")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    say(f"phase mask entry: {out['wall_s']:.1f} s")
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


def main(argv) -> int:
    readings = argv[1:] if argv[:1] == ["--step-readings"] else None
    e2e_child = argv[1:] if argv[:1] == ["--e2e-child"] and len(argv) == 4 else None
    if readings is None and e2e_child is None and argv not in (
            [], ["--cascade"], ["--htc"], ["--mask-entry"], ["--fork-heads"], ["--tta-caffe"],
            ["--norms-plugins"]):
        print("usage: python3 chip_smoke.py [--step-readings [f32|bf16] [model ...] | "
              "--cascade | --htc | --mask-entry | --fork-heads | --tta-caffe | --norms-plugins]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if e2e_child is not None:  # the parent built the kernels
        torch.set_num_threads(E2E_CHILD_THREADS)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        kind, synth, work = e2e_child
        out = (e2e_trains(BF16, card(), synth, work) if kind == "flagship"
               else mask_e2e_trains(card(), synth, work))
        say("E2E_RESULT " + json.dumps(out))
        return 0
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
    if readings is not None:
        dtypes = [d for tag, d in (("f32", torch.float32), ("bf16", BF16)) if tag in readings]
        step_readings(gpu, dtypes=dtypes, names=[n for n in readings if n not in ("f32", "bf16")])
        return 0
    if argv == ["--cascade"]:
        cascade_phase(gpu)
        cascade_tiny()
        return 0
    if argv == ["--htc"]:
        htc_phase(gpu)
        htc_tiny()
        return 0
    if argv == ["--fork-heads"]:
        fork_phase(gpu)
        fork_tiny()
        return 0
    if argv == ["--tta-caffe"]:
        tta_caffe_phase(gpu)
        tta_caffe_tiny()
        return 0
    if argv == ["--norms-plugins"]:
        norms_phase(gpu)
        norms_tiny()
        return 0
    if argv == ["--mask-entry"]:  # the full-width part alone, then the e2e
        mask_entry_phase(gpu, MASK_ENTRY_STEPS_ALONE)
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            synth = os.path.join(work, "shapes")
            generate(synth, n_train=200, n_val=50, seed=0)
            finish_e2e(*start_e2e("mask", synth, work))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0
    walls = {"nvcc": time.perf_counter() - t0}
    t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        walls[name] = now - t_phase
        t_phase = now
        say(f"phase {name}: {walls[name]:.1f} s; wall {now - t_start:.1f} s")

    mc = load_config(CONFIG).model.to_dict()
    mask_mc = load_config(MASK_CONFIG).model.to_dict()
    odd = odd_case(seed=2)
    runs, mask_runs = {}, {}
    for dtype in (torch.float32, BF16):
        runs[dtype] = run_paths(mc, dtype, gpu, odd)
        say(f"wall {time.perf_counter() - t_start:.1f} s")
        mask_runs[dtype] = run_mask_paths(mask_mc, dtype, gpu, odd)
        say(f"wall {time.perf_counter() - t_start:.1f} s")
    phase_done("flagship and Mask R-CNN")

    # ---------------------------------------- boosting family at full width
    x101 = {}
    for dtype in (torch.float32, BF16):
        x101[dtype] = run_x101(dtype, gpu)
        say(f"wall {time.perf_counter() - t_start:.1f} s")
    family = {}
    for name in FAMILY_OTHERS:
        family[name] = run_family_config(name, gpu)
    phase_done("boosting family")

    # ----------------------------------------------------------------- cascade
    cascade = cascade_phase(gpu)
    phase_done("cascade")

    # --------------------------------------------------------------------- HTC
    htc = htc_phase(gpu)
    phase_done("htc")

    # -------------------------------------------------------------- fork heads
    fork = fork_phase(gpu)
    phase_done("fork heads")

    # ------------------------------------------------------------ tta + caffe
    tta_caffe = tta_caffe_phase(gpu)
    phase_done("tta + caffe")

    # -------------------------------------------------------- norms + plugins
    norms = norms_phase(gpu)
    phase_done("norms + plugins")


    # ------------------ entry points: COCO-format data, train / test CLIs, e2e
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    children = []
    try:
        t0 = time.perf_counter()
        utdac, synth = os.path.join(work, "utdac_like"), os.path.join(work, "shapes")
        generate(synth, n_train=200, n_val=50, seed=0)
        # the flagship's and the tiny Mask R-CNN's bf16 e2e trainings run in
        # child processes on the card, host-bound, beside the entry points,
        # "mask entry" and the tiny-model checks; the parent leaves them cores
        children = [start_e2e(kind, synth, work) for kind in ("flagship", "mask")]
        threads = torch.get_num_threads()
        torch.set_num_threads(max(threads - 2 * E2E_CHILD_THREADS, 1))
        generate(utdac, n_train=24, n_val=9, seed=0, frame_sizes=UTDAC_FRAMES, n_portrait=2,
                 object_scale=0.3)
        say(f"synthetic COCO sets written in {time.perf_counter() - t0:.1f} s: 24 + 9 "
            f"UTDAC-sized frames {UTDAC_FRAMES} (2 portrait each), 200 + 50 shapes images")
        entry, e2e = {}, {}
        for dtype in (torch.float32, BF16):
            entry[dtype] = entry_points(dtype, gpu, utdac, work)
            say(f"wall {time.perf_counter() - t_start:.1f} s")
        phase_done("entry points, beside the e2e trainings")

        # --------- mask entry: masks and stuff maps through the loader, segm
        mask_entry = mask_entry_phase(gpu, MASK_ENTRY_STEPS)
        phase_done("mask entry, beside the e2e trainings")
        e2e[torch.float32] = e2e_trains(torch.float32, gpu, synth, work)

        # -------------------------------------------- tiny flagship, GPU vs CPU
        n_tiny = tiny_gpu_matches_cpu(seed=3)
        say(f"tiny flagship: GPU predict matches CPU predict ({n_tiny} detections)")
        tiny_metrics, tiny_worst, tiny_repeat, _ = tiny_train_gpu_matches_cpu(seed=7)
        say(f"tiny flagship: a GPU train step matches the CPU one (loss "
            f"{tiny_metrics['loss']:.6g}, worst parameter error {tiny_worst:.3g} of its "
            f"tolerance); two GPU steps from the same state give the same bits: {tiny_repeat}")
        level_errs, match = tiny_bf16_gpu_matches_cpu(seed=3)
        say("tiny bf16 flagship, GPU against CPU: C2-C5, P3-P7 max rel err "
            + ", ".join(f"{e:.3g}" for e in level_errs)
            + f" (tolerance {BF16_TOL['levels']}); roi_predict on the CPU's levels and proposals: "
            f"{match[0]} of {match[1]} detections matched, boxes within {match[2]:.3g} px, scores "
            f"within {match[3]:.3g}")
        b16_metrics, _, _, b16_summary = tiny_train_gpu_matches_cpu(seed=7, dtype=BF16)
        say(f"tiny bf16 flagship: a GPU train step holds the bf16 step rule (loss "
            f"{b16_metrics['loss']:.6g}, median GPU error over the float32 step's distance "
            f"{b16_summary['ratio_median']:.3g}, median tensor "
            f"{b16_summary['median_of_update']:.3g} of its update)")

        # ------------------------------------------ tiny Mask R-CNN, GPU vs CPU
        for dtype in (torch.float32, BF16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            say(f"tiny {tag} Mask R-CNN: GPU predict matches CPU predict: "
                f"{tiny_mask_gpu_matches_cpu(seed=3, dtype=dtype)}")
            m, worst, repeat, summary = tiny_train_gpu_matches_cpu(seed=7, dtype=dtype,
                                                                   config=tiny_mask_config)
            say(f"tiny {tag} Mask R-CNN: a GPU train step matches the CPU one (loss "
                f"{m['loss']:.6g}, loss_mask {m['loss_mask']:.6g}, worst f32 parameter error "
                f"{worst:.3g} of its tolerance, median tensor "
                f"{summary['median_of_update']:.3g} of its update"
                + (f", median GPU error over the float32 step's distance "
                   f"{summary['ratio_median']:.3g}" if "ratio_median" in summary else "")
                + f"); two GPU steps from the same state give the same bits: {repeat}")

        # -------------- the step rules' teeth: a deliberately wrong gradient
        teeth = {}
        for name, config in (("flagship", tiny_config), ("mask_rcnn", tiny_mask_config)):
            for dtype in (torch.float32, BF16):
                tag = "f32" if dtype == torch.float32 else "bf16"
                teeth[f"{tag} {name}"] = broken = wrong_step_broken(config, WRONG_K4_CAUGHT,
                                                                    dtype=dtype)
                if not broken:
                    raise AssertionError(f"the {tag} step rule holds for the tiny {name}'s step "
                                         f"with level 0's K4 gradient x {WRONG_K4_CAUGHT}")
                say(f"tiny {tag} {name}, level 0's K4 gradient x {WRONG_K4_CAUGHT}: the {tag} step "
                    f"rule breaks: {'; '.join(broken[:4])}")

        # ------------------------------- tiny ResNeXt and Res2Net-DCN, GPU vs CPU
        tiny_family = {}
        for name, config in TINY_FAMILY:
            n = tiny_gpu_matches_cpu(3, config)
            tiny_family[name] = {"predict_detections": n}
            for dtype in (torch.float32, BF16):
                tag = "f32" if dtype == torch.float32 else "bf16"
                m, worst, repeat, summary = tiny_train_gpu_matches_cpu(7, dtype, config)
                tiny_family[name][tag] = {"loss": m["loss"], "worst_of_tolerance": worst,
                                          **summary, "repeat_identical": repeat}
            say(f"tiny {name}: GPU predict matches CPU predict ({n} detections); one train step "
                f"on the GPU against the CPU: {tiny_family[name]}")

        # ------------------- tiny ProbCascade and HTC, GPU vs CPU, C.2, teeth
        cascade.update(cascade_tiny())
        htc.update(htc_tiny())
        fork.update(fork_tiny())
        tta_caffe.update(tta_caffe_tiny())
        norms.update(norms_tiny())

        # ---------------------------------- ROADMAP C.2: a bitwise repeatable step
        repeat_report = {}
        for name, config in (("flagship", tiny_config), ("mask_rcnn", tiny_mask_config),
                             *TINY_FAMILY):
            for dtype in (torch.float32, BF16):
                repeat_report.update(c2_check(name, config, dtype, unpinned=name == "flagship"))
        repeat_report.update(cascade["repeat"])
        repeat_report.update(htc["repeat"])
        repeat_report.update(fork["repeat"])
        repeat_report.update(tta_caffe["repeat"])
        repeat_report.update(norms["repeat"])
        phase_done("tiny models and C.2, beside the e2e trainings")
        torch.set_num_threads(threads)
        e2e[BF16] = finish_e2e(*children[0])
        mask_entry["e2e"] = finish_e2e(*children[1])
        phase_done("e2e trainings' rest")
    finally:
        for proc, _ in children:
            if proc.poll() is None:  # a check failed: stop the e2e trainings
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)

    r32, r16 = runs[torch.float32], runs[BF16]
    m32, m16 = mask_runs[torch.float32], mask_runs[BF16]
    say("summary (" + gpu + "): " + json.dumps({
        "entry_points": {("f32" if d == torch.float32 else "bf16"): {
            **entry[d], "e2e": e2e[d]} for d in (torch.float32, BF16)},
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
        "boosting_family": {
            "x101_32x4d_utdac": {
                ("f32" if d == torch.float32 else "bf16"): {
                    k: x101[d][k] for k in ("predict_ms", "predict_stages", "predict_peak",
                                            "train_ms", "train_parts", "train_peak")}
                for d in (torch.float32, BF16)},
            "bf16_configs": {n[len("boosting_rcnn_"):-3]: {
                k: v for k, v in r.items() if not k.endswith("_counts")}
                for n, r in family.items()},
            "tiny": tiny_family},
        "cascade": {
            "prob_cascade_utdac": {
                ("f32" if d == torch.float32 else "bf16"): {
                    k: cascade["utdac"][d][k] for k in ("predict_ms", "predict_stages",
                                                        "predict_peak", "train_ms",
                                                        "train_peak")}
                for d in (torch.float32, BF16)},
            "cascade_rcnn_coco_bf16": {k: v for k, v in cascade["coco"].items()
                                       if not k.endswith("_counts")},
            "tiny": cascade["tiny"], "wall_s": cascade["wall_s"]},
        "htc": {
            "htc_r50_fpn_1x_coco": {
                ("f32" if d == torch.float32 else "bf16"): {
                    k: htc["htc"][d][k] for k in ("predict_ms", "predict_stages",
                                                  "predict_peak", "train_ms", "train_peak")}
                for d in (torch.float32, BF16)},
            "cascade_mask_rcnn_bf16": {k: v for k, v in htc["cascade_mask"].items()
                                       if not k.endswith("_counts")},
            "tiny": htc["tiny"], "wall_s": htc["wall_s"]},
        "fork_heads": {
            **{f"{model}_{'f32' if d == torch.float32 else 'bf16'}": {
                k: v for k, v in fork[model][d].items() if not k.endswith("_counts")}
               for model in ("dynamic", "atss") for d in (torch.float32, BF16)},
            "bf16_configs": {n: {k: v for k, v in r.items() if not k.endswith("_counts")}
                             for n, r in fork["bf16"].items()},
            "tiny": fork["tiny"], "wall_s": fork["wall_s"]},
        "tta_caffe": {
            "flagship_tta": {("f32" if d == torch.float32 else "bf16"): {
                name: {k: v for k, v in r.items() if k != "counts"}
                for name, r in tta_caffe["tta"][d].items() if name != "check_flipped"}
                for d in (torch.float32, BF16)},
            "faster_rcnn_r50_caffe": {("f32" if d == torch.float32 else "bf16"): {
                k: v for k, v in r.items() if not k.endswith("_counts")}
                for d, r in tta_caffe["caffe"].items()},
            "tiny": tta_caffe["tiny"], "wall_s": tta_caffe["wall_s"]},
        "norms_plugins": {
            **{f"gcnet_syncbn_mask_rcnn_{'f32' if d == torch.float32 else 'bf16'}": {
                k: v for k, v in r.items() if not k.endswith("_counts")}
               for d, r in norms["gcnet"].items()},
            "bf16_configs": {n: {k: v for k, v in r.items() if not k.endswith("_counts")}
                             for n, r in norms["bf16"].items()},
            "tiny": norms["tiny"], "wall_s": norms["wall_s"]},
        "mask_entry": mask_entry,
        "phase_walls_s": walls,
        "wall_s": time.perf_counter() - t_start}))
    records = (kernel_records(r32, torch.float32, box=m32) + kernel_records(r16, BF16, box=m16)
               + kernel_records(m32, torch.float32, "_o14") + kernel_records(m16, BF16, "_o14"))
    # the family's, the entry points' and the e2e paths launch the 7 x 7
    # kernels too (counted under ``launches_by_path``; ``launches`` is the
    # flagship's), and the X101 paths held them to their plain versions
    utdac = cascade["utdac"]
    paths = [("x101_predict", x101[d]["predict_counts"]) for d in x101] + [
        ("x101_train", x101[d]["train_counts"]) for d in x101] + [
        ("cascade_predict", utdac[d]["predict_counts"]) for d in utdac] + [
        ("cascade_train", utdac[d]["train_counts"]) for d in utdac] + [
        ("cascade_coco_predict", cascade["coco"]["predict_counts"]),
        ("cascade_coco_train", cascade["coco"]["train_counts"])] + [
        ("htc_predict", htc["htc"][d]["predict_counts"]) for d in htc["htc"]] + [
        ("htc_train", htc["htc"][d]["train_counts"]) for d in htc["htc"]] + [
        ("cascade_mask_predict", htc["cascade_mask"]["predict_counts"]),
        ("cascade_mask_train", htc["cascade_mask"]["train_counts"])] + [
        (f"family_{part}", {k: sum(f[f"{part}_counts"][k] for f in family.values())
                            for k in counters()}) for part in ("predict", "train")] + [
        (path, counts) for d in (torch.float32, BF16)
        for path, counts in (("entry_train", entry[d]["train_counts"]),
                             ("entry_eval", entry[d]["eval_counts"]),
                             ("e2e_train", e2e[d]["counts"]))] + [
        (f"mask_entry_{name}_{part}", mask_entry[name][part]["counts"])
        for name in ("mask_rcnn", "htc") for part in ("train", "eval")] + [
        ("mask_e2e_train", mask_entry["e2e"]["counts"]),
        ("mask_e2e_eval", mask_entry["e2e"]["eval_counts"])] + [
        (f"{model}_{part}", fork[model][d][f"{part}_counts"])
        for model in ("dynamic", "atss") for d in (torch.float32, BF16)
        for part in ("predict", "train")] + [
        (f"fork_bf16_{part}", {k: sum(f[f"{part}_counts"][k] for f in fork["bf16"].values())
                               for k in counters()}) for part in ("predict", "train")] + [
        (f"tta_{name}", tta_caffe["tta"][d][name]["counts"])
        for d in (torch.float32, BF16) for name in ("flip", "multi")] + [
        (f"caffe_{part}", tta_caffe["caffe"][d][f"{part}_counts"])
        for d in (torch.float32, BF16) for part in ("predict", "train")] + [
        ("entry_tta_eval", entry[d]["tta_eval_counts"]) for d in (torch.float32, BF16)] + [
        (f"norms_gcnet_{part}", norms["gcnet"][d][f"{part}_counts"])
        for d in (torch.float32, BF16) for part in ("predict", "train")] + [
        (f"norms_bf16_{part}", {k: sum(f[f"{part}_counts"][k] for f in norms["bf16"].values())
                                for k in counters()}) for part in ("predict", "train")]
    # ... and the X101 and cascade paths held them to their plain versions
    checked = {d: [x101[d][k] for k in ("check_predict", "check_train")]
               + [utdac[d][k] for k in ("check_predict", "check_train")] for d in x101}
    checked[BF16].append(cascade["coco"]["check_predict"])
    for d in checked:  # ... and the fork heads' last stage at its predict RoIs, a TTA
        # flipped view's pyramid and RoIs and the caffe model's predict RoIs
        checked[d] += [fork[model][d]["check_predict"] for model in ("dynamic", "atss")]
        checked[d] += [tta_caffe["tta"][d]["check_flipped"], tta_caffe["caffe"][d]["check_predict"]]
        # ... and the GCNet model's box proposals and train slots
        checked[d] += [norms["gcnet"][d][k] for k in ("check_box_predict", "check_box_train")]
    more_errs = {f"roi_align_{part}{'' if d == torch.float32 else '_bf16'}":
                 max(c[part][0] for c in checked[d]) for d in checked for part in ("fwd", "bwd")}
    # ... and at 14, the GCNet model's mask RoIs and positive train slots
    for d, nr in norms["gcnet"].items():
        sfx = "" if d == torch.float32 else "_bf16"
        for part in ("fwd", "bwd"):
            name = f"roi_align_{part}{sfx}_o14"
            more_errs[name] = max([more_errs.get(name, 0.0)] + [
                nr[k][part][0] for k in ("check_mask_predict", "check_mask_train")])
    # ... and the HTC paths on the one semantic level, at 7 and 14
    semantic = {}
    for d, hr in htc["htc"].items():
        sfx = "" if d == torch.float32 else "_bf16"
        for o, k in (("", "7"), ("_o14", "14")):
            for part in ("fwd", "bwd"):
                name = f"roi_align_{part}{sfx}{o}"
                runs_ = [hr[f"sem_predict_{k}"], hr[f"sem_train_{k}"]]
                more_errs[name] = max([more_errs.get(name, 0.0)]
                                      + [x["check"][part][0] for x in runs_])
                semantic[name] = {
                    path: {"rois": x["rois"], "valid": x["valid"], "level": x["level"],
                           "call_ms": x["timed"][part]["call"],
                           "kernel_ms": x["timed"][part]["kernel"],
                           "plain_ms": x["timed"][part]["plain"],
                           "bound_ms": x["timed"][part]["bound"][0],
                           **({"tile_spread": x["spread"]} if part == "bwd" else {})}
                    for path, x in (("predict", runs_[0]), ("train", runs_[1]))}
    for record in records:
        for path, counts in paths:
            n = counts.get(record["name"], 0)
            if n:
                record.setdefault("launches_by_path", {})[path] = n
        if record["name"] in more_errs:
            record["max_abs_err"] = max(record["max_abs_err"], more_errs[record["name"]])
        if record["name"] in semantic:
            record["htc_semantic_shapes"] = semantic[record["name"]]
        for d in utdac:
            sfx = "" if d == torch.float32 else "_bf16"
            for part in ("fwd", "bwd"):
                if record["name"] == f"roi_align_{part}{sfx}":
                    record["cascade_stage2_shapes"] = {
                        path: {"call_ms": t["call"], "kernel_ms": t["kernel"],
                               "plain_ms": t["plain"], "bound_ms": t["bound"][0]}
                        for path, t in (("predict", utdac[d]["predict_shapes"][part]),
                                        ("train", utdac[d]["train_shapes"][part]))}
    for record in records:
        timings = [v for part in (record, record.get("train_shapes", {}),
                                  record.get("predict_shapes", {}),
                                  *record.get("box_shapes", {}).values(),
                                  *record.get("cascade_stage2_shapes", {}).values(),
                                  *record.get("htc_semantic_shapes", {}).values())
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
    sys.exit(main(sys.argv[1:]))
