"""The train loop (the epoch loop of the JAX package's ``tools/train.py``,
as a function): ``train_detector(cfg, work_dir, ...)``.

From the config: the model (``--tiny`` shrinks a two-stage config, the
mask and HTC ones too, to ResNet-18 at width 8 on a 128 x 160 canvas),
its compute dtype (``compute_dtype``), the train dataset and loader
(``data.train``, batch ``samples_per_gpu``; with the instances' mask crops
for a model with a mask head, with the stuff maps of ``seg_prefix`` for
one with a semantic head; the pipeline's ``lsj_range``, ``albu`` and
``instaboost`` augmentations; a wrapped set's pipeline is the one inside
it),
SGD with momentum and weight decay, or AdamW (the Swin configs'), and the
gradient clip (``optimizer``, ``optimizer_config``), the step schedule with linear
warmup (``lr_config``, epochs from ``runner.max_epochs``), checkpoints
every ``checkpoint_config.interval`` epochs and evaluation every
``evaluation.interval`` epochs on ``data.val``.  Each canvas (landscape,
and the transposed one of portrait batches) gets its own train step with
its own anchors.  A checkpoint holds the model, the optimizer's momentum
buffers and the sampler generator, so a resumed run continues bit for bit:
one saved at an epoch's end (``epoch_<n>``) resumes at the next epoch, one
saved where ``max_iters`` stopped the run mid-epoch (``iter_<step>``)
resumes at the next batch of that epoch.

It logs the losses, learning rate, gradient norm, images per second
(loading included) and the share of wall time spent waiting on the loader.

Data-parallel training (JAX ``tools/train.py:117-131, :208-209, :447``):
``train_detector`` joins the process group that the environment names
(``parallel/mesh.py::init_distributed``), shards the train loader by rank,
logs the ranks' averaged losses, and leaves the logs and checkpoints to
rank 0 (the others wait at a barrier).  Every rank evaluates, as every JAX
process does (``tools/train.py:467``), so the barrier never waits out an
evaluation.  The DG configs'
loader targets (``domain_file``, from the pipeline or ``data.train``,
``jigsaw``, ``dgaug``) are read from the split.

Not ported: the multi-step dispatch, the compile cache and device-put
helpers (TPU dispatch and relay work-arounds), and the ``outside_grad`` /
``stale`` proposal modes.
"""
from __future__ import annotations

import copy
import math
import os
import time
from typing import Any, Dict, Optional

import torch

from ..builder import build_detector, resolve_device
from ..config import Config, load_config
from ..data.builder import build_dataset
from ..data.loader import DetDataLoader, FakeDetLoader
from ..utils.logging import JsonLogWriter, collect_env, get_root_logger, log_to_file
from ..weights import load_pretrained
from .checkpoint import restore_checkpoint, save_checkpoint
from .eval import run_eval
from ..parallel.mesh import (barrier, cluster_spec_from_env, init_distributed, is_main, local_device,
                             rank, world_size)
from .train import OPT_TYPES, aux_parameters, make_optimizer, make_train_step, step_lr_schedule

__all__ = ["TINY_CANVAS", "shrink_model", "compute_dtype", "model_config", "check_data",
           "train_loader", "test_geometry", "eval_loader", "tta_options", "Trainer",
           "check_runner", "check_schedule", "config_optimizer", "build_trainer",
           "train_detector"]

TINY_CANVAS = (128, 160)
TINY_GN_GROUPS = 8  # divides the shrunk backbone's, neck's and heads' widths
# hooks whose work the loop does by construction
_INHERENT_HOOKS = ("NumClassCheckHook", "CheckInvalidLossHook")
# the JAX loader's augmentations and extra targets that the port's loader lacks
_UNPORTED_PIPELINE = ("mosaic_prob", "mixup_prob", "autoaugment", "ssd_aug")
# the loader's train-time augmentations, read from the pipeline
_AUGMENTATIONS = ("lsj_range", "albu", "instaboost")


# the keys of a ResNeXt or Res2Net backbone that ResNet-18 has no use for
# (the JAX build_resnet ignores the first three, its BasicBlock the dcn)
_BIG_BLOCK_KEYS = ("groups", "base_width", "scales", "dcn", "stage_with_dcn")


# the zoo's backbones at the tiny size: their changes and stage widths
# (RegNetX-400MF, HRNet-W18, ResNeSt-50 at a 16-channel stem and width 8,
# DetectoRS ResNet-50 at width 8, Swin at 16 dims with one shifted block)
_ZOO_TINY = {
    "RegNet": ({"arch": "regnetx_400mf"}, [32, 64, 160, 384]),
    "HRNet": ({"arch": "w18"}, [18, 36, 72, 144]),
    "ResNeSt": ({"depth": 50, "stem_channels": 16, "base_channels": 8}, [32, 64, 128, 256]),
    "DetectoRS_ResNet": ({"depth": 50, "base_channels": 8}, [32, 64, 128, 256]),
    "SwinTransformer": ({"embed_dims": 16, "depths": (2, 1, 1, 1), "num_heads": (1, 2, 4, 8)},
                        [16, 32, 64, 128]),
}


def _each(x):
    """A config's list of stage dicts (a cascade's), or its one dict."""
    return x if isinstance(x, list) else [x]


def shrink_model(mc: Dict[str, Any]) -> Dict[str, Any]:
    """The two-stage branch of the JAX ``tools/train.py::shrink_model``
    (the Boosting R-CNN family, Faster and Mask R-CNN, Cascade R-CNN, the
    ProbCascade and the other ensemble cascades, Cascade Mask R-CNN, HTC
    and Dynamic R-CNN): the backbone (ResNet, ResNeXt or Res2Net) becomes
    ResNet-18 at width 8, neck 32, RPN 32 (the ATSS RPN's 2 convs deep, the
    plain RPN's count of convs kept), FC 64 (every cascade stage's), fewer proposals
    and RoIs (every stage's sampler).  The mask heads keep their widths and
    pool the neck's 32 channels, as in the JAX package; Mask Scoring
    R-CNN's MaskIoU head gets convs of 16 and FCs of 64 (the JAX shrink
    keeps its 256 and 1024); the semantic head's
    width becomes the neck's, which its embedding is added to (the JAX
    shrink keeps its 256 channels, and its tiny HTC then fails to build).
    Two more changes where the JAX shrink's model cannot build: a backbone
    with ``plugins`` becomes ResNet-50 at width 8 (their bottlenecks; the
    JAX ResNet asserts that a BasicBlock takes none), and every GN
    ``norm_cfg`` gets ``TINY_GN_GROUPS`` groups, which divide every shrunk
    width (a GN(32) stem over 8 channels fails to build in flax).
    A neck-less config (C4, DC5) keeps its backbone's stages, strides and
    dilations on ResNet-18 at width 8 (the C4 res5 head takes half the
    backbone's output channels as planes); the JAX shrink cannot shrink
    one.  The zoo's backbones keep their kind at their smallest or a
    narrowed width (``_ZOO_TINY``: RegNetX-400MF, HRNet-W18, ResNeSt-50 at
    width 8), where the JAX shrink leaves them at full width beside a
    neck sized for ResNet-18; DetectoRS's ResNet-50 and the RFP's feedback
    copy go to width 8 (as the JAX package's own tests shrink them,
    ``tests/test_all_configs_forward.py:89-92``), Swin to 16 dims, heads
    (1, 2, 4, 8) and depths (2, 1, 1, 1), so that a shifted block runs
    (the JAX tests' depths are all 1); ``HiddenMixupResNet`` (DGaug's) stays one,
    around ResNet-18 at width 8, where the JAX shrink leaves it at
    ResNet-50 beside the shrunk neck, which then fails to build.  Other
    model types raise."""
    rpn = mc.get("rpn_head", {}).get("type")
    if rpn not in ("ATSSRPNHead", "RPNHead") or "roi_head" not in mc:
        raise NotImplementedError("--tiny shrinks the two-stage configs only")
    zoo = _ZOO_TINY.get(mc["backbone"].get("type"))
    if zoo:
        mc["backbone"].update(zoo[0])
        in_channels = zoo[1]
        if (mc.get("neck") or {}).get("type") == "RFP":  # its feedback backbone too
            mc["neck"]["rfp_backbone"].update(zoo[0])
    else:
        for key in _BIG_BLOCK_KEYS:
            mc["backbone"].pop(key, None)
        plugins = bool(mc["backbone"].get("plugins"))
        # HiddenMixupResNet keeps its kind around the small ResNet
        kind = "HiddenMixupResNet" if mc["backbone"].get("type") == "HiddenMixupResNet" \
            else "ResNet"
        mc["backbone"].update(type=kind, depth=50 if plugins else 18, base_channels=8)
        in_channels = [32, 64, 128, 256] if plugins else [8, 16, 32, 64]
    if mc.get("neck"):  # C4 and DC5 have none: their backbone keeps its stages
        mc["neck"].update(in_channels=in_channels, out_channels=32)
    for part in (mc["backbone"], mc.get("neck") or {}, *_each(mc["roi_head"]["bbox_head"]),
                 *_each(mc["roi_head"].get("mask_head") or [])):
        if (part.get("norm_cfg") or {}).get("type") == "GN":
            part["norm_cfg"] = dict(part["norm_cfg"], num_groups=TINY_GN_GROUPS)
    # the JAX shrink sets stacked_convs on the plain RPN too, where it is unread
    mc["rpn_head"].update(feat_channels=32, **({"stacked_convs": 2} if rpn == "ATSSRPNHead"
                                               else {}))
    roi = mc["roi_head"]
    for head in _each(roi["bbox_head"]):
        if head.get("type") != "BBoxHead":  # C4's res5 head has no FCs but its two
            head["fc_out_channels"] = 64
    for head in _each(roi.get("mask_head") or []):
        head["in_channels"] = 32
    if roi.get("mask_iou_head"):  # Mask Scoring R-CNN's, at the mask heads' scale
        roi["mask_iou_head"].update(in_channels=32, conv_out_channels=16, fc_out_channels=64)
    if roi.get("semantic_head"):
        roi["semantic_head"].update(in_channels=32, conv_out_channels=32)
    mc["train_cfg"]["rpn_proposal"].update(nms_pre=200, max_per_img=64)
    for rcnn in _each(mc["train_cfg"]["rcnn"]):
        rcnn["sampler"]["num"] = 32
    mc["test_cfg"]["rpn"].update(nms_pre=100, max_per_img=32)
    return mc


def compute_dtype(cfg: Config, dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """``dtype`` when given, else the config's ``compute_dtype``."""
    if dtype is not None:
        return dtype
    name = cfg.get("compute_dtype") or "float32"
    if name not in ("float32", "bfloat16"):
        raise NotImplementedError(f"compute_dtype={name!r} is not ported")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def model_config(cfg: Config, tiny: bool = False) -> Dict[str, Any]:
    mc = cfg.model.to_dict()
    return shrink_model(mc) if tiny else mc


def _load(cfg) -> Config:
    return load_config(cfg) if isinstance(cfg, str) else cfg


def _num_classes(mc: Dict[str, Any]) -> int:
    return _each(mc["roi_head"]["bbox_head"])[0].get("num_classes", 80)


def _split_pipeline(split_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """A split's pipeline: its wrapped set's (the first of a
    ``ConcatDataset``'s) with the split's own keys over it (a caffe strong
    baseline sets its ``img_norm`` on the ``RepeatDataset``).  The JAX
    ``tools/train.py`` reads the split's own pipeline only, and so trains a
    wrapped set at the default pipeline: at (800, 1344) without LSJ for the
    strong baselines, without the multi-scale range for LVIS."""
    inner = split_cfg.get("dataset") or (split_cfg.get("datasets") or [None])[0]
    return {**(_split_pipeline(inner) if inner else {}), **(split_cfg.get("pipeline") or {})}


def _dg_targets(pipeline: Dict[str, Any], split_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The loader's domain-generalisation targets: ``domain_file`` from the
    pipeline, else the split (the SUODAC base sets it on ``data.train``, as
    JAX ``tools/train.py:224-226`` reads it), ``jigsaw`` and ``dgaug``."""
    return dict(domain_file=pipeline.get("domain_file") or split_cfg.get("domain_file"),
                jigsaw=pipeline.get("jigsaw"), dgaug=bool(pipeline.get("dgaug", False)))


def _pipeline(data_cfg: Dict[str, Any], split: str, tiny: bool):
    pipeline = _split_pipeline(data_cfg[split])
    for key in _UNPORTED_PIPELINE:
        value = pipeline.get(key) or data_cfg[split].get(key)
        if value:
            raise NotImplementedError(f"data pipeline option {key}={value!r} is not ported "
                                      f"to PyTorch yet")
    canvas = TINY_CANVAS if tiny else tuple(pipeline.get("canvas", (800, 1344)))
    return pipeline, canvas


def check_data(cfg: Config) -> None:
    """Raise where the train split asks for a pipeline option the port
    lacks (``_UNPORTED_PIPELINE``) or a dataset type ``build_dataset`` does
    not take; reads the configs only."""
    data_cfg = cfg.data.to_dict()
    _pipeline(data_cfg, "train", False)

    def types(c):
        yield c.get("type", "CocoDataset")
        for inner in ([c["dataset"]] if c.get("dataset") else []) + list(c.get("datasets") or []):
            yield from types(inner)

    from ..data.builder import DATASET_TYPES

    for split in ("train", "val", "test"):
        for t in types(data_cfg.get(split) or {}):
            if t not in DATASET_TYPES:
                raise NotImplementedError(f"dataset type {t!r} is not ported to PyTorch yet")


def _targets(mc: Dict[str, Any]) -> Dict[str, bool]:
    """The mask heads' gt crops and the semantic head's stuff maps."""
    roi = mc.get("roi_head") or {}
    return {"with_masks": bool(roi.get("mask_head")),
            "with_semantic": bool(roi.get("semantic_head"))}


def train_loader(cfg: Config, mc: Dict[str, Any], device, seed: int = 0,
                 tiny: bool = False, num_shards: int = 1, shard_id: int = 0) -> DetDataLoader:
    """The train loader of ``data.train`` for the model config ``mc``: batch
    ``samples_per_gpu`` (a shard's, of ``num_shards``), the pipeline's
    canvas, scale, flip, ``max_gt``, multi-scale range, ``img_norm``,
    augmentations and domain-generalisation targets, with the targets
    ``mc``'s heads train on."""
    data_cfg = cfg.data.to_dict()
    pipeline, canvas = _pipeline(data_cfg, "train", tiny)
    return DetDataLoader(
        build_dataset(data_cfg["train"]), batch_size=data_cfg.get("samples_per_gpu", 2),
        num_shards=num_shards, shard_id=shard_id, **_dg_targets(pipeline, data_cfg["train"]),
        canvas=canvas, scale=tuple(pipeline.get("scale", (1333, 800))), train=True,
        flip_prob=pipeline.get("flip_prob", 0.5), max_gt=pipeline.get("max_gt", 100),
        seed=seed, mstrain_range=pipeline.get("mstrain_range"),
        semantic_stride=pipeline.get("semantic_stride", 8),
        img_norm=pipeline.get("img_norm", cfg.get("img_norm")), device=device,
        **{k: pipeline.get(k) for k in _AUGMENTATIONS}, **_targets(mc))


def test_geometry(cfg: Config, tiny: bool = False):
    """``(canvas, scale)`` of ``data.test``'s pipeline (the tiny canvas with
    ``tiny``)."""
    pipeline, canvas = _pipeline(cfg.data.to_dict(), "test", tiny)
    return canvas, tuple(pipeline.get("scale", (1333, 800)))


def eval_loader(cfg: Config, dataset, device, tiny: bool = False,
                split: str = "test") -> DetDataLoader:
    """The test-mode loader of ``data.<split>``'s pipeline on ``dataset``."""
    data_cfg = cfg.data.to_dict()
    pipeline, canvas = _pipeline(data_cfg, split, tiny)
    return DetDataLoader(dataset, batch_size=data_cfg.get("samples_per_gpu", 2), canvas=canvas,
                         scale=tuple(pipeline.get("scale", (1333, 800))), train=False,
                         img_norm=pipeline.get("img_norm", cfg.get("img_norm")), device=device)


def tta_options(cfg: Config, scales=None) -> Dict[str, Any]:
    """``run_eval_tta``'s keyword arguments for ``data.test`` (JAX
    ``tools/test.py``'s ``--tta``): the config's batch, the short sides
    ``scales`` (default: the pipeline's short side alone, flip-only TTA),
    ``long_side`` the pipeline scale's first value, and the pipeline's
    ``img_norm``.  ``--tiny`` leaves them as they are."""
    data_cfg = cfg.data.to_dict()
    pipeline, _ = _pipeline(data_cfg, "test", False)
    scale = tuple(pipeline.get("scale", (1333, 800)))
    return dict(batch_size=data_cfg.get("samples_per_gpu", 2),
                scales=list(scales or [scale[1]]), long_side=scale[0],
                img_norm=pipeline.get("img_norm", cfg.get("img_norm")))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """``detector``'s train step for each canvas, with one optimizer and
    one sampler ``generator``: ``trainer(batch) -> metrics``."""

    def __init__(self, detector, optimizer, generator: torch.Generator):
        self.detector = detector
        self.optimizer = optimizer
        self.generator = generator
        self._steps = {}

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        canvas = tuple(int(s) for s in batch["images"].shape[1:3])
        if canvas not in self._steps:
            anchors, nla = self.detector.anchors_for(canvas)
            self._steps[canvas] = make_train_step(self.detector, anchors, nla, self.optimizer)
        return self._steps[canvas](batch, generator=self.generator)


def check_runner(cfg: Config) -> None:
    """Raise on an iteration-based schedule (``runner.type='IterBasedRunner'``
    or ``lr_config.by_epoch=False``): the port trains by epochs, as the JAX
    package does, and would read its steps as epochs."""
    runner = cfg.get("runner") or {}
    if runner.get("type", "EpochBasedRunner") != "EpochBasedRunner":
        raise NotImplementedError(f"runner.type={runner.get('type')!r} is not ported (the "
                                  "port trains by epochs, runner.max_epochs)")
    if not (cfg.get("lr_config") or {}).get("by_epoch", True):
        raise NotImplementedError("lr_config.by_epoch=False is not ported (the port's step "
                                  "schedule decays at epochs)")


def _opt_type(cfg: Config) -> str:
    return str((cfg.get("optimizer") or {}).get("type", "sgd")).lower()


def check_schedule(cfg: Config) -> None:
    """Raise on what the port's optimizer and schedule do not take: an
    iteration-based schedule (``check_runner``), another optimizer than SGD
    with momentum or AdamW (JAX ``make_optimizer``'s two), another lr policy
    than the step one."""
    check_runner(cfg)
    opt = cfg.get("optimizer") or {}
    if _opt_type(cfg) not in OPT_TYPES or opt.get("nesterov", False):
        raise NotImplementedError(f"optimizer {opt!r} is not ported (SGD with momentum and "
                                  "AdamW are)")
    lrc = cfg.get("lr_config") or {}
    if lrc.get("policy", "step") != "step":
        raise NotImplementedError(f"lr_config policy {lrc.get('policy')!r} is not ported")


def config_optimizer(cfg: Config, detector, steps_per_epoch: int):
    """The config's optimizer and schedule on ``detector`` (JAX
    ``make_optimizer`` with the config's ``optimizer.type``: the JAX
    ``tools/train.py`` passes no ``opt_type`` and would train an ``adamw``
    config with SGD, ROADMAP C.4); what the port does not take raises
    (``check_schedule``)."""
    check_schedule(cfg)
    opt = cfg.get("optimizer") or {}
    lrc = cfg.get("lr_config") or {}
    sched = step_lr_schedule(opt.get("lr", 0.02), steps_per_epoch,
                             decay_epochs=lrc.get("step", [8, 11]),
                             warmup_iters=lrc.get("warmup_iters", 500),
                             warmup_ratio=lrc.get("warmup_ratio", 0.001))
    clip = (cfg.get("optimizer_config") or {}).get("grad_clip") or {}
    return make_optimizer(detector.net.parameters(), sched,
                          momentum=opt.get("momentum", 0.9),
                          weight_decay=opt.get("weight_decay", 1e-4),
                          grad_clip_norm=clip.get("max_norm"),
                          aux_params=aux_parameters(detector.net), opt_type=_opt_type(cfg))


def build_trainer(cfg: Config, detector, steps_per_epoch: int, seed: int = 0) -> Trainer:
    """The config's optimizer and schedule on ``detector``
    (``config_optimizer``), and a sampler generator seeded from ``seed``."""
    optimizer = config_optimizer(cfg, detector, steps_per_epoch)
    generator = torch.Generator(device=detector.device).manual_seed(seed + 1)
    return Trainer(detector, optimizer, generator)


def train_detector(cfg, work_dir: Optional[str] = None, *, detector=None, device=None,
                   seed: int = 0, resume_from: Optional[str] = None,
                   max_iters: Optional[int] = None, tiny: bool = False, fake_data: bool = False,
                   validate: bool = True) -> Dict[str, Any]:
    """Train the config's detector (or ``detector``, with its weights, when
    given) and return a summary: ``steps``, ``images``, ``train_s``,
    ``images_per_s`` (loading included), ``loader_wait_s`` and
    ``loader_wait_share``, ``aug_seconds`` (the augmentations' host time,
    by name) and ``aug_images``, ``last_metrics``, ``checkpoints``, ``eval``, and
    the ``trainer`` (its detector, optimizer and generator), which a
    caller may step on.

    The device is ``device``, else the GPU (raises without one); a given
    ``detector`` brings its own.  ``work_dir`` defaults to
    ``work_dirs/<config name>``; the log goes there too.

    Data-parallel (``parallel/mesh.py``): where the environment names a
    group (``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``, or
    Slurm's), every process joins it, trains on its shard of each global
    batch (``samples_per_gpu`` images a rank; ``--fake-data`` gives every
    rank the same noise batches, as the JAX tool does) on its card
    (``mesh.local_device``, unless ``device`` is given; NCCL joins the
    ranks on cards, gloo those on the CPU), and logs the ranks' averaged
    losses; every rank evaluates, rank 0 alone writes the logs and
    checkpoints, the others wait at a barrier."""
    cfg = _load(cfg)
    if detector is not None:
        device = detector.device
    elif cluster_spec_from_env() is not None and str(device or "cuda") == "cuda":
        device = local_device()  # the rank's own card
    device = resolve_device(device)
    init_distributed(device)
    name = os.path.splitext(os.path.basename(cfg.filename or "config"))[0]
    work_dir = work_dir or os.path.join("work_dirs", name)
    logger = get_root_logger()
    if not is_main():
        return _train(cfg, name, work_dir, detector, device, seed, resume_from, max_iters,
                      tiny, fake_data, validate, logger)
    os.makedirs(work_dir, exist_ok=True)
    with log_to_file(logger, os.path.join(work_dir, "train.log")):
        return _train(cfg, name, work_dir, detector, device, seed, resume_from, max_iters,
                      tiny, fake_data, validate, logger)


def _train(cfg, name, work_dir, detector, device, seed, resume_from, max_iters, tiny,
           fake_data, validate, logger) -> Dict[str, Any]:
    check_schedule(cfg)
    if not fake_data:
        check_data(cfg)
    main = is_main()
    jlog = JsonLogWriter(os.path.join(work_dir, "train.log.json")) if main else None
    if main:
        logger.info(f"env: {collect_env()}")
        cfg.dump(os.path.join(work_dir, "config_dump.py"))

    mc = model_config(cfg, tiny)
    if detector is None:
        detector = build_detector(copy.deepcopy(mc), device=device, seed=seed,
                                  dtype=compute_dtype(cfg))
        init_cfg = mc["backbone"].get("init_cfg") or {}
        if init_cfg.get("type") == "Pretrained" and not tiny:
            logger.info(f"loaded pretrained backbone: {load_pretrained(detector.net, init_cfg)}")
    device = detector.device
    for hook in cfg.get("custom_hooks", []) or []:
        if hook.get("type") not in _INHERENT_HOOKS:
            raise NotImplementedError(f"custom hook {hook.get('type')!r} is not ported")

    data_cfg = cfg.data.to_dict()
    pipeline, canvas = _pipeline(data_cfg, "train", tiny)
    val_ds = None
    if fake_data:
        # JAX tools/train.py:189-192: the DG detectors' fake targets
        loader = FakeDetLoader(data_cfg.get("samples_per_gpu", 2), canvas, _num_classes(mc),
                               num_batches=max_iters or 10, seed=seed,
                               semantic_stride=pipeline.get("semantic_stride", 8), device=device,
                               num_domains=(mc.get("num_domains", 2)
                                            if mc.get("type") == "DGFasterRCNN" else 0),
                               jigsaw=(mc.get("jig_classes", 31)
                                       if mc.get("type") == "JiGENFasterRCNN" else 0),
                               **_targets(mc))
    else:
        loader = train_loader(cfg, mc, device, seed=seed, tiny=tiny, num_shards=world_size(),
                              shard_id=rank())
        logger.info(f"train dataset: {len(loader.ds)} imgs, {len(loader)} steps/epoch")
        if validate:
            val_ds = build_dataset(data_cfg["val"], test_mode=True)
    batch = loader.batch_size
    steps_per_epoch = max(len(loader), 1)
    max_epochs = (cfg.get("runner") or {}).get("max_epochs", 12)
    trainer = build_trainer(cfg, detector, steps_per_epoch, seed)
    n_params = sum(p.numel() for p in detector.net.parameters())
    logger.info(f"model params: {n_params / 1e6:.2f}M, canvas {canvas}, "
                f"device {device}")

    start_epoch, start_iter, total_steps = 0, 0, 0
    if resume_from:
        meta = restore_checkpoint(resume_from, detector.net, trainer.optimizer,
                                  trainer.generator)
        start_epoch, total_steps = int(meta.get("epoch", 0)), int(meta["step"])
        start_iter = int(meta.get("iter", 0))
        logger.info(f"resumed from {resume_from} at epoch {start_epoch}, batch {start_iter}, "
                    f"step {total_steps}")

    log_interval = (cfg.get("log_config") or {}).get("interval", 50)
    ckpt_interval = (cfg.get("checkpoint_config") or {}).get("interval", 1)
    evaluation = cfg.get("evaluation") or {}
    sched = trainer.optimizer.lr_schedule
    summary = {"steps": 0, "images": 0, "train_s": 0.0, "loader_wait_s": 0.0,
               "last_metrics": {}, "checkpoints": [], "eval": [], "work_dir": work_dir}
    classes = list(data_cfg.get("train", {}).get("classes") or [])
    for epoch in range(start_epoch, max_epochs):
        stop = False
        t_epoch = time.perf_counter()
        wait = 0.0
        it = start_iter if epoch == start_epoch else 0
        batches = loader.epoch_iter(epoch, start=it)
        steps = 0
        while True:
            t0 = time.perf_counter()
            b = next(batches, None)
            wait += time.perf_counter() - t0
            if b is None:
                break
            metrics = trainer(b)
            total_steps += 1
            summary["steps"] += 1
            summary["images"] += int(b["images"].shape[0])
            if total_steps % log_interval == 0 or steps == 0:
                m = {k: float(v) for k, v in metrics.items()}
                if not math.isfinite(m["loss"]):
                    raise FloatingPointError(f"non-finite loss at step {total_steps}: {m}")
                elapsed = time.perf_counter() - t_epoch
                m.update(epoch=epoch, iter=it, lr=sched(trainer.optimizer.step_count - 1),
                         time=elapsed / (steps + 1), data_time=wait / (steps + 1))
                summary["last_metrics"] = m
                if main:
                    logger.info(f"Epoch [{epoch}][{it}/{steps_per_epoch}] " + " ".join(
                        f"{k}: {v:.4f}" for k, v in m.items() if k not in ("epoch", "iter")))
                    jlog.write({"mode": "train", **m})
            it += 1
            steps += 1
            if max_iters and total_steps >= max_iters:
                stop = True
                break
        batches.close()
        _sync(device)
        epoch_s = time.perf_counter() - t_epoch
        summary["train_s"] += epoch_s
        summary["loader_wait_s"] += wait
        logger.info(f"epoch {epoch}: {steps} steps in {epoch_s:.2f} s, "
                    f"{steps * batch / max(epoch_s, 1e-9):.2f} img/s, "
                    f"loader wait {wait / max(epoch_s, 1e-9):.1%}")
        meta = {"classes": classes, "config": name}
        if main and it < steps_per_epoch:  # stopped inside the epoch: resume at its next batch
            summary["checkpoints"].append(save_checkpoint(
                os.path.join(work_dir, f"iter_{total_steps}"), detector.net, trainer.optimizer,
                total_steps, meta={"epoch": epoch, "iter": it, **meta},
                generator=trainer.generator))
        elif main and ((epoch + 1) % ckpt_interval == 0 or epoch + 1 == max_epochs or stop):
            summary["checkpoints"].append(save_checkpoint(
                os.path.join(work_dir, f"epoch_{epoch + 1}"), detector.net, trainer.optimizer,
                total_steps, meta={"epoch": epoch + 1, **meta}, generator=trainer.generator))
        if val_ds is not None and (epoch + 1) % evaluation.get("interval", 1) == 0:
            stats = {}
            results = run_eval(detector, eval_loader(cfg, val_ds, device, tiny, "val"),
                               logger=logger, stats=stats)
            metrics = val_ds.evaluate(results, metric=evaluation.get("metric", "bbox"))
            if main:
                logger.info(f"Epoch [{epoch}] eval: {metrics}")
                jlog.write({"mode": "val", "epoch": epoch, **metrics})
            summary["eval"].append({"epoch": epoch + 1, **metrics, **stats})
        barrier()  # the other ranks wait for rank 0's checkpoint
        if stop:
            break
    summary["aug_seconds"] = dict(getattr(loader, "aug_seconds", {}))
    summary["aug_images"] = getattr(loader, "aug_images", 0)
    summary["images_per_s"] = summary["images"] / max(summary["train_s"], 1e-9)
    summary["loader_wait_share"] = summary["loader_wait_s"] / max(summary["train_s"], 1e-9)
    summary["trainer"] = trainer
    logger.info(f"done: {summary['steps']} steps, {summary['images_per_s']:.2f} img/s "
                f"(loading included), loader wait {summary['loader_wait_share']:.1%}")
    return summary
