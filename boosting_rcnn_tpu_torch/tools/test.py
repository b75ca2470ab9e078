"""Evaluation CLI (the port's counterpart of the JAX package's
``tools/test.py``):

    python -m boosting_rcnn_tpu_torch.tools.test <config> [<checkpoint>]
        [--eval bbox [segm]] [--out results.json] [--classwise]
        [--cfg-options k=v ...] [--tiny] [--device DEV]
        [--tta [--tta-scales S ...]]

Evaluates every image of ``data.test`` once and prints the metrics as one
json line: ``bbox_mAP``... and, with ``--eval segm`` for a mask model,
``segm_mAP``, ``segm_mAP_50``, ``segm_mAP_75``, ``segm_mAP_s``,
``segm_mAP_m`` and ``segm_mAP_l``.  ``--out`` writes the boxes only.
The metrics are the test set's own: LVIS's federated ``bbox_mAP``,
Cityscapes' ``cityscapes`` (mask AP; with ``--out x.json`` the official
instance dump goes to ``x_cityscapes/``), VOC's ``mAP``.
``--tta`` evaluates with flip test-time augmentation at the test
pipeline's short side, or at each short side of ``--tta-scales``
(``engine.eval.run_eval_tta``; the long side is the pipeline scale's
first value, which ``--tiny`` does not change); it gives boxes only, so
``--eval segm`` with it raises, as does a cascade or HTC, before any
image is read.  The checkpoint is a directory of the train CLI or an
mmdet ``.pth``; without one the weights are seeded random.  ``--device``
defaults to the GPU; without one the command raises unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from ..apis import init_detector
from ..config import load_config
from ..data.builder import build_dataset
from ..engine.eval import run_eval, run_eval_tta
from ..engine.runner import eval_loader, tta_options
from ..utils.logging import get_root_logger

__all__ = ["parse_args", "main"]


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Test a detector with the PyTorch port")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--eval", nargs="*", default=["bbox"])
    p.add_argument("--out", default=None, help="write the results as COCO json")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--classwise", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    p.add_argument("--tta", action="store_true",
                   help="flip (and multi-scale) test-time augmentation, boxes only")
    p.add_argument("--tta-scales", type=int, nargs="*", default=None,
                   help="short sides for --tta (default: the test pipeline's)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI on ``argv``; returns the metrics (with ``eval_stats``:
    images, seconds, images/s)."""
    args = parse_args(argv)
    if args.tta and "segm" in (args.eval or []):
        raise NotImplementedError("--tta gives boxes only: --eval segm cannot be evaluated with "
                                  "it")
    logger = get_root_logger()
    cfg = load_config(args.config)
    if args.cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1) for kv in args.cfg_options))
    handle = init_detector(cfg, args.checkpoint, device=args.device, tiny=args.tiny)
    det = handle.detector
    ds = build_dataset(cfg.data.to_dict()["test"], test_mode=True)
    stats = {}
    if args.tta:
        results = run_eval_tta(det, ds, **tta_options(cfg, args.tta_scales), logger=logger,
                               stats=stats)
    else:
        results = run_eval(det, eval_loader(cfg, ds, det.device, args.tiny), logger=logger,
                           stats=stats)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(ds.results_to_coco_json(results), f)
        logger.info(f"wrote {args.out}")
    metrics = {}
    if args.eval:
        kwargs = {}
        if "cityscapes" in args.eval and args.out:  # the official instance dump beside --out
            kwargs["outfile_prefix"] = os.path.splitext(args.out)[0] + "_cityscapes"
        metrics = ds.evaluate(results, metric=args.eval, classwise=args.classwise, **kwargs)
        logger.info(f"eval: {metrics}")
        print(json.dumps({k: v for k, v in metrics.items() if k != "classwise"}), flush=True)
    return {**metrics, "eval_stats": stats, "num_results": len(results)}


if __name__ == "__main__":
    main()
