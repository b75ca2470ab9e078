"""Training CLI (the port's counterpart of the JAX package's
``tools/train.py``):

    python -m boosting_rcnn_tpu_torch.tools.train <config> [--work-dir D]
        [--resume-from CKPT] [--seed N] [--cfg-options k=v ...]
        [--iters N] [--tiny] [--no-validate] [--fake-data] [--device DEV]

``--device`` defaults to the GPU; without one the command raises unless
``--device cpu`` is given.  ``--tiny`` trains the flagship at ResNet-18
width 8 on a 128 x 160 canvas; ``--fake-data`` trains on seeded noise
batches; ``--iters`` caps the steps.  Checkpoints go to
``<work-dir>/epoch_<n>``, or ``<work-dir>/iter_<step>`` where ``--iters``
stops the run inside an epoch (default work dir ``work_dirs/<config
name>``); ``--resume-from`` either continues at its next batch.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..config import load_config
from ..engine.runner import train_detector

__all__ = ["parse_args", "main"]


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="Train a detector with the PyTorch port")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cfg-options", nargs="*", default=[], help="override config, key=val")
    p.add_argument("--fake-data", action="store_true")
    p.add_argument("--iters", type=int, default=None, help="cap total steps")
    p.add_argument("--tiny", action="store_true", help="shrink the model (development)")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI on ``argv``; returns the train summary."""
    args = parse_args(argv)
    cfg = load_config(args.config)
    if args.cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1) for kv in args.cfg_options))
    return train_detector(cfg, args.work_dir, device=args.device, seed=args.seed,
                          resume_from=args.resume_from, max_iters=args.iters, tiny=args.tiny,
                          fake_data=args.fake_data, validate=not args.no_validate)


if __name__ == "__main__":
    main()
