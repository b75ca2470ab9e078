"""Checkpoints with ``torch.save`` (PyTorch port of
``boosting_rcnn_tpu/engine/checkpoint.py``, which uses orbax).

A checkpoint is a directory: ``state.pth`` holds the model's
``state_dict``, the optimizer's state (its step count and SGD momentum
buffers), the step and, when given, the sampler generator's state;
``meta.json`` holds the caller's meta (epoch, classes, config) with the
step and the port's version.  A restored model, optimizer and generator
continue bit for bit where the saved ones were.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from .. import __version__
from ..weights import from_mmdet_state_dict, read_state_dict

__all__ = ["save_checkpoint", "restore_checkpoint", "load_params", "checkpoint_meta"]

STATE = "state.pth"
META = "meta.json"


def save_checkpoint(path: str, model: torch.nn.Module, optimizer=None, step: int = 0,
                    meta: Optional[Dict[str, Any]] = None,
                    generator: Optional[torch.Generator] = None) -> str:
    """Write ``model`` (a ``TwoStageNet``), ``optimizer`` (the port's
    ``engine.train.Optimizer``), ``step`` and ``meta`` into directory
    ``path``; returns it."""
    os.makedirs(path, exist_ok=True)
    payload = {"model": model.state_dict(), "step": int(step)}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    if generator is not None:
        payload["generator"] = generator.get_state()
    torch.save(payload, os.path.join(path, STATE))
    with open(os.path.join(path, META), "w") as f:
        json.dump({**(meta or {}), "step": int(step), "port_version": __version__}, f)
    return path


def _read_meta(path: str) -> Dict[str, Any]:
    mp = os.path.join(path, META)
    if not os.path.exists(mp):
        return {}
    with open(mp) as f:
        return json.load(f)


def restore_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                       generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """Load directory ``path`` into ``model`` and, where given, ``optimizer``
    and ``generator`` (shapes must match); returns the meta with ``step``."""
    payload = torch.load(os.path.join(path, STATE), map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None:
        if "optimizer" not in payload:
            raise KeyError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(payload["optimizer"])
    if generator is not None and "generator" in payload:
        generator.set_state(payload["generator"])
    return {**_read_meta(path), "step": payload["step"]}


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """Weights only, as the port's ``state_dict``: from a checkpoint
    directory of ``save_checkpoint``, or from an mmdet checkpoint file
    (``weights.from_mmdet_state_dict``)."""
    if os.path.isdir(path):
        return torch.load(os.path.join(path, STATE), map_location="cpu",
                          weights_only=True)["model"]
    if os.path.isfile(path):
        return from_mmdet_state_dict(read_state_dict(path))
    raise FileNotFoundError(path)


def checkpoint_meta(path: str) -> Dict[str, Any]:
    """The meta of a checkpoint directory ({} for a file or none saved)."""
    return _read_meta(path) if os.path.isdir(path) else {}
