"""Weight bridge from the JAX package's parameters to the port's.

``from_jax_params`` takes the flax variables of the JAX flagship
(``{"params": ..., "batch_stats": ...}`` or the ``params`` tree alone) as
nested dicts of numpy arrays, named as flax names them, and returns a
``state_dict`` for ``TwoStageNet``.  The port's modules carry the JAX
module names, so the mapping is by rule:

  * ``Conv_0`` / ``GroupNorm_0`` inside a ConvModule -> ``conv`` / ``norm``;
  * conv ``kernel`` (HWIO) -> ``weight`` (OIHW); dense ``kernel`` (in, out)
    -> ``weight`` (out, in).  The first FC after the pool keeps its rows:
    both packages flatten the pooled (7, 7, C) features in HWC order;
  * norm ``scale`` -> ``weight``; a scalar ``scale`` (the per-level RPN
    ``Scale``) stays ``scale``; ``mean`` / ``var`` -> ``running_mean`` /
    ``running_var``.

Nothing here imports JAX: callers turn the flax tree into numpy first.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

__all__ = ["from_jax_params"]

_MODULE_NAMES = {"Conv_0": "conv", "GroupNorm_0": "norm"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _convert(path: Tuple[str, ...], value: np.ndarray):
    *mods, leaf = path
    mods = [_MODULE_NAMES.get(m, m) for m in mods]
    if leaf == "kernel":
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 2:
            value = value.T
        else:
            raise ValueError(f"kernel {'/'.join(path)} has shape {value.shape}")
        leaf = "weight"
    elif leaf == "scale" and value.ndim > 0:
        leaf = "weight"
    else:
        leaf = _STAT_NAMES.get(leaf, leaf)
    return ".".join(mods + [leaf]), torch.from_numpy(np.ascontiguousarray(value))


def from_jax_params(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``state_dict`` of ``TwoStageNet`` from JAX flax variables as numpy."""
    collections = (variables if "params" in variables else {"params": variables})
    state = {}
    for coll in ("params", "batch_stats"):
        for path, value in _leaves(collections.get(coll, {})):
            key, tensor = _convert(path, value.astype(np.float32))
            state[key] = tensor
    return state
