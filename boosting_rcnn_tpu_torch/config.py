"""Python-file config system.

Mirrors the reference's public config surface (mmcv ``Config`` semantics as
used by ``configs/boosting_rcnn/boosting_rcnn_r50_pafpn_1x_utdac.py:1-3``):

  * a config is a python file whose module-level variables form a dict;
  * ``_base_`` (str or list) composes parent configs, merged in order;
  * a dict value carrying ``_delete_: True`` *replaces* the base value
    instead of merging into it;
  * CLI overrides use dotted keys (``--cfg-options model.rpn_head.gamma=1``).

Re-implemented from scratch (no mmcv).  The PyTorch port keeps its own copy
of the loader so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List, Optional

__all__ = ["Config", "load_config", "merge_dict", "set_by_dotted_key"]

DELETE_KEY = "_delete_"
BASE_KEY = "_base_"


def _exec_config_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        src = f.read()
    ns: Dict[str, Any] = {"__file__": os.path.abspath(path)}
    code = compile(src, path, "exec")
    exec(code, ns)
    return {
        k: v
        for k, v in ns.items()
        if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))
    }


def merge_dict(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive merge with ``_delete_`` replacement semantics."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict):
            if v.get(DELETE_KEY, False):
                v = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
                out[k] = copy.deepcopy(v)
            elif k in out and isinstance(out[k], dict):
                out[k] = merge_dict(out[k], v)
            else:
                out[k] = copy.deepcopy(v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: str) -> "Config":
    cfg = _exec_config_file(path)
    bases = cfg.pop(BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        bpath = os.path.join(os.path.dirname(path), b)
        merged = merge_dict(merged, load_config(bpath).to_dict())
    merged = merge_dict(merged, cfg)
    return Config(merged, filename=path)


def _parse_value(v: str) -> Any:
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        if v.lower() in ("true", "false"):
            return v.lower() == "true"
        return v


def set_by_dotted_key(cfg: Dict[str, Any], key: str, value: Any) -> None:
    parts = key.split(".")
    d = cfg
    for p in parts[:-1]:
        if p not in d or not isinstance(d[p], dict):
            d[p] = {}
        d = d[p]
    d[parts[-1]] = value


class Config:
    """Attribute-style view over the merged config dict."""

    def __init__(self, data: Dict[str, Any], filename: Optional[str] = None):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "filename", filename)

    def __getattr__(self, k):
        try:
            v = self._data[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) else v

    def __getitem__(self, k):
        return self._data[k]

    def __contains__(self, k):
        return k in self._data

    def get(self, k, default=None):
        return self._data.get(k, default)

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    def merge_from_options(self, options: Dict[str, str]) -> None:
        """Apply ``--cfg-options`` style overrides (dotted keys)."""
        for k, v in options.items():
            set_by_dotted_key(self._data, k, _parse_value(v) if isinstance(v, str) else v)

    def dump(self, path: str) -> None:
        """Write the resolved config for reproducibility (the reference dumps
        the config into work_dir, ``tools/train.py:129``)."""
        import pprint

        with open(path, "w") as f:
            for k, v in self._data.items():
                f.write(f"{k} = {pprint.pformat(v, width=100)}\n")

    def __repr__(self):
        return f"Config({self.filename})"
