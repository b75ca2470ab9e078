"""Logger and json train log (PyTorch port of
``boosting_rcnn_tpu/utils/logging.py``: the reference's ``get_root_logger``
and the TextLoggerHook ``.log.json`` surface)."""
from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
from typing import Any, Dict

__all__ = ["get_root_logger", "log_to_file", "JsonLogWriter", "collect_env"]

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_root_logger(level=logging.INFO) -> logging.Logger:
    """The port's logger, writing to standard output."""
    logger = logging.getLogger("boosting_rcnn_tpu_torch")
    if not logger.handlers:
        logger.setLevel(level)
        logger.propagate = False
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(sh)
    return logger


@contextlib.contextmanager
def log_to_file(logger: logging.Logger, log_file: str):
    """``logger`` also writes to ``log_file`` inside the block."""
    os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
    fh = logging.FileHandler(log_file)
    fh.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(fh)
    try:
        yield logger
    finally:
        logger.removeHandler(fh)
        fh.close()


class JsonLogWriter:
    """Append-only ``.log.json`` writer: one json object per line."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path

    def write(self, record: Dict[str, Any]) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({k: _jsonable(v) for k, v in record.items()}) + "\n")


def _jsonable(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def collect_env() -> Dict[str, Any]:
    """Python, PyTorch and CUDA versions and the visible devices."""
    import torch

    info = {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda}
    if torch.cuda.is_available():
        info["devices"] = [torch.cuda.get_device_name(i)
                           for i in range(torch.cuda.device_count())]
    return info
