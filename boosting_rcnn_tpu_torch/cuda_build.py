"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``_build/lib<name>-<hash>.so`` inside the package (a directory that
``.gitignore`` lists), at first use, for ``sm_90a``; ``build_all`` starts
one ``nvcc`` per source, all together.  The file name carries a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is reused.  PyTorch's extension builder is not used: a
source that includes PyTorch's headers takes minutes to compile, a plain
C one seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)
BUILD_TIMEOUT_S = 600

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else under PyTorch's ``CUDA_HOME``, else
    ``/usr/local/cuda/bin/nvcc``; raises naming every place tried."""
    tried = ["PATH"]
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(Path(CUDA_HOME) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        tried.append(str(cand))
        if cand.is_file() and os.access(cand, os.X_OK):
            return str(cand)
    raise RuntimeError(f"nvcc not found; tried {', '.join(tried)}")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source, the
    headers of ``csrc/`` and the flags."""
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources) + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless it is built already.  Returns the
    seconds the build took (0.0 when already built); the ``ptxas`` report
    goes beside the library as ``<lib>.log``."""
    return build_all([name])[name]


def build_all(names: Sequence[str]) -> Dict[str, float]:
    """Compile every source of ``names`` that is not built yet, one
    ``nvcc`` each, all started together.  Returns each name's build
    seconds (0.0 when already built); raises naming every source that
    failed, with the compiler's output."""
    started = {}
    for name in names:
        out = library_path(name)
        if out.is_file() or name in started:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for other, *_ in started.values():
                other.kill()
                other.wait()
            raise
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc exited {proc.returncode} building {name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report of the last build of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
