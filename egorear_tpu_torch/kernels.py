"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, which is loaded with
``ctypes``. Libraries go to ``build/kernels/`` at the repository root (listed
in ``.gitignore``) and are named by a hash of the source and the flags, so an
edit rebuilds. Nothing here runs at import time: this module imports on hosts
with no CUDA toolkit, and only a kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = ("lazy_deform_sample", "lazy_deform_sample_bwd", "deform_sample",
           "deform_sample_bwd")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin); the "
            "port's CUDA kernels are built from source at first use"
        )
    return path


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives, keyed by content."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (Popen, tmp_path, out_path) or None
    when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a half file


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Build the named kernels, one nvcc per source, all started together.

    Returns each kernel's nvcc output (ptxas register/shared-memory report),
    or "" for a library that was already built.
    """
    names = list(names)
    with _lock:
        started = {n: _start_build(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish_build(n, s)
    logs = {}
    for n in names:
        log = library_path(n).with_suffix(".log")
        logs[n] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                _loaded[name] = lib
    return lib
