"""The port's native image loader (the JAX package's ``native/``): JPEG/PNG
decode, PIL-equivalent antialiased bicubic resize and ImageNet
normalisation fused into CHW float32, in C++ on a thread pool, bound with
ctypes (see ``image_loader.cc``).

``image_loader.cc`` is compiled at first use with ``g++`` into
``build/native/`` at the repository root (listed in ``.gitignore``), named
by a hash of the sources, the headers, the flags and the libraries it links.
It links the libjpeg and libpng that Pillow itself loads (a Pillow wheel's
``pillow.libs/`` beside the ``PIL`` package), else the system's, so the
decoded JPEG pixels are PIL's; the headers come from ``third_party/``
(libjpeg-turbo 2.1.5's for the jpeg62 ABI, libpng 1.6's API declared by
hand), so no ``-dev`` package is needed. Nothing here builds at import time.

Unlike the JAX package's binding, nothing falls back to PIL: when no
compiler or library is found, or the libjpeg found refuses the jpeg62 ABI,
:func:`load_library` raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
SOURCE = NATIVE_DIR / "image_loader.cc"
THIRD_PARTY = NATIVE_DIR / "third_party"
INCLUDE_DIRS = (THIRD_PARTY / "libjpeg-turbo", THIRD_PARTY / "libpng")
BUILD_DIR = NATIVE_DIR.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-Wall")
# Each library: the file names a Pillow wheel carries, the system's name
# for ctypes.util.find_library.
LIBRARIES = {"jpeg": ("libjpeg*.so*", "jpeg"), "png": ("libpng16*.so.16*", "png16")}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# The loaded library's path, what it links and the seconds this process
# spent building it (None when it was already built).
_loaded: dict = {}


def _pillow_lib_dirs() -> list:
    """Where a Pillow wheel keeps the libraries ``PIL._imaging`` loads."""
    import PIL

    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    return [libs] if libs.is_dir() else []


def _mapped(*prefixes: str) -> list:
    """The files this process maps whose names start with one of
    ``prefixes``."""
    with open("/proc/self/maps") as f:
        paths = {line.split(maxsplit=5)[-1].strip() for line in f}
    return sorted(Path(p) for p in paths if os.path.basename(p).startswith(prefixes))


def _system_library(name: str) -> Optional[Path]:
    """The path of the system's ``lib<name>``, resolved by loading it."""
    soname = ctypes.util.find_library(name)
    if soname is None:
        return None
    try:
        ctypes.CDLL(soname)
    except OSError:
        return None
    found = _mapped(soname)
    return found[0] if found else None


def find_libraries() -> Dict[str, Path]:
    """The libjpeg and libpng to link: Pillow's own, else the system's.
    Raises ``RuntimeError`` naming what was looked for when one is missing."""
    found, missing = {}, []
    dirs = _pillow_lib_dirs()
    for key, (pattern, system) in LIBRARIES.items():
        wheel = sorted(p for d in dirs for p in d.glob(pattern))
        path = wheel[0] if wheel else _system_library(system)
        if path is None:
            where = ", ".join(map(str, dirs)) or "pillow.libs (none beside PIL)"
            missing.append(f"{pattern} in {where}, and the system's lib{system} "
                           f"(ctypes.util.find_library)")
        else:
            found[key] = path
    if missing:
        raise RuntimeError("native loader: no library to link: looked for "
                           + "; ".join(missing))
    return found


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("native loader: g++ not found on PATH; the loader is "
                           "built from source at first use")
    return path


def library_path(libs: Dict[str, Path], include_dirs=INCLUDE_DIRS) -> Path:
    """Where the build for these libraries and headers lives, keyed by
    content."""
    h = hashlib.sha256(SOURCE.read_bytes())
    for d in include_dirs:
        for f in sorted(Path(d).rglob("*")):
            if f.is_file():
                h.update(f.name.encode() + f.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    for key in sorted(libs):
        h.update(f"{key}={libs[key]}".encode())
    return BUILD_DIR / f"image_loader-{h.hexdigest()[:16]}.so"


def build(libs: Optional[Dict[str, Path]] = None, include_dirs=INCLUDE_DIRS) -> Path:
    """Compile ``image_loader.cc`` into :data:`BUILD_DIR` unless already
    built; returns the library's path.
    Concurrent builders each write a file of their own and rename it into
    place, so none sees half a library."""
    libs = find_libraries() if libs is None else libs
    out = library_path(libs, include_dirs)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    rpaths = sorted({str(Path(p).parent) for p in libs.values()})
    cmd = [_cxx(), *CXX_FLAGS, *(f"-I{d}" for d in include_dirs), "-o", str(tmp),
           str(SOURCE), *(str(libs[k]) for k in sorted(libs)), "-lpthread",
           *(f"-Wl,-rpath,{d}" for d in rpaths)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native loader: g++ failed:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def bind(path) -> ctypes.CDLL:
    """Load a built library and declare its C entry points."""
    lib = ctypes.CDLL(str(path))
    for name, ptr in (("er_load_u8_batch", ctypes.c_uint8),
                      ("er_load_f32_batch", ctypes.c_float)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ptr), ctypes.c_int]
    lib.er_jpeg_abi_ok.restype = ctypes.c_int
    lib.er_jpeg_abi_ok.argtypes = []
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded native library, built first if needed. Raises
    ``RuntimeError`` when it cannot be built or its libjpeg refuses the
    jpeg62 ABI of the headers it was built with."""
    global _lib
    with _lock:
        if _lib is None:
            libs = find_libraries()
            fresh = not library_path(libs).exists()
            t0 = time.perf_counter()
            path = build(libs)
            seconds = time.perf_counter() - t0 if fresh else None
            lib = bind(path)
            if not lib.er_jpeg_abi_ok():
                raise RuntimeError(
                    f"native loader: {libs['jpeg']} refuses the jpeg62 ABI "
                    f"(JPEG_LIB_VERSION 62) of third_party/libjpeg-turbo")
            _lib = lib
            _loaded.update(so=str(path), linked={k: str(v) for k, v in libs.items()},
                           build_s=seconds)
        return _lib


def available() -> bool:
    try:
        load_library()
    except RuntimeError:
        return False
    return True


def library_info() -> dict:
    """The loaded library (``so``), the libraries it was linked to
    (``linked``), the seconds this process spent building it at first use
    (``build_s``, None when it was already built), its NEEDED entries
    (``readelf -d``) and the libjpeg and libpng this process maps."""
    load_library()
    so = _loaded["so"]
    needed = []
    readelf = shutil.which("readelf")
    if readelf:
        dyn = subprocess.run([readelf, "-d", so], capture_output=True,
                             text=True).stdout
        needed = [ln.split("[", 1)[1].rstrip("]") for ln in dyn.splitlines()
                  if "(NEEDED)" in ln]
    return dict(_loaded, needed=needed,
                mapped=[str(p) for p in _mapped("libjpeg", "libpng")])


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [os.fsencode(p) for p in paths]
    return arr


def _threads(n_threads: int) -> int:
    return n_threads or min(8, os.cpu_count() or 1)


def _check_size(out_size: int) -> None:
    if out_size < 1:
        raise ValueError(f"native loader: out_size {out_size} < 1")


def load_u8_batch(paths: Sequence[str], out_size: int = 256,
                  n_threads: int = 0) -> np.ndarray:
    """Decode + resize files -> (N, out, out, 3) uint8."""
    _check_size(out_size)
    lib = load_library()
    out = np.empty((len(paths), out_size, out_size, 3), np.uint8)
    fails = lib.er_load_u8_batch(
        _paths_array(paths), len(paths), out_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _threads(n_threads))
    if fails:
        raise IOError(f"native loader: {fails}/{len(paths)} decode failures")
    return out


def load_f32_batch(paths: Sequence[str], out_size: int = 256,
                   n_threads: int = 0) -> np.ndarray:
    """Decode + resize + ImageNet-normalise -> (N, 3, out, out) float32."""
    _check_size(out_size)
    lib = load_library()
    out = np.empty((len(paths), 3, out_size, out_size), np.float32)
    fails = lib.er_load_f32_batch(
        _paths_array(paths), len(paths), out_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), _threads(n_threads))
    if fails:
        raise IOError(f"native loader: {fails}/{len(paths)} decode failures")
    return out
