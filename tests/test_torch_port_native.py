"""The port's native image loader (``egorear_tpu_torch/native/``) held
against PIL and the JAX package's native loader on the CPU, on images made
from a seeded numpy rng and written with PIL (RGB JPEG at quality 75 and
95, grayscale JPEG; RGB, RGBA, grayscale, palette and 16-bit grayscale PNG;
872, 256 and 100 px):

  * against PIL: uint8 within one LSB at 256 px (PIL rounds its fixed-point
    filter differently), bitwise at the file's size (the same libjpeg and
    lossless PNG), float32 within ``F32_TOL`` (one LSB after
    normalisation). A 16-bit PNG keeps its high byte (libpng's
    ``strip_16``, as in the JAX package) where PIL's ``convert("RGB")``
    clips: it is held to PIL on the high byte;
  * against ``egorear_tpu.native``: bitwise, uint8 and float32 (skipped
    only where that library is not available);
  * a missing, empty, directory or non-image path counts as a failure and
    raises ``IOError`` with the count; 1 and 8 threads give the same bytes;
    four Python threads asking for four pool sizes at once;
  * without a Pillow wheel's ``pillow.libs/`` it links the system's
    libjpeg and libpng, bitwise the JAX package's loader;
  * a libjpeg that refuses the headers' jpeg62 ABI, no library and no
    compiler raise ``RuntimeError``, in the datasets too, and nothing
    falls back to PIL;
  * the six dataset types with the native loader (the default) bitwise the
    JAX datasets' native items, with and without ``device_preprocess``.

Cost in the suite: ~25 s alone (three ~2.5 s builds of the loader the
first time: Pillow's libraries, the system's, the wrong-ABI headers; the
JAX trees and items).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
from PIL import Image

from egorear_tpu import native as jax_native
from egorear_tpu.data.datasets import get_dataset as jax_get_dataset
from egorear_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from egorear_tpu_torch import native
from egorear_tpu_torch.data.datasets import _DATASETS, get_dataset
from egorear_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD
from torch_threads import torch_threads  # noqa: F401

F32_TOL = (1.0 / 255.0) / float(IMAGENET_STD.min()) + 1e-6
SIZES = (872, 256, 100)
KINDS = ("jpeg_q75", "jpeg_q95", "jpeg_gray", "png_rgb", "png_rgba", "png_gray",
         "png_palette", "png_16bit")



def _jax_native_available() -> bool:
    """``jax_native.available()``, asked under a lock in the build tree.

    ``available()`` runs ``make`` when the git-ignored ``.so`` is missing,
    and any xdist worker whose tests build a JAX dataset may do so at the
    same time, writing the file while this one loads it. A load that fails
    while the file exists is asked again, for a while, after the writer is
    done: only a library that is missing, or fails to load for 15 s, skips
    the tests below."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "build")
    os.makedirs(build, exist_ok=True)
    with open(os.path.join(build, "egorear_tpu_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for _ in range(30):
            if jax_native.available():
                return True
            if not os.path.exists(jax_native._SO):
                return False
            jax_native._tried = False  # ask again once the file is whole
            time.sleep(0.5)
    return False


needs_jax_native = pytest.mark.skipif(
    not _jax_native_available(), reason="the JAX package's native loader is not built")


def _smooth(rng, size: int, channels: int) -> np.ndarray:
    """A camera-like image: a bilinear upsampling of coarse noise plus fine
    noise, so JPEG keeps detail at both qualities."""
    coarse = rng.integers(0, 256, size=(size // 8 + 2, size // 8 + 2, channels),
                          dtype=np.uint8)
    up = np.asarray(Image.fromarray(coarse.squeeze(-1) if channels == 1 else coarse)
                    .resize((size, size), Image.BILINEAR), np.int64)
    return np.clip(up + rng.integers(-20, 21, size=up.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """{(kind, size): path}."""
    base = tmp_path_factory.mktemp("native_images")
    rng = np.random.default_rng(17)
    out = {}
    for size in SIZES:
        for kind in KINDS:
            path = str(base / f"{kind}_{size}.{kind.split('_')[0].replace('jpeg', 'jpg')}")
            if kind.startswith("jpeg"):
                arr = _smooth(rng, size, 1 if kind == "jpeg_gray" else 3)
                Image.fromarray(arr).save(path, quality=75 if kind == "jpeg_q75" else 95)
            elif kind == "png_16bit":
                Image.fromarray(rng.integers(0, 65536, size=(size, size),
                                             dtype=np.uint16)).save(path)
            else:
                img = Image.fromarray(_smooth(rng, size, {"png_rgba": 4, "png_gray": 1}
                                              .get(kind, 3)))
                (img.quantize(64) if kind == "png_palette" else img).save(path)
            out[kind, size] = path
    return out


def _pil_u8(path: str, size: int) -> np.ndarray:
    img = Image.open(path)
    if img.mode.startswith("I;16"):  # libpng's strip_16: the high byte
        img = Image.fromarray((np.asarray(img) >> 8).astype(np.uint8))
    return np.asarray(img.convert("RGB").resize([size, size], Image.BICUBIC), np.uint8)


def _normalised(u8: np.ndarray) -> np.ndarray:
    """PIL's pipeline after the resize, as ``datasets.load_image``."""
    return ((u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
            ).transpose(2, 0, 1)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_matches_pil(images, kind, size):
    path = images[kind, size]
    assert Image.open(path).size == (size, size)
    for out in (256, size):
        want = _pil_u8(path, out)
        got = native.load_u8_batch([path], out)
        assert got.shape == (1, out, out, 3) and got.dtype == np.uint8
        diff = np.abs(got[0].astype(np.int64) - want)
        if out == size:
            np.testing.assert_array_equal(got[0], want)
        else:
            assert diff.max() <= 1, (path, out, diff.max(), int((diff > 0).sum()))
        f32 = native.load_f32_batch([path], out)
        assert f32.shape == (1, 3, out, out) and f32.dtype == np.float32
        assert np.abs(f32[0] - _normalised(want)).max() <= F32_TOL


@needs_jax_native
@pytest.mark.parametrize("kind", KINDS)
def test_matches_jax_native_bitwise(images, kind):
    paths = [images[kind, size] for size in SIZES]
    for out in (256, 100, 872):
        np.testing.assert_array_equal(native.load_u8_batch(paths, out),
                                      jax_native.load_u8_batch(paths, out))
        np.testing.assert_array_equal(native.load_f32_batch(paths, out),
                                      jax_native.load_f32_batch(paths, out))


@pytest.mark.parametrize("bad", ["missing", "empty", "directory", "not_an_image"])
def test_failures_raise_with_their_count(images, tmp_path, bad):
    path = str(tmp_path / bad)
    if bad == "empty":
        open(path, "wb").close()
    elif bad == "directory":
        os.mkdir(path)
    elif bad == "not_an_image":
        with open(path, "w") as f:
            f.write("frame,joint,x,y\n" * 64)
    batch = [images["jpeg_q95", 256], path, images["png_rgb", 100]]
    for load in (native.load_u8_batch, native.load_f32_batch):
        with pytest.raises(IOError, match="1/3 decode failures"):
            load(batch, 64)
        with pytest.raises(ValueError, match="out_size 0"):
            load(batch, 0)
    # The JAX package's loader counts these two the same way (a directory
    # it would try to read whole).
    if bad in ("missing", "not_an_image") and jax_native.available():
        with pytest.raises(IOError, match="1/3 decode failures"):
            jax_native.load_u8_batch(batch, 64)


def test_thread_counts_give_the_same_bytes(images):
    paths = list(images.values())
    for load in (native.load_u8_batch, native.load_f32_batch):
        one = load(paths, 256, n_threads=1)
        np.testing.assert_array_equal(load(paths, 256, n_threads=8), one)
        np.testing.assert_array_equal(load(paths, 256), one)  # min(8, CPUs)


def test_concurrent_callers_with_other_pool_sizes(images):
    """Four Python threads call at once, each asking for its own pool size
    (14 pool threads in all), for several rounds, switching often: every
    result is the one-thread result, and the pools still serve a call
    after."""
    paths = [images[k, s] for k in ("jpeg_q75", "png_rgba", "png_palette")
             for s in SIZES]
    want = native.load_u8_batch(paths, 128, n_threads=1)
    results, errors = [], []
    start = threading.Barrier(4)

    def caller(n_threads):
        try:
            start.wait()
            for _ in range(5):
                results.append(native.load_u8_batch(paths, 128, n_threads=n_threads))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(n,)) for n in (1, 2, 3, 8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(results) == 20
    for r in results:
        np.testing.assert_array_equal(r, want)
    np.testing.assert_array_equal(native.load_u8_batch(paths, 128, n_threads=3), want)


def test_many_one_image_batches_from_several_threads(tmp_path):
    """Eight Python threads each make 400 calls of a one-image batch of a
    16-px PNG, uint8 and float32 in turn, on pools of 1, 2 and 8 threads:
    a caller returns as soon as its one job is counted, while that job's
    thread may still be signalling, so a completion signal that touched the
    caller's stack after the count would crash, hang or corrupt a result
    here. Every result is the expected one."""
    path = str(tmp_path / "tiny.png")
    Image.fromarray(np.random.default_rng(3).integers(
        0, 256, size=(16, 16, 3), dtype=np.uint8)).save(path)
    want = {8: native.load_u8_batch([path], 8), 16: native.load_u8_batch([path], 16)}
    want_f32 = native.load_f32_batch([path], 8)
    errors, bad = [], []
    start = threading.Barrier(8)

    def caller(k):
        try:
            start.wait()
            for i in range(400):
                n_threads = (1, 2, 8)[(i + k) % 3]
                if i % 2:
                    got = native.load_f32_batch([path], 8, n_threads=n_threads)
                    ok = np.array_equal(got, want_f32)
                else:
                    size = 8 if i % 4 else 16
                    got = native.load_u8_batch([path], size, n_threads=n_threads)
                    ok = np.array_equal(got, want[size])
                if not ok:
                    bad.append((k, i))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not bad and not any(t.is_alive() for t in threads)


@pytest.fixture
def no_loaded_library(monkeypatch):
    """The module as before its first use; the loaded library comes back
    after the test."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_loaded", {})


def test_wrong_jpeg_abi_raises(images, tmp_path, monkeypatch, no_loaded_library):
    """The loader built with headers of another ABI (JPEG_LIB_VERSION 80)
    against the jpeg62 library: the library refuses the struct through the
    error manager, so every JPEG fails (PNGs still decode) and nothing is
    written; ``load_library`` refuses such a build."""
    jpeg_dir = tmp_path / "libjpeg8"
    shutil.copytree(native.INCLUDE_DIRS[0], jpeg_dir)
    config = (jpeg_dir / "jconfig.h").read_text()
    assert "#define JPEG_LIB_VERSION  62" in config
    (jpeg_dir / "jconfig.h").write_text(config.replace(
        "#define JPEG_LIB_VERSION  62", "#define JPEG_LIB_VERSION  80"))
    path = native.build(include_dirs=(jpeg_dir, native.INCLUDE_DIRS[1]))
    lib = native.bind(path)
    assert lib.er_jpeg_abi_ok() == 0
    jpegs = [images[k, 100] for k in ("jpeg_q75", "jpeg_q95", "jpeg_gray")]
    out = np.full((3, 100, 100, 3), 7, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    fails = lib.er_load_u8_batch(native._paths_array(jpegs), 3, 100,
                                 out.ctypes.data_as(u8), 2)
    assert fails == 3 and (out == 7).all()
    png = np.empty((1, 100, 100, 3), np.uint8)
    assert lib.er_load_u8_batch(native._paths_array([images["png_rgb", 100]]), 1, 100,
                                png.ctypes.data_as(u8), 2) == 0
    np.testing.assert_array_equal(png[0], _pil_u8(images["png_rgb", 100], 100))

    monkeypatch.setattr(native, "build", lambda *args, **kwargs: path)
    with pytest.raises(RuntimeError, match="refuses the jpeg62 ABI"):
        native.load_library()
    assert not native.available()
    with pytest.raises(RuntimeError, match="jpeg62"):
        native.load_u8_batch(jpegs, 64)


@needs_jax_native
def test_system_libraries_without_pillow_libs(images, monkeypatch, no_loaded_library):
    """Without a Pillow wheel's ``pillow.libs/`` the loader links the
    system's libjpeg and libpng, as the JAX package's does: bitwise its
    output."""
    monkeypatch.setattr(native, "_pillow_lib_dirs", lambda: [])
    libs = native.find_libraries()
    assert all("pillow.libs" not in str(p) for p in libs.values()), libs
    paths = [images[k, s] for k in ("jpeg_q75", "jpeg_gray", "png_palette") for s in SIZES]
    np.testing.assert_array_equal(native.load_u8_batch(paths, 256),
                                  jax_native.load_u8_batch(paths, 256))
    assert native.library_info()["linked"] == {k: str(p) for k, p in libs.items()}


@pytest.mark.parametrize("missing", ["library", "compiler"])
def test_missing_library_or_compiler_raises(tmp_path, monkeypatch, no_loaded_library,
                                            missing):
    if missing == "library":
        monkeypatch.setattr(native, "_pillow_lib_dirs", lambda: [])
        monkeypatch.setattr(native, "_system_library", lambda name: None)
        match = "looked for libjpeg.*find_library.*libpng16"
    else:
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        match = "g\\+\\+ not found"
    with pytest.raises(RuntimeError, match=match):
        native.load_library()
    assert not native.available()
    with pytest.raises(RuntimeError, match=match):
        native.load_f32_batch(["x.jpg"], 64)
    with pytest.raises(RuntimeError, match=match):
        get_dataset("ego4view_syn_pose3d", str(tmp_path), "train")
    # PIL only where asked for.
    (tmp_path / "train.txt").write_text("")
    assert len(get_dataset("ego4view_syn_pose3d", str(tmp_path), "train",
                           use_native_loader=False)) == 0


# -- the datasets --------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A syn tree of 128-px JPEGs and an rw tree of 128-px PNGs from the
    JAX generator, with their heatmap NPYs."""
    base = tmp_path_factory.mktemp("native_trees")
    return {"syn": jax_make_synthetic(str(base / "syn"), "syn", num_chars=1,
                                      num_seqs=1, frames_per_seq=2, image_size=128,
                                      write_heatmaps=True, draw_pose=True, seed=6),
            "rw": jax_make_synthetic(str(base / "rw"), "rw", num_chars=1, num_seqs=1,
                                     frames_per_seq=2, image_size=128,
                                     write_heatmaps=True, draw_pose=True, seed=7)}


@needs_jax_native
@pytest.mark.parametrize("device_preprocess", [False, True])
@pytest.mark.parametrize("dataset_type", sorted(_DATASETS))
def test_dataset_items_match_jax_native(trees, dataset_type, device_preprocess):
    """Every item bitwise the JAX dataset's with its native loader (JAX's
    default): 128 -> 64 px float32, or 128 -> 96 px uint8 views with
    ``device_preprocess`` (stage 1 ignores the flag in both)."""
    root = trees[dataset_type.split("_")[1]]
    kw = (dict(device_preprocess=True, image_size=96) if device_preprocess
          else dict(image_size=64))
    want = jax_get_dataset(dataset_type, root, "train", use_native_loader=True, **kw)
    assert want._native is not None
    got = get_dataset(dataset_type, root, "train", **kw)
    assert len(got) == len(want) > 0
    uint8 = device_preprocess and not dataset_type.endswith("_heatmap")
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert list(g) == list(w)
        assert ("img_u8" in w) == uint8
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype and g[k].shape == v.shape, k
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            else:
                assert g[k] == v, k
