"""ctypes binding to the native image pipeline (``native/imgproc.cpp``), the
port's own copy of ``llava_reward_tpu/preprocess/native.py``.

The source is compiled as it stands, on first use, into
``build/native/libimgproc.so`` in the checkout (g++, libjpeg, libpng).
Every entry returns None where the library is missing or cannot decode, and
its callers then take the pure-Python path (PIL and numpy): this is host
code, and a machine without the toolchain or the libraries still runs.
``CALLS`` counts the native calls that returned a result.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .phi3v_processor import (
    OPENAI_CLIP_MEAN,
    OPENAI_CLIP_STD,
    hd_transform_scale,
    padded_size,
)

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "imgproc.cpp"
LIB_PATH = _ROOT / "build" / "native" / "libimgproc.so"
# the flags and libraries of native/Makefile
_CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native", "-shared"]
_LDLIBS = ["-ljpeg", "-lpng", "-lpthread"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None  # why the library is unavailable, if it is
CALLS = {"decode": 0, "hd_batch": 0, "resize": 0}


class _HdTask(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.c_void_p),
        ("len", ctypes.c_int64),
        ("transposed", ctypes.c_int32),
        ("new_h", ctypes.c_int32),
        ("new_w", ctypes.c_int32),
        ("pad_h", ctypes.c_int32),
        ("dst", ctypes.c_void_p),
        ("status", ctypes.c_int32),
    ]


def _build() -> bool:
    """Compile the source into LIB_PATH (a temporary name, then a rename, so
    two processes building at once never load a half-written library)."""
    global build_error
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", str(tmp), str(SOURCE), *_LDLIBS]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_error = f"{cmd[0]}: {e}"
        return False
    if out.returncode != 0:
        build_error = out.stderr.strip()[-2000:] or f"{cmd[0]} exited {out.returncode}"
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, LIB_PATH)
    return True


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    i32p = ctypes.POINTER(ctypes.c_int32)
    for fn in (lib.lrt_decode_jpeg, lib.lrt_decode_png):
        fn.argtypes = [p, i64, p, i32p, i32p]
        fn.restype = ctypes.c_int
    lib.lrt_resize_rgb8_f32.argtypes = [p, i32, i32, p, i32, i32, i32]
    lib.lrt_resize_rgb8_f32.restype = ctypes.c_int
    lib.lrt_phi3v_hd_batch.argtypes = [ctypes.POINTER(_HdTask), i32, p, p, i32]
    lib.lrt_phi3v_hd_batch.restype = ctypes.c_int


def load_native() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None where it cannot be built or
    loaded (``build_error`` says why)."""
    global _lib, _tried, build_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if (not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime) \
            and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
        _declare(lib)
        _lib = lib
    except OSError as e:
        build_error = str(e)
    return _lib


def native_available() -> bool:
    return load_native() is not None


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """JPEG/PNG bytes -> (h, w, 3) uint8, or None if the library is
    unavailable or cannot decode them."""
    lib = load_native()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    for fn in (lib.lrt_decode_jpeg, lib.lrt_decode_png):
        if fn(buf.ctypes.data, len(data), None, ctypes.byref(h), ctypes.byref(w)) == 0:
            out = np.empty((h.value, w.value, 3), np.uint8)
            if fn(buf.ctypes.data, len(data), out.ctypes.data, ctypes.byref(h),
                  ctypes.byref(w)) == 0:
                CALLS["decode"] += 1
                return out
    return None


def resize_rgb8(img: np.ndarray, out_h: int, out_w: int,
                mode: str = "bilinear") -> Optional[np.ndarray]:
    """(h, w, 3) uint8 -> (out_h, out_w, 3) float32, PIL-style antialiased."""
    lib = load_native()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((out_h, out_w, 3), np.float32)
    rc = lib.lrt_resize_rgb8_f32(img.ctypes.data, img.shape[0], img.shape[1], out.ctypes.data,
                                 out_h, out_w, 1 if mode == "bicubic" else 0)
    if rc != 0:
        return None
    CALLS["resize"] += 1
    return out


def phi3v_hd_batch(
    blobs: Sequence[bytes],
    sizes: Sequence[Tuple[int, int]],  # (w, h) per image (from headers)
    num_crops: int = 16,
    num_threads: int = 8,
) -> Optional[List[np.ndarray]]:
    """Fused decode + HD transform + normalise for a batch: the normalised
    (final_h, final_w, 3) float32 arrays, or None without the library."""
    lib = load_native()
    if lib is None:
        return None
    mean = np.ascontiguousarray(OPENAI_CLIP_MEAN, np.float32)
    std = np.ascontiguousarray(OPENAI_CLIP_STD, np.float32)
    tasks = (_HdTask * len(blobs))()
    keep = []  # the buffers the library reads and writes stay referenced
    outs: List[np.ndarray] = []
    for i, (blob, (w, h)) in enumerate(zip(blobs, sizes)):
        new_w, new_h, transposed = hd_transform_scale(w, h, num_crops)
        _, pad_h = padded_size(new_w, new_h)
        final_h, final_w = (new_w, pad_h) if transposed else (pad_h, new_w)
        dst = np.empty((final_h, final_w, 3), np.float32)
        buf = np.frombuffer(blob, np.uint8)
        keep.append((buf, dst))
        outs.append(dst)
        tasks[i].data = buf.ctypes.data
        tasks[i].len = len(blob)
        tasks[i].transposed = int(transposed)
        tasks[i].new_h = new_h
        tasks[i].new_w = new_w
        tasks[i].pad_h = pad_h
        tasks[i].dst = dst.ctypes.data
        tasks[i].status = 0
    rc = lib.lrt_phi3v_hd_batch(tasks, len(blobs), mean.ctypes.data, std.ctypes.data,
                                num_threads)
    if rc != 0:
        return None
    CALLS["hd_batch"] += 1
    return outs
