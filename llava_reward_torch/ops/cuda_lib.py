"""Build and load the port's hand-written CUDA kernels.

The sources in ``llava_reward_torch/csrc/`` have a plain C interface. At
first use each ``.cu`` file is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a``; the objects are linked into one shared
library under ``build/torch_kernels/`` in the checkout, named by a hash of
the sources and flags, and loaded with ``ctypes``. Nothing is compiled or
loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "lrt_fa_direct": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "lrt_fa_hm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
    + [_L] * 12 + [_I, _I, _I, _F, _P],
    "lrt_rope_transpose": [_P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _P],
    "lrt_rms_quant": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    "lrt_silu_mul_quant": [_P, _P, _P, _I, _I, _I, _P],
    "lrt_row_quant": [_P, _P, _P, _I, _I, _I, _P],
    "lrt_int8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global build_seconds
    so = BUILD_DIR / f"liblrt_kernels_{_digest()}.so"
    if so.exists():
        return so
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{os.getpid()}.o"
        log = open(BUILD_DIR / f"{src.stem}.log", "w")
        procs.append((src, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=log, stderr=subprocess.STDOUT,
        )))
        objs.append(obj)
    failed = []
    for src, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{src.name} (rc {rc}):\n{(BUILD_DIR / f'{src.stem}.log').read_text()}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
         *map(str, objs)],
        check=True, capture_output=True,
    )
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return so


def build_logs() -> str:
    """nvcc's output of the last build (ptxas registers, shared memory, spills)."""
    return "\n".join(
        p.read_text() for p in sorted(BUILD_DIR.glob("*.log")) if p.stat().st_size
    )


def load() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
