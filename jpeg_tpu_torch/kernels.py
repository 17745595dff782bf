"""Build and load the port's CUDA kernels.

``load_library`` compiles every ``csrc/*.cu`` source with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain ``extern "C"``
interface, and loads it with ``ctypes``.  The library lands in
``build/jpeg_tpu_torch/`` under the repository root, named by a hash of
the sources and flags, so an unchanged source is never rebuilt.  A
failed build raises; nothing falls back to the plain versions.

The build runs at first use, inside the first call that launches a
kernel -- never at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "jpeg_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


@dataclass(frozen=True)
class KernelLibrary:
    """The loaded library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date build was reused


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = Path(home or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.jt_decode_segments.argtypes = [p, p, p, p, p] + [i] * 10 + [p]
    lib.jt_decode_segments.restype = i
    lib.jt_decode_segments_table_ints.argtypes = []
    lib.jt_decode_segments_table_ints.restype = i


@lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load ``csrc/*.cu``; raises on any failure."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libjpeg_tpu_torch_{h.hexdigest()[:16]}.so"
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    from .entropy.place_cuda import TABLE_INTS

    if lib.jt_decode_segments_table_ints() != TABLE_INTS:
        raise RuntimeError("csrc/decode_segments.cu table layout differs "
                           "from entropy/place_cuda.py")
    return KernelLibrary(lib=lib, path=so, build_seconds=seconds)
