"""Build and load the port's CUDA kernels.

``load_library`` compiles every ``csrc/*.cu`` source with ``nvcc`` for
Hopper (``sm_90a``), one nvcc process per source, all started together,
links the objects into one shared library with a plain ``extern "C"``
interface, and loads it with ``ctypes``.  The library lands in
``build/jpeg_tpu_torch/`` under the repository root, named by a hash of
the sources, their ``csrc/*.cuh`` headers and the flags, so an unchanged
source is never rebuilt.  A
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
# No --use_fast_math, and nvcc's IEEE defaults (-prec-div=true,
# -prec-sqrt=true, -ftz=false): the encode kernel's quantizer needs a true
# division and the plain versions' float32 values.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {
        "jt_decode_segments": [p] * 5 + [i] * 12 + [p],
        "jt_decode_segments_count": [p] * 12 + [i] * 10 + [p],
        "jt_decode_segments_place": [p] * 11 + [i] * 11 + [p],
        "jt_decode_segments_launches": [],
        "jt_decode_segments_table_ints": [],
        "jt_decode_segments_lut_bits": [],
        "jt_decode_segments_cta_lanes": [],
        "jt_pixels_to_zz": [p, i, p, p, p, p, p, p, p] + [i] * 13 + [p],
        "jt_encode_dense_tile_blocks": [],
        "jt_encode_scan_pieces": [i, i],
        "jt_encode_segments": [p] * 7 + [i] * 3 + [p] * 7,
        "jt_compact_segments": [p] * 7 + [i] * 2 + [p] * 5,
        "jt_encode_scan_t_max": [],
        "jt_encode_scan_block_words": [],
        "jt_hist_blocks": [p, p, p, i, i, p, p],
        "jt_idct_exact": [p, p, p, p, ll, i, p],
        "jt_fdct_exact": [p, p, p, p, ll, i, p],
        "jt_color_exact": [p, p, ll, i, i, p],
        "jt_coeffs_to_pixels": [p] * 5 + [i] * 17 + [p],
        "jt_decode_dense_tile_blocks": [],
        "jt_decode_dense_comp_ints": [],
        "jt_decode_dense_plan_ints": [],
        "jt_rstless_sync": [p] * 9 + [i] * 9 + [p],
        "jt_rstless_resolve": [p] * 12 + [i] * 12 + [p],
        "jt_rstless_final": [p] * 9 + [i] * 12 + [p],
        "jt_decode_rstless_table_ints": [],
        "jt_decode_rstless_ncol": [],
        "jt_decode_rstless_gcol": [],
        "jt_decode_frame_fast": [p] * 5 + [i] * 12 + [p],
        "jt_encode_frame_fast": [p] * 5 + [i] * 14 + [p],
        "jt_dense_fast_resources": [i] * 5 + [p],
        "jt_dense_fast_comp_ints": [],
        "jt_dense_fast_block_floats": [],
        "jt_dense_fast_head_bytes": [],
        "jt_dense_fast_stages": [],
        "jt_rows_from_flat": [p, p, p, ll, i, i, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    lib.jt_decode_segments_launches.restype = ll


def _check_layouts(lib: ctypes.CDLL) -> None:
    """Raise if a source's compiled-in layout constants differ from the
    Python side that packs its inputs."""
    from .entropy.encode_cuda import BLOCK_WORDS, T_MAX
    from .entropy.place_cuda import CTA_LANES, LUT_BITS, TABLE_INTS
    from .entropy.speculative_torch import GCOL, NCOL
    from .models import decode_dense, dense_fast
    from .models.encode_dense import TILE_BLOCKS

    for name, got, want in (
        ("decode_segments.cu table ints", lib.jt_decode_segments_table_ints(),
         TABLE_INTS),
        ("decode_segments.cu LUT_BITS", lib.jt_decode_segments_lut_bits(),
         LUT_BITS),
        ("decode_segments.cu CTA_LANES", lib.jt_decode_segments_cta_lanes(),
         CTA_LANES),
        ("encode_scan.cu T_MAX", lib.jt_encode_scan_t_max(), T_MAX),
        ("encode_scan.cu BLOCK_WORDS", lib.jt_encode_scan_block_words(),
         BLOCK_WORDS),
        ("encode_dense.cu TILE_BLOCKS", lib.jt_encode_dense_tile_blocks(),
         TILE_BLOCKS),
        ("decode_dense.cu TILE_BLOCKS", lib.jt_decode_dense_tile_blocks(),
         decode_dense.TILE_BLOCKS),
        ("decode_dense.cu COMP_INTS", lib.jt_decode_dense_comp_ints(),
         decode_dense.COMP_INTS),
        ("decode_dense.cu PLAN_INTS", lib.jt_decode_dense_plan_ints(),
         decode_dense.PLAN_INTS),
        ("decode_rstless.cu table ints", lib.jt_decode_rstless_table_ints(),
         TABLE_INTS),
        ("decode_rstless.cu NCOL", lib.jt_decode_rstless_ncol(), NCOL),
        ("decode_rstless.cu GCOL", lib.jt_decode_rstless_gcol(), GCOL),
        ("dense_fast.cu COMP_INTS", lib.jt_dense_fast_comp_ints(),
         dense_fast.COMP_INTS),
        ("dense_fast.cu BP", lib.jt_dense_fast_block_floats(),
         dense_fast.BLOCK_FLOATS),
        ("dense_fast.cu HEAD_BYTES", lib.jt_dense_fast_head_bytes(),
         dense_fast.HEAD_BYTES),
        ("dense_fast.cu STAGES", lib.jt_dense_fast_stages(),
         dense_fast.STAGES),
    ):
        if got != want:
            raise RuntimeError(f"csrc/{name} is {got}, the Python side "
                               f"packs {want}")


@lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load ``csrc/*.cu``; raises on any failure."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):  # and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libjpeg_tpu_torch_{h.hexdigest()[:16]}.so"
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            nvcc = _nvcc()
            objs = [Path(work) / f"{src.stem}.o" for src in sources]
            procs = [
                subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                  str(src)], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources, objs)
            ]
            logs = [(src, proc.communicate()[0], proc.returncode)
                    for src, proc in zip(sources, procs)]
            failed = [(src, log, rc) for src, log, rc in logs if rc != 0]
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(
                    f"{src.name} ({rc}):\n{log}" for src, log, rc in failed))
            tmp = Path(work) / so.name
            res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                                  *map(str, objs)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({res.returncode}):\n"
                    f"{res.stdout}{res.stderr}")
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _check_layouts(lib)
    return KernelLibrary(lib=lib, path=so, build_seconds=seconds)
