"""ctypes bindings for the native host library: ``scanner.cpp``, the
JAX package's entropy kernel, ``ecs_walk.cpp``, the port's prep walk,
``encode_tail.cpp``, the port's encode host tail, ``stream_entry.cpp``,
the port's stream split, and ``optimal_tables.cpp``, the port's Annex
K.2 table builder.

``scanner.cpp`` is a byte-for-byte copy of ``jpeg_tpu/native``'s source,
bound here with the same functions and signatures; only the build
differs.  The others are the port's own: the three ``prep_ecs*_native``
wrappers unstuff and pack a frame's segments one 0xFF-free run at a time
(``jt_walk_ecs_flat`` and ``jt_walk_ecs_rows``, with the contracts of
``scanner.cpp``'s byte-at-a-time ``jt_prep_ecs*`` loops, which stay bound
as their oracle),
``finalize_flat_native`` pads, byte-stuffs and frames a chunk's encoded
segments in one pass, ``split_stream_native`` cuts a Motion-JPEG stream
into frames in one, and ``optimal_tables_native`` builds the optimal
Huffman tables of many symbol histograms (``tables.optimize_table``'s
tables) in one call.
``load_library`` compiles the sources with one ``g++`` command (the JAX
package Makefile's flags) into one library in
``build/jpeg_tpu_torch/`` under the repository root, named by a hash of
the sources, the flags and the target that ``-march=native`` resolves
to, through a temporary file and an atomic rename, so concurrent
processes never load a half-written library.  The build runs at first
use, never at import time.

``available()`` keeps the JAX package's meaning: False when the library
cannot be built or loaded, and the NumPy backends take over.  Such a
failure is tried once a process and warns once, with the tail of the
compiler's output; ``load_error()`` returns that output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
import warnings
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..kernels import BUILD_DIR
from ..utils.metrics import default_metrics

SOURCES = tuple(Path(__file__).resolve().parent / name
                for name in ("scanner.cpp", "ecs_walk.cpp",
                             "encode_tail.cpp", "stream_entry.cpp",
                             "optimal_tables.cpp"))
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
             "-pthread")


@dataclass(frozen=True)
class NativeLibrary:
    """The loaded library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date build was reused


def _declare(lib: ctypes.CDLL) -> None:
    i8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.jt_decode_segments.restype = None
    lib.jt_decode_segments.argtypes = [
        i8p, i64p, ctypes.c_int32, i32p, i32p, i32p, i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        i32p, i64p, i64p, ctypes.c_int32,
    ]
    lib.jt_find_ecs_end.restype = ctypes.c_int64
    lib.jt_find_ecs_end.argtypes = [i8p, ctypes.c_int64, ctypes.c_int64]
    lib.jt_unstuff.restype = ctypes.c_int64
    lib.jt_unstuff.argtypes = [i8p, ctypes.c_int64, i8p]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    # The old loops; each run walk shares its old loop's signature (the
    # rows walk's row_map may be None, a null pointer).
    rows = [u32p, ctypes.c_int64, i32p, ctypes.c_int64, i32p, i64p]
    flat = [u32p, ctypes.c_int64, i32p, i32p, ctypes.c_int64, i64p, i64p]
    for name, args in (
            ("jt_prep_ecs", [u32p, ctypes.c_int64, ctypes.c_int64, i32p,
                             i64p]),
            ("jt_prep_ecs_rows", rows), ("jt_walk_ecs_rows", rows),
            ("jt_prep_ecs_flat", flat), ("jt_walk_ecs_flat", flat)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [i8p, ctypes.c_int64, ctypes.c_int64, *args]
    lib.jt_encode_segments.restype = None
    lib.jt_encode_segments.argtypes = [
        i32p, i32p, i32p, i64p, ctypes.c_int32, i32p, i32p,
        i8p, ctypes.c_int64, i64p, i32p, ctypes.c_int32,
    ]
    lib.jt_finalize_flat.restype = ctypes.c_int64
    lib.jt_finalize_flat.argtypes = [
        u32p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64,
        i8p, i64p, ctypes.c_int64, i8p, ctypes.c_int64, i64p,
    ]
    lib.jt_optimal_tables.restype = ctypes.c_int64
    lib.jt_optimal_tables.argtypes = [i32p, ctypes.c_int64, i8p, i8p, i32p,
                                      i32p]


def _run(cmd) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300)


@lru_cache(maxsize=None)
def load_library() -> NativeLibrary:
    """Build (if needed) and load the library; raises ``RuntimeError``
    with the compiler's output when it cannot."""
    try:
        # -march=native differs between hosts that share the build
        # directory: key the build by the target it resolves to.
        target = _run([CXX, *CXX_FLAGS[:2], "-Q", "--help=target"])
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{CXX} could not run: {e}") from e
    if target.returncode != 0:
        raise RuntimeError(f"{CXX} -march=native failed "
                           f"({target.returncode}):\n{target.stderr}")
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(target.stdout.encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libjpeg_tpu_torch_host_{h.hexdigest()[:16]}.so"
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            tmp = Path(work) / so.name
            try:
                res = _run([CXX, *CXX_FLAGS, "-o", str(tmp),
                            *map(str, SOURCES)])
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"{CXX} could not run: {e}") from e
            if res.returncode != 0:
                raise RuntimeError(f"{CXX} failed ({res.returncode}):\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
        seconds = time.perf_counter() - t0
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        raise RuntimeError(f"cannot load {so}: {e}") from e
    _declare(lib)
    return NativeLibrary(lib=lib, path=so, build_seconds=seconds)


@lru_cache(maxsize=None)
def _attempt() -> Tuple[Optional[ctypes.CDLL], str]:
    """The library, or None and the build's error: tried once a process."""
    try:
        return load_library().lib, ""
    except RuntimeError as e:
        tail = "\n".join(str(e).splitlines()[-20:])
        warnings.warn(f"native host library unavailable, the NumPy "
                      f"backends take over: {tail}", RuntimeWarning,
                      stacklevel=4)
        return None, str(e)


def _load() -> Optional[ctypes.CDLL]:
    return _attempt()[0]


def available() -> bool:
    return _load() is not None


def load_error() -> str:
    """Why the library could not be built or loaded ("" when it was)."""
    return _attempt()[1]


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def decode_segments_native(
    seg_bytes: np.ndarray,  # concatenated unstuffed bytes, uint8
    seg_offsets: np.ndarray,  # [S+1] int64
    lut16: np.ndarray,  # [T, 65536] int32
    slot_dc_tab: np.ndarray,  # [bpm] int32
    slot_ac_tab: np.ndarray,
    slot_comp: np.ndarray,
    n_comps: int,
    max_blocks_per_seg: int,
    n_threads: int = 0,
):
    """Returns (blocks [S, max_blocks, 64] int32 visit order,
    blocks_written [S], mcu_counts [S])."""
    lib = _load()
    assert lib is not None
    S = seg_offsets.size - 1
    bpm = slot_comp.size
    out = np.zeros((S, max_blocks_per_seg, 64), dtype=np.int32)
    written = np.zeros(S, dtype=np.int64)
    counts = np.zeros(S, dtype=np.int64)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)

    seg_bytes = np.ascontiguousarray(seg_bytes, dtype=np.uint8)
    seg_offsets = np.ascontiguousarray(seg_offsets, dtype=np.int64)
    lut16 = np.ascontiguousarray(lut16, dtype=np.int32)
    slot_dc_tab = np.ascontiguousarray(slot_dc_tab, dtype=np.int32)
    slot_ac_tab = np.ascontiguousarray(slot_ac_tab, dtype=np.int32)
    slot_comp = np.ascontiguousarray(slot_comp, dtype=np.int32)

    lib.jt_decode_segments(
        _ptr(seg_bytes, ctypes.c_uint8),
        _ptr(seg_offsets, ctypes.c_int64),
        ctypes.c_int32(S),
        _ptr(lut16, ctypes.c_int32),
        _ptr(slot_dc_tab, ctypes.c_int32),
        _ptr(slot_ac_tab, ctypes.c_int32),
        _ptr(slot_comp, ctypes.c_int32),
        ctypes.c_int32(bpm),
        ctypes.c_int32(n_comps),
        ctypes.c_int64(max_blocks_per_seg),
        _ptr(out, ctypes.c_int32),
        _ptr(written, ctypes.c_int64),
        _ptr(counts, ctypes.c_int64),
        ctypes.c_int32(n_threads),
    )
    return out, written, counts


def encode_segments_native(
    zz: np.ndarray,  # [B, 64] int32, visit order, DC already differential
    dc_tab: np.ndarray,  # [B] int32
    ac_tab: np.ndarray,  # [B] int32
    seg_block_offsets: np.ndarray,  # [S+1] int64
    ehufco: np.ndarray,  # [T, 256] int32
    ehufsi: np.ndarray,  # [T, 256] int32
    n_threads: int = 0,
):
    """Threaded C++ entropy encode -> list of stuffed segment bytes.

    The native counterpart of the reference's write_ecs hot loop
    (encoder.c:560-587).  Raises UnsupportedError on a symbol with no
    code in its table (value_to_vlc parity).
    """
    lib = _load()
    assert lib is not None
    S = seg_block_offsets.size - 1
    bps = int(np.diff(seg_block_offsets).max()) if S else 0
    cap = bps * 68 * 31 // 8 * 2 + 16  # worst case incl. stuffing
    out = np.empty((S, cap), dtype=np.uint8)
    lens = np.zeros(S, dtype=np.int64)
    errors = np.zeros(S, dtype=np.int32)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    zz = np.ascontiguousarray(zz, dtype=np.int32)
    dc_tab = np.ascontiguousarray(dc_tab, dtype=np.int32)
    ac_tab = np.ascontiguousarray(ac_tab, dtype=np.int32)
    sbo = np.ascontiguousarray(seg_block_offsets, dtype=np.int64)
    ehufco = np.ascontiguousarray(ehufco, dtype=np.int32)
    ehufsi = np.ascontiguousarray(ehufsi, dtype=np.int32)
    lib.jt_encode_segments(
        _ptr(zz, ctypes.c_int32),
        _ptr(dc_tab, ctypes.c_int32),
        _ptr(ac_tab, ctypes.c_int32),
        _ptr(sbo, ctypes.c_int64),
        ctypes.c_int32(S),
        _ptr(ehufco, ctypes.c_int32),
        _ptr(ehufsi, ctypes.c_int32),
        _ptr(out, ctypes.c_uint8),
        ctypes.c_int64(cap),
        _ptr(lens, ctypes.c_int64),
        _ptr(errors, ctypes.c_int32),
        ctypes.c_int32(n_threads),
    )
    if (errors == 1).any():
        from ..errors import UnsupportedError

        raise UnsupportedError(
            "a symbol has no code in the selected Huffman table "
            "(content exceeds table range; use optimized tables)"
        )
    assert not errors.any(), "native encode buffer overflow"
    return [out[s, : lens[s]].tobytes() for s in range(S)]


def _walked(rc: int) -> int:
    """Count one frame of a prep walk: packed, or refused with a code."""
    default_metrics.count("native.ecs_walk_frames" if rc > 0
                          else "native.ecs_walk_refused")
    return rc


def prep_ecs_flat_native(
    data: bytes,
    start: int,
    out_buf: np.ndarray,  # [cap] uint32, C-contiguous
    buf_base: int,  # word offset where this frame's rows begin
    starts: np.ndarray,  # [max_rows] int32 (filled relative to buf_base)
    lens: np.ndarray,  # [max_rows] int32
):
    """Tight-pack one frame's segments at out_buf[buf_base:].

    Returns (nsegs, words_used); nsegs < 0 is a jt_prep_ecs* fallback code
    (``jt_walk_ecs_flat``).
    """
    lib = _load()
    assert lib is not None
    buf = np.frombuffer(data, dtype=np.uint8)
    used = ctypes.c_int64(0)
    end_off = ctypes.c_int64(0)
    view = out_buf[buf_base:]
    rc = _walked(
        lib.jt_walk_ecs_flat(
            _ptr(buf, ctypes.c_uint8),
            ctypes.c_int64(buf.size),
            ctypes.c_int64(start),
            view.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(view.size),
            _ptr(starts, ctypes.c_int32),
            _ptr(lens, ctypes.c_int32),
            ctypes.c_int64(starts.size),
            ctypes.byref(used),
            ctypes.byref(end_off),
        )
    )
    return rc, int(used.value)


def prep_ecs_rows_native(
    data: bytes,
    start: int,
    out_rows: np.ndarray,  # [total_rows, wn] uint32, C-contiguous, zeroed
    row_map: np.ndarray,  # [max_rows] int32: segment r -> absolute row
    lens: np.ndarray,  # [max_rows] int32
) -> int:
    """Unstuff+pack one frame's segments directly into caller-chosen lane
    rows of the padded matrix (no device rebuild gather; rows orderable
    by predicted symbol count).  Returns segment count or <0 fallback
    (``jt_walk_ecs_rows``)."""
    lib = _load()
    assert lib is not None
    assert out_rows.dtype == np.uint32 and out_rows.flags.c_contiguous
    buf = np.frombuffer(data, dtype=np.uint8)
    end_off = ctypes.c_int64(0)
    return _walked(
        lib.jt_walk_ecs_rows(
            _ptr(buf, ctypes.c_uint8),
            ctypes.c_int64(buf.size),
            ctypes.c_int64(start),
            out_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(out_rows.shape[1]),
            _ptr(row_map, ctypes.c_int32),
            ctypes.c_int64(row_map.size),
            _ptr(lens, ctypes.c_int32),
            ctypes.byref(end_off),
        )
    )


def prep_ecs_native(
    data: bytes,
    start: int,
    out_rows: np.ndarray,  # [max_rows, wn] uint32, C-contiguous, zeroed
    lens: np.ndarray,  # [max_rows] int32
) -> int:
    """Unstuff+pack one frame's restart segments into BE-u32 lane rows.

    Returns the segment count, or <0 (see jt_prep_ecs*) when the caller
    must fall back to the Python parser / retry with a wider matrix
    (``jt_walk_ecs_rows`` with no row map).
    """
    lib = _load()
    assert lib is not None
    assert out_rows.dtype == np.uint32 and out_rows.flags.c_contiguous
    buf = np.frombuffer(data, dtype=np.uint8)
    end_off = ctypes.c_int64(0)
    return _walked(
        lib.jt_walk_ecs_rows(
            _ptr(buf, ctypes.c_uint8),
            ctypes.c_int64(buf.size),
            ctypes.c_int64(start),
            out_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(out_rows.shape[1]),
            None,
            ctypes.c_int64(out_rows.shape[0]),
            _ptr(lens, ctypes.c_int32),
            ctypes.byref(end_off),
        )
    )


def finalize_flat_native(
    words: np.ndarray,  # [W] uint32, the chunk's compacted segment words
    seg_bits: np.ndarray,  # [frames * ns] bits a segment, frame-major
    frames: int,
    ns: int,  # segments a frame
    header: Union[bytes, Sequence[bytes]],  # SOI..SOS, or one a frame
) -> List[bytes]:
    """One JPEG byte string a frame: the header (``header``, or
    ``header[f]`` where a sequence gives each frame its own), each
    segment's bytes padded with 1s and byte-stuffed, RSTn between
    segments, EOI (``jt_finalize_flat``;
    ``DeviceEncoder._finalize_flat_ref`` is the plain version)."""
    lib = _load()
    assert lib is not None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    seg_bits = np.ascontiguousarray(seg_bits, dtype=np.int64)
    if seg_bits.size != frames * ns:
        raise ValueError(f"{seg_bits.size} bit counts for {frames} frames "
                         f"of {ns} segments")
    hdr_off = None  # one header for every frame
    if not isinstance(header, (bytes, bytearray)):
        if len(header) != frames:
            raise ValueError(f"{len(header)} headers for {frames} frames")
        hdr_off = np.zeros(frames + 1, dtype=np.int64)
        np.cumsum([len(h) for h in header], out=hdr_off[1:])
        header = b"".join(header)
    hdr = np.frombuffer(header, dtype=np.uint8)
    # Live bytes are at most 4 a word: the worst case stuffs every one.
    cap = (frames * hdr.size if hdr_off is None else hdr.size) \
        + 8 * words.size + 2 * seg_bits.size
    out = np.empty(cap, dtype=np.uint8)
    off = np.empty(frames + 1, dtype=np.int64)
    n = int(lib.jt_finalize_flat(
        _ptr(words, ctypes.c_uint32), ctypes.c_int64(words.size),
        _ptr(seg_bits, ctypes.c_int64), ctypes.c_int64(frames),
        ctypes.c_int64(ns), _ptr(hdr, ctypes.c_uint8),
        None if hdr_off is None else _ptr(hdr_off, ctypes.c_int64),
        ctypes.c_int64(hdr.size), _ptr(out, ctypes.c_uint8),
        ctypes.c_int64(cap), _ptr(off, ctypes.c_int64)))
    if n < 0:
        raise ValueError(f"jt_finalize_flat refused the chunk ({n}): "
                         f"{words.size} words for {seg_bits.sum()} bits")
    return [out[off[f]:off[f + 1]].tobytes() for f in range(frames)]


def optimal_tables_native(hist: np.ndarray):
    """Annex K.2 tables of each row of ``hist`` [n, 256] (symbol counts)
    in one ``jt_optimal_tables`` call -> (bits [n, 16] uint8, the DHT's
    L1..L16; values [n, 256] uint8, HUFFVAL then zeros; ehufco, ehufsi
    [n, 256] int32, the Annex C encode tables).  Each table equals
    ``tables.optimize_table(hist[t])`` and its ``derive_table``; raises
    ``ValueError`` for a row with no symbol or whose codes do not fit,
    where ``optimize_table`` raises too."""
    lib = _load()
    assert lib is not None
    hist = np.ascontiguousarray(hist, dtype=np.int32)
    if hist.ndim != 2 or hist.shape[1] != 256:
        raise ValueError(f"histograms must be [n, 256], got {hist.shape}")
    n = hist.shape[0]
    bits = np.empty((n, 16), dtype=np.uint8)
    values = np.empty((n, 256), dtype=np.uint8)
    ehufco = np.empty((n, 256), dtype=np.int32)
    ehufsi = np.empty((n, 256), dtype=np.int32)
    rc = int(lib.jt_optimal_tables(
        _ptr(hist, ctypes.c_int32), ctypes.c_int64(n),
        _ptr(bits, ctypes.c_uint8), _ptr(values, ctypes.c_uint8),
        _ptr(ehufco, ctypes.c_int32), _ptr(ehufsi, ctypes.c_int32)))
    if rc < 0:
        t = -rc - 1
        why = "has no symbol" if t < n else "needs codes past 32 bits"
        raise ValueError(f"histogram {t % n} {why}")
    return bits, values, ehufco, ehufsi


def split_stream_native(data, cap: int = 64) -> List[Tuple[int, int]]:
    """Each frame's ``(start, end)`` byte offsets in ``data`` (bytes-like),
    from one ``jt_split_stream`` walk; ``cap`` frames are tried first,
    then as many as the input can hold (a frame is 4 bytes or more)."""
    lib = _load()
    assert lib is not None
    buf = np.frombuffer(data, dtype=np.uint8)
    while True:
        starts = np.empty(cap, dtype=np.int64)
        ends = np.empty(cap, dtype=np.int64)
        k = int(lib.jt_split_stream(
            _ptr(buf, ctypes.c_uint8), ctypes.c_int64(buf.size),
            _ptr(starts, ctypes.c_int64), _ptr(ends, ctypes.c_int64),
            ctypes.c_int64(cap)))
        if k >= 0:
            return list(zip(starts[:k].tolist(), ends[:k].tolist()))
        cap = buf.size // 4 + 1
