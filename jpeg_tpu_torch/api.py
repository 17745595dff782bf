"""Single-image decode API: JPEG bytes -> RGB frame (+ coefficients).

The port of the JAX package's ``api.py``.  ``decode_jpeg`` is the analog
of the reference's process_jpeg_stream (decoder.c:661-685): parse
markers, entropy-decode every scan on the host, then run the dense
pipeline on ``device`` (``models/pipeline.decode_frame``; with
``exact=True`` the bit-exact kernels, byte-identical to the reference
codec).  ``DecodedImage``, ``expected_mcus``, ``checks_enabled`` and
``checks_level`` are copied from the JAX module.

Entropy backends: ``"auto"`` takes the threaded C++ engine
(``"native"``: ``entropy/native.py`` over ``native/scanner.cpp``, built
with g++ at first use) when its library is available, and otherwise the
NumPy lockstep engine for scans of 16 or more restart segments and the
serial oracle for the rest, as the JAX package chooses;
``"native"``, ``"serial"`` and ``"lockstep"`` force one.  Two backends
decode on the
``device`` they are given (required): ``"lockstep-jax"`` decodes every
scan with the general segment decode (``entropy/lockstep_jax.py``: the
kernels of ``csrc/decode_segments.cu``, or their plain versions on the
CPU), as the JAX package's backend of that name does on its device;
``"speculative"`` runs the RST-less engine (``entropy/speculative.py``:
kernels K8-K10) for a scan without restart markers, routes a scan with
them to the lockstep engine, and decodes a scan the engine refuses with
the serial oracle.  ``"auto"`` never picks either.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict

import numpy as np

from . import native
from .errors import CorruptStream, JpegError, UnsupportedError
from .format.parse import (
    Codestream,
    parse_codestream,
    unstuff,
    unstuff_ranges,
)
from .geometry import FrameGeometry
from .tables import HuffSpec, HuffTable, derive_table
from .utils.pnm import write_pnm

@lru_cache(maxsize=64)
def _derive_cached(spec: HuffSpec) -> HuffTable:
    return derive_table(spec)


@dataclass
class DecodedImage:
    """Decoded frame: float RGB raster plus geometry/metadata."""

    frame: np.ndarray  # float32 [size_y, size_x, Nf], RGB (K dropped later)
    geometry: FrameGeometry
    codestream: Codestream
    coefficients: Dict[int, np.ndarray]  # cid -> int32 [n_blocks, 64]

    @property
    def width(self) -> int:
        return self.geometry.width

    @property
    def height(self) -> int:
        return self.geometry.height

    def to_pnm(self) -> bytes:
        """PPM/PGM bytes exactly like write_frame (frame.c:548-567)."""
        return write_pnm(
            self.frame,
            self.geometry.width,
            self.geometry.height,
            self.geometry.precision,
        )

    def pixels(self) -> np.ndarray:
        """[height, width, C] integer samples (rounded + clamped)."""
        c = 3 if self.geometry.nf >= 3 else 1
        window = self.frame[: self.height, : self.width, :c]
        t = np.trunc(window)
        frac = window - t
        rounded = np.where(np.abs(frac) >= 0.5, t + np.copysign(1.0, window), t)
        maxval = (1 << self.geometry.precision) - 1
        return np.clip(rounded.astype(np.int32), 0, maxval)


def expected_mcus(geom: FrameGeometry, info) -> int:
    """MCU steps the geometry implies for one scan.

    Interleaved (Ns>1): the frame MCU grid (common.c:174).  Ns=1
    non-interleaved: each step covers H*V consecutive blocks of the
    component's own grid (decoder.c:274-302).
    """
    if info.ns == 0:
        # read_macroblock returns NO_MORE_DATA at once (decoder.c:271-273).
        return 0
    if info.ns > 1:
        return geom.n_mcus
    c = geom.by_id(info.component_ids[0])
    step = max(1, c.h * c.v)
    return -(-c.n_blocks // step)


def checks_enabled() -> bool:
    """Sanitizer mode (SURVEY §5): JPEG_TPU_CHECKS=1 arms extra decode
    invariant checks (MCU-count vs geometry, NaN guards in fast paths)."""
    return checks_level() >= 1


def checks_level() -> int:
    """JPEG_TPU_CHECKS tiers: 0 off, 1 host-side invariants, 2 (a test
    tier) also the JAX package's in-scan checks for ``"lockstep-jax"``:
    the plain scan and placement rerun on the decode's tensors with the
    checks of ``lockstep_torch.scan_lanes`` and
    ``place_cuda.place_emissions``, raising ``CorruptStream("sanitizer:
    ...")``."""
    v = os.environ.get("JPEG_TPU_CHECKS", "")
    if not v or v == "0":
        return 0
    return int(v) if v.isdigit() else 1


def decode_coefficients(
    data: bytes, entropy: str = "auto", device=None
) -> tuple[Codestream, Dict[int, np.ndarray]]:
    """Parse + entropy-decode only: JPEG bytes -> coefficient planes (host
    numpy).  Every backend decodes on the host except ``"lockstep-jax"``
    and ``"speculative"``, which run on ``device`` (required for them)."""
    try:
        return _decode_coefficients(data, entropy, device)
    except JpegError:
        if entropy != "auto":
            raise
        # An auto-picked fast engine may reject degenerate/corrupt
        # layouts the reference still decodes (e.g. a scan referencing
        # an undeclared component id, which it simply skips); the serial
        # oracle defines our behavior there -- retry once with it.  A
        # genuinely corrupt stream re-raises from the oracle.
        return _decode_coefficients(data, "serial", device)


def _decode_coefficients(
    data: bytes, entropy: str, device
) -> tuple[Codestream, Dict[int, np.ndarray]]:
    if entropy not in ("auto", "serial", "lockstep", "lockstep-jax",
                       "native", "speculative"):
        raise UnsupportedError(f"unknown entropy backend {entropy!r}")
    if entropy in ("lockstep-jax", "speculative"):
        if device is None:
            raise ValueError(f"entropy={entropy!r} decodes on a device: "
                             "pass device")
        from .device import resolve

        device = resolve(device)
    cs = parse_codestream(data)
    geom = cs.geometry
    if geom is None:
        raise UnsupportedError("no frame header before scan data")

    planes = {
        c.cid: np.zeros((c.n_blocks, 64), dtype=np.int32)
        for c in geom.components
    }

    cs.mcus_decoded = []
    for scan in cs.scans:
        if scan.info.ns == 0:
            # Ns=0 scan: the reference's read_macroblock returns
            # NO_MORE_DATA immediately (decoder.c:271-273), so read_ecs
            # processes zero macroblocks and the marker walk continues.
            cs.mcus_decoded.append(0)
            continue
        tables = {k: _derive_cached(spec) for k, spec in scan.htables.items()}
        backend = entropy
        if backend == "auto":
            if native.available():
                backend = "native"
            else:
                # Lockstep decodes restart segments in parallel lanes, but
                # its per-step cost is fixed -- it only amortizes with
                # enough lanes; otherwise the serial reader wins.
                backend = "lockstep" if len(scan.ecs_ranges) >= 16 else "serial"
        if backend == "native":
            if not native.available():
                raise UnsupportedError(
                    "entropy='native' requested but the native library is "
                    "unavailable (no C++ toolchain?); use entropy='auto'"
                )
            from .entropy.native import decode_scan_native

            seg_bytes, seg_offsets = unstuff_ranges(data, scan.ecs_ranges)
            n = decode_scan_native(
                geom,
                scan.info,
                tables,
                planes,
                ri=scan.ri,
                seg_bytes=seg_bytes,
                seg_offsets=seg_offsets,
            )
            cs.mcus_decoded.append(int(n))
            continue
        segments = [unstuff(data[s:e]) for (s, e) in scan.ecs_ranges]
        if backend == "serial":
            from .entropy.serial import decode_scan_serial

            n = decode_scan_serial(geom, scan.info, tables, segments, planes)
        elif backend == "speculative":
            from .entropy.speculative import decode_scan_speculative

            n = decode_scan_speculative(
                geom, scan.info, tables, tuple(sorted(scan.htables.items())),
                segments, planes, device)
        elif backend == "lockstep-jax":
            from .entropy.lockstep_jax import decode_scan_lockstep_jax

            n = decode_scan_lockstep_jax(
                geom, scan.info, tables, tuple(sorted(scan.htables.items())),
                segments, planes, device)
        else:
            from .entropy.lockstep import decode_scan_lockstep

            n = decode_scan_lockstep(geom, scan.info, tables, segments, planes)
        cs.mcus_decoded.append(int(n))
    if checks_enabled():
        # Sanitizer: every scan must have decoded exactly the MCU count
        # its geometry implies (the reference's expected-vs-processed
        # report, common.c:174, hardened into an assertion).
        for scan, got in zip(cs.scans, cs.mcus_decoded):
            want = expected_mcus(geom, scan.info)
            if got != want:
                raise CorruptStream(
                    f"scan decoded {got} MCUs, geometry expects {want}"
                )
    return cs, planes


def decode_jpeg(
    data: bytes, device, exact: bool = True, entropy: str = "auto"
) -> DecodedImage:
    """Full decode: JPEG bytes -> RGB float frame (+ coefficients).

    Entropy decode runs on the host (``entropy="lockstep-jax"`` and
    ``"speculative"``: on ``device``), the dense pipeline on ``device``;
    ``frame`` comes back as a float32 numpy array.
    """
    from .device import resolve
    from .models.pipeline import decode_frame

    dev = resolve(device)
    cs, planes = decode_coefficients(data, entropy=entropy, device=dev)
    geom = cs.geometry
    frame = decode_frame(planes, geom, cs.qtables.astype(np.int32), exact,
                         device=dev).cpu().numpy()
    if checks_enabled() and not np.isfinite(frame).all():
        # Sanitizer: the dense kernels are pure fixed-range arithmetic;
        # a NaN/Inf means a kernel bug, not bad input.
        raise AssertionError("non-finite samples out of the dense pipeline")
    return DecodedImage(frame=frame, geometry=geom, codestream=cs,
                        coefficients=planes)
