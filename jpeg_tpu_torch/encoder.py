"""Top-level JPEG encoder (the analog of encoder.c's process_stream).

The port of the JAX package's ``encoder.py``.  Pipeline (encoder.c:176-193
+ 589-645):
  PNM bytes -> padded float raster -> RGB->YCC -> box downsample ->
  blocks -> FDCT -> quantize  (dense, on ``device``)
  -> symbolize -> [optimize: histogram + K.2] -> bit-pack -> markers.

Extensions over the reference: ``restart_interval`` emits DRI + RSTn so
the output is parallel-decodable (the reference never does, SURVEY §2.2);
subsampling factors up to 2x2 like the reference CLI.

With defaults (restart_interval=0, exact=True) output files are
byte-identical to the reference encoder at equal settings.  The dense
stage runs on ``device`` (``models/pipeline.encode_frame``: the exact
kernels with ``exact=True``); entropy coding runs on the host with the
NumPy packer, or on ``device`` with ``entropy_backend="jax"`` (the
segment encode kernel, ``entropy/encode_cuda.pack_scan_device``: the same
bytes), or on the host with ``entropy_backend="native"`` (the threaded
C++ coder of ``native/scanner.cpp``; NumPy when its library is not
available, as the JAX package does).  ``EncodeParams`` and
``geometry_for_image`` are copied unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .constants import (
    DEFAULT_HTABLES,
    STD_CHROMINANCE_QUANT,
    STD_LUMINANCE_QUANT,
    scale_qtable,
)
from .entropy.encode import histogram, pack_scan, symbolize_scan
from .errors import UnsupportedError
from .format import emit
from .geometry import Component, FrameGeometry, ScanInfo, with_block_grid
from .tables import HuffSpec, derive_table, optimize_table
from .utils.pnm import PnmImage, read_pnm


@dataclass
class EncodeParams:
    """CLI-equivalent parameters (encoder.c:67-88) + extensions."""

    h: int = 2  # luma horizontal sampling factor (1..2)
    v: int = 1  # luma vertical sampling factor (1..2)
    quality: int = 75
    optimize: bool = True
    restart_interval: int = 0  # extension: MCUs per restart interval
    exact: bool = True  # bit-exact float path vs fast MXU path
    entropy_backend: str = "numpy"  # "numpy" (host), "jax" (on-device),
    # or "native" (threaded C++ host kernel; falls back to numpy)


def geometry_for_image(img: PnmImage, params: EncodeParams) -> FrameGeometry:
    """Component layout + table assignment (encoder.c:109-152)."""
    if img.components == 1:
        comps = (Component(cid=1, h=1, v=1, tq=0, td=0, ta=0),)
    elif img.components == 3:
        if not (1 <= params.h <= 2 and 1 <= params.v <= 2):
            raise UnsupportedError("sampling factors must be 1..2")
        comps = (
            Component(cid=1, h=params.h, v=params.v, tq=0, td=0, ta=0),
            Component(cid=2, h=1, v=1, tq=1, td=1, ta=1),
            Component(cid=3, h=1, v=1, tq=1, td=1, ta=1),
        )
    else:
        raise UnsupportedError("PNM must have 1 or 3 components")
    geom = FrameGeometry(
        precision=img.precision,
        height=img.height,
        width=img.width,
        components=comps,
    )
    return with_block_grid(geom)


def encode_jpeg_from_planes(
    planes: Dict[int, np.ndarray],
    geom: FrameGeometry,
    qtables: np.ndarray,
    params: EncodeParams,
    device,
) -> bytes:
    """Entropy + format stage: quantized planes -> JPEG bytes.

    ``device`` is where ``entropy_backend="jax"`` codes the symbols; the
    other backends run on the host.
    """
    info = ScanInfo(
        component_ids=tuple(c.cid for c in sorted(geom.components, key=lambda c: c.cid)),
        td=tuple(c.td for c in sorted(geom.components, key=lambda c: c.cid)),
        ta=tuple(c.ta for c in sorted(geom.components, key=lambda c: c.cid)),
    )

    # The numpy symbolization feeds the numpy packer and the optimizer's
    # dry pass; the device and native backends symbolize on their own, so
    # skip it when neither consumer needs it.
    symbols = None
    if params.optimize or params.entropy_backend not in ("jax", "native"):
        symbols = symbolize_scan(planes, geom, info, params.restart_interval)

    # Table selection: default (MJPEG) tables or per-image optimized
    # (produce_codestream ordering, encoder.c:614-630).
    specs: Dict[tuple, HuffSpec] = {
        k: HuffSpec.from_pair(v) for k, v in DEFAULT_HTABLES.items()
    }
    if params.optimize:
        freq = histogram(symbols)
        for key, counts in freq.items():
            specs[key] = optimize_table(counts)

    tables = {k: derive_table(s) for k, s in specs.items()}
    if params.entropy_backend == "jax":
        from .device import resolve
        from .entropy.encode_cuda import pack_scan_device

        segments = pack_scan_device(
            planes, geom, info, tables, params.restart_interval,
            resolve(device),
        )
    elif params.entropy_backend == "native":
        from . import native
        from .entropy.encode_cuda import visit_zz_and_tables

        if not native.available():
            if symbols is None:
                symbols = symbolize_scan(
                    planes, geom, info, params.restart_interval
                )
            segments = pack_scan(symbols, tables, params.restart_interval)
        else:
            zz, dct, act, seg_of, ehufco, ehufsi = visit_zz_and_tables(
                planes, geom, info, tables, params.restart_interval
            )
            n_seg = int(seg_of.max()) + 1
            sbo = np.searchsorted(seg_of, np.arange(n_seg + 1)).astype(np.int64)
            segments = native.encode_segments_native(
                zz, dct, act, sbo, ehufco, ehufsi
            )
    else:
        segments = pack_scan(symbols, tables, params.restart_interval)

    out = bytearray()
    out += emit.emit_soi()
    out += emit.emit_dqt(qtables[0], 0)
    if geom.nf > 1:
        out += emit.emit_dqt(qtables[1], 1)
    out += emit.emit_sof0(geom)
    out += emit.emit_dht(specs[(0, 0)], 0, 0)
    out += emit.emit_dht(specs[(1, 0)], 1, 0)
    if geom.nf > 1:
        out += emit.emit_dht(specs[(0, 1)], 0, 1)
        out += emit.emit_dht(specs[(1, 1)], 1, 1)
    if params.restart_interval:
        out += emit.emit_dri(params.restart_interval)
    out += emit.emit_sos(info)
    out += emit.emit_scan_body(segments)
    out += emit.emit_eoi()
    return bytes(out)


def encode_jpeg(pnm_bytes: bytes, params: Optional[EncodeParams],
                device) -> bytes:
    """Full encode: PNM bytes -> JPEG bytes (process_stream analog), the
    dense stage on ``device``."""
    import torch

    from .device import resolve
    from .models.pipeline import encode_frame

    params = params or EncodeParams()
    dev = resolve(device)

    # Peek header to learn geometry, then re-read with MCU padding.
    probe = read_pnm(pnm_bytes)
    geom = geometry_for_image(probe, params)
    img = read_pnm(pnm_bytes, pad_to=(8 * geom.max_v, 8 * geom.max_h))

    qtables = np.ones((4, 64), dtype=np.uint16)
    qtables[0] = scale_qtable(STD_LUMINANCE_QUANT, params.quality)
    qtables[1] = scale_qtable(STD_CHROMINANCE_QUANT, params.quality)

    planes = encode_frame(torch.from_numpy(img.data).to(dev), geom,
                          qtables.astype(np.int32), params.exact)
    planes = {cid: p.cpu().numpy() for cid, p in planes.items()}
    return encode_jpeg_from_planes(planes, geom, qtables, params, dev)
