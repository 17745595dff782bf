"""Motion-JPEG stream utilities.

The reference's MJPEG support is exactly "headerless frames decode with
the implicit Annex-K tables" (common.c:90-99) -- there is no container
parsing.  This module adds the stream-level pieces around that:

  * ``split_stream``: cut a concatenated-JPEG byte stream (the common
    raw .mjpeg layout: SOI..EOI SOI..EOI ...) into frames: one native
    walk (``native/stream_entry.cpp``), or ``_split_stream_py``, the
    JAX package's NumPy walk, where the native library is not available;
  * ``decode_stream``: decode every frame with ``api.decode_jpeg``,
    isolating per-frame failures (``StreamResult``);
  * ``decode_stream_device``: decode a stream into pixels that stay on
    the device;
  * ``warm_stream_device``: one such decode, which builds and loads the
    kernels before a timed run.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from .api import DecodedImage, decode_jpeg
from .errors import FileIOError, JpegError
from .utils.metrics import default_metrics, trace

# RST-less frames above this size take the speculative engine; smaller
# ones decode one lane per frame (the JAX package's threshold,
# jpeg_tpu/mjpeg.py:112).
RSTLESS_DEVICE_MAX_BYTES = 8192


def split_stream(data: bytes) -> List[bytes]:
    """Split concatenated JPEG frames on SOI..EOI boundaries.

    One C++ walk of the stream (``native.split_stream_native``) while the
    native library is available, else ``_split_stream_py``: the same
    rules, the same frames.  ``mjpeg.native_splits`` and
    ``python_splits`` count which walk ran.
    """
    from . import native

    if native.available():
        default_metrics.count("mjpeg.native_splits")
        return [data[s:e] for s, e in native.split_stream_native(data)]
    default_metrics.count("mjpeg.python_splits")
    return _split_stream_py(data)


def _split_stream_py(data: bytes) -> List[bytes]:
    """``split_stream``'s NumPy walk (the JAX package's).

    Marker-aware: length-prefixed segment payloads are skipped, so an
    EXIF/APPn-embedded thumbnail (which contains its own SOI/EOI) cannot
    mis-split the parent frame.  Inside entropy-coded data only stuffed
    0xFF00 and RSTn bytes occur (io.c:277-290), which the candidate mask
    excludes -- so the scan is exact for baseline streams, and a
    vectorized prepass keeps the Python walk at marker granularity.
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.size
    if n < 4:
        return []
    nxt = buf[1:]
    is_marker = (
        (buf[:-1] == 0xFF)
        & (nxt != 0x00)  # stuffed 0xFF inside ECS
        & (nxt != 0xFF)  # fill bytes (io.c:196-214)
        & ~((nxt >= 0xD0) & (nxt <= 0xD7))  # RSTn: ECS continues
    )
    cand = np.nonzero(is_marker)[0]
    frames: List[bytes] = []
    p = 0
    start: Optional[int] = None
    while True:
        ci = int(np.searchsorted(cand, p))
        if ci >= cand.size:
            break
        pos = int(cand[ci])
        m = int(buf[pos + 1])
        if start is None:
            p = pos + 2
            if m == 0xD8:
                start = pos
            continue
        if m == 0xD9:  # EOI
            frames.append(data[start : pos + 2])
            start = None
            p = pos + 2
            continue
        if m in (0xD8, 0x01):  # stray SOI / TEM: no payload
            p = pos + 2
            continue
        if pos + 4 > n:
            break
        seglen = (int(buf[pos + 2]) << 8) | int(buf[pos + 3])
        if seglen < 2:
            p = pos + 2
            continue
        # Skip the payload (this is what hides embedded thumbnails);
        # after SOS the ECS follows and the candidate mask already
        # steps over stuffing and restart markers.
        p = pos + 2 + seglen
    return frames


@dataclass
class StreamResult:
    """Batch decode outcome with per-frame fault isolation."""

    frames: List[Optional[DecodedImage]]
    errors: List[Tuple[int, str]] = field(default_factory=list)

    @property
    def ok_count(self) -> int:
        return sum(f is not None for f in self.frames)


def decode_stream_device(data: bytes, device, chunk: int = 8):
    """Raw MJPEG bytes -> pixel batch [F, H, W, C] on ``device``.

    All frames share one geometry and (implicit or repeated) Huffman
    tables; entropy and dense decode run on the device in ``chunk``-frame
    chunks and the pixels stay there (``DeviceDecoder``: any restart
    layout, and small RST-less frames as one lane each).  RST-less frames
    over ``RSTLESS_DEVICE_MAX_BYTES`` bytes take the speculative engine
    (``decode_stream_rstless`` with the decoder built for frame 0, whose
    header selects the native prep), each chunk down the JAX package's
    ladder (jpeg_tpu/mjpeg.py:112-135): the chunk as one batch; if the engine
    refuses it, one frame at a time; a frame it refuses too decodes with
    ``decode_jpeg(exact=False)`` (entropy on the host, dense stage on
    ``device``), its pixels uploaded and counted in
    ``mjpeg.rstless_host_frames``.  Raises on malformed streams -- use
    ``decode_stream`` when per-frame fault isolation matters more than
    throughput.  The call is one ``device_decode.stream`` span, holding
    ``device_decode.split`` (``split_stream``) and
    ``device_decode.for_stream``.
    """
    from .models.device_decode import (
        DeviceDecoder,
        _host_pixels,
        decode_frame_rstless,
        decode_stream_rstless,
    )

    with trace("device_decode.stream"):
        with trace("device_decode.split"):
            parts = split_stream(data)
        if not parts:
            raise FileIOError("no JPEG frames in stream")
        with trace("device_decode.for_stream"):
            dec = DeviceDecoder.for_stream(parts[0], device)
        if dec.segs_per_frame > 1 or \
                len(parts[0]) <= RSTLESS_DEVICE_MAX_BYTES:
            return dec.decode_batch(parts, chunk=chunk)
        step = chunk if chunk > 0 else len(parts)
        outs = []
        for lo in range(0, len(parts), step):
            batch = parts[lo : lo + step]
            try:
                outs.append(decode_stream_rstless(batch, dec.device,
                                                  chunk=step, dec=dec))
                continue
            except JpegError:
                default_metrics.count("mjpeg.rstless_batch_fallbacks")
            for p in batch:
                try:
                    outs.append(decode_frame_rstless(p, dec.device)[None])
                except JpegError:
                    default_metrics.count("mjpeg.rstless_host_frames")
                    outs.append(_host_pixels(p, dec.geom, dec.device)[None])
        return outs[0] if len(outs) == 1 else torch.cat(outs)


def warm_stream_device(data: bytes, device, chunk: int = 8,
                       max_rounds: int = 4, budget_s: Optional[float] = None):
    """Warm what ``decode_stream_device(data, device)`` uses; -> its output.

    The JAX engine learns step bounds that are static arguments of its
    programs, so its warm-up loops until they stop changing
    (``max_rounds`` passes at most, ``budget_s`` seconds at most).  The
    port learns nothing and compiles nothing per shape: one decode builds
    and loads the kernels, so the loop always stops after its first pass.
    The two bounds are kept for the JAX signature.
    """
    return decode_stream_device(data, device, chunk=chunk)


def decode_stream(
    data: bytes, device, exact: bool = False, entropy: str = "auto"
) -> StreamResult:
    """Decode every frame of a raw MJPEG byte stream (dense stage on
    ``device``); isolate failures."""
    parts = split_stream(data)
    out: List[Optional[DecodedImage]] = []
    errors: List[Tuple[int, str]] = []
    for i, frame in enumerate(parts):
        try:
            out.append(decode_jpeg(frame, device, exact=exact,
                                   entropy=entropy))
        except JpegError as e:
            out.append(None)
            errors.append((i, f"{type(e).__name__}: {e}"))
    return StreamResult(frames=out, errors=errors)
