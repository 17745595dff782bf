"""Motion-JPEG stream utilities.

The reference's MJPEG support is exactly "headerless frames decode with
the implicit Annex-K tables" (common.c:90-99) -- there is no container
parsing.  This module adds the stream-level pieces around that:

  * ``split_stream``: cut a concatenated-JPEG byte stream (the common
    raw .mjpeg layout: SOI..EOI SOI..EOI ...) into frames (copied
    unchanged from the JAX package);
  * ``decode_stream_device``: decode a restart-marker stream into pixels
    that stay on the device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .errors import FileIOError


def split_stream(data: bytes) -> List[bytes]:
    """Split concatenated JPEG frames on SOI..EOI boundaries.

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


def decode_stream_device(data: bytes, device, chunk: int = 8):
    """Raw MJPEG bytes -> pixel batch [F, H, W, C] on ``device``.

    All frames share one geometry and (implicit or repeated) Huffman
    tables; segment and dense decode run on the device in ``chunk``-frame
    chunks and the pixels stay there.  The stream must carry restart
    markers that tile MCU rows evenly; otherwise (RST-less streams
    included) this raises ``UnsupportedError``.  Raises on malformed
    streams.
    """
    from .models.device_decode import DeviceDecoder

    parts = split_stream(data)
    if not parts:
        raise FileIOError("no JPEG frames in stream")
    dec = DeviceDecoder.for_stream(parts[0], device)
    return dec.decode_batch(parts, chunk=chunk)
