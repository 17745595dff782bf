"""PPM (P6) / PGM (P5) file I/O (reference frame.c:246-567).

Reading returns the payload as a float32 interleaved raster padded to the
MCU-aligned size with edge replication (right edge then bottom rows,
frame.c:277-350), exactly the layout the encoder prologue consumes.
Writing rounds with C ``roundf`` (ties away from zero), clamps to
[0, maxval] and emits 16-bit samples big-endian (frame.c:352-405).
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

from ..errors import FileIOError, UnsupportedError


@dataclass
class PnmImage:
    """Decoded PNM payload.

    data: float32 [size_y, size_x, components] (padded, interleaved)
    width/height: true image dims; size_x/size_y: padded dims
    precision: floor(log2(maxval)) + 1 (frame.c:259-275)
    """

    data: np.ndarray
    width: int
    height: int
    components: int
    precision: int

    @property
    def maxval(self) -> int:
        return (1 << self.precision) - 1


def _skip_comments(buf: io.BytesIO) -> None:
    """Skip '#'-to-EOL comments (frame.c:431-446)."""
    while True:
        c = buf.read(1)
        if c == b"#":
            while True:
                c2 = buf.read(1)
                if c2 in (b"", b"\n"):
                    break
        else:
            if c:
                buf.seek(-1, io.SEEK_CUR)
            return


def _read_token(buf: io.BytesIO) -> bytes:
    """Whitespace-delimited token with comment skipping (fscanf-like)."""
    while True:
        c = buf.read(1)
        if c == b"":
            raise FileIOError("unexpected EOF in PNM header")
        if c.isspace():
            continue
        if c == b"#":
            buf.seek(-1, io.SEEK_CUR)
            _skip_comments(buf)
            continue
        break
    tok = c
    while True:
        c = buf.read(1)
        if c == b"" or c.isspace():
            break
        tok += c
    if c and c.isspace():
        buf.seek(-1, io.SEEK_CUR)
    return tok


def precision_from_maxval(maxval: int) -> int:
    """floor_log2(maxval) + 1 (frame.c:259-275): 255 -> 8, 4095 -> 12."""
    if maxval <= 0:
        raise UnsupportedError("invalid maxval")
    return maxval.bit_length()


def read_pnm(data: bytes, pad_to: tuple[int, int] | None = None) -> PnmImage:
    """Parse a P5/P6 file; pad to ``pad_to = (mcu_h, mcu_w)`` multiples.

    ``pad_to`` gives the (8*max_V, 8*max_H) MCU alignment; None means no
    padding (size == true dims).
    """
    buf = io.BytesIO(data)
    magic = buf.read(2)
    if len(magic) != 2 or magic[0:1] != b"P":
        raise UnsupportedError("not a PNM file")
    if magic[1:2] == b"5":
        components = 1
    elif magic[1:2] == b"6":
        components = 3
    else:
        raise UnsupportedError(f"unsupported PNM magic {magic!r}")

    width = int(_read_token(buf))
    height = int(_read_token(buf))
    maxval = int(_read_token(buf))
    precision = precision_from_maxval(maxval)
    if precision > 16:
        raise UnsupportedError("maxval too large")
    # Exactly one whitespace byte separates header from body (frame.c:509).
    sep = buf.read(1)
    if not sep or not sep.isspace():
        raise UnsupportedError("malformed PNM header terminator")

    sample_size = 1 if maxval <= 0xFF else 2
    body = buf.read(width * height * components * sample_size)
    if len(body) != width * height * components * sample_size:
        raise FileIOError("truncated PNM body")

    dt = np.dtype(">u2") if sample_size == 2 else np.uint8
    raw = np.frombuffer(body, dtype=dt).reshape(height, width, components)
    img = raw.astype(np.float32)

    if pad_to is None:
        size_y, size_x = height, width
    else:
        mcu_h, mcu_w = pad_to
        size_y = -(-height // mcu_h) * mcu_h
        size_x = -(-width // mcu_w) * mcu_w
    if (size_y, size_x) != (height, width):
        # Edge replication: right edge then bottom rows (frame.c:308-345).
        img = np.pad(
            img,
            ((0, size_y - height), (0, size_x - width), (0, 0)),
            mode="edge",
        )

    return PnmImage(
        data=img,
        width=width,
        height=height,
        components=components,
        precision=precision,
    )


def write_pnm(
    data: np.ndarray,
    width: int,
    height: int,
    precision: int,
    components: int | None = None,
) -> bytes:
    """Serialize the (possibly padded) float raster to P5/P6 bytes.

    ``data``: float32 [size_y, size_x, C]; only the top-left
    [height, width] window is written.  4-component frames drop the K
    channel and write P6, like write_frame (frame.c:548-567).
    """
    nf = data.shape[-1]
    if components is None:
        components = 3 if nf >= 3 else 1
    if components not in (1, 3):
        raise UnsupportedError("PNM supports 1 or 3 components")

    maxval = (1 << precision) - 1
    header = (b"P6" if components == 3 else b"P5") + b"\n%d %d\n%d\n" % (
        width,
        height,
        maxval,
    )

    window = np.asarray(data[:height, :width, :components], dtype=np.float32)
    # C roundf: ties away from zero (frame.c:375/385), then int clamp.
    t = np.trunc(window)
    frac = window - t
    rounded = np.where(np.abs(frac) >= 0.5, t + np.copysign(1.0, window), t)
    clamped = np.clip(rounded.astype(np.int32), 0, maxval)

    if maxval <= 0xFF:
        body = clamped.astype(np.uint8).tobytes()
    else:
        body = clamped.astype(">u2").tobytes()
    return header + body
