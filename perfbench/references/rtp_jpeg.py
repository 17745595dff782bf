"""Plain reference for the RFC 2435 (RTP/JPEG) configurations.

Baseline sequential JPEG (ITU-T T.81) with the Annex K tables, written
from the standard and nothing else: NumPy and plain PyTorch only.  It
imports neither ``jax`` nor ``jpeg_tpu`` nor anything of the program
under test, and it takes nothing the program made.

- ``forward``: RGB frames -> quantized 8x8 blocks per component (colour
  conversion, edge padding to whole MCUs, box downsampling, level shift,
  FDCT as one [64, 64] product, division and rounding half away from
  zero).  ``torch.float64`` on the host makes the corpus; ``float32``
  with TF32 off is the encode cell's reference.
- ``inverse``: quantized blocks -> RGB uint8 pixels (dequantization,
  IDCT as one [64, 64] product, level shift, nearest-neighbour chroma
  upsampling, colour conversion, rounding half away from zero, clamp).
- ``encode_frame``: quantized blocks -> a JPEG frame with DQT, SOF0, DHT,
  DRI (restart interval > 0) and SOS, vectorized over the frame.
- ``split_frame`` / ``header_problems`` / ``decode_segment``: read a
  frame back, to judge an encoder's output segment by segment.

Every product and sum runs in the dtype asked for.  ``tf32=True`` runs
the DCT products with TF32 operands (the tensor cores' format on the
card, emulated by rounding on the host): the control that a correct
float32 path must beat.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# T.81 Figure A.6: ZIGZAG[k] is the raster index of the k-th coefficient.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int64)

# T.81 Tables K.1 and K.2, raster order.
K1_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int64)
K2_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32, dtype=np.int64)

# T.81 Tables K.3-K.6 in DHT form: (codes of each length 1..16, values).
DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             tuple(range(12)))
AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), (
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA))
AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119), (
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA))
# (class, id) -> spec; class 0 DC, 1 AC; id 0 luma, 1 chroma.
HUFFMAN = {(0, 0): DC_LUMA, (0, 1): DC_CHROMA,
           (1, 0): AC_LUMA, (1, 1): AC_CHROMA}

# Bit length of |v| for |v| < 2**16 (T.81 F.1.2.1: the magnitude category).
_SIZE = np.zeros(1 << 16, np.int64)
for _b in range(1, 17):
    _SIZE[1 << (_b - 1): 1 << _b] = _b


def qtable(std: np.ndarray, quality: int) -> np.ndarray:
    """The libjpeg scaling of an Annex K table that RFC 2435 §4.2 names
    for Q 1..99: ``clamp((std * s + 50) // 100, 1, 255)``."""
    q = min(max(int(quality), 1), 100)
    s = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((std * s + 50) // 100, 1, 255).astype(np.int64)


def qtables(quality: int) -> np.ndarray:
    """[2, 64] raster-order tables: luma, chroma."""
    return np.stack([qtable(K1_LUMA, quality), qtable(K2_CHROMA, quality)])


def code_table(spec) -> Tuple[np.ndarray, np.ndarray]:
    """T.81 Annex C: (code[256], length[256]) of a DHT spec; length 0
    where a value has no code."""
    counts, values = spec
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    c, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code[values[k]], size[values[k]] = c, length
            c, k = c + 1, k + 1
        c <<= 1
    return code, size


@dataclass(frozen=True)
class Geometry:
    """A three-component frame whose luma is sampled ``h`` x ``v`` times
    the chroma (4:2:0 is 2 x 2)."""

    width: int
    height: int
    h: int = 2
    v: int = 2

    @property
    def m_x(self) -> int:
        return -(-self.width // (8 * self.h))

    @property
    def m_y(self) -> int:
        return -(-self.height // (8 * self.v))

    @property
    def n_mcus(self) -> int:
        return self.m_x * self.m_y

    @property
    def bpm(self) -> int:
        return self.h * self.v + 2

    def blocks(self, comp: int) -> Tuple[int, int]:
        """(block rows, block columns) of component ``comp``."""
        if comp == 0:
            return self.m_y * self.v, self.m_x * self.h
        return self.m_y, self.m_x

    def segments(self, ri: int) -> int:
        return -(-self.n_mcus // ri) if ri else 1


def geometry_of(config: dict) -> Geometry:
    h, v = {"4:2:0": (2, 2), "4:2:2": (2, 1), "4:4:4": (1, 1)}[
        config["sampling"]]
    return Geometry(int(config["width"]), int(config["height"]), h, v)


# --------------------------------------------------------------------------
# Dense stages (torch, any device).
# --------------------------------------------------------------------------

def dct_basis() -> np.ndarray:
    """A[x, u] = C(u) / 2 * cos((2x + 1) u pi / 16), float64 (T.81 A.3.3)."""
    x = np.arange(8)[:, None]
    u = np.arange(8)[None, :]
    c = np.where(u == 0, 1 / np.sqrt(2.0), 1.0)
    return 0.5 * c * np.cos((2 * x + 1) * u * np.pi / 16)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits), nearest
    even: what the tensor cores read."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(tf32: bool):
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _product(x: torch.Tensor, m: torch.Tensor, tf32: bool) -> torch.Tensor:
    """``x @ m``: float32 or float64 in full precision, or with TF32
    operands (on the card by the tensor cores, on the host by rounding)."""
    if tf32 and x.device.type != "cuda":
        x, m = _tf32(x), _tf32(m)
    with _matmul_precision(tf32 and x.device.type == "cuda"):
        return x @ m


def roundf(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (C ``roundf``)."""
    t = torch.trunc(x)
    return torch.where((x - t).abs() >= 0.5, t + torch.sign(x), t)


def forward(rgb: torch.Tensor, quality: int, geom: Geometry,
            dtype=torch.float32, tf32: bool = False) -> List[torch.Tensor]:
    """[N, H, W, 3] uint8 RGB -> per component [N, rows, cols, 64] int32
    quantized blocks in raster order.

    Pixels are padded to whole MCUs by repeating the last row and
    column; colour conversion covers the true frame only, so the padding
    keeps its RGB values as Y, Cb and Cr (the reference codec's
    convention that the program follows).  Chroma is the mean of each
    ``v`` x ``h`` box, added row by row from zero.
    """
    if tf32 and dtype != torch.float32:
        raise ValueError("TF32 is a float32 control")
    n, H, W, _ = rgb.shape
    dev = rgb.device
    sy, sx = geom.m_y * 8 * geom.v, geom.m_x * 8 * geom.h
    ys = torch.arange(sy, device=dev).clamp(max=H - 1)
    xs = torch.arange(sx, device=dev).clamp(max=W - 1)
    x = rgb.index_select(1, ys).index_select(2, xs).to(dtype)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.1687 * r - 0.3313 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.4187 * g - 0.0813 * b + 128.0
    inside = ((torch.arange(sy, device=dev) < H)[:, None]
              & (torch.arange(sx, device=dev) < W)[None, :])
    planes = [torch.where(inside, c, raw) for c, raw in
              ((y, r), (cb, g), (cr, b))]
    basis = torch.from_numpy(np.kron(dct_basis(), dct_basis())).to(dev, dtype)
    qt = torch.from_numpy(qtables(quality)).to(dev, dtype)
    out = []
    for comp, p in enumerate(planes):
        if comp:
            boxes = p.reshape(n, sy // geom.v, geom.v, sx // geom.h, geom.h)
            acc = torch.zeros_like(boxes[:, :, 0, :, 0])
            for dy in range(geom.v):
                for dx in range(geom.h):
                    acc = acc + boxes[:, :, dy, :, dx]
            p = acc / float(geom.v * geom.h)
        rows, cols = geom.blocks(comp)
        blk = (p - 128.0).reshape(n, rows, 8, cols, 8).permute(0, 1, 3, 2, 4)
        coef = _product(blk.reshape(-1, 64), basis, tf32)
        q = qt[0 if comp == 0 else 1]
        out.append(roundf(coef / q).to(torch.int32).reshape(n, rows, cols,
                                                           64))
    return out


def inverse(blocks: Sequence[torch.Tensor], quality: int, geom: Geometry,
            tf32: bool = False) -> torch.Tensor:
    """Per component [N, rows, cols, 64] int raster blocks -> [N, H, W, 3]
    uint8 RGB, in float32 (TF32 operands for the IDCT when asked)."""
    dev = blocks[0].device
    basis = torch.from_numpy(np.kron(dct_basis().T, dct_basis().T)).to(
        dev, torch.float32)
    qt = torch.from_numpy(qtables(quality)).to(dev, torch.int32)
    planes = []
    for comp, blk in enumerate(blocks):
        n, rows, cols, _ = blk.shape
        deq = (blk.to(torch.int32) * qt[0 if comp == 0 else 1]).to(
            torch.float32)
        pix = _product(deq.reshape(-1, 64), basis, tf32) + 128.0
        pix = pix.reshape(n, rows, cols, 8, 8).permute(0, 1, 3, 2, 4)
        pix = pix.reshape(n, rows * 8, cols * 8)
        if comp:
            pix = pix.repeat_interleave(geom.v, 1).repeat_interleave(geom.h, 2)
        planes.append(pix[:, :geom.height, :geom.width])
    y, cb, cr = planes
    cb, cr = cb - 128.0, cr - 128.0
    rgb = (y + 1.402 * cr, y - 0.34414 * cb - 0.71414 * cr, y + 1.772 * cb)
    return torch.stack([roundf(c).clamp(0, 255).to(torch.uint8)
                        for c in rgb], dim=-1)


# --------------------------------------------------------------------------
# Entropy coding (NumPy, host).
# --------------------------------------------------------------------------

def _marker(code: int, payload: bytes) -> bytes:
    return bytes((0xFF, code)) + (len(payload) + 2).to_bytes(2, "big") + \
        payload


def frame_header(geom: Geometry, quality: int, ri: int) -> bytes:
    """SOI, DQT, SOF0, DHT, DRI (when ``ri``) and SOS: the header that
    RFC 2435 §3.1.8 / Appendix B rebuilds for types 0-1 and 64-65."""
    qt = qtables(quality)
    dqt = b"".join(bytes([i]) + bytes(qt[i][ZIGZAG].astype(np.uint8))
                   for i in range(2))
    sof = bytes([8]) + geom.height.to_bytes(2, "big") + \
        geom.width.to_bytes(2, "big") + bytes(
            [3, 1, (geom.h << 4) | geom.v, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = b"".join(bytes([(tc << 4) | th]) + bytes(spec[0]) + bytes(spec[1])
                   for (tc, th), spec in sorted(HUFFMAN.items()))
    out = b"\xff\xd8" + _marker(0xDB, dqt) + _marker(0xC0, sof) + \
        _marker(0xC4, dht)
    if ri:
        out += _marker(0xDD, ri.to_bytes(2, "big"))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return out + _marker(0xDA, sos)


def _bitstream_blocks(planes: Sequence[np.ndarray], geom: Geometry):
    """Per component [rows, cols, 64] raster blocks -> ([B, 64] zig-zag
    blocks in the scan's interleaved order, [B] component, [B] MCU)."""
    y = planes[0][..., ZIGZAG].reshape(geom.m_y, geom.v, geom.m_x, geom.h, 64)
    y = y.transpose(0, 2, 1, 3, 4).reshape(geom.n_mcus, geom.h * geom.v, 64)
    cb = planes[1][..., ZIGZAG].reshape(geom.n_mcus, 1, 64)
    cr = planes[2][..., ZIGZAG].reshape(geom.n_mcus, 1, 64)
    zz = np.concatenate([y, cb, cr], axis=1).reshape(-1, 64).astype(np.int64)
    comp = np.tile(np.array([0] * (geom.h * geom.v) + [1, 2]), geom.n_mcus)
    mcu = np.repeat(np.arange(geom.n_mcus), geom.bpm)
    return zz, comp, mcu


def _amplitude(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, v, v + (1 << size) - 1)


def encode_segments(planes: Sequence[np.ndarray], geom: Geometry,
                    ri: int) -> List[bytes]:
    """Quantized blocks of one frame -> its entropy-coded segments, each
    padded with 1-bits to a byte and byte-stuffed (T.81 F.1.2, F.1.2.3,
    B.1.1.5), one per restart interval."""
    zz, comp, mcu = _bitstream_blocks(planes, geom)
    nb = zz.shape[0]
    seg = mcu // ri if ri else np.zeros(nb, np.int64)
    tab = (comp > 0).astype(np.int64)
    dcc = np.stack([code_table(HUFFMAN[(0, t)]) for t in (0, 1)])  # [2,2,256]
    acc = np.stack([code_table(HUFFMAN[(1, t)]) for t in (0, 1)])

    # DC: differences to the previous block of the component in the
    # same restart interval.
    diff = np.empty(nb, np.int64)
    for c in range(3):
        idx = np.flatnonzero(comp == c)
        dc = zz[idx, 0]
        prev = np.concatenate(([0], dc[:-1]))
        first = np.concatenate(([True], seg[idx][1:] != seg[idx][:-1]))
        diff[idx] = dc - np.where(first, 0, prev)
    dsz = _SIZE[np.abs(diff)]
    if dsz.max(initial=0) > 11:
        raise ValueError("a DC difference is out of the baseline range")
    coded = [dcc[tab, 1, dsz]]
    vals = [(dcc[tab, 0, dsz] << dsz) | _amplitude(diff, dsz)]
    lens = [dcc[tab, 1, dsz] + dsz]
    keys = [np.arange(nb) * 256]

    # AC: run/size symbols, ZRL for runs of 16 zeros, EOB.
    b, k = np.nonzero(zz[:, 1:])
    v = zz[b, k + 1]
    prevk = np.concatenate(([-1], k[:-1]))
    prevk[np.concatenate(([True], b[1:] != b[:-1]))] = -1
    run = k - prevk - 1
    asz = _SIZE[np.abs(v)]
    if asz.max(initial=0) > 10:
        raise ValueError("an AC coefficient is out of the baseline range")
    sym = ((run & 15) << 4) | asz
    coded.append(acc[tab[b], 1, sym])
    vals.append((acc[tab[b], 0, sym] << asz) | _amplitude(v, asz))
    lens.append(acc[tab[b], 1, sym] + asz)
    keys.append(b * 256 + 2 + 2 * k)
    nzrl = run >> 4
    zb = np.repeat(b, nzrl)
    vals.append(acc[tab[zb], 0, 0xF0])
    lens.append(acc[tab[zb], 1, 0xF0])
    keys.append(zb * 256 + 1 + 2 * np.repeat(k, nzrl))
    last = np.full(nb, -1, np.int64)
    np.maximum.at(last, b, k)
    eob = np.flatnonzero(last < 62)
    vals.append(acc[tab[eob], 0, 0x00])
    lens.append(acc[tab[eob], 1, 0x00])
    keys.append(eob * 256 + 200)

    if any((c == 0).any() for c in coded):
        raise ValueError("a symbol has no code in the Annex K tables")
    val, ln, key = (np.concatenate(a) for a in (vals, lens, keys))
    # 1-bit padding closes each segment on a byte.
    nseg = int(seg.max()) + 1
    seg_bits = np.bincount(seg[key // 256], weights=ln, minlength=nseg)
    pad = (-seg_bits.astype(np.int64)) % 8
    last_block = np.flatnonzero(np.concatenate((seg[1:] != seg[:-1], [True])))
    val = np.concatenate((val, (1 << pad) - 1))
    ln = np.concatenate((ln, pad))
    key = np.concatenate((key, last_block * 256 + 255))
    order = np.argsort(key, kind="stable")
    val, ln = val[order], ln[order]

    total = int(ln.sum())
    start = np.cumsum(ln) - ln
    item = np.repeat(np.arange(ln.size), ln)
    shift = ln[item] - 1 - (np.arange(total) - start[item])
    data = np.packbits(((val[item] >> shift) & 1).astype(np.uint8))

    ends = np.cumsum((seg_bits.astype(np.int64) + pad) // 8)
    ff = data == 0xFF
    stuffed = np.zeros(data.size + int(ff.sum()), np.uint8)
    stuffed[np.arange(data.size) + np.cumsum(ff) - ff] = data
    ffcum = np.concatenate(([0], np.cumsum(ff)))
    s_end = ends + ffcum[ends]
    s_start = np.concatenate(([0], s_end[:-1]))
    raw = stuffed.tobytes()
    return [raw[s:e] for s, e in zip(s_start.tolist(), s_end.tolist())]


def join_frame(header: bytes, segments: Sequence[bytes]) -> bytes:
    """Header, the segments with RSTm between them, EOI."""
    parts = [header]
    for m, s in enumerate(segments):
        if m:
            parts.append(bytes((0xFF, 0xD0 + ((m - 1) & 7))))
        parts.append(s)
    parts.append(b"\xff\xd9")
    return b"".join(parts)


def encode_frame(planes: Sequence[np.ndarray], geom: Geometry, quality: int,
                 ri: int) -> bytes:
    """Quantized blocks of one frame -> the whole JPEG frame."""
    return join_frame(frame_header(geom, quality, ri),
                      encode_segments(planes, geom, ri))


# --------------------------------------------------------------------------
# Reading a frame back.
# --------------------------------------------------------------------------

def split_frame(data: bytes) -> Tuple[Dict[int, List[bytes]], List[bytes],
                                      Optional[str]]:
    """-> (marker payloads before the scan by marker code, the scan's
    stuffed segments, a problem or None).  The scan ends at EOI; RSTm
    must count 0..7 in turn."""
    buf = np.frombuffer(data, np.uint8)
    if buf.size < 4 or buf[0] != 0xFF or buf[1] != 0xD8:
        return {}, [], "no SOI"
    markers: Dict[int, List[bytes]] = {}
    p = 2
    while True:
        if p + 4 > buf.size or buf[p] != 0xFF:
            return markers, [], f"no marker at byte {p}"
        code = int(buf[p + 1])
        n = (int(buf[p + 2]) << 8) | int(buf[p + 3])
        markers.setdefault(code, []).append(data[p + 4:p + 2 + n])
        p += 2 + n
        if code == 0xDA:
            break
    ecs = buf[p:]
    at = np.flatnonzero((ecs[:-1] == 0xFF) & (ecs[1:] != 0x00))
    segments, s = [], 0
    for m, pos in enumerate(at.tolist()):
        code = int(ecs[pos + 1])
        segments.append(data[p + s:p + pos])
        s = pos + 2
        if code == 0xD9:
            if p + s != len(data):
                return markers, segments, "bytes after EOI"
            return markers, segments, None
        if code != 0xD0 + (m & 7):
            return markers, segments, f"marker {code:#x} inside the scan"
    return markers, segments, "no EOI"


def header_problems(markers: Dict[int, List[bytes]], geom: Geometry,
                    quality: int, ri: int) -> List[str]:
    """What in a frame's markers departs from the configuration: size,
    sampling, quantization tables, Huffman tables (absent means the
    implicit Annex K ones), restart interval and scan components."""
    bad = []
    sof = markers.get(0xC0, [])
    if len(sof) != 1 or sof[0] != bytes([8]) + geom.height.to_bytes(
            2, "big") + geom.width.to_bytes(2, "big") + bytes(
            [3, 1, (geom.h << 4) | geom.v, 0, 2, 0x11, 1, 3, 0x11, 1]):
        bad.append("SOF0")
    qt = qtables(quality)
    got_q = {}
    for payload in markers.get(0xDB, []):
        i = 0
        while i < len(payload):
            pq, tq = payload[i] >> 4, payload[i] & 15
            n = 128 if pq else 64
            got_q[tq] = (pq, payload[i + 1:i + 1 + n])
            i += 1 + n
    for t in (0, 1):
        if got_q.get(t) != (0, bytes(qt[t][ZIGZAG].astype(np.uint8))):
            bad.append(f"DQT {t}")
    for payload in markers.get(0xC4, []):
        i = 0
        while i < len(payload):
            tc, th = payload[i] >> 4, payload[i] & 15
            counts = tuple(payload[i + 1:i + 17])
            vals = tuple(payload[i + 17:i + 17 + sum(counts)])
            if HUFFMAN.get((tc, th)) != (counts, vals):
                bad.append(f"DHT {tc},{th}")
            i += 17 + sum(counts)
    dri = markers.get(0xDD, [])
    got_ri = int.from_bytes(dri[-1], "big") if dri else 0
    if got_ri != ri:
        bad.append(f"DRI {got_ri}")
    if markers.get(0xDA) != [bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])]:
        bad.append("SOS")
    return bad


def decode_segment(segment: bytes, geom: Geometry, mcus: int) -> np.ndarray:
    """One stuffed segment of ``mcus`` MCUs -> [mcus * bpm, 64] zig-zag
    blocks, DC undifferenced from 0 at the segment's start (T.81 F.2).
    Raises ``ValueError`` on a code the tables lack or a short segment."""
    data = segment.replace(b"\xff\x00", b"\xff")
    bits = np.unpackbits(np.frombuffer(data, np.uint8)).tolist()
    lookup = {}
    for key, spec in HUFFMAN.items():
        code, size = code_table(spec)
        lookup[key] = {(int(size[s]), int(code[s])): s
                       for s in range(256) if size[s]}
    pos = [0]

    def take(n: int) -> int:
        if pos[0] + n > len(bits):
            raise ValueError("segment ends inside a code")
        v = 0
        for bit in bits[pos[0]:pos[0] + n]:
            v = (v << 1) | bit
        pos[0] += n
        return v

    def symbol(table) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | take(1)
            s = table.get((length, code))
            if s is not None:
                return s
        raise ValueError("no such Huffman code")

    def extend(v: int, size: int) -> int:
        return v if size == 0 or v >= 1 << (size - 1) else v - (1 << size) + 1

    out = np.zeros((mcus * geom.bpm, 64), np.int64)
    pred = [0, 0, 0]
    comps = [0] * (geom.h * geom.v) + [1, 2]
    for i in range(mcus * geom.bpm):
        c = comps[i % geom.bpm]
        t = 1 if c else 0
        size = symbol(lookup[(0, t)])
        pred[c] += extend(take(size), size)
        out[i, 0] = pred[c]
        k = 1
        while k < 64:
            rs = symbol(lookup[(1, t)])
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r != 15:
                    break
                k += 16
                continue
            k += r
            if k > 63:
                raise ValueError("run past the block's end")
            out[i, k] = extend(take(s), s)
            k += 1
    return out
