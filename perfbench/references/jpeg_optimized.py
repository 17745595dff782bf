"""Plain reference for frames with per-image optimal Huffman tables.

Baseline sequential JPEG (ITU-T T.81) in which each frame carries the
Huffman tables made optimal for its own symbols (Annex K.2), as IJG
libjpeg's ``cjpeg -optimize`` writes a file.  Written from the standard,
NumPy and plain PyTorch only: it imports neither ``jax`` nor
``jpeg_tpu`` nor anything of the program under test, and takes nothing
the program made.  TF32 is off for every product it runs.

From ``rtp_jpeg.py`` (the RFC 2435 reference) it takes the dense
stages, ``forward`` and ``inverse``, the geometry and the reading of a
frame into markers and segments, ``split_frame``.  Its own:

- ``symbols`` / ``histogram``: a frame's coded symbols (T.81 F.1.2: the
  DC size category of each difference, per nonzero AC its ZRLs and its
  (run, size) symbol, EOB unless position 63 is nonzero) and their
  counts per table;
- ``optimal_table`` / ``optimal_tables``: Annex K.2 from Figures K.1-K.4
  (code sizes with the reserved point, BITS adjusted to 16 bits, HUFFVAL
  sorted).  T.81 leaves ties between equal counts open; this takes the
  larger symbol value, as libjpeg's ``jpeg_gen_optimal_table`` does;
- ``encode_segments`` / ``frame_header`` / ``encode_frame``: a frame
  coded with its own tables, whose header carries them as four DHT
  segments (DC then AC, luma then chroma, cjpeg's order);
- ``header_problems``: what in a frame's markers departs from the
  configuration, with the frame's own DHT read and checked, not compared
  with a fixed table -> (problems, the frame's tables);
- ``decode_segments``: every segment of a frame decoded with the frame's
  tables at once, the segments walked in lockstep (one symbol a segment a
  step, T.81 F.2.2), with the counts of the symbols read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench.cell import load_module

_rtp = load_module(Path(__file__).with_name("rtp_jpeg.py"))

Geometry = _rtp.Geometry
geometry_of = _rtp.geometry_of
forward = _rtp.forward
inverse = _rtp.inverse
qtables = _rtp.qtables
split_frame = _rtp.split_frame
join_frame = _rtp.join_frame
ZIGZAG = _rtp.ZIGZAG

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Tables by index t = 2 * class + id: DC luma, DC chroma, AC luma, AC
# chroma; (class, id) = divmod(t, 2).
TABLES = ((0, 0), (0, 1), (1, 0), (1, 1))
# The order of the DHT segments in a header (libjpeg writes each scan
# component's DC table, then its AC table).
DHT_ORDER = ((0, 0), (1, 0), (0, 1), (1, 1))
_SIZE = _rtp._SIZE


# --------------------------------------------------------------------------
# Symbols and their counts.
# --------------------------------------------------------------------------

def symbols(planes: Sequence[np.ndarray], geom, ri: int) -> Dict[str,
                                                                  np.ndarray]:
    """The coded items of a frame's quantized blocks (per component
    [rows, cols, 64] raster order), in no particular order, each with
    ``table`` (index into ``TABLES``), ``symbol``, ``amp`` (the appended
    bits) and ``amp_size``, and ``key``, whose sort is the bitstream
    order, and ``segment``, the restart interval of its block."""
    zz, comp, mcu = _rtp._bitstream_blocks(planes, geom)
    nb = zz.shape[0]
    seg = mcu // ri if ri else np.zeros(nb, np.int64)
    chroma = (comp > 0).astype(np.int64)
    # DC: the difference to the previous block of the component in the
    # same restart interval.
    diff = np.empty(nb, np.int64)
    for c in range(3):
        idx = np.flatnonzero(comp == c)
        dc = zz[idx, 0]
        prev = np.concatenate(([0], dc[:-1]))
        first = np.concatenate(([True], seg[idx][1:] != seg[idx][:-1]))
        diff[idx] = dc - np.where(first, 0, prev)
    dsz = _SIZE[np.abs(diff)]
    tab, sym, amp, asz, key = ([chroma], [dsz], [_amplitude(diff, dsz)],
                               [dsz], [np.arange(nb) * 256])
    # AC: (run, size) of each nonzero, a ZRL for each 16 zeros before it.
    b, k = np.nonzero(zz[:, 1:])
    v = zz[b, k + 1]
    prevk = np.concatenate(([-1], k[:-1]))
    prevk[np.concatenate(([True], b[1:] != b[:-1]))] = -1
    run = k - prevk - 1
    vsz = _SIZE[np.abs(v)]
    tab.append(2 + chroma[b])
    sym.append(((run & 15) << 4) | vsz)
    amp.append(_amplitude(v, vsz))
    asz.append(vsz)
    key.append(b * 256 + 2 + 2 * k)
    nzrl = run >> 4
    zb = np.repeat(b, nzrl)
    # The z-th ZRL before position k sorts before the nonzero's item.
    zk = np.repeat(k, nzrl)
    tab.append(2 + chroma[zb])
    sym.append(np.full(zb.size, 0xF0, np.int64))
    amp.append(np.zeros(zb.size, np.int64))
    asz.append(np.zeros(zb.size, np.int64))
    key.append(zb * 256 + 1 + 2 * zk)
    last = np.full(nb, -1, np.int64)
    np.maximum.at(last, b, k)
    eob = np.flatnonzero(last < 62)
    tab.append(2 + chroma[eob])
    sym.append(np.zeros(eob.size, np.int64))
    amp.append(np.zeros(eob.size, np.int64))
    asz.append(np.zeros(eob.size, np.int64))
    key.append(eob * 256 + 200)
    out = {name: np.concatenate(parts) for name, parts in (
        ("table", tab), ("symbol", sym), ("amp", amp), ("amp_size", asz),
        ("key", key))}
    out["segment"] = seg[out["key"] // 256]
    return out


def _amplitude(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, v, v + (1 << size) - 1)


def histogram(items: Dict[str, np.ndarray]) -> np.ndarray:
    """[4, 256] counts of each table's symbols."""
    return np.bincount(items["table"] * 256 + items["symbol"],
                       minlength=4 * 256).reshape(4, 256)


# --------------------------------------------------------------------------
# Annex K.2: optimal tables.
# --------------------------------------------------------------------------

def _least(freq: np.ndarray, skip: int = -1) -> int:
    """The value of the least nonzero count (the larger value on a tie),
    ``skip`` left out; -1 if none."""
    live = freq > 0
    if skip >= 0:
        live[skip] = False
    if not live.any():
        return -1
    return int(np.flatnonzero(live & (freq == freq[live].min()))[-1])


def optimal_table(counts: np.ndarray) -> Tuple[Tuple[int, ...],
                                               Tuple[int, ...]]:
    """Symbol counts [256] -> (BITS: codes of each length 1..16, HUFFVAL)
    by T.81 Annex K.2.  Raises ``ValueError`` for no symbol or a code
    size past 32 bits."""
    # Figure K.1: code sizes.  FREQ(256) = 1 reserves one code point, so
    # no code is all 1-bits.
    freq = np.append(np.asarray(counts, np.int64), 1)
    codesize = np.zeros(257, np.int64)
    others = np.full(257, -1, np.int64)
    while True:
        v1 = _least(freq)
        v2 = _least(freq, v1)
        if v2 < 0:
            break
        freq[v1] += freq[v2]
        freq[v2] = 0
        while True:
            codesize[v1] += 1
            if others[v1] < 0:
                break
            v1 = int(others[v1])
        others[v1] = v2
        while True:
            codesize[v2] += 1
            if others[v2] < 0:
                break
            v2 = int(others[v2])
    if codesize.max() > 32:
        raise ValueError("a code size past 32 bits")
    # Figure K.2: the number of codes of each size.
    bits = np.bincount(codesize[codesize > 0], minlength=33)
    # Figure K.3: no code longer than 16 bits; then the reserved point's
    # code comes off the longest length.
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    longest = np.flatnonzero(bits[:17])
    if longest.size == 0:
        raise ValueError("no symbol has a count")
    bits[longest[-1]] -= 1
    # Figure K.4: the values by code size, then by value.
    values = [v for size in range(1, 33) for v in range(256)
              if codesize[v] == size]
    return tuple(int(b) for b in bits[1:17]), tuple(values)


def optimal_tables(hist: np.ndarray) -> Dict[Tuple[int, int], tuple]:
    """[4, 256] counts -> {(class, id): (BITS, HUFFVAL)}."""
    return {key: optimal_table(hist[t]) for t, key in enumerate(TABLES)}


def code_lut(spec) -> Tuple[np.ndarray, np.ndarray]:
    """T.81 Annex C of a (BITS, HUFFVAL) table: (code [256], length
    [256]), length 0 where a value has no code."""
    return _rtp.code_table(spec)


# --------------------------------------------------------------------------
# Encoding with a frame's own tables.
# --------------------------------------------------------------------------

def encode_segments(planes: Sequence[np.ndarray], geom, ri: int,
                    tables: Dict[Tuple[int, int], tuple]) -> List[bytes]:
    """Quantized blocks of one frame -> its stuffed segments, coded with
    ``tables`` and padded with 1-bits (T.81 F.1.2.3, B.1.1.5)."""
    items = symbols(planes, geom, ri)
    codes = np.stack([code_lut(tables[key]) for key in TABLES])  # [4,2,256]
    code = codes[items["table"], 0, items["symbol"]]
    size = codes[items["table"], 1, items["symbol"]]
    if (size == 0).any():
        raise ValueError("a symbol has no code in the tables")
    val = (code << items["amp_size"]) | items["amp"]
    ln = size + items["amp_size"]
    seg, key = items["segment"], items["key"]
    nseg = geom.segments(ri)
    seg_bits = np.bincount(seg, weights=ln, minlength=nseg).astype(np.int64)
    pad = (-seg_bits) % 8
    # The pad of segment s sorts after its last item.
    mcus = ri or geom.n_mcus
    last_block = np.minimum((np.arange(nseg) + 1) * mcus,
                            geom.n_mcus) * geom.bpm - 1
    val = np.concatenate((val, (1 << pad) - 1))
    ln = np.concatenate((ln, pad))
    key = np.concatenate((key, last_block * 256 + 255))
    order = np.argsort(key, kind="stable")
    val, ln = val[order], ln[order]
    start = np.cumsum(ln) - ln
    item = np.repeat(np.arange(ln.size), ln)
    shift = ln[item] - 1 - (np.arange(int(ln.sum())) - start[item])
    data = np.packbits(((val[item] >> shift) & 1).astype(np.uint8))
    ends = np.cumsum((seg_bits + pad) // 8)
    starts = np.concatenate(([0], ends[:-1]))
    raw = data.tobytes()
    return [raw[s:e].replace(b"\xff", b"\xff\x00")
            for s, e in zip(starts.tolist(), ends.tolist())]


def _marker(code: int, payload: bytes) -> bytes:
    return bytes((0xFF, code)) + (len(payload) + 2).to_bytes(2, "big") + \
        payload


def frame_header(geom, quality: int, ri: int,
                 tables: Dict[Tuple[int, int], tuple]) -> bytes:
    """SOI, DQT, SOF0, one DHT a table (``DHT_ORDER``), DRI (when ``ri``)
    and SOS."""
    qt = qtables(quality)
    out = b"\xff\xd8" + b"".join(
        _marker(0xDB, bytes([i]) + bytes(qt[i][ZIGZAG].astype(np.uint8)))
        for i in range(2))
    out += _marker(0xC0, bytes([8]) + geom.height.to_bytes(2, "big")
                   + geom.width.to_bytes(2, "big") + bytes(
                       [3, 1, (geom.h << 4) | geom.v, 0, 2, 0x11, 1, 3,
                        0x11, 1]))
    for tc, th in DHT_ORDER:
        counts, values = tables[(tc, th)]
        out += _marker(0xC4, bytes([(tc << 4) | th]) + bytes(counts)
                       + bytes(values))
    if ri:
        out += _marker(0xDD, ri.to_bytes(2, "big"))
    return out + _marker(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                      0]))


def encode_frame(planes: Sequence[np.ndarray], geom, quality: int,
                 ri: int, tables: Optional[dict] = None) -> bytes:
    """Quantized blocks of one frame -> a JPEG frame with the optimal
    tables of its own symbols (or ``tables``)."""
    if tables is None:
        tables = optimal_tables(histogram(symbols(planes, geom, ri)))
    return join_frame(frame_header(geom, quality, ri, tables),
                      encode_segments(planes, geom, ri, tables))


def scan_blocks(planes: Sequence[np.ndarray], geom) -> np.ndarray:
    """[n_mcus * bpm, 64] zig-zag blocks in the scan's order, DC absolute:
    what ``decode_segments`` returns for a frame of these blocks."""
    return _rtp._bitstream_blocks(planes, geom)[0]


# --------------------------------------------------------------------------
# Reading a frame back.
# --------------------------------------------------------------------------

def header_problems(markers: Dict[int, List[bytes]], geom, quality: int,
                    ri: int) -> Tuple[List[str], Dict[Tuple[int, int],
                                                      tuple]]:
    """What in a frame's markers departs from the configuration (size,
    sampling, quantization tables, restart interval, scan components, as
    ``rtp_jpeg.header_problems`` checks them), and whether its DHT
    segments define each of the four tables once, as a code that fits
    (T.81 Annex C) -> (problems, the frame's tables)."""
    bad = [p for p in _rtp.header_problems(markers, geom, quality, ri)
           if not p.startswith("DHT")]
    got: Dict[Tuple[int, int], tuple] = {}
    for payload in markers.get(0xC4, []):
        i = 0
        while i < len(payload):
            if i + 17 > len(payload):
                bad.append("DHT length")
                break
            tc, th = payload[i] >> 4, payload[i] & 15
            counts = tuple(payload[i + 1:i + 17])
            values = tuple(payload[i + 17:i + 17 + sum(counts)])
            if len(values) != sum(counts):
                bad.append("DHT length")
            elif (tc, th) not in TABLES or (tc, th) in got:
                bad.append(f"DHT {tc},{th}")
            elif not _fits(counts):
                bad.append(f"DHT {tc},{th} codes")
            else:
                got[(tc, th)] = (counts, values)
            i += 17 + sum(counts)
    bad += [f"DHT {tc},{th} missing" for tc, th in TABLES
            if (tc, th) not in got]
    return bad, got


def _fits(counts: Sequence[int]) -> bool:
    """Whether codes of these lengths exist with none all 1-bits."""
    code = 0
    for n in counts:
        code = (code + n) << 1
    return 0 < code <= (1 << 17) - 2


def _lut(tables: Dict[Tuple[int, int], tuple]) -> np.ndarray:
    """[4, 65536]: for each 16-bit window, symbol << 8 | code length of
    the code it starts with, 0 where none does."""
    lut = np.zeros((4, 1 << 16), np.int64)
    for t, key in enumerate(TABLES):
        counts, values = tables[key]
        code, k = 0, 0
        for length, n in enumerate(counts, start=1):
            for _ in range(n):
                lo = code << (16 - length)
                lut[t, lo:lo + (1 << (16 - length))] = \
                    (values[k] << 8) | length
                code, k = code + 1, k + 1
            code <<= 1
    return lut


def decode_segments(segments: Sequence[bytes], geom, ri: int,
                    tables: Dict[Tuple[int, int], tuple]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """A frame's stuffed segments -> ([n_mcus * bpm, 64] zig-zag blocks in
    the scan's order, DC undifferenced from 0 at each segment's start;
    [4, 256] counts of the symbols read).  All segments step together,
    one symbol each a step.  Raises ``ValueError`` on a code the tables
    lack, a segment that ends inside a code, a run past a block's end,
    or more than its 1-bit padding left over in a segment."""
    per = ri or geom.n_mcus
    nseg = len(segments)
    mcus = np.minimum(per, geom.n_mcus - per * np.arange(nseg))
    if nseg != geom.segments(ri) or (mcus <= 0).any():
        raise ValueError(f"{nseg} segments")
    data = [s.replace(b"\xff\x00", b"\xff") for s in segments]
    nbytes = np.array([len(d) for d in data], np.int64)
    buf = np.frombuffer(b"".join(data) + bytes(4), np.uint8).astype(np.int64)
    end = np.cumsum(nbytes) * 8
    pos = end - nbytes * 8
    nblk = mcus * geom.bpm

    def peek(p):  # the 16 bits from bit p
        b = p >> 3
        w = (buf[b] << 16) | (buf[b + 1] << 8) | buf[b + 2]
        return (w >> (8 - (p & 7))) & 0xFFFF

    lut = _lut(tables)
    comp_of = np.array([0] * (geom.h * geom.v) + [1, 2])
    out = np.zeros((nseg, per * geom.bpm, 64), np.int64)
    hist = np.zeros(4 * 256, np.int64)
    pred = np.zeros((nseg, 3), np.int64)
    blk = np.zeros(nseg, np.int64)
    k = np.zeros(nseg, np.int64)
    live = np.flatnonzero(blk < nblk)
    while live.size:
        p, kk, bb = pos[live], k[live], blk[live]
        comp = comp_of[bb % geom.bpm]
        dc = kk == 0
        t = np.where(dc, 0, 2) + (comp > 0)
        e = lut[t, peek(p)]
        if (e == 0).any():
            raise ValueError("a code the tables lack")
        sym = e >> 8
        p = p + (e & 255)
        size = np.where(dc, sym, sym & 15)
        extra = peek(p) >> (16 - size)
        val = np.where(extra >= (1 << np.maximum(size - 1, 0)), extra,
                       extra - (1 << size) + 1)
        val[size == 0] = 0
        p = p + size
        if (p > end[live]).any():
            raise ValueError("a segment ends inside a code")
        pos[live] = p
        hist += np.bincount(t * 256 + sym, minlength=4 * 256)
        # DC: the predictor of the block's component.
        d = live[dc]
        pred[d, comp[dc]] += val[dc]
        out[d, bb[dc], 0] = pred[d, comp[dc]]
        k[d] = 1
        # AC: EOB ends the block, ZRL skips 16 zeros, else a run and a
        # coefficient.
        a = ~dc
        ai, ka, sa, va = live[a], kk[a], sym[a], val[a]
        run, sz = sa >> 4, sa & 15
        coef = sz > 0
        zrl = (sz == 0) & (run == 15)
        kn = ka + np.where(coef, run, 0) + np.where(zrl, 16, 0)
        if (kn[coef | zrl] > 63).any():
            raise ValueError("a run past the block's end")
        out[ai[coef], bb[a][coef], kn[coef]] = va[coef]
        kn = kn + coef
        done = (~coef & ~zrl) | (kn > 63)
        k[ai] = np.where(done, 0, kn)
        blk[ai] += done
        live = np.flatnonzero(blk < nblk)
    rest = end - pos
    if (rest > 7).any():
        raise ValueError("bits left over in a segment")
    ones = (peek(pos) >> (16 - rest)) == (1 << rest) - 1
    if not ones.all():
        raise ValueError("padding that is not 1-bits")
    return (np.concatenate([out[s, :nblk[s]] for s in range(nseg)]),
            hist.reshape(4, 256))
