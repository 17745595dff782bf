"""Codestream (marker) parsing: bytes -> structured codestream model.

Mirrors the reference's marker state machine (decoder.c:472-659 +
io.c:186-220 read_marker) but separates *parsing* from *decoding*: the
output `Codestream` carries every table/geometry update plus the byte
ranges of each entropy-coded segment, so the entropy stage can decode all
segments in parallel afterwards (the reference interleaves the two).

Scan/table state is snapshotted per scan: JPEG allows DHT/DQT between
scans, so each `Scan` records the table versions in force when its SOS
appeared.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..constants import (
    APPN_SKIPPED,
    INV_ZIGZAG,
    M_COM,
    M_DAC,
    M_DHT,
    M_DQT,
    M_DRI,
    M_EOI,
    M_SOF0,
    M_SOF1,
    M_SOF2,
    M_SOF3,
    M_SOF9,
    M_SOF10,
    M_SOI,
    M_SOS,
    M_TEM,
    ZIGZAG,
    is_rst,
)
from ..constants import DEFAULT_HTABLES
from ..errors import CorruptStream, FileIOError, UnsupportedError
from ..geometry import Component, FrameGeometry, ScanInfo, with_block_grid
from ..tables import HuffSpec
from ..utils.metrics import default_metrics


@dataclass
class Scan:
    """One SOS + its entropy-coded segments (split at RST markers)."""

    info: ScanInfo
    # Byte ranges [start, end) into the original buffer, one per ECS
    # (segment boundaries = RST markers; DC predictors reset per segment).
    ecs_ranges: List[Tuple[int, int]] = field(default_factory=list)
    # Huffman specs in force for this scan: {(tc, th): HuffSpec}
    htables: Dict[Tuple[int, int], HuffSpec] = field(default_factory=dict)
    # Restart interval in force (0 = none); informational, decode is
    # marker-driven like the reference (SURVEY §3.4).
    ri: int = 0


@dataclass
class Codestream:
    """Everything parse_format learns before/while scanning ECS data."""

    geometry: Optional[FrameGeometry] = None
    qtables: np.ndarray = field(
        default_factory=lambda: np.ones((4, 64), dtype=np.uint16)
    )
    qtable_precisions: List[int] = field(default_factory=lambda: [0, 0, 0, 0])
    scans: List[Scan] = field(default_factory=list)
    ri: int = 0
    comments: List[bytes] = field(default_factory=list)
    trailing_garbage: int = 0
    adobe_transform: Optional[int] = None  # from APP14, informational
    # Filled by api.decode_coefficients: MCUs actually entropy-decoded per
    # scan (the reference's processed-macroblock report, common.c:174,
    # decoder.c:385).  Empty until a decode runs.
    mcus_decoded: List[int] = field(default_factory=list)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u8(self) -> int:
        if self.pos >= len(self.data):
            raise FileIOError("unexpected EOF")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def u16(self) -> int:
        return (self.u8() << 8) | self.u8()

    def nibbles(self) -> Tuple[int, int]:
        b = self.u8()
        return (b >> 4) & 15, b & 15

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise FileIOError("unexpected EOF")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def skip(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise FileIOError("seek past EOF")
        self.pos += n

    def read_marker(self) -> int:
        """io.c:186-220: skip garbage to 0xFF, skip fills, 0xFF00 restarts."""
        while True:
            # seek to next 0xFF
            while True:
                if self.pos >= len(self.data):
                    raise FileIOError("EOF while seeking marker")
                if self.data[self.pos] == 0xFF:
                    self.pos += 1
                    break
                self.pos += 1
            # consume fill bytes / detect stuffed zero
            restart = False
            while True:
                b = self.u8()
                if b == 0xFF:
                    continue
                if b == 0x00:
                    restart = True  # not a marker: keep seeking
                    break
                return 0xFF00 | b
            if restart:
                continue


class _EcsEndIndex:
    """All ECS-terminator positions, computed once per buffer.

    A terminator is an 0xFF followed by a non-zero byte (the reference's
    read_ecs_byte rule, io.c:247-274), or a trailing lone 0xFF.  One
    vectorized pass + binary search per query keeps many-segment streams
    O(n + S log n) instead of O(n * S).
    """

    def __init__(self, data: bytes):
        buf = np.frombuffer(data, dtype=np.uint8)
        self.n = buf.size
        if buf.size >= 2:
            hits = np.nonzero((buf[:-1] == 0xFF) & (buf[1:] != 0x00))[0]
        else:
            hits = np.zeros(0, dtype=np.int64)
        if buf.size and buf[-1] == 0xFF:
            hits = np.append(hits, buf.size - 1)
        self.hits = hits

    def find(self, start: int) -> int:
        i = np.searchsorted(self.hits, start)
        if i < self.hits.size:
            return int(self.hits[i])
        return self.n


def unstuff(data: bytes) -> np.ndarray:
    """Remove the 0x00 after each 0xFF inside an ECS (io.c:247-274)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size == 0:
        return buf
    # A byte is a stuffing zero iff it's 0x00 preceded by 0xFF.  Inside a
    # well-formed ECS every 0xFF is followed by 0x00, so 0xFF-0x00 pairs
    # can't overlap and a simple predecessor test is exact.
    prev_is_ff = np.concatenate(([False], buf[:-1] == 0xFF))
    drop = (buf == 0x00) & prev_is_ff
    return buf[~drop]


def unstuff_ranges(data: bytes, ranges) -> Tuple[np.ndarray, np.ndarray]:
    """Batch unstuff: one pass over the buffer for ALL ECS ranges.

    Returns (concatenated unstuffed bytes, offsets[S+1]) -- the layout
    the native decode kernel consumes directly.
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    prev_is_ff = np.empty(buf.size, dtype=bool)
    if buf.size:
        prev_is_ff[0] = False
        np.equal(buf[:-1], 0xFF, out=prev_is_ff[1:])
    keep = ~((buf == 0x00) & prev_is_ff)
    kept_before = np.concatenate(([0], np.cumsum(keep)))

    sel = np.zeros(buf.size, dtype=bool)
    offsets = np.zeros(len(ranges) + 1, dtype=np.int64)
    for i, (s, e) in enumerate(ranges):
        sel[s:e] = True
        offsets[i + 1] = offsets[i] + (kept_before[e] - kept_before[s])
    out = buf[sel & keep]
    return out, offsets


def _parse_dqt_segment(r: _Reader, cs: Codestream, seg_len: int) -> None:
    """Multi-table DQT (decoder.c:20-68, loop at 523-526).

    A DO-WHILE like the reference: at least one table parses even when
    the declared length is shorter than a table (the loop condition is
    only checked after each table, so a table may also read PAST the
    declared end -- parsing resumes from the overrun position, not from
    pos+len).  Fuzz-found divergence: a DQT with length 0 still consumes
    one 65/129-byte table."""
    end = r.pos - 2 + seg_len
    first = True
    while first or r.pos < end:
        first = False
        pq, tq = r.nibbles()
        if tq >= 4:
            raise UnsupportedError("invalid DQT Tq")
        if pq >= 2:
            raise UnsupportedError("invalid DQT Pq")
        q = np.ones(64, dtype=np.uint16)
        for i in range(64):
            val = r.u16() if pq else r.u8()
            q[ZIGZAG[i]] = val
        cs.qtables[tq] = q
        cs.qtable_precisions[tq] = pq


def _parse_sof(r: _Reader, cs: Codestream) -> None:
    """SOF0/SOF1 frame header (decoder.c:70-136)."""
    p = r.u8()
    y = r.u16()
    x = r.u16()
    nf = r.u8()
    if x <= 0 or nf <= 0:
        raise UnsupportedError("invalid frame header")
    comps = []
    for _ in range(nf):
        c = r.u8()
        h, v = r.nibbles()
        tq = r.u8()
        if h == 0 or v == 0:
            # T.81 requires H,V in 1..4; the reference never validates.
            # A zero factor puts it in undefined territory: SIGFPE when
            # max_H/max_V end up 0 (ceil_div, common.c:171-172), an
            # INFINITE LOOP for an Ns=1 scan over the 0-block component
            # (read_macroblock consumes nothing, read_ecs never stops),
            # and in some interleaved layouts an accept with NULL
            # component buffers.  No parity is definable (PARITY.md);
            # we count the event and reject cleanly.
            default_metrics.count("serial.reference_ub")
            raise CorruptStream("zero sampling factor")
        if tq > 3:
            # SOF reads Tq as a full byte and never validates it
            # (decoder.c:117-121, unlike DQT's Tq < 4 check): dequantize
            # then reads context->qtable[Tq] out of bounds -- undefined
            # (PARITY.md).  Defined analog: clamp to the last table id
            # (matching XLA's clamped gather on the device paths).
            default_metrics.count("serial.reference_ub")
            tq = 3
        comps.append(Component(cid=c, h=h, v=v, tq=tq))
    geom = FrameGeometry(precision=p, height=y, width=x, components=tuple(comps))
    cs.geometry = with_block_grid(geom)


def _parse_dht_segment(
    r: _Reader, htables: Dict[Tuple[int, int], HuffSpec], seg_len: int
) -> None:
    """Multi-table DHT (decoder.c:143-184, loop at 586-590).

    DO-WHILE semantics, like DQT: at least one table parses regardless
    of the declared length, and a table whose counts overrun the
    segment end leaves the parse position at the overrun point."""
    end = r.pos - 2 + seg_len
    first = True
    while first or r.pos < end:
        first = False
        tc, th = r.nibbles()
        if tc >= 2:
            raise UnsupportedError("invalid DHT Tc")
        counts = tuple(r.u8() for _ in range(16))
        values = tuple(r.u8() for _ in range(sum(counts)))
        if sum(counts) > 255:
            # The reference derives codes at parse time and its Annex-C
            # tables hold at most 255 symbols plus a terminator; a
            # larger DHT fails the `K < 256` assertion
            # (huffman.c:59,67) and aborts -- i.e. the stream is
            # rejected even when the table is never used by a scan.
            raise CorruptStream("DHT with more than 255 symbols")
        if th > 3:
            # The reference never validates Th and its arrays hold four
            # ids (htable[2][4], common.h:142): a larger id WRITES out
            # of bounds into the neighboring context fields at parse
            # time -- undefined (PARITY.md).  Defined analog: keep the
            # table under its id; flag so byte comparison is off.
            default_metrics.count("serial.reference_ub")
        htables[(tc, th)] = HuffSpec(counts, values)


def _parse_sos(r: _Reader, cs: Codestream) -> ScanInfo:
    """SOS header (decoder.c:197-259) incl. baseline-only guards."""
    ns = r.u8()
    cids, tds, tas = [], [], []
    for _ in range(ns):
        cid = r.u8()
        td, ta = r.nibbles()
        cids.append(cid)
        tds.append(td)
        tas.append(ta)
    ss = r.u8()
    se = r.u8()
    ah, al = r.nibbles()
    if ss != 0 or se != 63:
        raise UnsupportedError("non-baseline spectral selection")
    if ah != 0 or al != 0:
        raise UnsupportedError("successive approximation not supported")
    # Update component table selectors (decoder.c:225-226).
    if cs.geometry is not None:
        comps = list(cs.geometry.components)
        for j, cid in enumerate(cids):
            for i, c in enumerate(comps):
                if c.cid == cid:
                    comps[i] = Component(
                        cid=c.cid, h=c.h, v=c.v, tq=c.tq,
                        td=tds[j], ta=tas[j], b_x=c.b_x, b_y=c.b_y,
                    )
        cs.geometry = FrameGeometry(
            precision=cs.geometry.precision,
            height=cs.geometry.height,
            width=cs.geometry.width,
            components=tuple(comps),
        )
    return ScanInfo(component_ids=tuple(cids), td=tuple(tds), ta=tuple(tas))


def parse_codestream(data: bytes) -> Codestream:
    """Full marker walk (decoder.c:472-659), ECS bodies left as byte ranges."""
    cs = Codestream()
    ecs_index = _EcsEndIndex(data)
    htables: Dict[Tuple[int, int], HuffSpec] = {
        key: HuffSpec.from_pair(pair) for key, pair in DEFAULT_HTABLES.items()
    }
    r = _Reader(data)
    current_scan: Optional[Scan] = None

    while True:
        marker = r.read_marker()

        if marker == M_SOI:
            continue
        if marker in APPN_SKIPPED:
            seg_len = r.u16()
            payload_start = r.pos
            if marker == 0xFFEE and seg_len >= 14:  # APP14 "Adobe"
                payload = data[r.pos : r.pos + seg_len - 2]
                if payload[:5] == b"Adobe":
                    cs.adobe_transform = payload[11]
            r.pos = payload_start
            r.skip(seg_len - 2)
            continue
        if marker == M_DQT:
            seg_len = r.u16()
            _parse_dqt_segment(r, cs, seg_len)
            continue
        if marker in (M_SOF0, M_SOF1):
            r.u16()
            _parse_sof(r, cs)
            continue
        if marker in (M_SOF2, M_SOF3, M_SOF9, M_SOF10):
            r.u16()
            _parse_sof(r, cs)
            kind = {
                M_SOF2: "progressive DCT",
                M_SOF3: "lossless",
                M_SOF9: "arithmetic coding",
                M_SOF10: "arithmetic coding",
            }[marker]
            raise UnsupportedError(f"{kind} not supported")
        if marker == M_DHT:
            seg_len = r.u16()
            _parse_dht_segment(r, htables, seg_len)
            continue
        if marker == M_DRI:
            r.u16()
            cs.ri = r.u16()
            continue
        if marker == M_SOS:
            r.u16()
            info = _parse_sos(r, cs)
            for key in [(0, td) for td in info.td] + [
                (1, ta) for ta in info.ta
            ]:
                if key not in htables:
                    # The reference never validates Td/Ta either: decode
                    # reads hcode[tc][th] which for an undefined id
                    # th <= 3 is UNINITIALIZED memory (practically the
                    # fresh-page zeros of the context malloc: last_k=0,
                    # so no code ever matches and the scan ends at its
                    # first symbol) and for th > 3 an out-of-bounds read
                    # aliasing a neighboring table (UB; PARITY.md).  The
                    # zero table reproduces the former exactly; the
                    # latter is additionally flagged.
                    if key[1] > 3:
                        default_metrics.count("serial.reference_ub")
                    htables[key] = HuffSpec(tuple([0] * 16), ())
            current_scan = Scan(info=info, htables=dict(htables), ri=cs.ri)
            cs.scans.append(current_scan)
            end = ecs_index.find(r.pos)
            current_scan.ecs_ranges.append((r.pos, end))
            r.pos = end
            continue
        if is_rst(marker):
            if current_scan is None:
                # The reference accepts a restart marker before any SOS:
                # its scan struct still has Ns = 0 (decoder.c:479), so
                # the RSTn case's read_ecs returns after zero
                # macroblocks (read_macroblock decoder.c:270-272) and
                # the marker walk continues.  Mirror the no-op.
                continue
            end = ecs_index.find(r.pos)
            current_scan.ecs_ranges.append((r.pos, end))
            r.pos = end
            continue
        if marker == M_EOI:
            cs.trailing_garbage = len(data) - r.pos
            return cs
        if marker == M_COM:
            seg_len = r.u16()
            if seg_len < 2:
                raise UnsupportedError("invalid COM length")
            cs.comments.append(r.take(seg_len - 2))
            continue
        if marker == M_TEM:
            continue
        if marker == M_DAC:
            seg_len = r.u16()
            r.skip(seg_len - 2)
            continue
        raise UnsupportedError(f"unhandled marker 0x{marker:04x}")
