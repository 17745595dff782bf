"""Serial (oracle) entropy decode.

A direct, sequential implementation of the reference's ECS reader
(decoder.c:262-388 + coeffs.c:196-254 + huffman.c:255-312 + io.c:18-41),
used as the executable specification for the vectorized/TPU decoders and
for streams the parallel path can't assume structure about.

Instead of the reference's bit-FIFO + per-bit linear code scan, symbols
decode via a 16-bit-window lookup table -- semantically identical for
canonical prefix codes, including end-of-segment behaviour: a symbol whose
code or extra bits would extend past the segment's last byte raises
NoMoreData exactly where the reference's next_bit does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..constants import ZIGZAG
from ..errors import CorruptStream, NoMoreData, UnsupportedError
from ..utils.metrics import default_metrics
from ..geometry import FrameGeometry, ScanInfo
from ..tables import HuffTable


def extend_coeff(cat: int, extra: int) -> int:
    """F.12 sign extension (coeffs.c:33-48).

    ``extra`` is the reference's uint16 accumulator value (the low 16 of
    the consumed bits).  A corrupt DC table can deliver cat up to 255:
    decode_coeff stays DEFINED through cat == 30 (the uint16 promotes to
    int, the shifts fit, sign is 0, and our exact formula reproduces it);
    cat >= 31 shifts past the int width / overflows INT32_C(1) << cat --
    undefined, so count it and return the extra bits unextended (any
    defined choice works: harnesses skip byte comparison once
    `serial.reference_ub` fires, see PARITY.md).
    """
    if cat == 0:
        return 0
    if cat >= 31:
        default_metrics.count("serial.reference_ub")
        return extra
    if extra >> (cat - 1):
        return extra
    return extra - (1 << cat) + 1


class BitReader:
    """MSB-first bit reader over unstuffed ECS bytes.

    ``nbits`` counts every bit of every byte (the reference consumes whole
    bytes from its FIFO; NO_MORE_DATA only fires when *fetching* a byte
    past the marker, io.c:18-41 + 247-274).
    """

    __slots__ = ("data", "nbits", "pos", "_buf", "_buflen", "_bytepos")

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, dtype=np.uint8)
        self.nbits = self.data.size * 8
        self.pos = 0
        self._buf = 0  # bit accumulator, MSB-aligned within _buflen bits
        self._buflen = 0
        self._bytepos = 0

    def _fill(self, need: int) -> None:
        while self._buflen < need:
            if self._bytepos < self.data.size:
                self._buf = (self._buf << 8) | int(self.data[self._bytepos])
                self._bytepos += 1
            else:
                self._buf <<= 8  # zero padding past the end (never consumed)
            self._buflen += 8

    def peek16(self) -> int:
        self._fill(16)
        return (self._buf >> (self._buflen - 16)) & 0xFFFF

    def consume(self, n: int) -> None:
        if self.pos + n > self.nbits:
            # Mid-symbol end of segment: reference rewinds and reports
            # NO_MORE_DATA (io.c:261-269).
            self.pos = self.nbits
            raise NoMoreData()
        self._fill(n)
        self._buflen -= n
        self._buf &= (1 << self._buflen) - 1
        self.pos += n

    def read_bits(self, n: int) -> int:
        """Consume ``n`` bits; return the LOW 16 of their value.

        Mirrors read_extra_bits (huffman.c:294-312): the reference shifts
        every bit into a uint16, so when a corrupt DC table requests
        cat > 16 extra bits, all ``cat`` bits are consumed (keeping the
        stream position in lockstep) but only the last 16 survive.
        """
        if n == 0:
            return 0
        self._fill(n)
        val = (self._buf >> (self._buflen - n)) & ((1 << n) - 1)
        self.consume(n)
        return val & 0xFFFF


def read_code(br: BitReader, table: HuffTable) -> int:
    """Decode one Huffman symbol (read_code, huffman.c:255-271)."""
    window = br.peek16()
    packed = int(table.lut16[window])
    if packed < 0:
        # No code matches any prefix: the reference keeps pulling bits to
        # the end of the segment and then reports NO_MORE_DATA.
        br.pos = br.nbits
        raise NoMoreData()
    length = packed & 0xFF
    br.consume(length)
    return packed >> 8


def decode_block(
    br: BitReader,
    dc_table: HuffTable,
    ac_table: HuffTable,
    out: Optional[np.ndarray],
    oob: bool = False,
) -> None:
    """Decode one 8x8 block into ``out`` [64] raster (read_block,
    coeffs.c:196-254).  ``out is None`` replicates the reference's
    corrupt-file NULL-block path: consume the DC code then bail.
    ``oob=True`` marks a block the REFERENCE would write out of bounds
    (the Ns=1 overrun, decoder.c:274-302): its first write happens right
    after a successful DC read, so the UB event is counted exactly
    there -- a bit reader that dies inside the DC code never reaches it.
    """
    cat = read_code(br, dc_table)
    extra = br.read_bits(cat)
    if out is None:
        raise CorruptStream("block past end of component buffer")
    if oob:
        default_metrics.count("serial.reference_ub")
    out[:] = 0
    out[0] = extend_coeff(cat, extra)

    i = 1
    rem = 63
    while rem > 0:
        rs = read_code(br, ac_table)
        cat = rs & 15
        extra = br.read_bits(cat)
        zrl = rs >> 4
        if rs == 0:  # EOB
            return
        i += zrl
        if i > 63:
            # A run past coefficient 63 sends the reference out of bounds
            # (coeffs.c:247 indexes zigzag[i>63]; observed outcomes range
            # from stray writes into NEIGHBORING blocks' buffers to heap
            # corruption aborts -- undefined behavior either way).  The
            # defined analog: consume the identical bits so the stream
            # stays in lockstep, drop the unplaceable write, keep
            # decoding.  Counted so callers can tell the output is not
            # byte-pinned to the reference here (PARITY.md).
            default_metrics.count("serial.reference_ub")
        else:
            out[ZIGZAG[i]] = extend_coeff(cat, extra)
        i += 1
        rem -= zrl + 1


class ScanDecoder:
    """Sequential scan decode across its ECS segments (read_ecs)."""

    def __init__(
        self,
        geom: FrameGeometry,
        info: ScanInfo,
        tables: Dict[Tuple[int, int], HuffTable],
        planes: Dict[int, np.ndarray],
    ):
        self.geom = geom
        self.info = info
        self.planes = planes  # cid -> int32 [n_blocks, 64] raster
        self.mblocks = 0  # continues across segments (decoder.c:256)
        # Resolve per-scan-component tables once.
        self.dc_tables = [tables[(0, td)] for td in info.td]
        self.ac_tables = [tables[(1, ta)] for ta in info.ta]

    def decode_segment(self, data: np.ndarray) -> int:
        """Decode one ECS (between RST markers).  Returns MCUs decoded."""
        br = BitReader(data)
        # DC predictors reset at segment start (decoder.c:371-373).
        last_dc: Dict[int, int] = {}
        count = 0
        while True:
            try:
                self._read_macroblock(br, last_dc)
            except (NoMoreData, CorruptStream):
                break
            self.mblocks += 1
            count += 1
        return count

    def _read_macroblock(self, br: BitReader, last_dc: Dict[int, int]) -> None:
        """decoder.c:262-362."""
        info, geom = self.info, self.geom
        seq_no = self.mblocks

        if info.ns == 0:
            raise NoMoreData()

        if info.ns == 1:
            # A.2.2 non-interleaved: H*V consecutive blocks per step over
            # the component's own raster block grid (decoder.c:274-302).
            cid = info.component_ids[0]
            comp = geom.by_id_or_none(cid)
            if comp is None:
                # The reference's component array holds all 256 ids;
                # an undeclared one has H = V = 0 from init_component,
                # so read_macroblock consumes NOTHING and read_ecs
                # loops forever (decoder.c:364-383 has no MCU bound) --
                # a hang, no parity definable (PARITY.md).
                default_metrics.count("serial.reference_ub")
                raise CorruptStream(
                    "Ns=1 scan over undeclared component (reference hangs)"
                )
            plane = self.planes[cid]
            blocks_in_mb = comp.h * comp.v
            scratch = np.zeros(64, dtype=np.int64)
            for w in range(blocks_in_mb):
                block_seq = blocks_in_mb * seq_no + w
                in_range = block_seq < comp.n_blocks
                # The reference's Ns=1 branch has NO past-the-end guard
                # (decoder.c:274-302, unlike the interleaved branch's
                # NULL check at 339-347): it writes past the component's
                # heap buffer -- undefined; observed as glibc heap-
                # corruption aborts.  Decoding into a scratch block is
                # the defined analog (identical bit consumption);
                # decode_block counts the event iff the write happens.
                out = plane[block_seq] if in_range else scratch
                decode_block(br, self.dc_tables[0], self.ac_tables[0],
                             out, oob=not in_range)
                out[0] += last_dc.get(cid, 0)
                last_dc[cid] = int(out[0])
            return

        if geom.m_x == 0:
            raise UnsupportedError("SOS before SOF")

        x = seq_no % geom.m_x
        y = seq_no // geom.m_x
        for j, cid in enumerate(info.component_ids):
            comp = geom.by_id_or_none(cid)
            if comp is None:
                # Undeclared id: the reference's component[Cs] has
                # H = V = 0 (init_component), so the per-component block
                # loops run zero times -- the component contributes no
                # blocks and consumes no bits.  DEFINED behavior; skip
                # to stay bit-exact (decoder.c:316-358).
                continue
            plane = self.planes[cid]
            for v in range(comp.v):
                for h in range(comp.h):
                    block_x = x * comp.h + h
                    block_y = y * comp.v + v
                    block_seq = block_y * comp.b_x + block_x
                    # Past-the-end guard (decoder.c:339-347): decode DC,
                    # then stop the whole ECS.
                    out = (
                        plane[block_seq]
                        if block_seq < comp.n_blocks
                        else None
                    )
                    decode_block(br, self.dc_tables[j], self.ac_tables[j], out)
                    out[0] += last_dc.get(cid, 0)
                    last_dc[cid] = int(out[0])


def decode_scan_serial(
    geom: FrameGeometry,
    info: ScanInfo,
    tables: Dict[Tuple[int, int], HuffTable],
    segments: List[np.ndarray],
    planes: Dict[int, np.ndarray],
) -> int:
    """Decode all ECS segments of one scan sequentially.  Returns MCUs."""
    dec = ScanDecoder(geom, info, tables, planes)
    for seg in segments:
        dec.decode_segment(seg)
    return dec.mblocks
