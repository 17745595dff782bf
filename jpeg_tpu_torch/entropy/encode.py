"""Vectorized entropy encoding: quantized blocks -> JPEG bitstream.

The reference encodes bit-serially, twice (dry pass for the K.2 optimizer,
encoder.c:525-558, then the real pass, 560-587).  Here both passes share
ONE vectorized symbolization: every (symbol, extra-bits) item of the scan
is materialized as flat arrays, so

  * the dry pass is a histogram (np.bincount / a psum across shards), and
  * the real pass is a prefix-sum bit-packing: item lengths -> cumsum ->
    bit offsets -> masked scatter into a bit array -> packbits -> byte
    stuffing.

This is the encoder analog of the parallel decode design: no bit-serial
loop anywhere, and the same code path vectorizes across restart intervals
(each interval flushes its own byte-aligned stream).

Symbol semantics follow F.1.2 exactly (coeffs.c:256-363): category coding
with ties-away extra bits, RRRRSSSS AC symbols, ZRL for runs > 15, EOB
unless coefficient 63 is non-zero.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..constants import ZIGZAG
from ..geometry import FrameGeometry, ScanInfo
from ..tables import HuffTable


def encode_cat(c: np.ndarray) -> np.ndarray:
    """Category (SSSS) of each coefficient: bit length of |c| (coeffs.c:56-74)."""
    mag = np.abs(c.astype(np.int64))
    # bit_length: positions of highest set bit + 1; 0 -> 0
    return np.where(mag == 0, 0, np.floor(np.log2(np.maximum(mag, 1))).astype(np.int64) + 1)


def encode_extra(c: np.ndarray, cat: np.ndarray) -> np.ndarray:
    """Extra bits (coeffs.c:76-83): (c - (c<0)) & ((1<<cat)-1)."""
    c64 = c.astype(np.int64)
    adj = np.where(c64 < 0, c64 - 1, c64)
    mask = (np.int64(1) << cat.astype(np.int64)) - 1
    return (adj & mask).astype(np.int64)


@dataclass
class ScanSymbols:
    """Flat symbol stream for one scan, in bitstream order."""

    sym: np.ndarray  # [n] uint8 symbol values (DC cat or AC RRRRSSSS)
    extra_val: np.ndarray  # [n] int64 extra bits value
    extra_len: np.ndarray  # [n] int64 extra bits count
    is_dc: np.ndarray  # [n] bool
    table_id: np.ndarray  # [n] int64: Td for DC symbols, Ta for AC symbols
    mcu_index: np.ndarray  # [n] int64: owning MCU (for restart splitting)
    n_mcus: int


def build_visit_order(
    geom: FrameGeometry, info: ScanInfo
) -> Tuple[np.ndarray, np.ndarray]:
    """Block visit order for a scan.

    Returns (comp_idx[n_visits], block_seq[n_visits]) where comp_idx
    indexes info.component_ids and block_seq indexes that component's
    [n_blocks] plane.

    Interleaved (Ns>1): MCU-major then component then v then h
    (encoder.c:412-464).  Non-interleaved (Ns=1): plain raster block
    order -- the consumption order of the reference's A.2.2 path
    (decoder.c:274-302 reads blocks_in_mb*seq+w, i.e. consecutive).
    """
    if info.ns == 1:
        comp = geom.by_id(info.component_ids[0])
        n = comp.n_blocks
        return np.zeros(n, dtype=np.int64), np.arange(n, dtype=np.int64)
    m_x, m_y = geom.m_x, geom.m_y
    per_mcu_comp: List[np.ndarray] = []
    per_mcu_seq: List[np.ndarray] = []
    ys, xs = np.mgrid[0:m_y, 0:m_x]  # [m_y, m_x]
    for j, cid in enumerate(info.component_ids):
        comp = geom.by_id(cid)
        vs, hs = np.mgrid[0 : comp.v, 0 : comp.h]
        # [m_y, m_x, V, H]
        by = ys[:, :, None, None] * comp.v + vs[None, None]
        bx = xs[:, :, None, None] * comp.h + hs[None, None]
        seq = by * comp.b_x + bx
        per_mcu_seq.append(seq.reshape(m_y * m_x, -1))
        per_mcu_comp.append(np.full((m_y * m_x, comp.v * comp.h), j, dtype=np.int64))
    comp_idx = np.concatenate(per_mcu_comp, axis=1).reshape(-1)
    block_seq = np.concatenate(per_mcu_seq, axis=1).reshape(-1)
    return comp_idx, block_seq


def symbolize_scan(
    planes: Dict[int, np.ndarray],  # cid -> int32 [n_blocks, 64] raster
    geom: FrameGeometry,
    info: ScanInfo,
    restart_interval: int = 0,
) -> ScanSymbols:
    """Blocks -> flat symbol stream (the shared dry/real pass core)."""
    comp_idx, block_seq = build_visit_order(geom, info)
    n_visits = comp_idx.size
    if info.ns == 1:
        # Non-interleaved: one "MCU step" = H*V consecutive blocks
        # (decoder.c:283 blocks_in_mb).
        c0 = geom.by_id(info.component_ids[0])
        blocks_per_mcu = c0.h * c0.v
    else:
        blocks_per_mcu = n_visits // geom.n_mcus

    # Gather visited blocks in zig-zag order: [N, 64]
    stacked = [
        np.asarray(planes[cid], dtype=np.int64) for cid in info.component_ids
    ]
    zz = np.empty((n_visits, 64), dtype=np.int64)
    for j in range(len(info.component_ids)):
        sel = comp_idx == j
        zz[sel] = stacked[j][block_seq[sel]][:, ZIGZAG]

    # Differential DC per component along visit order, with predictor
    # resets at restart-interval boundaries (A.2.4 / our DRI extension).
    mcu_of_visit = np.arange(n_visits) // blocks_per_mcu
    interval_of_visit = (
        mcu_of_visit // restart_interval if restart_interval else np.zeros(n_visits, dtype=np.int64)
    )
    dc = zz[:, 0].copy()
    dcd = np.empty_like(dc)
    for j in range(len(info.component_ids)):
        sel = np.nonzero(comp_idx == j)[0]
        seq = dc[sel]
        prev = np.concatenate(([0], seq[:-1]))
        # reset prediction at the first visit of each restart interval
        iv = interval_of_visit[sel]
        first_of_interval = np.concatenate(([True], iv[1:] != iv[:-1]))
        d = np.where(first_of_interval, seq, seq - prev)
        dcd[sel] = d

    # ---- DC symbols -------------------------------------------------
    dc_cat = encode_cat(dcd)
    dc_extra = encode_extra(dcd, dc_cat)

    # ---- AC symbols (vectorized run-length over [N, 63]) -------------
    acs = zz[:, 1:]
    rows, cols = np.nonzero(acs != 0)  # row-major: block order then position
    pos = cols + 1  # zig-zag position 1..63
    vals = acs[rows, cols]

    first_in_row = np.empty(rows.size, dtype=bool)
    if rows.size:
        first_in_row[0] = True
        first_in_row[1:] = rows[1:] != rows[:-1]
    prev_pos = np.concatenate(([0], pos[:-1])) if rows.size else pos
    prev_pos = np.where(first_in_row, 0, prev_pos)
    gap = pos - prev_pos - 1
    n_zrl = gap // 16  # ZRL symbols before this coefficient
    run = gap % 16

    ac_cat = encode_cat(vals)
    ac_sym = (run.astype(np.int64) << 4) | ac_cat
    ac_extra = encode_extra(vals, ac_cat)

    # EOB per block: emitted unless position 63 is non-zero (F.2 logic:
    # all-zero blocks get a lone EOB).
    has_any = np.zeros(n_visits, dtype=bool)
    last_pos = np.zeros(n_visits, dtype=np.int64)
    if rows.size:
        np.maximum.at(last_pos, rows, pos)
        has_any[rows] = True
    eob = ~(has_any & (last_pos == 63))

    # ---- Assemble the flat stream ------------------------------------
    # Per-block symbol counts: 1 DC + sum over nz (n_zrl+1) + eob.
    per_block_ac = np.zeros(n_visits, dtype=np.int64)
    if rows.size:
        np.add.at(per_block_ac, rows, n_zrl + 1)
    n_syms_block = 1 + per_block_ac + eob.astype(np.int64)
    block_offset = np.concatenate(([0], np.cumsum(n_syms_block)[:-1]))
    total = int(n_syms_block.sum())

    sym = np.zeros(total, dtype=np.uint8)
    extra_val = np.zeros(total, dtype=np.int64)
    extra_len = np.zeros(total, dtype=np.int64)
    is_dc = np.zeros(total, dtype=bool)

    # DC at each block offset.
    dc_pos_out = block_offset
    sym[dc_pos_out] = dc_cat.astype(np.uint8)
    extra_val[dc_pos_out] = dc_extra
    extra_len[dc_pos_out] = dc_cat
    is_dc[dc_pos_out] = True

    if rows.size:
        # Within-block cumulative symbol index for each nz coefficient.
        group = n_zrl + 1
        cum = np.cumsum(group)
        row_start_cum = np.where(first_in_row, 0, np.concatenate(([0], cum[:-1])))
        # recompute per-row base: cumulative symbols before this nz in its row
        base = np.zeros(rows.size, dtype=np.int64)
        run_cum = np.concatenate(([0], cum[:-1]))
        row_first_cum = np.zeros(rows.size, dtype=np.int64)
        row_first_cum[first_in_row] = run_cum[first_in_row]
        # propagate row-first cumulative to all members of the row
        fill_idx = np.maximum.accumulate(
            np.where(first_in_row, np.arange(rows.size), 0)
        )
        base = run_cum - run_cum[fill_idx]
        # position of the (run,cat) symbol itself: after DC + preceding
        # symbols in the row + its own ZRLs.
        sym_pos = block_offset[rows] + 1 + base + n_zrl
        sym[sym_pos] = ac_sym.astype(np.uint8)
        extra_val[sym_pos] = ac_extra
        extra_len[sym_pos] = ac_cat

        # ZRL symbols (value 0xF0, no extra bits) fill the gap before it.
        if int(n_zrl.sum()):
            zr_rep = np.repeat(sym_pos, n_zrl)
            counts = np.repeat(n_zrl, n_zrl)
            starts = np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
            within = np.arange(zr_rep.size) - starts
            zr_out = zr_rep - counts + within
            sym[zr_out] = 0xF0

    # EOB (value 0, no extras) as the last symbol of flagged blocks.
    eob_rows = np.nonzero(eob)[0]
    eob_pos = block_offset[eob_rows] + n_syms_block[eob_rows] - 1
    sym[eob_pos] = 0

    # Table id + MCU index per symbol.
    td = np.asarray(info.td, dtype=np.int64)
    ta = np.asarray(info.ta, dtype=np.int64)
    comp_of_sym = np.repeat(comp_idx, n_syms_block)
    table_id = np.where(is_dc, td[comp_of_sym], ta[comp_of_sym])
    mcu_index = np.repeat(mcu_of_visit, n_syms_block)

    return ScanSymbols(
        sym=sym,
        extra_val=extra_val,
        extra_len=extra_len,
        is_dc=is_dc,
        table_id=table_id,
        mcu_index=mcu_index,
        n_mcus=geom.n_mcus,
    )


def histogram(symbols: ScanSymbols) -> Dict[Tuple[int, int], np.ndarray]:
    """Dry pass: per-(class, table) symbol frequency (write_block_dry)."""
    out: Dict[Tuple[int, int], np.ndarray] = {}
    for tc in (0, 1):
        cls = symbols.is_dc if tc == 0 else ~symbols.is_dc
        for th in np.unique(symbols.table_id[cls]):
            sel = cls & (symbols.table_id == th)
            out[(tc, int(th))] = np.bincount(
                symbols.sym[sel], minlength=256
            ).astype(np.int64)
    return out


def _pack_bits_msb(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate (value, bit-length) items MSB-first; 1-pad the tail byte
    (flush_bits, io.c:65-87) and byte-stuff 0x00 after 0xFF (io.c:277-290).
    """
    if values.size == 0:
        return b""
    max_len = 32
    cols = np.arange(max_len, dtype=np.int64)
    shifts = lengths[:, None] - 1 - cols[None, :]
    valid = shifts >= 0
    bits = np.where(
        valid, (values[:, None] >> np.maximum(shifts, 0)) & 1, 0
    ).astype(np.uint8)
    flat = bits[valid]  # row-major: item order, MSB-first within item
    pad = (-flat.size) % 8
    if pad:
        flat = np.concatenate([flat, np.ones(pad, dtype=np.uint8)])
    packed = np.packbits(flat)
    # Byte stuffing.
    is_ff = packed == 0xFF
    if is_ff.any():
        out = np.zeros(packed.size + int(is_ff.sum()), dtype=np.uint8)
        dst = np.arange(packed.size) + np.cumsum(is_ff) - is_ff
        out[dst] = packed
        return out.tobytes()
    return packed.tobytes()


def pack_scan(
    symbols: ScanSymbols,
    tables: Dict[Tuple[int, int], HuffTable],
    restart_interval: int = 0,
) -> List[bytes]:
    """Real pass: symbols + code tables -> stuffed ECS byte strings.

    Returns one byte string per restart interval (a single-element list
    when restart_interval == 0); the caller interleaves RSTn markers.
    """
    # Per-symbol (code, size) via the EHUFCO/EHUFSI tables.
    n = symbols.sym.size
    code = np.zeros(n, dtype=np.int64)
    size = np.zeros(n, dtype=np.int64)
    for tc in (0, 1):
        cls = symbols.is_dc if tc == 0 else ~symbols.is_dc
        for th in np.unique(symbols.table_id[cls]):
            sel = cls & (symbols.table_id == th)
            t = tables[(tc, int(th))]
            code[sel] = t.ehufco[symbols.sym[sel]]
            size[sel] = t.ehufsi[symbols.sym[sel]]
    if n and (size == 0).any():
        # A used symbol has no code in the selected table -- e.g. 12-bit
        # DC categories > 11 against the 8-bit default tables.  The
        # reference fails hard here too (value_to_vlc -1, huffman.c:252,
        # leaving a truncated file); raise a clean error instead.
        from ..errors import UnsupportedError

        bad = int(symbols.sym[size == 0][0])
        raise UnsupportedError(
            f"symbol 0x{bad:02x} has no code in the selected Huffman table "
            "(content exceeds table range; use optimized tables)"
        )

    item_val = (code << symbols.extra_len) | symbols.extra_val
    item_len = size + symbols.extra_len

    if not restart_interval:
        return [_pack_bits_msb(item_val, item_len)]

    interval = symbols.mcu_index // restart_interval
    n_intervals = int(interval.max()) + 1 if n else 1
    out = []
    for k in range(n_intervals):
        sel = interval == k
        out.append(_pack_bits_msb(item_val[sel], item_len[sel]))
    return out
