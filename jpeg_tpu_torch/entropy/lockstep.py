"""Lockstep segment-parallel entropy decode.

The TPU-native answer to the reference's bit-serial ECS reader: all ECS
segments of a scan decode *simultaneously*, one Huffman symbol per lane
per step, entirely with vectorized array ops.  Restart markers make this
correct for free (T.81 resets DC prediction and byte-aligns at every RST,
decoder.c:371-373), and a scan's global MCU placement needs only an
exclusive prefix-sum of per-segment MCU counts afterwards -- entropy
decode itself never depends on the MCU index (SURVEY §2.2 "sequence
parallel" row).

Per step and lane:
  1. load a 48-bit window at the current bit offset (6 byte gathers),
  2. canonical-decode the code via per-length mincode/maxcode compare
     (16 parallel compares -- no 64K LUT gather, VPU-friendly),
  3. read extra bits from the same window, F.12 sign-extend,
  4. advance block/MCU state machine (EOB / ZRL / coefficient),
  5. emit (local_mcu, slot, zigzag_pos, value) for the final scatter.

A lane dies exactly where the reference would hit NO_MORE_DATA: when a
code or its extra bits would consume past the segment's last byte
(io.c:247-274 semantics, bit-for-bit).

This module is the NumPy engine (also the oracle for the JAX/TPU port in
``lockstep_jax``); the step math is kept in plain array ops so both
backends share structure.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..constants import ZIGZAG
from ..geometry import FrameGeometry, ScanInfo
from ..tables import HuffTable


@dataclass(eq=False)  # identity hash: plans are cached + used as static jit args
class ScanPlan:
    """Static per-scan decode tables + block-mapping constants.

    ``slots`` enumerate the blocks of one MCU in scan order
    (decoder.c:319-358): for each slot we record its component index,
    (v, h) offsets, component grid and table ids so the global block
    index is pure arithmetic of (mcu, slot).
    """

    interleaved: bool
    m_x: int
    blocks_per_mcu: int
    # Per-slot arrays [bpm]:
    slot_comp: np.ndarray
    slot_v: np.ndarray
    slot_h: np.ndarray
    slot_V: np.ndarray
    slot_H: np.ndarray
    slot_bx: np.ndarray
    slot_nblocks: np.ndarray
    slot_plane_offset: np.ndarray
    slot_dc_tab: np.ndarray  # index into stacked tables
    slot_ac_tab: np.ndarray
    # Stacked decode tables [T, ...]:
    mincode: np.ndarray  # [T, 17]
    maxcode: np.ndarray  # [T, 17]
    valptr: np.ndarray  # [T, 17]
    huffval: np.ndarray  # [T, 256]
    n_comps: int
    max_codes: int = 256  # longest table's code count (one-hot width hint)
    # Valid-MCU count: block_ok(mcu, slot) == (mcu < n_mcus) exactly,
    # because every component's block grid is MCU-divisible
    # (b_x = m_x*H, b_y = m_y*V; Ns=1 grids divide by H*V too).
    n_mcus: int = 1 << 30


def build_scan_plan(
    geom: FrameGeometry,
    info: ScanInfo,
    tables: Dict[Tuple[int, int], HuffTable],
) -> ScanPlan:
    comps = [geom.by_id(cid) for cid in info.component_ids]
    interleaved = info.ns > 1

    # Stack the used decode tables.
    keys: List[Tuple[int, int]] = []
    for td in info.td:
        if (0, td) not in keys:
            keys.append((0, td))
    for ta in info.ta:
        if (1, ta) not in keys:
            keys.append((1, ta))
    T = len(keys)
    mincode = np.zeros((T, 17), dtype=np.int64)
    maxcode = np.full((T, 17), -1, dtype=np.int64)
    valptr = np.zeros((T, 17), dtype=np.int64)
    huffval = np.zeros((T, 256), dtype=np.int64)
    max_codes = 1
    for t, key in enumerate(keys):
        tab = tables[key]
        mincode[t] = tab.mincode
        maxcode[t] = tab.maxcode
        valptr[t] = tab.valptr
        huffval[t, : tab.n_codes] = tab.huffval
        max_codes = max(max_codes, tab.n_codes)
    tab_index = {k: i for i, k in enumerate(keys)}

    # Slot layout.
    slot_comp, slot_v, slot_h = [], [], []
    offsets = {}
    off = 0
    for j, c in enumerate(comps):
        offsets[j] = off
        off += c.n_blocks
    if interleaved:
        for j, c in enumerate(comps):
            for v in range(c.v):
                for h in range(c.h):
                    slot_comp.append(j)
                    slot_v.append(v)
                    slot_h.append(h)
    else:
        c = comps[0]
        for w in range(c.h * c.v):
            slot_comp.append(0)
            slot_v.append(0)
            slot_h.append(w)  # consecutive-block index within the step
    bpm = len(slot_comp)
    slot_comp = np.asarray(slot_comp, dtype=np.int64)

    return ScanPlan(
        interleaved=interleaved,
        m_x=geom.m_x,
        blocks_per_mcu=bpm,
        slot_comp=slot_comp,
        slot_v=np.asarray(slot_v, dtype=np.int64),
        slot_h=np.asarray(slot_h, dtype=np.int64),
        slot_V=np.asarray([comps[j].v for j in slot_comp], dtype=np.int64),
        slot_H=np.asarray([comps[j].h for j in slot_comp], dtype=np.int64),
        slot_bx=np.asarray([comps[j].b_x for j in slot_comp], dtype=np.int64),
        slot_nblocks=np.asarray(
            [comps[j].n_blocks for j in slot_comp], dtype=np.int64
        ),
        slot_plane_offset=np.asarray(
            [offsets[int(j)] for j in slot_comp], dtype=np.int64
        ),
        slot_dc_tab=np.asarray(
            [tab_index[(0, info.td[j])] for j in slot_comp], dtype=np.int64
        ),
        slot_ac_tab=np.asarray(
            [tab_index[(1, info.ta[j])] for j in slot_comp], dtype=np.int64
        ),
        mincode=mincode,
        maxcode=maxcode,
        valptr=valptr,
        huffval=huffval,
        n_comps=len(comps),
        max_codes=max_codes,
        n_mcus=(
            geom.n_mcus
            if interleaved
            else (comps[0].n_blocks + bpm - 1) // bpm
        ),
    )


def _pad_segments(segments: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length byte segments into [S, L+8] with zero tail."""
    S = len(segments)
    maxlen = max((s.size for s in segments), default=0)
    mat = np.zeros((S, maxlen + 8), dtype=np.uint8)
    nbits = np.zeros(S, dtype=np.int64)
    for i, s in enumerate(segments):
        mat[i, : s.size] = s
        nbits[i] = s.size * 8
    return mat, nbits


def _extend(cat: np.ndarray, extra: np.ndarray) -> np.ndarray:
    """Vectorized F.12 sign extension."""
    sign = extra >> np.maximum(cat - 1, 0)
    neg = extra - (np.int64(1) << cat) + 1
    return np.where(cat == 0, 0, np.where(sign != 0, extra, neg))


def decode_segments_lockstep(
    plan: ScanPlan,
    segments: Sequence[np.ndarray],
    max_mcus_hint: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Decode all segments in lockstep.

    Returns (mcu_counts[S], em_mcu, em_slot, em_pos, em_val, em_lane):
    per-segment completed-MCU counts plus flat emission arrays (already
    filtered to valid coefficient writes, positions in raster order).
    """
    S = len(segments)
    if S == 0:
        return (np.zeros(0, dtype=np.int64),) + tuple(
            np.zeros(0, dtype=np.int64) for _ in range(5)
        )
    bytes_mat, nbits = _pad_segments(segments)
    bpm = plan.blocks_per_mcu

    # Worst-case symbols: 64 per block (DC + 63 AC) + 1; also bounded by
    # available bits (every symbol costs >= 1 bit).
    if max_mcus_hint is None:
        max_blocks = int(nbits.max()) // 2 // 1 + 1
    else:
        max_blocks = max_mcus_hint * bpm + bpm
    max_steps = int(min(65 * max_blocks, int(nbits.max()) + 1))

    bitpos = np.zeros(S, dtype=np.int64)
    alive = nbits > 0
    mcu = np.zeros(S, dtype=np.int64)
    slot = np.zeros(S, dtype=np.int64)
    coeff = np.zeros(S, dtype=np.int64)  # 0 = expect DC, else next AC index
    # DC predictor per (lane, component) = accumulated DC of the last
    # *completed* block; cur_diff holds the in-flight block's raw diff.
    # The reference adds the predictor only after a block fully decodes
    # (decoder.c:350-355), so partial blocks keep the raw diff -- we
    # emit the diff as an assignment at DC time and the predictor as an
    # order-independent scatter-ADD at block completion.
    dc_pred = np.zeros((S, plan.n_comps), dtype=np.int64)
    cur_diff = np.zeros(S, dtype=np.int64)

    em_mcu, em_slot, em_pos, em_val, em_lane = [], [], [], [], []
    ad_mcu, ad_slot, ad_val, ad_lane = [], [], [], []

    offs6 = np.arange(6)
    shift6 = np.uint64(40) - np.uint64(8) * np.arange(6, dtype=np.uint64)

    while alive.any():
        if len(em_mcu) > max_steps:
            break  # corrupt-stream backstop
        idx = np.nonzero(alive)[0]
        bp = bitpos[idx]
        p = bp >> 3
        r = (bp & 7).astype(np.uint64)

        raw = bytes_mat[idx[:, None], p[:, None] + offs6[None, :]].astype(np.uint64)
        win48 = (raw << shift6[None, :]).sum(axis=1, dtype=np.uint64)
        win48 = (win48 << r) & np.uint64((1 << 48) - 1)
        code16 = (win48 >> np.uint64(32)).astype(np.int64)

        # Table per lane: DC table when coeff==0 else AC table.
        sl = slot[idx]
        tab = np.where(coeff[idx] == 0, plan.slot_dc_tab[sl], plan.slot_ac_tab[sl])

        # Canonical decode: first length L with prefix <= maxcode[L].
        Ls = np.arange(1, 17)
        prefixes = code16[:, None] >> (16 - Ls)[None, :]
        ok = prefixes <= plan.maxcode[tab][:, 1:]
        any_ok = ok.any(axis=1)
        L = np.where(any_ok, np.argmax(ok, axis=1) + 1, 16)
        pref_L = code16 >> (16 - L)
        vidx = plan.valptr[tab, L] + pref_L - plan.mincode[tab, L]
        vidx = np.clip(vidx, 0, 255)
        value = plan.huffval[tab, vidx]

        is_dc = coeff[idx] == 0
        # Clamp DC categories so window shifts stay in range; anything
        # over 16 is corrupt and kills the lane below anyway.
        cat = np.where(is_dc, np.minimum(value, 31), value & 15)
        corrupt = (~any_ok) | (cat > 16)
        need = L + cat
        overrun = bp + need > nbits[idx]
        die = corrupt | overrun

        extra = (win48 >> (np.uint64(48) - (need).astype(np.uint64))).astype(
            np.int64
        ) & ((np.int64(1) << cat) - 1)
        coef_val = _extend(cat, extra)

        # --- state transition for surviving lanes -------------------
        live = ~die
        # Block index of the current slot (for emission validity).
        if plan.interleaved:
            my = mcu[idx] // plan.m_x
            mx = mcu[idx] % plan.m_x
            block_seq = (my * plan.slot_V[sl] + plan.slot_v[sl]) * plan.slot_bx[
                sl
            ] + (mx * plan.slot_H[sl] + plan.slot_h[sl])
        else:
            block_seq = mcu[idx] * bpm + plan.slot_h[sl]
        block_ok = block_seq < plan.slot_nblocks[sl]

        # Interleaved NULL-block parity: consume the DC bits then kill
        # the lane (decoder.c:339-347).
        comp = plan.slot_comp[sl]
        dc_null = live & is_dc & ~block_ok & plan.interleaved

        rs = value
        is_eob = (~is_dc) & (rs == 0)
        zrl = np.where(is_dc, 0, rs >> 4)
        new_coeff = np.where(is_dc, 1, coeff[idx] + zrl)
        ac_corrupt = live & ~is_dc & ~is_eob & (new_coeff > 63)
        die = die | dc_null | ac_corrupt
        live = ~die

        # Coefficient assignment (raw DC diff at pos 0, or AC value).
        write = live & block_ok & (is_dc | (~is_eob))
        pos = np.where(is_dc, 0, ZIGZAG[np.clip(new_coeff, 0, 63)])

        em_lane.append(idx[write])
        em_mcu.append(mcu[idx][write])
        em_slot.append(sl[write])
        em_pos.append(pos[write])
        em_val.append(coef_val[write])

        # Advance.
        cur_diff[idx] = np.where(live & is_dc, coef_val, cur_diff[idx])
        after_coeff = np.where(is_dc, 1, new_coeff + 1)
        block_done = live & (is_eob | (after_coeff >= 64))

        # Completed block: scatter-ADD the predictor into pos 0, then
        # fold this block's diff into the predictor chain.
        pred_here = dc_pred[idx, comp]
        addw = block_done & block_ok
        ad_lane.append(idx[addw])
        ad_mcu.append(mcu[idx][addw])
        ad_slot.append(sl[addw])
        ad_val.append(pred_here[addw])
        done_idx = idx[block_done]
        dc_pred[done_idx, comp[block_done]] = (
            pred_here[block_done] + cur_diff[idx][block_done]
        )

        next_slot = np.where(block_done, sl + 1, sl)
        wrap = next_slot >= bpm
        next_mcu = mcu[idx] + (block_done & wrap)
        next_slot = np.where(wrap, 0, next_slot)
        next_coeff = np.where(block_done, 0, after_coeff)

        bitpos[idx] = np.where(live, bp + need, nbits[idx])
        mcu[idx] = np.where(live, next_mcu, mcu[idx])
        slot[idx] = np.where(live, next_slot, slot[idx])
        coeff[idx] = np.where(live, next_coeff, coeff[idx])
        alive[idx] = live

    def _cat(parts):
        return (
            np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)
        )

    assign = (_cat(em_mcu), _cat(em_slot), _cat(em_pos), _cat(em_val), _cat(em_lane))
    adds = (_cat(ad_mcu), _cat(ad_slot), _cat(ad_val), _cat(ad_lane))
    return mcu, assign, adds


def decode_scan_lockstep(
    geom: FrameGeometry,
    info: ScanInfo,
    tables: Dict[Tuple[int, int], HuffTable],
    segments: Sequence[np.ndarray],
    planes: Dict[int, np.ndarray],
) -> int:
    """Parallel scan decode: lockstep segments + prefix-sum placement."""
    plan = build_scan_plan(geom, info, tables)
    counts, assign, adds = decode_segments_lockstep(plan, segments)
    em_mcu, em_slot, em_pos, em_val, em_lane = assign
    ad_mcu, ad_slot, ad_val, ad_lane = adds

    # Exclusive prefix sum of per-segment MCU counts -> global MCU index.
    seg_offset = (
        np.concatenate(([0], np.cumsum(counts)[:-1])) if counts.size else counts
    )

    def _flat_block(mcus, slots, lane):
        gmcu = mcus + seg_offset[lane]
        if plan.interleaved:
            my = gmcu // plan.m_x
            mx = gmcu % plan.m_x
            seq = (my * plan.slot_V[slots] + plan.slot_v[slots]) * plan.slot_bx[
                slots
            ] + (mx * plan.slot_H[slots] + plan.slot_h[slots])
        else:
            seq = gmcu * plan.blocks_per_mcu + plan.slot_h[slots]
        ok = seq < plan.slot_nblocks[slots]
        return plan.slot_plane_offset[slots] + seq, ok

    comp_sizes = [geom.by_id(cid).n_blocks for cid in info.component_ids]
    flat = np.concatenate(
        [
            np.asarray(planes[cid], dtype=np.int32).reshape(-1, 64)
            for cid in info.component_ids
        ]
    )

    blk, ok = _flat_block(em_mcu, em_slot, em_lane)
    flat[blk[ok], em_pos[ok]] = em_val[ok].astype(np.int32)

    ablk, aok = _flat_block(ad_mcu, ad_slot, ad_lane)
    np.add.at(flat[:, 0], ablk[aok], ad_val[aok].astype(np.int32))

    off = 0
    for cid, n in zip(info.component_ids, comp_sizes):
        planes[cid][:] = flat[off : off + n]
        off += n
    return int(counts.sum())
