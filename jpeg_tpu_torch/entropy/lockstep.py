"""Scan plan for the segment-parallel entropy decode.

``ScanPlan`` holds a scan's static decode tables and block-mapping
constants; ``build_scan_plan`` derives it from the frame geometry, the
scan header and the Huffman tables.  Both are copied unchanged from the
JAX package's ``entropy/lockstep.py`` (which also holds the NumPy
lockstep engine, not needed by this port yet).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

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
