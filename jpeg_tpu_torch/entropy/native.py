"""Native (C++) entropy decode backend.

Segments decode in parallel host threads via jpeg_tpu.native; placement
uses the same prefix-sum contract as the lockstep engines: the kernel
returns visit-order blocks + per-segment MCU counts, and NumPy scatters
rows into the component planes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..geometry import FrameGeometry, ScanInfo
from ..tables import HuffTable
from .lockstep import build_scan_plan
from .. import native


def decode_scan_native(
    geom: FrameGeometry,
    info: ScanInfo,
    tables: Dict[Tuple[int, int], HuffTable],
    planes: Dict[int, np.ndarray],
    ri: int = 0,
    segments: Sequence[np.ndarray] = None,
    seg_bytes: np.ndarray = None,
    seg_offsets: np.ndarray = None,
) -> int:
    """Pass either ``segments`` (list of unstuffed byte arrays) or the
    pre-concatenated (seg_bytes, seg_offsets) layout."""
    plan = build_scan_plan(geom, info, tables)
    bpm = plan.blocks_per_mcu

    if seg_bytes is None:
        S = len(segments)
        if S == 0:
            return 0
        seg_offsets = np.zeros(S + 1, dtype=np.int64)
        for i, s in enumerate(segments):
            seg_offsets[i + 1] = seg_offsets[i] + s.size
        seg_bytes = (
            np.concatenate([np.asarray(s, dtype=np.uint8) for s in segments])
            if seg_offsets[-1]
            else np.zeros(0, dtype=np.uint8)
        )
    else:
        S = seg_offsets.size - 1
        if S == 0:
            return 0

    # Stack the 16-bit decode LUTs in plan table order.
    keys_order = []  # reconstruct the stacking order used by the plan
    for td in info.td:
        if (0, td) not in keys_order:
            keys_order.append((0, td))
    for ta in info.ta:
        if (1, ta) not in keys_order:
            keys_order.append((1, ta))
    lut16 = np.stack([tables[k].lut16 for k in keys_order])

    max_seg_bits = int((np.diff(seg_offsets)).max()) * 8
    cap = max_seg_bits // 2 + 2
    if ri:
        cap = min(cap, ri * bpm + 2 * bpm)
    total_expected = sum(geom.by_id(cid).n_blocks for cid in info.component_ids)
    cap = max(bpm, min(cap, total_expected + 2 * bpm))

    blocks, written, counts = native.decode_segments_native(
        seg_bytes,
        seg_offsets,
        lut16,
        plan.slot_dc_tab,
        plan.slot_ac_tab,
        plan.slot_comp,
        plan.n_comps,
        cap,
    )

    # ---- placement (prefix-sum of MCU counts) ------------------------
    seg_mcu_off = np.concatenate(([0], np.cumsum(counts)[:-1]))
    k = np.repeat(np.arange(S), written)
    if k.size:
        starts = np.repeat(np.cumsum(written) - written, written)
        v = np.arange(k.size) - starts
        gmcu = seg_mcu_off[k] + v // bpm
        slot = v % bpm
        if plan.interleaved:
            my = gmcu // plan.m_x
            mx = gmcu % plan.m_x
            seq = (my * plan.slot_V[slot] + plan.slot_v[slot]) * plan.slot_bx[
                slot
            ] + (mx * plan.slot_H[slot] + plan.slot_h[slot])
        else:
            seq = gmcu * bpm + plan.slot_h[slot]
        ok = seq < plan.slot_nblocks[slot]
        flat_idx = plan.slot_plane_offset[slot] + seq

        flat = np.concatenate(
            [
                np.asarray(planes[cid], dtype=np.int32).reshape(-1, 64)
                for cid in info.component_ids
            ]
        )
        rows = blocks[k, v]
        flat[flat_idx[ok]] = rows[ok]
        off = 0
        for cid in info.component_ids:
            n = geom.by_id(cid).n_blocks
            planes[cid][:] = flat[off : off + n]
            off += n
    return int(counts.sum())
