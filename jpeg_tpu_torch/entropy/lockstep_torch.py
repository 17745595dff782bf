"""Plain PyTorch lockstep entropy scan (the port of ``lockstep_jax``).

All restart segments of a chunk decode together, one Huffman symbol per
lane per step, with every intermediate an [S]-shaped tensor.  This is the
plain version beside the ``decode_segments`` CUDA kernel
(``place_cuda.py``): the CPU tests run it against the JAX scan, and
``chip_smoke.py`` runs it against the kernel on the card.

Semantics are those of ``jpeg_tpu/entropy/lockstep_jax.py``
``_symbol_step_scalar`` step for step, including corrupt input (a lane
dies on an unmatched code, a DC category above 16, an AC run past 63, a
symbol that overruns its segment, or a DC of an out-of-range MCU in an
interleaved scan), and the single emission stream: AC coefficients emit
on their step, a block's final DC (predictor + diff) one step later.
Unlike the JAX scan there is no static step bound: the loop runs until
no lane is alive.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..constants import ZIGZAG
from ..errors import CorruptStream
from ..tables import derive_table
from .lockstep import ScanPlan, build_scan_plan


@lru_cache(maxsize=256)
def _cached_plan(geom, info, spec_items) -> ScanPlan:
    tables = {k: derive_table(spec) for k, spec in spec_items}
    return build_scan_plan(geom, info, tables)


def pack_words(bytes_cat: np.ndarray, lens: np.ndarray):
    """Vectorized pack: concatenated segment bytes -> ([S, Wn] u32, nbits).

    Column count is the max segment length rounded to a multiple of 64
    bytes (+8 slack for the word lookahead).
    """
    S = lens.size
    maxlen = int(lens.max()) if S else 0
    pad = ((maxlen + 8 + 63) // 64) * 64
    mat = np.zeros((S, pad), dtype=np.uint8)
    if bytes_cat.size:
        starts = np.cumsum(lens) - lens
        rows = np.repeat(np.arange(S), lens)
        cols = np.arange(bytes_cat.size) - np.repeat(starts, lens)
        mat[rows, cols] = bytes_cat
    words = mat.reshape(S, -1, 4).astype(np.uint32)
    words = (
        (words[:, :, 0] << 24)
        | (words[:, :, 1] << 16)
        | (words[:, :, 2] << 8)
        | words[:, :, 3]
    )
    return words, (lens * 8).astype(np.int64)


def _plan_tensors(plan: ScanPlan, device: torch.device):
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    return dict(
        maxcode=t(plan.maxcode),
        mincode=t(plan.mincode),
        valptr=t(plan.valptr),
        huffval=t(plan.huffval),
        slot_comp=t(plan.slot_comp),
        slot_dc_tab=t(plan.slot_dc_tab),
        slot_ac_tab=t(plan.slot_ac_tab),
        zigzag=t(ZIGZAG),
    )


def scan_lanes(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
               checks: bool = False):
    """Run the lockstep symbol scan over all lanes until every lane dies.

    ``words`` [S, Wn] int32 holding big-endian u32 segment words
    (``pack_words``), ``nbits`` [S] int32.  Returns ``(mcu_counts [S],
    em_key [steps, S], em_val [steps, S], nsteps [S])``, all int32, with
    the JAX engine's key packing ``((mcu << 4 | slot) * 64 + pos) + 1``
    (0 = no emission) and ``nsteps`` the per-lane count of steps begun
    alive.

    ``checks`` is the JAX scan's sanitizer tier (``JPEG_TPU_CHECKS=2``,
    ``lockstep_jax.py:359-375``): a live lane that decodes an invalid
    symbol (no matching code, a DC category above 16, an AC run past 63)
    while at least 16 bits of its segment remain raises ``CorruptStream``
    ("sanitizer: ...") once the scan ends, where the production scan only
    kills the lane.
    """
    dev = words.device
    S = words.shape[0]
    k = _plan_tensors(plan, dev)
    vpad = ((plan.max_codes + 3) // 4) * 4
    bpm = plan.blocks_per_mcu
    # u32 words as int64, plus two zero columns: reads past a row's end
    # give 0, as the JAX engine's word select does.
    w64 = torch.nn.functional.pad(words.to(torch.int64) & 0xFFFFFFFF, (0, 2))
    wmax = w64.shape[1] - 2
    lanes = torch.arange(S, device=dev)
    ls = torch.arange(1, 17, device=dev)
    nb = nbits.to(torch.int64)

    def z(dtype=torch.int64):
        return torch.zeros(S, dtype=dtype, device=dev)

    bitpos, mcu, slot, coeff = z(), z(), z(), z()
    alive = nb > 0
    dc_pred = torch.zeros(plan.n_comps, S, dtype=torch.int32, device=dev)
    cur_diff = z(torch.int32)
    pend_key, pend_val = z(torch.int32), z(torch.int32)
    nsteps = z(torch.int32)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    keys, vals = [], []
    while bool(alive.any()):
        nsteps = nsteps + alive.to(torch.int32)
        # ---- 32-bit window at bitpos ---------------------------------
        widx = (bitpos >> 5).clamp(max=wmax)
        w0 = w64[lanes, widx]
        w1 = w64[lanes, widx + 1]
        r = bitpos & 31
        win = ((w0 << r) | (w1 >> (32 - r))) & 0xFFFFFFFF
        code16 = win >> 16

        # ---- canonical decode: first length with prefix <= maxcode ----
        is_dc = coeff == 0
        tab = torch.where(is_dc, k["slot_dc_tab"][slot], k["slot_ac_tab"][slot])
        ok = (code16[:, None] >> (16 - ls)[None, :]) <= k["maxcode"][tab][:, 1:]
        any_ok = ok.any(dim=1)
        length = torch.where(
            any_ok, ok.to(torch.int32).argmax(dim=1) + 1, 16
        )
        base = torch.where(any_ok, k["valptr"][tab, length], 0)
        minc = torch.where(any_ok, k["mincode"][tab, length], 0)
        pref = code16 >> (16 - length)
        vidx = (base + pref - minc).clamp(0, vpad - 1)
        value = k["huffval"][tab, vidx]

        # DC categories clamp to 16 for the shifts; a raw DC category
        # above 16 kills the lane.
        cat = torch.where(is_dc, value.clamp(max=16), value & 15)
        corrupt = (~any_ok) | (is_dc & (value > 16))
        need = length + cat
        overrun = bitpos + need > nb
        die = (~alive) | corrupt | overrun

        extra = (win >> (32 - need.clamp(max=32))) & ((1 << cat) - 1)
        sign = extra >> (cat - 1).clamp(min=0)
        neg = extra - (1 << cat) + 1
        coef_val = torch.where(
            cat == 0, 0, torch.where(sign != 0, extra, neg)
        ).to(torch.int32)

        # Lane-local MCU bound; interleaved DC of an out-of-range MCU dies.
        block_ok = mcu < plan.n_mcus
        comp = k["slot_comp"][slot]
        dc_null = (~die) & is_dc & (~block_ok) & plan.interleaved

        is_eob = (~is_dc) & (value == 0)
        zrl = torch.where(is_dc, 0, value >> 4)
        new_coeff = torch.where(is_dc, 1, coeff + zrl)
        ac_corrupt = (~die) & (~is_dc) & (~is_eob) & (new_coeff > 63)
        if checks:
            # Tail 1-padding legitimately fails the prefix match when
            # fewer than 16 bits remain: only a symbol that fits counts.
            fits = bitpos + 16 <= nb
            bad = bad | (alive & fits & (corrupt | ac_corrupt)).any()
        die = die | dc_null | ac_corrupt
        live = (~die) & alive

        # AC writes on their step; last step's pending DC flushes first.
        write = live & block_ok & (~is_dc) & (~is_eob)
        zz = k["zigzag"][new_coeff.clamp(0, 63)]
        key = torch.where(write, ((mcu << 4) | slot) * 64 + zz + 1, 0)
        key = key.to(torch.int32)
        flush = pend_key > 0
        keys.append(torch.where(flush, pend_key, key))
        vals.append(torch.where(flush, pend_val, coef_val))

        cur_diff = torch.where(live & is_dc, coef_val, cur_diff)
        after = torch.where(is_dc, 1, new_coeff + 1)
        block_done = live & (is_eob | (after >= 64))

        pred_here = dc_pred[comp, lanes]
        dc_new = pred_here + cur_diff  # int32: wraps like the JAX engine
        pend_key = torch.where(
            block_done & block_ok, ((mcu << 4) | slot) * 64 + 1, 0
        ).to(torch.int32)
        pend_val = dc_new
        dc_pred = dc_pred.clone()
        dc_pred[comp, lanes] = torch.where(block_done, dc_new, pred_here)

        next_slot = torch.where(block_done, slot + 1, slot)
        wrap = next_slot >= bpm
        mcu = torch.where(live, mcu + (block_done & wrap).to(torch.int64), mcu)
        slot = torch.where(live, torch.where(wrap, 0, next_slot), slot)
        coeff = torch.where(live, torch.where(block_done, 0, after), coeff)
        bitpos = torch.where(live, bitpos + need, nb)
        alive = live
    if checks and bool(bad):
        raise CorruptStream(
            "sanitizer: live lane hit an invalid Huffman symbol (bad "
            "prefix, DC category > 16, or AC run past 63) -- corrupt stream "
            "or kernel bug")
    if keys:
        em_key, em_val = torch.stack(keys), torch.stack(vals)
    else:
        em_key = em_val = torch.zeros(0, S, dtype=torch.int32, device=dev)
    return mcu.to(torch.int32), em_key, em_val, nsteps
