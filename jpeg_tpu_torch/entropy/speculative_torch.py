"""Plain PyTorch versions of the RST-less speculative decode kernels.

The engine (``entropy/speculative.py``) decodes an entropy-coded segment
that has no restart markers in parallel: the segment is cut into chunk
rows of ``cb`` bytes, and a decode started at a row's first bit with a
guessed block slot re-synchronizes with the true decode after a short
junk prefix (Huffman codes self-synchronize).  Two decodes that reach one
block-start state -- a bit position together with the block's slot in
the MCU, which picks its Huffman tables -- are identical from there on.
The final decode cuts each row further into ``P`` pieces of ``pb`` bytes.

These functions follow the CUDA kernels of ``csrc/decode_rstless.cu``
step for step, so that their outputs can be held to the kernels' bit for
bit; on CPU tensors the engine runs them.

* K8 ``sync_ref``: one lane per (row, variant), variant ``v`` starting at
  the row's first bit with slot ``v``.  The head walk records every block
  start inside the row's first ``strip`` bits in a membership map
  ``member[row, bit, slot] = max((ordinal << 4 | variant) + 1)``, marks
  the piece boundaries it passes, and stops at the lane's strip mark: the
  first block start at or after the strip's end (or where it dies, its
  final state).  A row's lanes with equal strip marks (bit and slot) are
  one decode from there on: the lowest is the group's survivor.  The
  tail walk runs the survivors only, from their strip marks through the
  row into its successor, and stops at the first block start that some
  successor variant also passed (a link), or, past the successor's
  strip, at a miss (it then reports its crossing: the first block start
  at or after the successor's first bit); the last row of a frame
  decodes to the segment's end.  On the way it marks, at each piece
  boundary ``j`` of the row, the first block start at or after
  ``row_start + j * pb`` (bit, slot, ordinal; ordinal ``MARK_NONE``
  where the walk stopped before).  Each member of a group takes its
  survivor's link and later marks, ordinals shifted by the difference of
  their ordinals at the strip mark.  -> ``links [R * bpm, NCOL]``:
  status, next bit, next slot, ordinal there, successor payload; ``marks
  [R * bpm, P - 1, MCOL]``: those of a walk of every lane from its row's
  first bit.
* K9 ``resolve_ref``: per frame, a walk from row 0, variant 0 (the true
  start, bit 0 slot 0) through the links, then a re-decode of every row
  whose true entry is known but whose authority is not (and of the rows
  after it while its decode misses again; a re-decode stops where its
  mark at a piece boundary is a K8 variant's too, and takes that
  variant's link), repeated until a walk leaves no row to re-decode or
  the frame reaches ``max_rounds``; then the frame's stats and the piece
  layout (``layout_ref``).  -> ``Resolved``.
* K10 ``final_ref``: each piece re-decodes exactly its blocks from its
  entry into their plane rows, with piece-local DC predictors; the
  per-frame, per-component prefix of the pieces' DC sums is then added to
  every block's DC, and a row is ok when all its pieces are.

All bit positions are frame-global: a row reads its frame's words at its
own offset, so a decode can run past its chunk when a block is longer
than a chunk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..device import upload
from .lockstep import ScanPlan
from .lockstep_torch import _plan_tensors
from .place_cuda import C_MAX, _slot_affinities, huffval_pad, kernel_m_x

# links columns (csrc/decode_rstless.cu has the same)
L_ST, L_BIT, L_SLOT, L_M, L_PAY = range(5)
NCOL = 5
ST_LINK, ST_MISS, ST_END = 0, 1, 2
# override table columns: valid, entry bit, entry slot, then a links row
O_VALID, O_BIT, O_SLOT = range(3)
OCOL = 3 + NCOL
# marks columns, and the ordinal of a boundary the walk did not reach
M_BIT, M_SLOT, M_ORD = range(3)
MCOL = 3
MARK_NONE = (1 << 31) - 1
# K8's group state of a lane (csrc GCOL): its strip mark (bit -1 where it
# ended in the strip), its ordinal there, and its group's survivor variant
# (-1 where it ended in the strip)
G_BIT, G_SLOT, G_ORD, G_SRV = range(4)
GCOL = 4
# K9's per-row outputs (rows of ``Resolved.row``): entry bit and slot,
# block count, state, the variant whose decode holds the row (-1: its
# override) and the row's first ordinal in it, the row's first block
# (frame-local)
R_BIT, R_SLOT, R_NBLK, R_STATE, R_SRC, R_K, R_G0 = range(7)
RCOL = 7
# K9's per-frame outputs (columns of ``Resolved.frame``): rounds (walks
# that left rows to re-decode), recovery rows, mispredicts, 1 where the
# frame reached max_rounds, 1 where the walk refused it
S_ROUNDS, S_RECOVERY, S_MISPREDICTS, S_UNRESOLVED, S_BAD = range(5)
SCOL = 5
# piece columns: entry bit, entry slot, first block (frame-local), count
P_BIT, P_SLOT, P_G, P_N = range(4)
PCOL = 4
# row states of the resolve walk
SETTLED, RECOVER, PENDING = 0, 1, 2


def n_pieces(cb_bits: int, piece_bits: int) -> int:
    """Pieces a chunk row of ``cb_bits`` is cut into (the last may be
    shorter)."""
    return -(-cb_bits // piece_bits)


def row_layout(sizes, chunk_bytes: int) -> np.ndarray:
    """Frame ECS byte sizes -> ``row0`` [F + 1] int64: frame f owns chunk
    rows ``row0[f] .. row0[f + 1] - 1`` (at least one row, even when its
    segment is empty)."""
    rows = [max(1, -(-int(n) // chunk_bytes)) for n in sizes]
    return np.concatenate(([0], np.cumsum(rows))).astype(np.int64)


def _consts(plan: ScanPlan, dev: torch.device) -> Dict[str, torch.Tensor]:
    k = _plan_tensors(plan, dev)
    c0, c1, c2, po, nb = _slot_affinities(plan)
    for name, a in (("c0", c0), ("c1", c1), ("c2", c2), ("blk_end", po + nb)):
        k[name] = torch.as_tensor(a, dtype=torch.int64, device=dev)
    return k


def _words64(words: torch.Tensor) -> torch.Tensor:
    """[F, wn] int32 big-endian words -> int64 u32 values with two zero
    columns: reads past a row's end give 0, as the kernels' word reads."""
    return torch.nn.functional.pad(words.to(torch.int64) & 0xFFFFFFFF, (0, 2))


def _symbol(plan: ScanPlan, k, w64, fr, bitpos, slot, coeff, nb):
    """Decode one Huffman symbol on every lane (the canonical compare;
    the kernels' 12-bit lookup table gives the same, see
    ``place_cuda.lookup_table``).  -> dict of per-lane results; ``dies``
    marks the death rules of the restart kernels: no code matches, a DC
    category above 16, a symbol past the segment's end, an AC run past
    coefficient 63."""
    wmax = w64.shape[1] - 2
    widx = (bitpos >> 5).clamp(max=wmax)
    w0 = w64[fr, widx]
    w1 = w64[fr, widx + 1]
    r = bitpos & 31
    win = ((w0 << r) | (w1 >> (32 - r))) & 0xFFFFFFFF
    code16 = win >> 16
    is_dc = coeff == 0
    tab = torch.where(is_dc, k["slot_dc_tab"][slot], k["slot_ac_tab"][slot])
    ls = torch.arange(1, 17, device=bitpos.device)
    ok = (code16[:, None] >> (16 - ls)[None, :]) <= k["maxcode"][tab][:, 1:]
    any_ok = ok.any(dim=1)
    length = torch.where(any_ok, ok.to(torch.int64).argmax(dim=1) + 1, 16)
    base = torch.where(any_ok, k["valptr"][tab, length], 0)
    minc = torch.where(any_ok, k["mincode"][tab, length], 0)
    vidx = (base + (code16 >> (16 - length)) - minc).clamp(
        0, huffval_pad(plan) - 1)
    value = k["huffval"][tab, vidx]
    cat = torch.where(is_dc, value.clamp(max=16), value & 15)
    need = length + cat
    extra = (win >> (32 - need.clamp(max=32))) & ((1 << cat) - 1)
    sign = extra >> (cat - 1).clamp(min=0)
    coef_val = torch.where(cat == 0, 0, torch.where(
        sign != 0, extra, extra - (1 << cat) + 1)).to(torch.int32)
    is_eob = (~is_dc) & (value == 0)
    new_coeff = torch.where(is_dc, 1, coeff + (value >> 4))
    dies = ((~any_ok) | (is_dc & (value > 16)) | (bitpos + need > nb)
            | ((~is_dc) & (~is_eob) & (new_coeff > 63)))
    after = torch.where(is_dc, 1, new_coeff + 1)
    return dict(is_dc=is_dc, is_eob=is_eob, need=need, coef_val=coef_val,
                new_coeff=new_coeff, after=after, dies=dies,
                done=is_eob | (after >= 64))


def _advance(plan, s, live, bitpos, slot, coeff, blk):
    """Move the live lanes past their symbol."""
    done = live & s["done"]
    nxt = slot + done.to(torch.int64)
    slot = torch.where(live, torch.where(nxt >= plan.blocks_per_mcu, 0, nxt),
                       slot)
    coeff = torch.where(live, torch.where(s["done"], 0, s["after"]), coeff)
    bitpos = torch.where(live, bitpos + s["need"], bitpos)
    return bitpos, slot, coeff, blk + done.to(torch.int64)


@dataclass(frozen=True)
class Rows:
    """The chunk rows of a batch: frame f owns rows ``row0[f] ..
    row0[f + 1] - 1``; per row (int64 [R] on the batch's device) its
    frame, its index in the frame, whether it is the frame's last and the
    frame's first row; ``r0`` and ``frame32`` are int32 copies of
    ``row0`` and ``frame`` on the device, for the kernels."""

    row0: np.ndarray  # [F + 1] int64, on the host
    frame: torch.Tensor
    local: torch.Tensor
    last: torch.Tensor
    first: torch.Tensor
    r0: torch.Tensor
    frame32: torch.Tensor

    @staticmethod
    def build(row0: np.ndarray, dev: torch.device) -> "Rows":
        """Compute on the host and upload in one copy."""
        row0 = np.asarray(row0, np.int64)
        counts = np.diff(row0)
        frame = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
        first = row0[:-1][frame]
        local = np.arange(row0[-1], dtype=np.int64) - first
        last = (local == counts[frame] - 1).astype(np.int64)
        t = upload(np.concatenate([frame, local, last, first, row0]), dev)
        R = frame.size
        return Rows(row0, t[:R], t[R:2 * R], t[2 * R:3 * R] > 0,
                    t[3 * R:4 * R], t[4 * R:].to(torch.int32),
                    t[:R].to(torch.int32))

    @property
    def R(self) -> int:
        return int(self.row0[-1])

    @property
    def F(self) -> int:
        return int(self.row0.size - 1)


class Resolved(NamedTuple):
    """K9's result, int32 tensors on the batch's device."""

    row: torch.Tensor     # [RCOL, R]: R_BIT .. R_G0
    frame: torch.Tensor   # [F, SCOL]: S_ROUNDS .. S_BAD
    pieces: torch.Tensor  # [R * P, PCOL]: P_BIT .. P_N


class Head(NamedTuple):
    """K8's head walk and grouping, on the batch's device."""

    member: torch.Tensor  # [R * strip_bits * bpm] int32
    links: torch.Tensor   # [R * bpm, NCOL] int32: final where G_SRV < 0
    marks: torch.Tensor   # [R * bpm, P - 1, MCOL] int32, up to the strip mark
    group: torch.Tensor   # [R * bpm, GCOL] int32


def _mark(marks, jn, new, bitpos, slot, blk, row_start, piece_bits, P):
    """Lanes ``new`` stand at a block start: mark their boundaries from
    ``jn`` (the next unmarked one) up to ``bitpos`` with (bit, slot,
    ordinal).  -> (updated jn, the marked lanes, the boundary count
    reached per lane)."""
    reach = (torch.div(bitpos - row_start, piece_bits, rounding_mode="floor")
             + 1).clamp(1, P)
    new = new & (reach > jn)
    li = new.nonzero().squeeze(1)
    if P > 1 and li.numel():
        js = torch.arange(1, P, device=bitpos.device)
        sel = (js[None, :] >= jn[li, None]) & (js[None, :] < reach[li, None])
        sub = marks[li]
        sub[sel] = torch.stack([bitpos, slot, blk], 1)[li][:, None, :] \
            .expand(-1, P - 1, -1)[sel]
        marks[li] = sub
    return torch.where(new, reach, jn), li, reach


def sync_head_ref(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                  rows: Rows, cb_bits: int, strip_bits: int,
                  piece_bits: int) -> Head:
    """K8's head walk and grouping: every lane decodes its row's strip
    into the membership map and its marks, to its strip mark or its
    death (then its links row is final: ST_END where it died); then each
    row's lanes are grouped by strip mark (bit, slot), the lowest variant
    of a group its survivor."""
    dev = words.device
    bpm = plan.blocks_per_mcu
    k = _consts(plan, dev)
    w64 = _words64(words)
    frame, local, R = rows.frame, rows.local, rows.R
    P = n_pieces(cb_bits, piece_bits)
    lane = torch.arange(R * bpm, device=dev)
    row, var = lane // bpm, lane % bpm
    fr = frame[row]
    nb = nbits.to(torch.int64)[fr]
    start = local[row] * cb_bits
    bitpos, slot = start.clone(), var.clone()
    coeff = torch.zeros_like(bitpos)
    blk = torch.zeros_like(bitpos)
    member = torch.zeros(R * strip_bits * bpm, dtype=torch.int32, device=dev)
    links = torch.zeros(R * bpm, NCOL, dtype=torch.int64, device=dev)
    marks = torch.full((R * bpm, P - 1, MCOL), -1, dtype=torch.int64,
                       device=dev)
    marks[:, :, M_ORD] = MARK_NONE
    jn = torch.ones_like(bitpos)
    at_mark = torch.zeros(R * bpm, dtype=torch.bool, device=dev)
    active = torch.ones_like(at_mark)
    while bool(active.any()):
        bs = active & (coeff == 0)
        jn, _, _ = _mark(marks, jn, bs, bitpos, slot, blk, start,
                         piece_bits, P)
        rel = bitpos - start
        stop = bs & (rel >= strip_bits)
        at_mark |= stop
        active = active & ~stop
        at = active & (coeff == 0)
        idx = (row * strip_bits + rel) * bpm + slot
        member.scatter_reduce_(0, idx[at], ((blk << 4 | var) + 1)[at]
                               .to(torch.int32), "amax")
        s = _symbol(plan, k, w64, fr, bitpos, slot, coeff, nb)
        dead = active & s["dies"]
        links[dead] = torch.stack([torch.full_like(bitpos, ST_END), bitpos,
                                   slot, blk, torch.full_like(bitpos, -1)],
                                  1)[dead]
        active = active & ~dead
        bitpos, slot, coeff, blk = _advance(plan, s, active, bitpos, slot,
                                            coeff, blk)
    # the group of each lane at its strip mark: the lowest variant of its
    # row with the same (bit, slot)
    mb = torch.where(at_mark, bitpos, -1).reshape(R, bpm)
    ms = torch.where(at_mark, slot, -1).reshape(R, bpm)
    same = (mb[:, :, None] == mb[:, None, :]) & \
        (ms[:, :, None] == ms[:, None, :])
    srv = torch.where(at_mark, same.reshape(R * bpm, bpm).to(torch.int64)
                      .argmax(1), -1)
    group = torch.stack([torch.where(at_mark, bitpos, -1),
                         torch.where(at_mark, slot, -1),
                         torch.where(at_mark, blk, 0), srv], 1)
    return Head(member, links.to(torch.int32), marks.to(torch.int32),
                group.to(torch.int32))


def tail_walk_ref(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                  rows: Rows, member: torch.Tensor, row: torch.Tensor,
                  start_bit: torch.Tensor, start_slot: torch.Tensor,
                  cb_bits: int, strip_bits: int, piece_bits: int,
                  splice=None, start_blk=None, start_j=None):
    """The tail walk of K8 and of K9's re-decode, for lanes starting at
    (``start_bit``, ``start_slot``) in chunk row ``row`` (int64 [n]), at
    ordinal ``start_blk`` (None: 0) with boundaries before ``start_j``
    (None: 1) already marked elsewhere (K8 resumes at a strip mark).
    ``splice`` (a re-decode: K8's (links, marks)): where a lane's last
    mark at a block start is also variant v's mark there (lowest v first),
    the lane takes v's links row and later marks, their ordinals shifted
    to its own block count, and stops.  -> ([n, NCOL] int32 links rows,
    [n, P - 1, MCOL] int32 marks; a boundary before ``start_j`` unmarked)."""
    dev = words.device
    bpm = plan.blocks_per_mcu
    k = _consts(plan, dev)
    w64 = _words64(words)
    frame, local, last_row = rows.frame, rows.local, rows.last
    fr = frame[row]
    nb = nbits.to(torch.int64)[fr]
    last = last_row[row]
    row_start = local[row] * cb_bits
    next_start = row_start + cb_bits
    n = row.numel()
    P = n_pieces(cb_bits, piece_bits)
    bitpos = start_bit.to(torch.int64).clone()
    slot = start_slot.to(torch.int64).clone()
    coeff = torch.zeros_like(bitpos)
    blk = torch.zeros_like(bitpos) if start_blk is None else \
        start_blk.to(torch.int64).clone()
    out = torch.zeros(n, NCOL, dtype=torch.int64, device=dev)
    out[:, L_PAY] = -1
    marks = torch.full((n, P - 1, MCOL), -1, dtype=torch.int64, device=dev)
    marks[:, :, M_ORD] = MARK_NONE
    jn = torch.ones(n, dtype=torch.int64, device=dev) if start_j is None \
        else start_j.to(torch.int64).clone()  # next boundary
    crossed = torch.zeros(n, dtype=torch.bool, device=dev)
    cross = torch.zeros(n, 3, dtype=torch.int64, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)

    def settle(mask, st, b, s_, m, pay):
        out[mask] = torch.stack([torch.full_like(b, st), b, s_, m, pay],
                                1)[mask]

    while bool(active.any()):
        # marks: every boundary j < P at or before a block start
        jn, li, reach = _mark(marks, jn, active & (coeff == 0), bitpos, slot,
                              blk, row_start, piece_bits, P)
        if P > 1 and splice is not None and li.numel():
            _splice(splice, bpm, P, row, li, reach[li] - 1, bitpos, slot,
                    blk, out, marks, active)
        rel = bitpos - next_start
        chk = active & (coeff == 0) & ~last & (rel >= 0)
        first = chk & ~crossed
        cross[first] = torch.stack([bitpos, slot, blk], 1)[first]
        crossed = crossed | first
        in_strip = chk & (rel < strip_bits)
        idx = ((row + 1) * strip_bits + rel.clamp(0, strip_bits - 1)) * bpm \
            + slot
        look = torch.where(in_strip, member[idx.clamp(0, member.numel() - 1)]
                           .to(torch.int64), 0)
        hit = in_strip & (look > 0)
        settle(hit, ST_LINK, bitpos, slot, blk, look - 1)
        miss = chk & (rel >= strip_bits)
        settle(miss, ST_MISS, cross[:, 0], cross[:, 1], cross[:, 2],
               torch.full_like(bitpos, -1))
        active = active & ~hit & ~miss
        s = _symbol(plan, k, w64, fr, bitpos, slot, coeff, nb)
        dead = active & s["dies"]
        settle(dead, ST_END, bitpos, slot, blk, torch.full_like(bitpos, -1))
        active = active & ~dead
        bitpos, slot, coeff, blk = _advance(plan, s, active, bitpos, slot,
                                            coeff, blk)
    return out.to(torch.int32), marks.to(torch.int32)


def _splice(splice, bpm: int, P: int, row, li, jr, bitpos, slot, blk, out,
            marks, active) -> None:
    """Lanes ``li`` just marked boundaries up to ``jr`` (>= 1) at a block
    start: those whose mark there is also a variant's mark of their row
    take that variant's links row and marks after ``jr`` (ordinals shifted
    by the lanes' block count less the variant's ordinal there) and stop
    (``out``, ``marks`` and ``active`` in place)."""
    links8, marks8 = splice
    vmarks = marks8.to(torch.int64).reshape(-1, bpm, P - 1, MCOL)[row[li]]
    at = vmarks[torch.arange(li.numel(), device=li.device), :, jr - 1]
    hit = (at[:, :, M_BIT] == bitpos[li, None]) & \
        (at[:, :, M_SLOT] == slot[li, None])
    has = hit.any(1)
    if not bool(has.any()):
        return
    sel = has.nonzero().squeeze(1)
    lanes = li[sel]
    v = hit[sel].to(torch.int64).argmax(1)  # the lowest matching variant
    shift = blk[lanes] - at[sel, v, M_ORD]
    lk = links8.to(torch.int64).reshape(-1, bpm, NCOL)[row[lanes], v]
    out[lanes] = torch.stack([lk[:, L_ST], lk[:, L_BIT], lk[:, L_SLOT],
                              lk[:, L_M] + shift, lk[:, L_PAY]], 1)
    vm = vmarks[sel, v]  # [s, P - 1, MCOL]
    vm[:, :, M_ORD] = torch.where(vm[:, :, M_ORD] == MARK_NONE, MARK_NONE,
                                  vm[:, :, M_ORD] + shift[:, None])
    after = torch.arange(1, P, device=li.device)[None, :] > jr[sel, None]
    sub = marks[lanes]
    sub[after] = vm[after]
    marks[lanes] = sub
    active[lanes] = False


def sync_tail_ref(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                  rows: Rows, head: Head, cb_bits: int, strip_bits: int,
                  piece_bits: int):
    """K8's tail walk: each survivor resumes at its strip mark; every
    member of its group takes its links row and its marks after the strip
    mark, ordinals shifted by the member's ordinal less the survivor's
    there.  -> (links [R * bpm, NCOL] int32, marks [R * bpm, P - 1, MCOL]
    int32)."""
    dev = words.device
    bpm = plan.blocks_per_mcu
    g = head.group.to(torch.int64)
    lane = torch.arange(g.shape[0], device=dev)
    row = lane // bpm
    srv = g[:, G_SRV]
    sv = (srv == lane % bpm).nonzero().squeeze(1)
    start = rows.local[row[sv]] * cb_bits
    j0 = (torch.div(g[sv, G_BIT] - start, piece_bits, rounding_mode="floor")
          + 1).clamp(max=n_pieces(cb_bits, piece_bits))
    t_links, t_marks = tail_walk_ref(
        plan, words, nbits, rows, head.member, row[sv], g[sv, G_BIT],
        g[sv, G_SLOT], cb_bits, strip_bits, piece_bits,
        start_blk=g[sv, G_ORD], start_j=j0)
    links = head.links.to(torch.int64).clone()
    marks = head.marks.to(torch.int64).clone()
    pos = torch.full((lane.numel(),), -1, dtype=torch.int64, device=dev)
    pos[sv] = torch.arange(sv.numel(), device=dev)
    mem = (srv >= 0).nonzero().squeeze(1)  # survivors and members
    at = pos[row[mem] * bpm + srv[mem]]  # their survivor's tail walk
    shift = g[mem, G_ORD] - g[row[mem] * bpm + srv[mem], G_ORD]
    lk = t_links[at].to(torch.int64)
    lk[:, L_M] += shift
    links[mem] = lk
    mk = t_marks[at].to(torch.int64)
    after = torch.arange(1, mk.shape[1] + 1, device=dev)[None, :] >= \
        j0[at][:, None]
    mk[:, :, M_ORD] = torch.where(mk[:, :, M_ORD] == MARK_NONE, MARK_NONE,
                                  mk[:, :, M_ORD] + shift[:, None])
    sub = marks[mem]
    sub[after] = mk[after]
    marks[mem] = sub
    return links.to(torch.int32), marks.to(torch.int32)


def sync_ref(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
             rows: Rows, cb_bits: int, strip_bits: int, piece_bits: int):
    """Plain K8: -> (links [R * bpm, NCOL] int32, member [R * strip_bits *
    bpm] int32, marks [R * bpm, P - 1, MCOL] int32)."""
    head = sync_head_ref(plan, words, nbits, rows, cb_bits, strip_bits,
                         piece_bits)
    links, marks = sync_tail_ref(plan, words, nbits, rows, head, cb_bits,
                                 strip_bits, piece_bits)
    return links, head.member, marks


def walk_frames(links: np.ndarray, ovr: np.ndarray, rows: Rows,
                bpm: int, cb_bits: int) -> Dict[str, np.ndarray]:
    """K9's walk over each frame's rows (numpy, the kernel's algorithm).

    Row 0 of a frame enters at (bit 0, slot 0) through variant 0.  A row
    entered through a link uses the linked variant's row of ``links``
    (its ordinal at the entry, ``k``, came with the link); a row entered
    by a handoff (its predecessor's crossing) takes its override when one
    was decoded from that entry, and otherwise needs a re-decode
    (RECOVER): the walk goes on optimistically through the row's
    majority link (ties: lowest variant), or stops the frame (PENDING)
    when no variant linked.  A row whose entry lies past its chunk is
    empty; after a row whose decode ended, every row is empty.  -> int64
    arrays: per row ``f_bit``, ``f_slot``, ``nblk``, ``state``, ``src``
    (-1: the override) and ``k`` (the decode and ordinal that hold the
    row's blocks; 0, 0 for a row without them) and ``g0`` (the blocks of
    the frame's rows before it); per frame ``bad`` and ``nrec`` (RECOVER
    rows).
    """
    row0 = rows.row0
    R, F = rows.R, rows.F
    out = {name: np.zeros(R, np.int64) for name in
           ("f_bit", "f_slot", "nblk", "state", "src", "k", "g0")}
    bad = np.zeros(F, np.int64)
    nrec = np.zeros(F, np.int64)
    lk = links.reshape(R, bpm, NCOL).astype(np.int64)
    for f in range(F):
        e_bit = e_slot = src = k = gsum = 0
        handoff = ended = blocked = False
        for i, q in enumerate(range(row0[f], row0[f + 1])):
            out["g0"][q] = gsum
            if blocked:
                out["state"][q] = PENDING
                continue
            out["f_bit"][q], out["f_slot"][q] = e_bit, e_slot
            if ended or e_bit >= (i + 1) * cb_bits:
                continue  # an empty row
            o = ovr[q]
            from_ovr = False
            if o[O_VALID] and o[O_BIT] == e_bit and o[O_SLOT] == e_slot:
                rec, k, from_ovr = o[3:], 0, True
            elif not handoff:
                rec = lk[q, src]
            else:
                out["state"][q] = RECOVER
                nrec[f] += 1
                votes: Dict[Tuple[int, int, int], list] = {}
                for w in range(bpm):  # the vote: (next bit, slot, payload)
                    if lk[q, w, L_ST] == ST_LINK:
                        key = (int(lk[q, w, L_BIT]), int(lk[q, w, L_SLOT]),
                               int(lk[q, w, L_PAY]))
                        votes.setdefault(key, [0, w])[0] += 1
                if not votes:
                    blocked = True
                    continue
                best = max(votes.values(), key=lambda c: (c[0], -c[1]))
                rec = lk[q, best[1]]
                e_bit, e_slot = int(rec[L_BIT]), int(rec[L_SLOT])
                src, k = int(rec[L_PAY]) & 15, int(rec[L_PAY]) >> 4
                handoff = False
                continue
            n = int(rec[L_M]) - k
            if n < 0:
                bad[f] = 1
                blocked = True
                out["state"][q] = PENDING
                continue
            out["nblk"][q] = n
            out["src"][q] = -1 if from_ovr else src
            out["k"][q] = k
            gsum += n
            e_bit, e_slot = int(rec[L_BIT]), int(rec[L_SLOT])
            if rec[L_ST] == ST_LINK:
                src, k = int(rec[L_PAY]) & 15, int(rec[L_PAY]) >> 4
                handoff = False
            elif rec[L_ST] == ST_MISS:
                k, handoff = 0, True
            else:
                ended = True
    out["bad"] = bad
    out["nrec"] = nrec
    return out


def walk_ref(links: torch.Tensor, ovr: torch.Tensor, rows: Rows,
             bpm: int, cb_bits: int):
    """One K9 walk on any device: -> (f_bit, f_slot, nblk, state [R],
    frame_bad [F], n_rec [1]) int32 tensors on the links' device."""
    dev = links.device
    w = walk_frames(links.cpu().numpy(), ovr.cpu().numpy(), rows, bpm,
                    cb_bits)
    return (*(torch.from_numpy(w[n].astype(np.int32)).to(dev) for n in
              ("f_bit", "f_slot", "nblk", "state", "bad")),
            torch.tensor([int(w["nrec"].sum())], dtype=torch.int32,
                         device=dev))


def recover_ref(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                rows: Rows, member: torch.Tensor, links: torch.Tensor,
                marks: torch.Tensor, walk: Dict[str, np.ndarray],
                start: np.ndarray, ovr: np.ndarray, ovr_marks: np.ndarray,
                cb_bits: int, strip_bits: int, piece_bits: int) -> None:
    """Plain K9 re-decode of the rows where ``start`` is set (RECOVER
    rows of the walk ``walk``): each one's tail walk from its entry,
    spliced onto K8's variants (``links``, ``marks``) where it meets one,
    with its marks, written into its override row (``ovr``,
    ``ovr_marks``, numpy, in place); a re-decode that misses again goes on
    in the row that holds its crossing, unless a row up to that one is
    RECOVER itself (its own chain owns it)."""
    dev = words.device
    st_np = walk["state"]
    frame = rows.frame.cpu().numpy()
    idx = np.flatnonzero(start)
    bits = walk["f_bit"][idx]
    slots = walk["f_slot"][idx]
    while idx.size:
        res, mk = tail_walk_ref(plan, words, nbits, rows, member,
                                torch.from_numpy(idx).to(dev),
                                torch.from_numpy(bits).to(dev),
                                torch.from_numpy(slots).to(dev), cb_bits,
                                strip_bits, piece_bits, (links, marks))
        res = res.cpu().numpy()
        ovr[idx] = np.concatenate([np.ones((idx.size, 1), np.int64),
                                   np.stack([bits, slots], 1), res], 1)
        ovr_marks[idx] = mk.cpu().numpy()
        nxt = []
        for i, r in enumerate(res):
            if r[L_ST] != ST_MISS:
                continue
            q, f = int(idx[i]), int(frame[idx[i]])
            q2 = int(rows.row0[f]) + int(r[L_BIT]) // cb_bits
            if q2 < rows.row0[f + 1] and not (st_np[q + 1 : q2 + 1]
                                              == RECOVER).any():
                nxt.append((q2, int(r[L_BIT]), int(r[L_SLOT])))
        idx = np.array([n[0] for n in nxt], np.int64)
        bits = np.array([n[1] for n in nxt], np.int64)
        slots = np.array([n[2] for n in nxt], np.int64)


def layout_ref(row: torch.Tensor, marks: torch.Tensor,
               ovr_marks: torch.Tensor, bpm: int, P: int) -> torch.Tensor:
    """The piece layout at the end of K9: -> pieces [R * P, PCOL] int32.

    A row's blocks are ordinals ``[k, k + nblk)`` of the decode that holds
    it (variant ``src``'s row of ``marks``, or its override's marks), so a
    mark whose ordinal lies in that range is a true block start.  Piece j
    runs from boundary j to boundary j + 1, each the mark's ordinal
    clamped into the range (boundary 0 is the row's entry, boundary P its
    end); a piece that starts at ``k`` enters at the row's entry, any
    other at its mark."""
    R = row.shape[1]
    r = row.to(torch.int64)
    kk, n, src = r[R_K], r[R_NBLK], r[R_SRC]
    q = torch.arange(R, device=row.device)
    mk = torch.where((src >= 0)[:, None, None],
                     marks.to(torch.int64).reshape(R, bpm, P - 1, MCOL)[
                         q, src.clamp(min=0)],
                     ovr_marks.to(torch.int64))
    end = (kk + n)[:, None]
    inner = torch.minimum(torch.maximum(mk[:, :, M_ORD], kk[:, None]), end)
    bnd = torch.cat([kk[:, None], inner, end], 1)  # [R, P + 1]
    lo, hi = bnd[:, :-1], bnd[:, 1:]
    entry = lo == kk[:, None]
    bit = torch.where(entry, r[R_BIT][:, None],
                      torch.cat([r[R_BIT][:, None], mk[:, :, M_BIT]], 1))
    slot = torch.where(entry, r[R_SLOT][:, None],
                       torch.cat([r[R_SLOT][:, None], mk[:, :, M_SLOT]], 1))
    g = r[R_G0][:, None] + lo - kk[:, None]
    return torch.stack([bit, slot, g, hi - lo], -1).reshape(R * P, PCOL) \
        .to(torch.int32)


def resolve_ref(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                rows: Rows, links: torch.Tensor, member: torch.Tensor,
                marks: torch.Tensor, cb_bits: int, strip_bits: int,
                piece_bits: int, max_rounds: int) -> Resolved:
    """Plain K9: the rounds of every frame (walk; stop the frame when the
    walk counts no RECOVER row, or at ``max_rounds`` such walks; else
    re-decode them), in one loop over the batch; a frame that has stopped
    keeps its override rows, so its later walks repeat its last.  Then
    each frame's mispredicts (rows its first walk settled at an entry the
    last walk does not keep; counted only when the frame resolved after a
    re-decode) and the piece layout."""
    dev = words.device
    bpm = plan.blocks_per_mcu
    R, F = rows.R, rows.F
    P = n_pieces(cb_bits, piece_bits)
    lk = links.cpu().numpy()
    frame = rows.frame.cpu().numpy()
    ovr = np.zeros((R, OCOL), np.int64)
    ovr_marks = np.zeros((R, P - 1, MCOL), np.int64)
    rounds = np.zeros(F, np.int64)
    rec = np.zeros(F, np.int64)
    unresolved = np.zeros(F, np.int64)
    done = np.zeros(F, bool)
    first = None
    while True:
        w = walk_frames(lk, ovr, rows, bpm, cb_bits)
        if first is None:
            first = w
        more = ~done & (w["nrec"] > 0)
        rounds += more
        rec += np.where(more, w["nrec"], 0)
        hit = more & (rounds >= max_rounds)
        unresolved[hit] = 1
        done |= ~more | hit
        if done.all():
            break
        recover_ref(plan, words, nbits, rows, member, links, marks, w,
                    (w["state"] == RECOVER) & ~done[frame], ovr, ovr_marks,
                    cb_bits, strip_bits, piece_bits)
    moved = (first["state"] == SETTLED) & (
        (first["f_bit"] != w["f_bit"]) | (first["f_slot"] != w["f_slot"]))
    mis = np.bincount(frame, weights=moved, minlength=F).astype(np.int64)
    mis[(rounds == 0) | (unresolved == 1)] = 0
    row = torch.from_numpy(np.stack([
        w[n] for n in ("f_bit", "f_slot", "nblk", "state", "src", "k", "g0")
    ]).astype(np.int32)).to(dev)
    stats = torch.from_numpy(np.stack(
        [rounds, rec, mis, unresolved, w["bad"]], 1).astype(np.int32)).to(dev)
    pieces = layout_ref(row, marks, torch.from_numpy(ovr_marks).to(dev), bpm,
                        P)
    return Resolved(row, stats, pieces)


def frame_prefix(x: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Per-frame exclusive prefix sum of ``x`` [N] or [N, C] (int32,
    wrapping like the kernels' int32 sums); ``first`` [N] is the index of
    the first element of each element's frame."""
    excl = x.to(torch.int64).cumsum(0) - x.to(torch.int64)
    out = excl - excl[first]
    return ((out + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _placement(plan: ScanPlan, k, gblk, slot, frame, total_blocks):
    """Frame-local block ordinal -> (flat offset of coefficient 0, valid)
    with the restart kernels' affinities (``place_cuda.kernel_tables``)."""
    mcu = gblk // plan.blocks_per_mcu
    m_x = kernel_m_x(plan)
    my = mcu // m_x
    rel = k["c0"][slot] + my * k["c1"][slot] + (mcu - my * m_x) * k["c2"][slot]
    valid = (mcu < plan.n_mcus) & (rel < k["blk_end"][slot])
    return (frame * total_blocks + rel) * 64, valid


def _piece_frames(rows: Rows, pieces: torch.Tensor) -> Tuple[int, torch.Tensor]:
    """-> (pieces a row, each piece's row)."""
    P = pieces.shape[0] // rows.R
    return P, torch.arange(pieces.shape[0], device=pieces.device) // P


def final_walk_ref(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                   rows: Rows, pieces: torch.Tensor, total_blocks: int):
    """K10's walk, a lane per piece, each block written whole when it
    completes (a block a lane dies in is not written): -> (coeffs [F *
    total_blocks, 64] int32 with piece-local DC, dc_sum [R * P, C_MAX]
    int32 (each piece's last local DC per component), ok [R * P] int32: 0
    where a piece with blocks died before its last block or its entry
    slot is not its first block's slot, ``g % bpm``)."""
    dev = words.device
    bpm = plan.blocks_per_mcu
    k = _consts(plan, dev)
    w64 = _words64(words)
    _, prow = _piece_frames(rows, pieces)
    frame = rows.frame[prow]
    N = pieces.shape[0]
    out = torch.zeros(rows.F * total_blocks, 64, dtype=torch.int32,
                      device=dev)
    buf = torch.zeros(pieces.shape[0], 64, dtype=torch.int32, device=dev)
    e = pieces.to(torch.int64)
    n, g = e[:, P_N], e[:, P_G]
    slot = e[:, P_SLOT].clone()
    ok = ~((n > 0) & (g % bpm != slot))
    active = (n > 0) & ok
    nb = nbits.to(torch.int64)[frame]
    bitpos = e[:, P_BIT].clone()
    coeff = torch.zeros(N, dtype=torch.int64, device=dev)
    blk = torch.zeros_like(coeff)
    pred = torch.zeros(N, C_MAX, dtype=torch.int32, device=dev)
    cur = torch.zeros(N, dtype=torch.int32, device=dev)
    lanes = torch.arange(N, device=dev)
    while bool(active.any()):
        s = _symbol(plan, k, w64, frame, bitpos, slot, coeff, nb)
        dead = active & s["dies"]
        ok = ok & ~dead
        live = active & ~dead
        dst, valid = _placement(plan, k, g + blk, slot, frame, total_blocks)
        ac = live & ~s["is_dc"] & ~s["is_eob"]
        pos = k["zigzag"][s["new_coeff"].clamp(0, 63)]
        buf[lanes[ac], pos[ac]] = s["coef_val"][ac]
        cur = torch.where(live & s["is_dc"], s["coef_val"], cur)
        done = live & s["done"]
        comp = k["slot_comp"][slot]
        dc = pred[lanes, comp] + cur
        put = done & valid
        buf[put, 0] = dc[put]
        out[dst[put] // 64] = buf[put]
        buf[done] = 0
        pred[lanes[done], comp[done]] = dc[done]
        bitpos, slot, coeff, blk = _advance(plan, s, live, bitpos, slot,
                                            coeff, blk)
        active = live & (blk < n)
    return out, pred, ok.to(torch.int32)


def dc_fix_ref(plan: ScanPlan, coeffs: torch.Tensor, rows: Rows,
               pieces: torch.Tensor, base: torch.Tensor,
               total_blocks: int) -> torch.Tensor:
    """K10's DC pass: add each piece's DC base (``base`` [R * P, C_MAX],
    the per-frame exclusive prefix of the pieces' ``dc_sum``) to
    coefficient 0 of each of its placed blocks.  -> the updated
    coefficients."""
    dev = coeffs.device
    k = _consts(plan, dev)
    _, prow = _piece_frames(rows, pieces)
    n = pieces[:, P_N].to(torch.int64)
    pc = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n)
    start = torch.repeat_interleave(n.cumsum(0) - n, n)
    gblk = pieces[:, P_G].to(torch.int64)[pc] + torch.arange(
        pc.numel(), device=dev) - start
    slot = gblk % plan.blocks_per_mcu
    dst, valid = _placement(plan, k, gblk, slot, rows.frame[prow[pc]],
                            total_blocks)
    flat = coeffs.reshape(-1).clone()
    add = base[pc, k["slot_comp"][slot]]
    flat[dst[valid]] += add[valid]
    return flat.reshape(-1, 64)


def final_ref(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
              rows: Rows, pieces: torch.Tensor, total_blocks: int):
    """Plain K10: the piece walk, the DC prefix over each frame's pieces,
    the DC pass.  -> (coeffs [F * total_blocks, 64] int32, ok [R] int32:
    1 where every piece of the row is ok)."""
    P, prow = _piece_frames(rows, pieces)
    coeffs, dc_sum, ok = final_walk_ref(plan, words, nbits, rows, pieces,
                                        total_blocks)
    base = frame_prefix(dc_sum, rows.first[prow] * P)
    return (dc_fix_ref(plan, coeffs, rows, pieces, base, total_blocks),
            ok.reshape(rows.R, P).amin(1))
