"""Plain PyTorch versions of the RST-less speculative decode kernels.

The engine (``entropy/speculative.py``) decodes an entropy-coded segment
that has no restart markers in parallel: the segment is cut into chunk
rows of ``cb`` bytes, and a decode started at a row's first bit with a
guessed block slot re-synchronizes with the true decode after a short
junk prefix (Huffman codes self-synchronize).  Two decodes that reach one
block-start state -- a bit position together with the block's slot in
the MCU, which picks its Huffman tables -- are identical from there on.

These functions follow the CUDA kernels of ``csrc/decode_rstless.cu``
step for step, so that their intermediate outputs can be held to the
kernels' bit for bit; on CPU tensors the engine runs them.

* K8 ``sync_ref``: one lane per (row, variant), variant ``v`` starting at
  the row's first bit with slot ``v``.  The head walk records every block
  start inside the row's first ``strip`` bits in a membership map
  ``member[row, bit, slot] = max((ordinal << 4 | variant) + 1)``.  The
  tail walk decodes through the row into its successor and stops at the
  first block start that some successor variant also passed (a link),
  or, past the successor's strip, at a miss (it then reports its
  crossing: the first block start at or after the successor's first
  bit); the last row of a frame decodes to the segment's end.  ->
  ``links [R * bpm, NCOL]``: status, next bit, next slot, ordinal there,
  successor payload.
* K9 ``resolve_ref``: a walk per frame from row 0, variant 0 (the true
  start, bit 0 slot 0) through the links, then a re-decode (``recover``)
  of every row whose true entry is known but whose authority is not (and
  of the rows after it while its decode misses again), repeated until no
  row needs one.  -> each row's entry bit and slot and
  its block count.
* K10 ``final_ref``: each row re-decodes exactly its blocks from its
  entry into their plane rows (block ordinal ``g0`` from a per-frame
  prefix of the counts), with row-local DC predictors; the per-frame,
  per-component prefix of the rows' DC sums is then added to every
  block's DC.

All bit positions are frame-global: a row reads its frame's words at its
own offset, so a decode can run past its chunk when a block is longer
than a chunk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

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
# row states of the resolve walk
SETTLED, RECOVER, PENDING = 0, 1, 2


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
        t = torch.from_numpy(np.concatenate(
            [frame, local, last, first, row0])).to(dev)
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


def sync_head_ref(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                  rows: Rows, cb_bits: int,
                  strip_bits: int) -> torch.Tensor:
    """K8's head walk: -> member [R * strip_bits * bpm] int32."""
    dev = words.device
    bpm = plan.blocks_per_mcu
    k = _consts(plan, dev)
    w64 = _words64(words)
    frame, local, R = rows.frame, rows.local, rows.R
    lane = torch.arange(R * bpm, device=dev)
    row, var = lane // bpm, lane % bpm
    fr = frame[row]
    nb = nbits.to(torch.int64)[fr]
    start = local[row] * cb_bits
    bitpos, slot = start.clone(), var.clone()
    coeff = torch.zeros_like(bitpos)
    blk = torch.zeros_like(bitpos)
    member = torch.zeros(R * strip_bits * bpm, dtype=torch.int32, device=dev)
    alive = torch.ones_like(bitpos, dtype=torch.bool)
    while True:
        rel = bitpos - start
        alive = alive & (rel < strip_bits)
        if not bool(alive.any()):
            break
        at = alive & (coeff == 0)
        idx = (row * strip_bits + rel) * bpm + slot
        member.scatter_reduce_(0, idx[at], ((blk << 4 | var) + 1)[at]
                               .to(torch.int32), "amax")
        s = _symbol(plan, k, w64, fr, bitpos, slot, coeff, nb)
        alive = alive & ~s["dies"]
        bitpos, slot, coeff, blk = _advance(plan, s, alive, bitpos, slot,
                                            coeff, blk)
    return member


def tail_walk_ref(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                  rows: Rows, member: torch.Tensor, row: torch.Tensor,
                  start_bit: torch.Tensor, start_slot: torch.Tensor,
                  cb_bits: int, strip_bits: int) -> torch.Tensor:
    """The tail walk of K8 and of K9's re-decode, for lanes starting at
    (``start_bit``, ``start_slot``) in chunk row ``row`` (int64 [n]).
    -> [n, NCOL] int32 links rows."""
    dev = words.device
    bpm = plan.blocks_per_mcu
    k = _consts(plan, dev)
    w64 = _words64(words)
    frame, local, last_row = rows.frame, rows.local, rows.last
    fr = frame[row]
    nb = nbits.to(torch.int64)[fr]
    last = last_row[row]
    next_start = (local[row] + 1) * cb_bits
    n = row.numel()
    bitpos = start_bit.to(torch.int64).clone()
    slot = start_slot.to(torch.int64).clone()
    coeff = torch.zeros_like(bitpos)
    blk = torch.zeros_like(bitpos)
    out = torch.zeros(n, NCOL, dtype=torch.int64, device=dev)
    out[:, L_PAY] = -1
    crossed = torch.zeros(n, dtype=torch.bool, device=dev)
    cross = torch.zeros(n, 3, dtype=torch.int64, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)

    def settle(mask, st, b, s_, m, pay):
        out[mask] = torch.stack([torch.full_like(b, st), b, s_, m, pay],
                                1)[mask]

    while bool(active.any()):
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
    return out.to(torch.int32)


def sync_ref(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
             rows: Rows, cb_bits: int, strip_bits: int):
    """Plain K8: -> (links [R * bpm, NCOL] int32, member [R * strip_bits *
    bpm] int32)."""
    dev = words.device
    bpm = plan.blocks_per_mcu
    member = sync_head_ref(plan, words, nbits, rows, cb_bits, strip_bits)
    local = rows.local
    lane = torch.arange(local.numel() * bpm, device=dev)
    row = lane // bpm
    links = tail_walk_ref(plan, words, nbits, rows, member, row,
                          local[row] * cb_bits, lane % bpm, cb_bits,
                          strip_bits)
    return links, member


def walk_frames(links: np.ndarray, ovr: np.ndarray, rows: Rows,
                bpm: int, cb_bits: int):
    """K9's walk over each frame's rows (numpy, the kernel's algorithm).

    Row 0 of a frame enters at (bit 0, slot 0) through variant 0.  A row
    entered through a link uses the linked variant's row of ``links``
    (its ordinal at the entry, ``k``, came with the link); a row entered
    by a handoff (its predecessor's crossing) takes its override when one
    was decoded from that entry, and otherwise needs a re-decode
    (RECOVER): the walk goes on optimistically through the row's
    majority link (ties: lowest variant), or stops the frame (PENDING)
    when no variant linked.  A row whose entry lies past its chunk is
    empty; after a row whose decode ended, every row is empty.  ->
    (f_bit, f_slot, nblk, state [R] int32, frame_bad [F] int32, number of
    RECOVER rows).
    """
    row0 = rows.row0
    R = rows.R
    f_bit = np.zeros(R, np.int64)
    f_slot = np.zeros(R, np.int64)
    nblk = np.zeros(R, np.int64)
    state = np.zeros(R, np.int64)
    bad = np.zeros(row0.size - 1, np.int64)
    n_rec = 0
    lk = links.reshape(R, bpm, NCOL).astype(np.int64)
    for f in range(row0.size - 1):
        e_bit = e_slot = src = k = 0
        handoff = ended = blocked = False
        for i, q in enumerate(range(row0[f], row0[f + 1])):
            if blocked:
                state[q] = PENDING
                continue
            f_bit[q], f_slot[q] = e_bit, e_slot
            if ended or e_bit >= (i + 1) * cb_bits:
                continue  # an empty row
            o = ovr[q]
            if o[O_VALID] and o[O_BIT] == e_bit and o[O_SLOT] == e_slot:
                rec, k = o[3:], 0
            elif not handoff:
                rec = lk[q, src]
            else:
                state[q] = RECOVER
                n_rec += 1
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
                state[q] = PENDING
                continue
            nblk[q] = n
            e_bit, e_slot = int(rec[L_BIT]), int(rec[L_SLOT])
            if rec[L_ST] == ST_LINK:
                src, k = int(rec[L_PAY]) & 15, int(rec[L_PAY]) >> 4
                handoff = False
            elif rec[L_ST] == ST_MISS:
                k, handoff = 0, True
            else:
                ended = True
    return (f_bit.astype(np.int32), f_slot.astype(np.int32),
            nblk.astype(np.int32), state.astype(np.int32),
            bad.astype(np.int32), n_rec)


def walk_ref(links: torch.Tensor, ovr: torch.Tensor, rows: Rows,
             bpm: int, cb_bits: int):
    """Plain K9 walk on any device: -> (f_bit, f_slot, nblk, state [R],
    frame_bad [F], n_rec [1]) int32 tensors on the links' device."""
    dev = links.device
    out = walk_frames(links.cpu().numpy(), ovr.cpu().numpy(), rows, bpm,
                      cb_bits)
    *arrs, n_rec = out
    return (*(torch.from_numpy(a).to(dev) for a in arrs),
            torch.tensor([n_rec], dtype=torch.int32, device=dev))


def recover_ref(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                rows: Rows, member: torch.Tensor, f_bit: torch.Tensor,
                f_slot: torch.Tensor, state: torch.Tensor, ovr: torch.Tensor,
                cb_bits: int, strip_bits: int) -> torch.Tensor:
    """Plain K9 re-decode: every RECOVER row's tail walk from its entry,
    written into its override row; a re-decode that misses again goes on
    in the row that holds its crossing, unless a row up to that one is
    RECOVER itself (its own chain owns it).  -> the updated ``ovr`` [R,
    OCOL]."""
    ovr = ovr.clone()
    st_np = state.cpu().numpy()
    frame = rows.frame.cpu().numpy()
    idx = np.flatnonzero(st_np == RECOVER)
    bits = f_bit.cpu().numpy()[idx]
    slots = f_slot.cpu().numpy()[idx]
    while idx.size:
        t_idx = torch.from_numpy(idx).to(ovr.device)
        res = tail_walk_ref(plan, words, nbits, rows, member, t_idx,
                            torch.from_numpy(bits).to(ovr.device),
                            torch.from_numpy(slots).to(ovr.device), cb_bits,
                            strip_bits)
        ovr[t_idx] = torch.cat([
            torch.ones(idx.size, 1, dtype=torch.int32, device=ovr.device),
            torch.from_numpy(np.stack([bits, slots], 1)).to(ovr.device),
            res], 1)
        nxt = []
        for i, r in enumerate(res.cpu().numpy()):
            if r[L_ST] != ST_MISS:
                continue
            q, f = int(idx[i]), int(frame[idx[i]])
            q2 = int(rows.row0[f]) + int(r[L_BIT]) // cb_bits
            if q2 < rows.row0[f + 1] and not (st_np[q + 1 : q2 + 1]
                                              == RECOVER).any():
                nxt.append((q2, int(r[L_BIT]), int(r[L_SLOT])))
        idx = np.array([n[0] for n in nxt], np.int64)
        bits = np.array([n[1] for n in nxt], np.int32)
        slots = np.array([n[2] for n in nxt], np.int32)
    return ovr


def resolve_loop(walk, recover, R: int, dev: torch.device, max_rounds: int):
    """K9's round loop, shared by the kernel wrapper and the plain version:
    walk; stop when no row needs a re-decode (one host read of the count
    per round); else re-decode those rows and walk again.  -> (f_bit,
    f_slot, nblk, state, frame_bad, stats) with stats (rounds, recovery
    rows, mispredicts); ``None`` in place of the arrays when
    ``max_rounds`` walks leave rows to recover."""
    ovr = torch.zeros(R, OCOL, dtype=torch.int32, device=dev)
    first = None
    rounds = rec_rows = 0
    while True:
        f_bit, f_slot, nblk, state, bad, n_rec = walk(ovr)
        if first is None:
            first = (f_bit, f_slot, state)
        n = int(n_rec.item())
        if n == 0:
            break
        rounds += 1
        rec_rows += n
        if rounds >= max_rounds:
            return None, (rounds, rec_rows, 0)
        ovr = recover(f_bit, f_slot, state, ovr)
    # A mispredict: a row the first walk settled at an entry the final
    # walk does not keep (its authority came through a wrong guess).
    fb0, fs0, st0 = first
    mis = int(((st0 == SETTLED) & ((fb0 != f_bit) | (fs0 != f_slot)))
              .sum()) if rounds else 0
    return (f_bit, f_slot, nblk, state, bad), (rounds, rec_rows, mis)


def resolve_ref(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                rows: Rows, links: torch.Tensor, member: torch.Tensor,
                cb_bits: int, strip_bits: int, max_rounds: int):
    """Plain K9 (walk and re-decode rounds); result as ``resolve_loop``."""
    bpm = plan.blocks_per_mcu
    return resolve_loop(
        lambda ovr: walk_ref(links, ovr, rows, bpm, cb_bits),
        lambda fb, fs, st, ovr: recover_ref(plan, words, nbits, rows, member,
                                            fb, fs, st, ovr, cb_bits,
                                            strip_bits),
        rows.R, words.device, max_rounds)


def frame_prefix(x: torch.Tensor, rows: Rows) -> torch.Tensor:
    """Per-frame exclusive prefix sum over rows of ``x`` [R] or [R, C]
    (int32, wrapping like the kernels' int32 sums).  The sum runs along
    the last axis of a [C, R] copy: a scan along the outer axis of [R, C]
    takes the card ~0.5 ms for 3,088 rows."""
    xt = x.to(torch.int64).t().contiguous() if x.dim() == 2 \
        else x.to(torch.int64)
    excl = xt.cumsum(-1) - xt
    out = excl - excl[..., rows.first]
    out = out.t() if x.dim() == 2 else out
    return ((out + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32) \
        .contiguous()


def _placement(plan: ScanPlan, k, gblk, slot, frame, total_blocks):
    """Frame-local block ordinal -> (flat offset of coefficient 0, valid)
    with the restart kernels' affinities (``place_cuda.kernel_tables``)."""
    mcu = gblk // plan.blocks_per_mcu
    m_x = kernel_m_x(plan)
    my = mcu // m_x
    rel = k["c0"][slot] + my * k["c1"][slot] + (mcu - my * m_x) * k["c2"][slot]
    valid = (mcu < plan.n_mcus) & (rel < k["blk_end"][slot])
    return (frame * total_blocks + rel) * 64, valid


def final_walk_ref(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                   rows: Rows, f_bit: torch.Tensor, f_slot: torch.Tensor,
                   nblk: torch.Tensor, g0: torch.Tensor, total_blocks: int):
    """K10's walk: -> (coeffs [F * total_blocks, 64] int32 with row-local
    DC, dc_sum [R, C_MAX] int32 (each row's last local DC per component),
    ok [R] int32: 0 where a row with blocks died before its last block or
    its entry slot is not its first block's slot, ``g0 % bpm``)."""
    dev = words.device
    bpm = plan.blocks_per_mcu
    k = _consts(plan, dev)
    w64 = _words64(words)
    frame, R, F = rows.frame, rows.R, rows.F
    out = torch.zeros(F * total_blocks * 64, dtype=torch.int32, device=dev)
    n = nblk.to(torch.int64)
    g = g0.to(torch.int64)
    slot = f_slot.to(torch.int64).clone()
    ok = ~((n > 0) & (g % bpm != slot))
    active = (n > 0) & ok
    nb = nbits.to(torch.int64)[frame]
    bitpos = f_bit.to(torch.int64).clone()
    coeff = torch.zeros(R, dtype=torch.int64, device=dev)
    blk = torch.zeros_like(coeff)
    pred = torch.zeros(R, C_MAX, dtype=torch.int32, device=dev)
    cur = torch.zeros(R, dtype=torch.int32, device=dev)
    lanes = torch.arange(R, device=dev)
    while bool(active.any()):
        s = _symbol(plan, k, w64, frame, bitpos, slot, coeff, nb)
        dead = active & s["dies"]
        ok = ok & ~dead
        live = active & ~dead
        dst, valid = _placement(plan, k, g + blk, slot, frame, total_blocks)
        ac = live & valid & ~s["is_dc"] & ~s["is_eob"]
        pos = k["zigzag"][s["new_coeff"].clamp(0, 63)]
        out[(dst + pos)[ac]] = s["coef_val"][ac]
        cur = torch.where(live & s["is_dc"], s["coef_val"], cur)
        done = live & s["done"]
        comp = k["slot_comp"][slot]
        dc = pred[lanes, comp] + cur
        out[dst[done & valid]] = dc[done & valid]
        pred[lanes[done], comp[done]] = dc[done]
        bitpos, slot, coeff, blk = _advance(plan, s, live, bitpos, slot,
                                            coeff, blk)
        active = live & (blk < n)
    return out.reshape(-1, 64), pred, ok.to(torch.int32)


def dc_fix_ref(plan: ScanPlan, coeffs: torch.Tensor, rows: Rows,
               nblk: torch.Tensor, g0: torch.Tensor, base: torch.Tensor,
               total_blocks: int) -> torch.Tensor:
    """K10's DC pass: add each row's DC base (``base`` [R, C_MAX], the
    per-frame exclusive prefix of ``dc_sum``) to coefficient 0 of each of
    its placed blocks.  -> the updated coefficients."""
    dev = coeffs.device
    k = _consts(plan, dev)
    n = nblk.to(torch.int64)
    row = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n)
    start = torch.repeat_interleave(n.cumsum(0) - n, n)
    gblk = g0.to(torch.int64)[row] + torch.arange(row.numel(),
                                                  device=dev) - start
    slot = gblk % plan.blocks_per_mcu
    dst, valid = _placement(plan, k, gblk, slot, rows.frame[row],
                            total_blocks)
    flat = coeffs.reshape(-1).clone()
    add = base[row, k["slot_comp"][slot]]
    flat[dst[valid]] += add[valid]
    return flat.reshape(-1, 64)


def final_ref(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
              rows: Rows, f_bit: torch.Tensor, f_slot: torch.Tensor,
              nblk: torch.Tensor, total_blocks: int):
    """Plain K10: walk, the DC prefix, the DC pass.  -> (coeffs [F *
    total_blocks, 64] int32, ok [R] int32)."""
    g0 = frame_prefix(nblk, rows)
    coeffs, dc_sum, ok = final_walk_ref(plan, words, nbits, rows, f_bit,
                                        f_slot, nblk, g0, total_blocks)
    base = frame_prefix(dc_sum, rows)
    return dc_fix_ref(plan, coeffs, rows, nblk, g0, base, total_blocks), ok
