"""Kernel wrappers of the RST-less speculative decode (K8-K10).

Each wrapper takes the batch as ``entropy/speculative.py`` lays it out --
``words`` [F, wn] int32 (one row of big-endian u32 words per frame, as
``lockstep_torch.pack_words`` packs them), ``nbits`` [F] int32, and the
chunk rows (``speculative_torch.Rows``) -- checks its tensors, and on a
CUDA tensor launches the kernels of ``csrc/decode_rstless.cu`` on PyTorch's current stream and
counts the call in ``<wrapper>.launches``; on a CPU tensor it runs the
plain version of ``entropy/speculative_torch.py``.  Anything else raises.
No wrapper reads the device back.

* ``sync`` (K8): head walk into the membership map and the marks to each
  variant's strip mark, grouping a row's variants by strip mark; then the
  tail walk of the survivors only, which writes every member's links and
  later marks -> (links [R * bpm, NCOL], member [R * strip_bits * bpm],
  marks [R * bpm, P - 1, MCOL]).  Its two launches are counted apart in
  ``sync.stage_launches``; ``_sync`` returns the survivor list (count,
  then lanes) on the card besides.
* ``resolve`` (K9): one launch, a CTA per frame running the frame's walk
  and re-decode rounds on the card, its stats and its piece layout ->
  ``Resolved`` (row outputs, per-frame stats, pieces [R * P, PCOL]).
* ``final`` (K10): the piece walk (a thread per piece) and the DC pass
  (the per-frame DC prefix over pieces, computed in each CTA, and the
  rows' ok bits) -> (coeffs [F * total_blocks, 64], ok [R]).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import check_tensor, cuda_stream
from .lockstep import ScanPlan
from .place_cuda import (
    C_MAX,
    _device_tables,
    _staged_ints,
    check_plan,
    huffval_pad,
    kernel_m_x,
)
from .speculative_torch import (
    GCOL,
    MCOL,
    NCOL,
    OCOL,
    PCOL,
    RCOL,
    SCOL,
    Resolved,
    Rows,
    final_ref,
    n_pieces,
    resolve_ref,
    sync_ref,
)

# Bytes of shared memory the resolve kernel stages per frame: the code
# tables, then as many rows' links, override rows and walk outputs as fit
# (a frame of more rows is walked in tiles).
RESOLVE_STAGE_BYTES = 200 * 1024
# Threads of a CTA of the DC pass (csrc DC_THREADS): a tile holds
# DC_THREADS // P rows.
DC_THREADS = 256


def _lib():
    from ..kernels import load_library

    return load_library().lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _batch(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
           rows: Rows):
    """Validate a CUDA batch -> (device, F, R)."""
    if words.device.type != "cuda":
        raise ValueError(f"rstless kernels: unsupported device {words.device}")
    check_plan(plan)
    dev = words.device
    F, R = rows.F, rows.R
    if words.dim() != 2 or words.shape[0] != F:
        raise ValueError(f"words must be [{F}, wn], got {tuple(words.shape)}")
    check_tensor("words", words, (torch.int32,), words.shape, dev)
    check_tensor("nbits", nbits, (torch.int32,), (F,), dev)
    check_tensor("rows.r0", rows.r0, (torch.int32,), (F + 1,), dev)
    check_tensor("rows.frame32", rows.frame32, (torch.int32,), (R,), dev)
    return dev, F, R


def sync(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
         rows: Rows, cb_bits: int, strip_bits: int, piece_bits: int):
    """K8.  -> (links [R * bpm, NCOL] int32, member [R * strip_bits * bpm]
    int32, marks [R * bpm, P - 1, MCOL] int32)."""
    if words.device.type == "cpu":
        return sync_ref(plan, words, nbits, rows, cb_bits, strip_bits,
                        piece_bits)
    return _sync(plan, words, nbits, rows, cb_bits, strip_bits,
                 piece_bits)[:3]


def _sync(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
          rows: Rows, cb_bits: int, strip_bits: int, piece_bits: int):
    """K8 on the card -> ``sync``'s triple and the survivor list
    [1 + R * bpm] int32 (count, then lanes in no fixed order)."""
    dev, F, R = _batch(plan, words, nbits, rows)
    bpm = plan.blocks_per_mcu
    P = n_pieces(cb_bits, piece_bits)
    if max(R * strip_bits, R * (P - 1) * MCOL, R * GCOL + 1) * bpm >= 1 << 31:
        raise ValueError("membership map or marks too large for int32 "
                         "offsets")
    member = torch.zeros(R * strip_bits * bpm, dtype=torch.int32, device=dev)
    links = torch.empty(R * bpm, NCOL, dtype=torch.int32, device=dev)
    marks = torch.empty(R * bpm, P - 1, MCOL, dtype=torch.int32, device=dev)
    # group state [R * bpm, GCOL], then the survivor count and list
    scratch = torch.empty(R * bpm * (GCOL + 1) + 1, dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        rc = _lib().jt_rstless_sync(
            _device_tables(plan, dev).data_ptr(), words.data_ptr(),
            nbits.data_ptr(), rows.r0.data_ptr(), rows.frame32.data_ptr(),
            member.data_ptr(), links.data_ptr(), marks.data_ptr(),
            scratch.data_ptr(), R, words.shape[1], bpm, huffval_pad(plan),
            _staged_ints(plan), cb_bits, strip_bits, piece_bits, P,
            cuda_stream(dev))
    _check(rc, "rstless sync")
    sync.stage_launches["head"] += 1
    sync.stage_launches["tail"] += 1
    sync.launches += 1
    return links, member, marks, scratch[R * bpm * GCOL:]


sync.launches = 0
sync.stage_launches = {"head": 0, "tail": 0}


def resolve(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
            rows: Rows, links: torch.Tensor, member: torch.Tensor,
            marks: torch.Tensor, cb_bits: int, strip_bits: int,
            piece_bits: int, max_rounds: int) -> Resolved:
    """K9: per frame, walk and re-decode the rows a walk could not settle
    until a walk settles every row or ``max_rounds`` walks left rows to
    re-decode; then the pieces.  One launch, no host read: the caller
    reads ``Resolved.frame`` (rounds, recovery rows, mispredicts,
    ``max_rounds`` reached, walk refusal per frame) with its own checks."""
    if words.device.type == "cpu":
        return resolve_ref(plan, words, nbits, rows, links, member, marks,
                           cb_bits, strip_bits, piece_bits, max_rounds)
    dev, F, R = _batch(plan, words, nbits, rows)
    bpm = plan.blocks_per_mcu
    P = n_pieces(cb_bits, piece_bits)
    check_tensor("links", links, (torch.int32,), (R * bpm, NCOL), dev)
    check_tensor("member", member, (torch.int32,),
                 (R * strip_bits * bpm,), dev)
    check_tensor("marks", marks, (torch.int32,), (R * bpm, P - 1, MCOL), dev)
    if R * P * PCOL >= 1 << 31:
        raise ValueError("too many pieces for int32 offsets")
    tab = _staged_ints(plan)
    row_ints = bpm * NCOL + OCOL + RCOL  # links, override, walk outputs
    tile = min(int(np.diff(rows.row0).max()),
               (RESOLVE_STAGE_BYTES // 4 - tab) // row_ints)
    if tile < 1:
        raise ValueError("code tables leave no shared memory for a row")
    scratch = torch.empty(R * (OCOL + (P - 1) * MCOL + 3), dtype=torch.int32,
                          device=dev)
    row = torch.empty(RCOL, R, dtype=torch.int32, device=dev)
    frame = torch.empty(F, SCOL, dtype=torch.int32, device=dev)
    pieces = torch.empty(R * P, PCOL, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().jt_rstless_resolve(
            _device_tables(plan, dev).data_ptr(), words.data_ptr(),
            nbits.data_ptr(), rows.r0.data_ptr(), rows.frame32.data_ptr(),
            member.data_ptr(), links.data_ptr(), marks.data_ptr(),
            scratch.data_ptr(), row.data_ptr(), frame.data_ptr(),
            pieces.data_ptr(), F, R, words.shape[1], bpm, huffval_pad(plan),
            tab, cb_bits, strip_bits, piece_bits, P, tile, max_rounds,
            cuda_stream(dev))
    _check(rc, "rstless resolve")
    resolve.launches += 1
    return Resolved(row, frame, pieces)


resolve.launches = 0


def final(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
          rows: Rows, pieces: torch.Tensor, total_blocks: int):
    """K10.  -> (coeffs [F * total_blocks, 64] int32 with the frame's DC
    chain, ok [R] int32).  On the card a block no piece decodes (only in
    a frame the engine refuses) holds no defined value; the plain version
    leaves it 0."""
    if words.device.type == "cpu":
        return final_ref(plan, words, nbits, rows, pieces, total_blocks)
    dev, F, R = _batch(plan, words, nbits, rows)
    if pieces.dim() != 2 or pieces.shape[0] % R or pieces.shape[0] == 0:
        raise ValueError(f"pieces must be [R * P, {PCOL}] for R = {R}, got "
                         f"{tuple(pieces.shape)}")
    P = pieces.shape[0] // R
    check_tensor("pieces", pieces, (torch.int32,), (R * P, PCOL), dev)
    if F * total_blocks * 64 >= 1 << 31:
        raise ValueError("batch too large for int32 coefficient offsets")
    tile_rows = max(1, DC_THREADS // P)
    tiles = -(-int(np.diff(rows.row0).max()) // tile_rows)
    coeffs = torch.empty(F * total_blocks, 64, dtype=torch.int32, device=dev)
    scratch = torch.empty(R * P * (C_MAX + 1), dtype=torch.int32, device=dev)
    ok = torch.empty(R, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().jt_rstless_final(
            _device_tables(plan, dev).data_ptr(), words.data_ptr(),
            nbits.data_ptr(), rows.r0.data_ptr(), rows.frame32.data_ptr(),
            pieces.data_ptr(), coeffs.data_ptr(), scratch.data_ptr(),
            ok.data_ptr(), F, R, words.shape[1], plan.blocks_per_mcu,
            plan.n_mcus, kernel_m_x(plan), huffval_pad(plan),
            _staged_ints(plan), total_blocks, P, tile_rows, tiles,
            cuda_stream(dev))
    _check(rc, "rstless final")
    final.launches += 1
    return coeffs, ok


final.launches = 0
