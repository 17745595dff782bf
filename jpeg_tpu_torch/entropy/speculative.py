"""Speculative parallel decode of entropy-coded segments without restart
markers (the port of ``jpeg_tpu/entropy/speculative.py``).

Without restart markers a scan's bit positions and its DC predictor chain
(decoder.c:350-355) are strictly sequential (read_ecs, decoder.c:364-388).
Huffman codes self-synchronize, though: a decode started at a wrong
position falls into the true symbol boundaries after a short prefix.  The
engine cuts each frame's unstuffed segment into chunk rows of
``CHUNK_BYTES`` and runs three device stages on the whole batch of
frames (``speculative_cuda``; the kernels of ``csrc/decode_rstless.cu``,
or on the CPU their plain versions in ``speculative_torch``):

  K8 sync     every (row, slot variant) decodes its row and links into
              its successor row at the first block-start state (bit,
              slot) that a successor variant also passed, marking on the
              way the first block start after each piece boundary of the
              row (pieces of ``PIECE_BYTES``);
  K9 resolve  one launch, a CTA per frame: a walk chains authority from
              row 0 (bit 0, slot 0) through the links; rows whose
              authority the links do not give are re-decoded from their
              now-known entry, round after round until every row is
              settled; the frame's stats and its pieces (entry, first
              block, block count: a row's marks that fall inside its
              blocks are true block starts) stay on the card;
  K10 final   every piece re-decodes exactly its blocks into their plane
              rows, and a DC pass adds the per-frame prefix of the
              pieces' DC sums, completing the predictor chain.

The result is bit-identical to the serial oracle on valid streams.  A
frame whose final decode does not reach the geometry's MCU count (a
damaged stream), or a batch the rounds cannot settle, is refused: the
call returns ``None`` and counts ``speculative.fallbacks`` and
``speculative.fallback[<reason>]``; callers step down (one frame at a
time, then the host).

What the TPU engine needed for XLA's static shapes has no counterpart
here: no phase-variant lane roster, no capped record lists (TCAP, HCAP),
no learned step bounds, no environment knobs.  The chunk, strip and
piece sizes are module constants, checked once by ``check_capacity``.
The host reads the device once a batch: the frame checks and the
resolve stats together, after K10.  The host prep is ``prepare_batch``
(unstuffed segments through ``pack_words``) or, for frames that share
one header up to their segment, ``prepare_batch_native`` (one
``jt_walk_ecs_rows`` pass a frame, with no row map);
``speculative_core`` decodes either.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import upload
from ..errors import UnsupportedError
from ..utils.metrics import default_metrics, trace
from . import speculative_cuda
from .lockstep import ScanPlan
from .lockstep_torch import pack_words
from .place_cuda import check_plan
from .speculative_torch import (
    R_NBLK,
    S_BAD,
    S_MISPREDICTS,
    S_RECOVERY,
    S_ROUNDS,
    S_UNRESOLVED,
    Rows,
    row_layout,
)

# Chunk row bytes: small enough that a batch of 1080p frames gives every
# SM of an H100 several warps of (row, variant) threads (an 8-frame chunk
# of the bench stream, ~206 KB a frame: ~3,200 rows, ~19,000 threads at
# 4:2:0), large enough that the strip is a small share of the decoding.
CHUNK_BYTES = 512
# Head strip bytes: block starts recorded for the predecessor to link at.
STRIP_BYTES = 128
# Piece bytes of the final decode (K10): a thread decodes one piece, so a
# batch runs CHUNK_BYTES / PIECE_BYTES times as many chains of 1/that
# length as one per row.  32 B gave the shortest K10 on an H100 over 16
# to 512 B (tools/rstless_piece_sweep.py; PERF.md).
PIECE_BYTES = 32
MAX_CHUNK_BYTES = 1 << 20
MAX_STRIP_BYTES = 4096
MAX_PIECES = 1 << 16  # pieces a row


def check_capacity(chunk_bytes: int, strip_bytes: int,
                   piece_bytes: Optional[int] = None) -> int:
    """Raise ``ValueError`` unless 1 <= strip_bytes <= chunk_bytes,
    strip_bytes <= MAX_STRIP_BYTES, chunk_bytes <= MAX_CHUNK_BYTES,
    1 <= piece_bytes <= chunk_bytes and a row holds at most MAX_PIECES
    pieces: an entry linked into a row's strip must lie inside the row,
    and bit offsets, membership entries and marks must fit int32.
    ``piece_bytes`` None is ``min(PIECE_BYTES, chunk_bytes)``.  -> the
    piece bytes."""
    for name, v in (("chunk_bytes", chunk_bytes),
                    ("strip_bytes", strip_bytes),
                    ("piece_bytes", piece_bytes)):
        if not isinstance(v, (int, np.integer)) or isinstance(v, bool):
            if not (name == "piece_bytes" and v is None):
                raise ValueError(f"{name} must be an int, got {v!r}")
    if not 1 <= strip_bytes <= min(chunk_bytes, MAX_STRIP_BYTES):
        raise ValueError(f"strip_bytes {strip_bytes} outside 1 .. "
                         f"min(chunk_bytes, {MAX_STRIP_BYTES})")
    if chunk_bytes > MAX_CHUNK_BYTES:
        raise ValueError(f"chunk_bytes {chunk_bytes} above "
                         f"{MAX_CHUNK_BYTES}")
    if piece_bytes is None:
        piece_bytes = min(PIECE_BYTES, chunk_bytes)
    if not 1 <= piece_bytes <= chunk_bytes:
        raise ValueError(f"piece_bytes {piece_bytes} outside 1 .. "
                         f"chunk_bytes")
    if -(-chunk_bytes // piece_bytes) > MAX_PIECES:
        raise ValueError(f"more than {MAX_PIECES} pieces of {piece_bytes} "
                         f"bytes a row")
    return int(piece_bytes)


check_capacity(CHUNK_BYTES, STRIP_BYTES, PIECE_BYTES)


def _fallback(why: str) -> None:
    """Count a refused batch with its reason (the part before ':')."""
    default_metrics.count("speculative.fallbacks")
    default_metrics.count(f"speculative.fallback[{why.split(':')[0]}]")
    return None


def prepare_batch(segments: Sequence[np.ndarray], device: torch.device,
                  chunk_bytes: int = CHUNK_BYTES):
    """Host prep: pack each frame's unstuffed segment into one row of
    big-endian words (``pack_words``, as ``DeviceDecoder.prepare``) and
    cut it into chunk rows; upload.  -> (words [F, wn] int32, nbits [F]
    int32, ``Rows``), all on ``device``.  Counted in
    ``speculative.python_prep_chunks``."""
    segs = [np.asarray(s, np.uint8) for s in segments]
    sizes = np.array([s.size for s in segs], np.int64)
    words, nbits = pack_words(np.concatenate(segs), sizes)
    rows = Rows.build(row_layout(sizes, chunk_bytes), device)
    default_metrics.count("speculative.python_prep_chunks")
    return (upload(words.view(np.int32), device),
            upload(nbits.astype(np.int32), device), rows)


def prepare_batch_native(frames: Sequence[bytes], scan_start: int,
                         device: torch.device,
                         chunk_bytes: int = CHUNK_BYTES):
    """The native host prep of frames that share one header up to their
    entropy-coded segment, which starts at byte ``scan_start`` of each:
    one C++ pass a frame (``jt_walk_ecs_rows``, no row map) unstuffs the
    segment into its row of a zeroed [F, wn] word matrix; upload.  ``wn`` is
    ``pack_words``' width for the longest stuffed segment, which bounds
    the unstuffed one, so no row overflows.  -> ``prepare_batch``'s
    (words, nbits, ``Rows``) on ``device``: equal bit counts and rows,
    equal words over ``pack_words``' width and zeros past it; or None
    when the library is not available or a frame is not one segment
    closed by EOI (malformed, truncated, another marker, RSTn inside the
    segment): the Python prep then decides.  Counted in
    ``speculative.native_prep_chunks``."""
    from .. import native

    if not frames or not native.available():
        return None
    F = len(frames)
    wn = (max(map(len, frames)) - scan_start + 8 + 63) // 64 * 16
    words = np.zeros((F, wn), np.uint32)
    lens = np.zeros(F, np.int32)
    for f, data in enumerate(frames):
        if native.prep_ecs_native(data, scan_start, words[f:f + 1],
                                  lens[f:f + 1]) != 1:
            return None
    rows = Rows.build(row_layout(lens, chunk_bytes), device)
    default_metrics.count("speculative.native_prep_chunks")
    return (upload(words.view(np.int32), device), upload(lens * 8, device),
            rows)


def speculative_core_batch(plan: ScanPlan, total_blocks: int,
                           segments: Sequence[np.ndarray],
                           device: torch.device,
                           chunk_bytes: int = CHUNK_BYTES,
                           strip_bytes: int = STRIP_BYTES,
                           piece_bytes: Optional[int] = None):
    """Decode F same-plan RST-less segments (unstuffed uint8) on
    ``device``: ``prepare_batch`` in a ``device_decode.spec_prepare``
    span, then ``speculative_core``, whose result this is."""
    check_capacity(chunk_bytes, strip_bytes, piece_bytes)
    if not segments:
        return _fallback("empty batch")
    with trace("device_decode.spec_prepare"):
        words, nbits, rows = prepare_batch(segments, device, chunk_bytes)
    return speculative_core(plan, total_blocks, words, nbits, rows,
                            chunk_bytes, strip_bytes, piece_bytes)


def speculative_core(plan: ScanPlan, total_blocks: int, words: torch.Tensor,
                     nbits: torch.Tensor, rows: Rows,
                     chunk_bytes: int = CHUNK_BYTES,
                     strip_bytes: int = STRIP_BYTES,
                     piece_bytes: Optional[int] = None):
    """Decode a prepared batch of F same-plan RST-less frames (words [F,
    wn] int32, nbits [F] int32 and their ``Rows`` of ``chunk_bytes``, as
    ``prepare_batch`` or ``prepare_batch_native`` give them) on their
    device.

    -> (coeffs [F * total_blocks, 64] int32 on the device, plane order,
    n_use: each frame's decoded blocks, at most ``total_blocks``), or
    ``None`` when the batch is refused (counted).  The resolve rounds are
    bounded by the largest frame's row count plus one, which always
    suffices: each round settles at least one more row of every frame.
    ``piece_bytes`` None is ``min(PIECE_BYTES, chunk_bytes)``.  The
    device is read once, after K10: the resolve stats with the frame
    checks.
    """
    piece_bytes = check_capacity(chunk_bytes, strip_bytes, piece_bytes)
    try:
        check_plan(plan)
    except UnsupportedError as e:
        return _fallback(f"plan: {e}")
    if rows.F == 0:
        return _fallback("empty batch")
    device = words.device
    max_rounds = int(np.diff(rows.row0).max()) + 1
    default_metrics.count("speculative.batches")
    cb, sb, pb = chunk_bytes * 8, strip_bytes * 8, piece_bytes * 8
    with trace("device_decode.spec_dispatch"):
        links, member, marks = speculative_cuda.sync(plan, words, nbits,
                                                     rows, cb, sb, pb)
        res = speculative_cuda.resolve(plan, words, nbits, rows, links,
                                       member, marks, cb, sb, pb, max_rounds)
        # K10 reads none of K8's outputs: free the membership map before
        # the coefficients are allocated
        links = member = marks = None
        # K10 runs on an unresolved batch too (its unsettled rows hold no
        # blocks), so that the batch needs one host read.
        coeffs, ok = speculative_cuda.final(plan, words, nbits, rows,
                                            res.pieces, total_blocks)
    # The one host read: per frame, the resolve stats, the rows that did
    # not decode their blocks, and the blocks decoded.
    with trace("device_decode.spec_readback"):
        frame = rows.frame
        zero = torch.zeros(rows.F, dtype=torch.int64, device=device)
        check = torch.cat([
            res.frame.t().to(torch.int64),
            zero.index_add(0, frame, (ok == 0).to(torch.int64))[None],
            zero.index_add(0, frame, res.row[R_NBLK].to(torch.int64))[None],
        ]).cpu().numpy()
    rounds = int(check[S_ROUNDS].max())
    default_metrics.count("speculative.resolve_rounds", rounds)
    default_metrics.count("speculative.recovery_rows",
                          int(check[S_RECOVERY].sum()))
    default_metrics.count("speculative.mispredicts",
                          int(check[S_MISPREDICTS].sum()))
    if check[S_UNRESOLVED].any():
        return _fallback(f"unresolved: {rounds} rounds")
    not_ok, blocks = check[-2], check[-1]
    want = plan.n_mcus * plan.blocks_per_mcu
    refused = (check[S_BAD] > 0) | (not_ok > 0) | (blocks < want)
    if refused.any():
        return _fallback(f"invalid frame: {int(np.argmax(refused))} of "
                         f"{rows.F}")
    return coeffs, [int(min(t, total_blocks)) for t in blocks]


def decode_scan_speculative(geom, info, tables, htable_key: tuple,
                            segments: List[np.ndarray],
                            planes, device) -> int:
    """Scan-level entry (``api.decode_coefficients(entropy=
    "speculative")``): decode one scan into ``planes`` (host int32
    [n_blocks, 64] per component id) and return its MCU count.

    An RST-less scan (one segment) runs the engine on ``device`` and
    downloads the coefficients; a refused scan decodes with the serial
    oracle instead.  A scan with restart markers already has explicit
    entry points, so it routes to the lockstep engine.
    """
    if len(segments) > 1:
        from .lockstep import decode_scan_lockstep

        return decode_scan_lockstep(geom, info, tables, list(segments),
                                    planes)
    from .lockstep_torch import _cached_plan

    plan = _cached_plan(geom, info, htable_key)
    comps = [geom.by_id(cid) for cid in info.component_ids]
    total_blocks = sum(c.n_blocks for c in comps)
    seg = np.asarray(segments[0], np.uint8)
    res = speculative_core_batch(plan, total_blocks, [seg], device)
    if res is None:
        from .serial import decode_scan_serial

        return decode_scan_serial(geom, info, tables, [seg], planes)
    coeffs, _ = res
    c = coeffs.cpu().numpy()
    off = 0
    for comp in comps:
        planes[comp.cid][:] = c[off : off + comp.n_blocks]
        off += comp.n_blocks
    return plan.n_mcus  # the engine refuses a scan that decodes fewer
