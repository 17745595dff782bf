"""Kernel wrappers of the RST-less speculative decode (K8-K10).

Each wrapper takes the batch as ``entropy/speculative.py`` lays it out --
``words`` [F, wn] int32 (one row of big-endian u32 words per frame, as
``lockstep_torch.pack_words`` packs them), ``nbits`` [F] int32, and the
chunk rows (``speculative_torch.Rows``) -- checks its tensors, and on a
CUDA tensor launches the kernels of ``csrc/decode_rstless.cu`` on PyTorch's current stream and
counts the call in ``<wrapper>.launches``; on a CPU tensor it runs the
plain version of ``entropy/speculative_torch.py``.  Anything else raises.

* ``sync`` (K8): head walk into the membership map, then the tail walk
  -> (links [R * bpm, NCOL], member [R * strip_bits * bpm]).
* ``resolve`` (K9): walk and re-decode rounds; one host read per round.
  It counts each walk and each re-decode it launches (``2 * rounds + 1``
  a batch that resolves).
* ``final`` (K10): the final walk, the DC prefix (a torch cumsum) and the
  DC pass -> (coeffs [F * total_blocks, 64], ok [R]).
"""

from __future__ import annotations

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
    NCOL,
    OCOL,
    Rows,
    final_ref,
    frame_prefix,
    resolve_loop,
    resolve_ref,
    sync_ref,
)

# Bytes of shared memory the resolve walk stages per frame tile.
WALK_STAGE_BYTES = 48 * 1024


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
         rows: Rows, cb_bits: int, strip_bits: int):
    """K8.  -> (links [R * bpm, NCOL] int32, member [R * strip_bits * bpm]
    int32)."""
    if words.device.type == "cpu":
        return sync_ref(plan, words, nbits, rows, cb_bits, strip_bits)
    dev, F, R = _batch(plan, words, nbits, rows)
    r0, frame = rows.r0, rows.frame32
    bpm = plan.blocks_per_mcu
    if R * strip_bits * bpm >= 1 << 31:
        raise ValueError("membership map too large for int32 offsets")
    member = torch.zeros(R * strip_bits * bpm, dtype=torch.int32, device=dev)
    links = torch.empty(R * bpm, NCOL, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().jt_rstless_sync(
            _device_tables(plan, dev).data_ptr(), words.data_ptr(),
            nbits.data_ptr(), r0.data_ptr(), frame.data_ptr(),
            member.data_ptr(), links.data_ptr(), R, words.shape[1], bpm,
            huffval_pad(plan), _staged_ints(plan), cb_bits, strip_bits,
            cuda_stream(dev))
    _check(rc, "rstless sync")
    sync.launches += 1
    return links, member


sync.launches = 0


def resolve(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
            rows: Rows, links: torch.Tensor, member: torch.Tensor,
            cb_bits: int, strip_bits: int, max_rounds: int):
    """K9: walk, and re-decode the rows a walk could not settle, until a
    walk settles every row.  -> ((f_bit, f_slot, nblk, state [R] int32,
    frame_bad [F] int32) or None after ``max_rounds`` rounds, (rounds,
    recovery rows, mispredicts))."""
    if words.device.type == "cpu":
        return resolve_ref(plan, words, nbits, rows, links, member, cb_bits,
                           strip_bits, max_rounds)
    dev, F, R = _batch(plan, words, nbits, rows)
    r0, frame = rows.r0, rows.frame32
    bpm = plan.blocks_per_mcu
    check_tensor("links", links, (torch.int32,), (R * bpm, NCOL), dev)
    check_tensor("member", member, (torch.int32,),
                 (R * strip_bits * bpm,), dev)
    lib = _lib()
    stream = cuda_stream(dev)
    tables = _device_tables(plan, dev)
    tile = WALK_STAGE_BYTES // (4 * (bpm * NCOL + OCOL))

    def walk(ovr):
        out = [torch.empty(R, dtype=torch.int32, device=dev) for _ in range(4)]
        bad = torch.empty(F, dtype=torch.int32, device=dev)
        n_rec = torch.zeros(1, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.jt_rstless_walk(
                links.data_ptr(), ovr.data_ptr(), r0.data_ptr(),
                *(t.data_ptr() for t in out), bad.data_ptr(),
                n_rec.data_ptr(), F, bpm, cb_bits, tile, stream)
        _check(rc, "rstless walk")
        resolve.launches += 1
        return (*out, bad, n_rec)

    def recover(f_bit, f_slot, state, ovr):
        with torch.cuda.device(dev):
            rc = lib.jt_rstless_recover(
                tables.data_ptr(), words.data_ptr(), nbits.data_ptr(),
                r0.data_ptr(), frame.data_ptr(), member.data_ptr(),
                f_bit.data_ptr(), f_slot.data_ptr(), state.data_ptr(),
                ovr.data_ptr(), R, words.shape[1], bpm, huffval_pad(plan),
                _staged_ints(plan), cb_bits, strip_bits, stream)
        _check(rc, "rstless recover")
        resolve.launches += 1
        return ovr

    return resolve_loop(walk, recover, R, dev, max_rounds)


resolve.launches = 0


def final(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
          rows: Rows, f_bit: torch.Tensor, f_slot: torch.Tensor,
          nblk: torch.Tensor, total_blocks: int):
    """K10.  -> (coeffs [F * total_blocks, 64] int32 with the frame's DC
    chain, ok [R] int32)."""
    if words.device.type == "cpu":
        return final_ref(plan, words, nbits, rows, f_bit, f_slot, nblk,
                         total_blocks)
    dev, F, R = _batch(plan, words, nbits, rows)
    r0, frame = rows.r0, rows.frame32
    for name, t in (("f_bit", f_bit), ("f_slot", f_slot), ("nblk", nblk)):
        check_tensor(name, t, (torch.int32,), (R,), dev)
    if F * total_blocks * 64 >= 1 << 31:
        raise ValueError("batch too large for int32 coefficient offsets")
    lib = _lib()
    stream = cuda_stream(dev)
    tables = _device_tables(plan, dev)
    bpm = plan.blocks_per_mcu
    g0 = frame_prefix(nblk, rows)
    coeffs = torch.zeros(F * total_blocks, 64, dtype=torch.int32, device=dev)
    dc_sum = torch.empty(R, C_MAX, dtype=torch.int32, device=dev)
    ok = torch.empty(R, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.jt_rstless_final(
            tables.data_ptr(), words.data_ptr(), nbits.data_ptr(),
            r0.data_ptr(), frame.data_ptr(), f_bit.data_ptr(),
            f_slot.data_ptr(), nblk.data_ptr(), g0.data_ptr(),
            coeffs.data_ptr(), dc_sum.data_ptr(), ok.data_ptr(), R,
            words.shape[1], bpm, plan.n_mcus, kernel_m_x(plan),
            huffval_pad(plan), _staged_ints(plan), total_blocks, stream)
    _check(rc, "rstless final")
    base = frame_prefix(dc_sum, rows).contiguous()
    with torch.cuda.device(dev):
        rc = lib.jt_rstless_dc_fix(
            tables.data_ptr(), r0.data_ptr(), frame.data_ptr(),
            nblk.data_ptr(), g0.data_ptr(), base.data_ptr(),
            coeffs.data_ptr(), R, bpm, plan.n_mcus, kernel_m_x(plan),
            total_blocks, stream)
    _check(rc, "rstless dc fix")
    final.launches += 1
    return coeffs, ok


final.launches = 0
