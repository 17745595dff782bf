"""Restart-segment decode straight into plane-major coefficient blocks.

``decode_segments`` is the port of the JAX package's TPU decode of a
chunk of restart segments.  It takes the shape the JAX package takes:

* eligible shapes (``placement_eligible``, copied from the JAX module:
  each lane owns ``ri`` whole MCUs of one MCU row) port the region
  placement (``jpeg_tpu/entropy/place_pallas.py``, the Pallas kernel
  ``_region_kernel`` behind ``_place_region``) fused with the symbol scan
  that feeds it (``lockstep_jax._scan_lanes``).  On a CUDA tensor one
  thread per segment decodes it to its end and writes every coefficient
  into its block (``csrc/decode_segments.cu``, one pass); on a CPU tensor
  the plain version ``decode_segments_ref`` runs the eager scan
  (``lockstep_torch.scan_lanes``), ``place_region`` and
  ``region_to_coeffs``, the same two steps the TPU takes;
* every other shape (``decode_segments_general``: a restart interval that
  does not tile the MCU rows, a short last segment, an RST-less frame as
  one lane) ports the scan followed by the prefix-sum scatter
  ``lockstep_jax._place_emissions``.  On a CUDA tensor the kernel walks
  each segment three times (count its MCUs; a per-frame ``torch.cumsum``
  gives each lane its first MCU; place; resolve the coefficients two
  lanes write at a lane boundary); on a CPU tensor the plain version
  ``decode_segments_general_ref`` runs the eager scan and
  ``place_emissions``.

The two semantics differ only on damaged lanes (a region drops a lane's
writes past ``ri`` MCUs; the prefix sum moves the next lanes along), so
the dispatch keeps the JAX package's rule, ``RB_MAX`` included.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..constants import ZIGZAG
from ..device import cuda_stream
from ..errors import UnsupportedError
from .lockstep import ScanPlan
from .lockstep_torch import scan_lanes

# Region blocks cap of the TPU kernel's VMEM regions, kept so that the
# eligible shapes, and so the semantics on damaged lanes, match the JAX
# package's shape for shape.
RB_MAX = 64

# Packed plan-table layout shared with csrc/decode_segments.cu (int32).
T_MAX = 8  # stacked Huffman tables
SLOTS = 16  # blocks per MCU
C_MAX = 4  # components per scan
OFF_MAXCODE = 0
OFF_MINCODE = OFF_MAXCODE + T_MAX * 17
OFF_VALPTR = OFF_MINCODE + T_MAX * 17
OFF_HUFFVAL = OFF_VALPTR + T_MAX * 17
OFF_SLOT_COMP = OFF_HUFFVAL + T_MAX * 256
OFF_SLOT_DC = OFF_SLOT_COMP + SLOTS
OFF_SLOT_AC = OFF_SLOT_DC + SLOTS
OFF_C0 = OFF_SLOT_AC + SLOTS
OFF_C1 = OFF_C0 + SLOTS
OFF_C2 = OFF_C1 + SLOTS
OFF_BLK_END = OFF_C2 + SLOTS
OFF_ZIGZAG = OFF_BLK_END + SLOTS
TABLE_INTS = OFF_ZIGZAG + 64


def placement_eligible(plan: ScanPlan, ri: int, segs_per_frame: int) -> bool:
    """True when every lane owns ``ri`` whole MCUs of one MCU row.

    Non-interleaved (Ns=1) scans walk their single plane's blocks in
    raster order (decoder.c:319-335), so a lane's region is already
    plane-contiguous and only even lane tiling is required; interleaved
    scans additionally need segments to tile MCU rows evenly.
    """
    if ri <= 0:
        return False
    bpm = plan.blocks_per_mcu
    if bpm > 16 or ri * bpm > RB_MAX:
        return False
    if plan.n_mcus % ri:
        return False
    if plan.interleaved and plan.m_x % ri:
        return False
    return segs_per_frame * ri == plan.n_mcus


def region_path(plan: ScanPlan, spf: int, ri: int, total_blocks: int) -> bool:
    """True when a chunk of this shape takes the one-pass region kernel:
    eligible, and the scan's MCUs cover the frame's blocks exactly."""
    return (placement_eligible(plan, ri, spf)
            and spf * ri * plan.blocks_per_mcu == total_blocks)


def _comp_layout(plan: ScanPlan) -> Tuple[Tuple[int, int, int], ...]:
    """Per-component (slot0, V, H) in scan order (slots are comp-major,
    v-major, h-minor -- build_scan_plan)."""
    out = []
    s = 0
    while s < plan.blocks_per_mcu:
        v = int(plan.slot_V[s])
        h = int(plan.slot_H[s])
        out.append((s, v, h))
        s += v * h
    return tuple(out)


def place_region(em_key: torch.Tensor, em_val: torch.Tensor, bpm: int,
                 rb: int) -> torch.Tensor:
    """[steps, S] emission stream -> [S, rb*64] lane-major regions.

    Plain form of the TPU kernel's masked one-hot select: each valid key
    lands at ``(mcu*bpm + slot)*64 + pos`` of its lane's region; writes
    past the region (lane-local MCU >= ri) are dropped, as the kernel's
    ``region[:s, :rb*64]`` slice drops them.  Slots are write-once, so the
    scatter order never matters.
    """
    steps, s = em_key.shape
    kk = em_key.to(torch.int64) - 1
    flat = ((kk >> 10) * bpm + ((kk >> 6) & 15)) * 64 + (kk & 63)
    ok = (em_key > 0) & (flat < rb * 64)
    lane = torch.arange(s, device=em_key.device).expand(steps, s)
    region = torch.zeros(s, rb * 64, dtype=torch.int32, device=em_key.device)
    region[lane[ok], flat[ok]] = em_val[ok]
    return region


def region_to_coeffs(plan: ScanPlan, region: torch.Tensor, frames: int,
                     segs_per_frame: int, ri: int) -> torch.Tensor:
    """Lane-major regions -> plane-major [frames*total_blocks, 64].

    Pure reshape/permute per component: a lane covers ``ri`` consecutive
    MCUs of one MCU row, so component blocks land at
    (my*V + v, (gx*ri + r)*H + h).
    """
    bpm = plan.blocks_per_mcu
    if not plan.interleaved:
        # Ns=1: region blocks ARE the plane's blocks in raster order.
        return region.reshape(-1, 64)
    m_x = plan.m_x
    m_y = plan.n_mcus // m_x
    gx = m_x // ri
    r = region.reshape(frames, segs_per_frame, ri, bpm, 64)
    parts = []
    for s0, v, h in _comp_layout(plan):
        c = r[:, :, :, s0 : s0 + v * h, :]
        c = c.reshape(frames, m_y, gx, ri, v, h, 64)
        c = c.permute(0, 1, 4, 2, 3, 5, 6)
        parts.append(c.reshape(frames, m_y * v * m_x * h, 64))
    return torch.cat(parts, dim=1).reshape(-1, 64)


def _slot_affinities(plan: ScanPlan):
    """Per-slot (c0, c1, c2, plane offset, blocks) int64 arrays: a block of
    frame-local MCU gm is c0 + (gm // m_x)*c1 + (gm % m_x)*c2, the JAX
    placement's three fused constants (Ns=1 scans: c1 = 0, c2 = bpm and
    no division, one "row" spans every MCU)."""
    bpm = plan.blocks_per_mcu
    po = plan.slot_plane_offset.astype(np.int64)
    if plan.interleaved:
        c0 = po + plan.slot_v * plan.slot_bx + plan.slot_h
        c1 = plan.slot_V * plan.slot_bx
        c2 = plan.slot_H
    else:
        c0 = po + plan.slot_h
        c1 = np.zeros(bpm, np.int64)
        c2 = np.full(bpm, bpm, np.int64)
    return (c0.astype(np.int64), c1.astype(np.int64), c2.astype(np.int64),
            po, plan.slot_nblocks.astype(np.int64))


def place_emissions(plan: ScanPlan, mcu_counts: torch.Tensor,
                    em_key: torch.Tensor, em_val: torch.Tensor, frames: int,
                    spf: int, total_blocks: int) -> torch.Tensor:
    """Prefix-sum placement of one [steps, S] emission stream ->
    plane-major [frames*total_blocks, 64] int32.

    The port of ``lockstep_jax._place_emissions`` in its single-stream
    scatter-SET form: a per-frame exclusive cumsum of the lane MCU counts
    gives each lane its first MCU, so a key's MCU is ``gmcu = seg_offset +
    local_mcu`` and its block ``c0 + my*c1 + mx*c2`` (interleaved) or
    ``po + gmcu*bpm + slot_h`` (Ns=1); a write is dropped unless
    ``seq < slot_nblocks``.  Where two lanes write one coefficient (the
    partial MCU a damaged lane died in, and the next lane's first MCU),
    the emission latest in (step, lane) order wins, as XLA's scatter
    applies updates in order on the CPU.
    """
    dev = em_key.device
    S = mcu_counts.shape[0]
    per_frame = mcu_counts.to(torch.int64).reshape(frames, spf)
    seg_offset = (per_frame.cumsum(1) - per_frame).reshape(S)
    keys = em_key.reshape(-1).to(torch.int64)
    upd = torch.nonzero(keys > 0).squeeze(1)  # (step, lane) order
    lane = upd % S
    kk = keys[upd] - 1
    pos = kk & 63
    slot = (kk >> 6) & 15
    gmcu = (kk >> 10) + seg_offset[lane]
    c0, c1, c2, po, nb = (torch.from_numpy(a).to(dev)
                          for a in _slot_affinities(plan))
    if plan.interleaved:
        my = gmcu // plan.m_x
        blk = c0[slot] + my * c1[slot] + (gmcu - my * plan.m_x) * c2[slot]
    else:
        blk = c0[slot] + gmcu * c2[slot]
    good = blk - po[slot] < nb[slot]
    flat = ((lane // spf) * total_blocks + blk) * 64 + pos
    flat, upd = flat[good], upd[good]
    n = frames * total_blocks * 64
    last = torch.full((n,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, flat, upd, "amax")
    win = last[flat] == upd
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    out[flat[win]] = em_val.reshape(-1)[upd[win]].to(torch.int32)
    return out.reshape(frames * total_blocks, 64)


def check_plan(plan: ScanPlan) -> None:
    """Raise ``UnsupportedError`` unless the kernels' packed tables hold
    this scan (<= 8 Huffman tables, <= 16 blocks per MCU, <= 4
    components)."""
    if (plan.maxcode.shape[0] > T_MAX or plan.blocks_per_mcu > SLOTS
            or plan.n_comps > C_MAX):
        raise UnsupportedError(
            f"decode_segments takes <= {T_MAX} tables, <= {SLOTS} blocks "
            f"per MCU and <= {C_MAX} components"
        )


def check_shape(plan: ScanPlan, frames: int, spf: int,
                total_blocks: int) -> None:
    """``check_plan``, and ``ValueError`` on an empty chunk."""
    check_plan(plan)
    if frames <= 0 or spf <= 0 or total_blocks <= 0:
        raise ValueError("frames, segments and blocks must be positive")


def decode_segments_ref(plan: ScanPlan, words: torch.Tensor,
                        nbits: torch.Tensor, frames: int, spf: int, ri: int,
                        total_blocks: int):
    """Plain PyTorch version of the region kernel, on any device.

    -> (coeffs [frames*total_blocks, 64] int32 plane-major,
        mcu_counts [S] int32 lane-local MCUs decoded when the lane died).
    """
    check_shape(plan, frames, spf, total_blocks)
    if not region_path(plan, spf, ri, total_blocks):
        raise UnsupportedError(
            f"restart interval {ri} with {spf} segments per frame does not "
            f"tile this frame's MCU rows evenly ({plan.n_mcus} MCUs, "
            f"m_x={plan.m_x}): decode_segments_general takes it"
        )
    counts, em_key, em_val, _ = scan_lanes(plan, words, nbits)
    bpm = plan.blocks_per_mcu
    region = place_region(em_key, em_val, bpm, ri * bpm)
    return region_to_coeffs(plan, region, frames, spf, ri), counts


def decode_segments_general_ref(plan: ScanPlan, words: torch.Tensor,
                                nbits: torch.Tensor, frames: int, spf: int,
                                total_blocks: int):
    """Plain PyTorch version of the general kernel, on any device: the
    eager scan, then ``place_emissions``.  -> (coeffs, mcu_counts) as
    ``decode_segments_ref``."""
    check_shape(plan, frames, spf, total_blocks)
    counts, em_key, em_val, _ = scan_lanes(plan, words, nbits)
    return (place_emissions(plan, counts, em_key, em_val, frames, spf,
                            total_blocks), counts)


def kernel_tables(plan: ScanPlan) -> np.ndarray:
    """The plan's decode tables and block affinities, packed for the kernel.

    A frame-local MCU ``gm`` has, for ``slot``, the frame-relative block
    ``c0 + (gm // m_x)*c1 + (gm % m_x)*c2`` (``kernel_m_x`` gives the
    divisor; Ns=1 scans never divide); the block lies inside its component
    when it is below ``blk_end = plane offset + slot_nblocks``.
    """
    check_plan(plan)
    T = plan.maxcode.shape[0]
    bpm = plan.blocks_per_mcu
    t = np.zeros(TABLE_INTS, dtype=np.int64)
    t[OFF_MAXCODE : OFF_MINCODE] = -1  # unused tables never match
    for name, off, width in (("maxcode", OFF_MAXCODE, 17),
                             ("mincode", OFF_MINCODE, 17),
                             ("valptr", OFF_VALPTR, 17),
                             ("huffval", OFF_HUFFVAL, 256)):
        t[off : off + T * width] = getattr(plan, name).reshape(-1)
    t[OFF_SLOT_COMP : OFF_SLOT_COMP + bpm] = plan.slot_comp
    t[OFF_SLOT_DC : OFF_SLOT_DC + bpm] = plan.slot_dc_tab
    t[OFF_SLOT_AC : OFF_SLOT_AC + bpm] = plan.slot_ac_tab
    c0, c1, c2, po, nb = _slot_affinities(plan)
    t[OFF_C0 : OFF_C0 + bpm] = c0
    t[OFF_C1 : OFF_C1 + bpm] = c1
    t[OFF_C2 : OFF_C2 + bpm] = c2
    t[OFF_BLK_END : OFF_BLK_END + bpm] = po + nb
    t[OFF_ZIGZAG : OFF_ZIGZAG + 64] = ZIGZAG
    return t.astype(np.int32)


def kernel_m_x(plan: ScanPlan) -> int:
    """MCU-row width the kernel divides by (all MCUs for Ns=1 scans)."""
    return plan.m_x if plan.interleaved else plan.n_mcus


@lru_cache(maxsize=64)
def _device_tables(plan: ScanPlan, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(kernel_tables(plan)).to(device)


def _check_tensor(name: str, t: torch.Tensor, ndim: int,
                  device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, words on {device}")
    if t.dtype != torch.int32 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {ndim}-D int32 tensor, got "
            f"{t.dtype} {tuple(t.shape)}"
        )


def _check_launch(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                  frames: int, spf: int, total_blocks: int) -> torch.device:
    """Validate a CUDA launch's inputs; -> their device."""
    if words.device.type != "cuda":
        raise ValueError(f"decode_segments: unsupported device {words.device}")
    check_shape(plan, frames, spf, total_blocks)
    dev = words.device
    _check_tensor("words", words, 2, dev)
    _check_tensor("nbits", nbits, 1, dev)
    S, wn = words.shape
    if S != frames * spf or nbits.shape[0] != S:
        raise ValueError(
            f"expected {frames}x{spf} lanes, got words {tuple(words.shape)}, "
            f"nbits {tuple(nbits.shape)}"
        )
    if wn < 2:
        raise ValueError("words rows need at least two u32 words")
    if frames * total_blocks * 64 >= 1 << 31:
        raise ValueError("chunk too large for int32 coefficient offsets")
    return dev


def decode_segments(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                    frames: int, spf: int, ri: int, total_blocks: int):
    """Decode ``frames * spf`` restart segments into plane-major blocks.

    ``words`` [S, Wn] int32 (big-endian u32 segment words, ``pack_words``),
    ``nbits`` [S] int32, lanes frame-major.  -> (coeffs [frames *
    total_blocks, 64] int32, mcu_counts [S] int32).  Shapes that
    ``region_path`` accepts take the one-pass region kernel; every other
    shape goes to ``decode_segments_general``.  A CUDA tensor launches the
    kernel (and counts the launch in ``decode_segments.launches``); a CPU
    tensor runs ``decode_segments_ref``.  Anything else raises.
    """
    if not region_path(plan, spf, ri, total_blocks):
        return decode_segments_general(plan, words, nbits, frames, spf,
                                       total_blocks)
    if words.device.type == "cpu":
        return decode_segments_ref(plan, words, nbits, frames, spf, ri,
                                   total_blocks)
    dev = _check_launch(plan, words, nbits, frames, spf, total_blocks)
    S, wn = words.shape

    from ..kernels import load_library

    lib = load_library().lib
    tables = _device_tables(plan, dev)
    coeffs = torch.zeros(frames * total_blocks, 64, dtype=torch.int32,
                         device=dev)
    counts = torch.empty(S, dtype=torch.int32, device=dev)
    vpad = ((plan.max_codes + 3) // 4) * 4
    with torch.cuda.device(dev):
        rc = lib.jt_decode_segments(
            tables.data_ptr(), words.data_ptr(), nbits.data_ptr(),
            coeffs.data_ptr(), counts.data_ptr(),
            S, wn, spf, ri, total_blocks, plan.blocks_per_mcu, plan.n_mcus,
            int(plan.interleaved), kernel_m_x(plan), vpad, cuda_stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"decode_segments launch failed: CUDA error {rc}")
    decode_segments.launches += 1
    return coeffs, counts


decode_segments.launches = 0


def lane_layout(counts: torch.Tensor, frames: int, spf: int):
    """Per-lane (first MCU, first lane of the frame with that first MCU),
    both [S] int32, from the lane MCU counts: the general kernel's
    placement inputs."""
    per = counts.to(torch.int64).reshape(frames, spf)
    off = per.cumsum(1) - per
    first = torch.searchsorted(off, off)  # offsets never decrease
    return (off.reshape(-1).to(torch.int32).contiguous(),
            first.reshape(-1).to(torch.int32).contiguous())


def decode_segments_general(plan: ScanPlan, words: torch.Tensor,
                            nbits: torch.Tensor, frames: int, spf: int,
                            total_blocks: int):
    """Decode ``frames * spf`` restart segments of any shape the kernel
    tables hold (prefix-sum placement).  Arguments and result as
    ``decode_segments``; the restart interval plays no part.

    A CUDA tensor launches the three walks of ``csrc/decode_segments.cu``
    (counted once per call in ``decode_segments_general.launches``); a CPU
    tensor runs ``decode_segments_general_ref``.  Anything else raises.
    """
    if words.device.type == "cpu":
        return decode_segments_general_ref(plan, words, nbits, frames, spf,
                                           total_blocks)
    dev = _check_launch(plan, words, nbits, frames, spf, total_blocks)
    S, wn = words.shape

    from ..kernels import load_library

    lib = load_library().lib
    tables = _device_tables(plan, dev)
    bpm = plan.blocks_per_mcu
    args = (int(plan.interleaved), kernel_m_x(plan),
            ((plan.max_codes + 3) // 4) * 4)
    counts = torch.empty(S, dtype=torch.int32, device=dev)
    coeffs = torch.zeros(frames * total_blocks, 64, dtype=torch.int32,
                         device=dev)
    bkey = torch.zeros(frames * (spf + 1) * bpm * 64, dtype=torch.int64,
                       device=dev)
    with torch.cuda.device(dev):
        stream = cuda_stream(dev)
        rc = lib.jt_decode_segments_count(
            tables.data_ptr(), words.data_ptr(), nbits.data_ptr(),
            counts.data_ptr(), S, wn, spf, bpm, plan.n_mcus, *args, stream)
        if rc != 0:
            raise RuntimeError(
                f"decode_segments_general pass 1 failed: CUDA error {rc}")
        off, first = lane_layout(counts, frames, spf)
        rc = lib.jt_decode_segments_place(
            tables.data_ptr(), words.data_ptr(), nbits.data_ptr(),
            counts.data_ptr(), off.data_ptr(), first.data_ptr(),
            bkey.data_ptr(), coeffs.data_ptr(), S, wn, spf, total_blocks,
            bpm, plan.n_mcus, *args, stream)
    if rc != 0:
        raise RuntimeError(
            f"decode_segments_general passes 2-3 failed: CUDA error {rc}")
    decode_segments_general.launches += 1
    return coeffs, counts


decode_segments_general.launches = 0
