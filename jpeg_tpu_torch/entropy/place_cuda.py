"""Restart-segment decode straight into plane-major coefficient blocks.

``decode_segments`` is the port of the JAX package's region placement
(``jpeg_tpu/entropy/place_pallas.py``, the Pallas kernel ``_region_kernel``
behind ``_place_region``) fused with the symbol scan that feeds it
(``lockstep_jax._scan_lanes``).  On a CUDA tensor it launches the
hand-written kernel ``csrc/decode_segments.cu``: one thread per restart
segment decodes its segment to the end and writes every coefficient into
its block.  On a CPU tensor it runs the plain version
``decode_segments_ref``: the eager scan (``lockstep_torch.scan_lanes``),
then ``place_region`` and ``region_to_coeffs``, the same two steps the
TPU takes.

Only shapes where each lane owns ``ri`` whole MCUs of one MCU row are
taken (``placement_eligible``, copied from the JAX module); a lane's
blocks are then pure arithmetic of its index, so no prefix sum over MCU
counts is needed.  Other shapes raise ``UnsupportedError``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..constants import ZIGZAG
from ..errors import UnsupportedError
from .lockstep import ScanPlan
from .lockstep_torch import scan_lanes

# Region blocks cap of the TPU kernel's VMEM regions, kept so eligibility
# matches the JAX package.  Only the plain version's region placement
# holds a region; the CUDA kernel computes each block index and has no cap.
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
OFF_ZIGZAG = OFF_C2 + SLOTS
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


def check_shape(plan: ScanPlan, frames: int, spf: int, ri: int,
                total_blocks: int) -> None:
    """Raise ``UnsupportedError`` unless ``decode_segments`` takes this
    stream shape (the general-shape decode is not ported yet)."""
    if not placement_eligible(plan, ri, spf):
        raise UnsupportedError(
            f"restart interval {ri} with {spf} segments per frame does not "
            f"tile this frame's MCU rows evenly ({plan.n_mcus} MCUs, "
            f"m_x={plan.m_x}); the general-shape decode is not ported yet"
        )
    if spf * ri * plan.blocks_per_mcu != total_blocks:
        raise UnsupportedError(
            "decode_segments needs the scan's MCUs to cover the frame's "
            "blocks exactly"
        )
    if frames <= 0:
        raise ValueError("frames must be positive")


def decode_segments_ref(plan: ScanPlan, words: torch.Tensor,
                        nbits: torch.Tensor, frames: int, spf: int, ri: int,
                        total_blocks: int):
    """Plain PyTorch version of the kernel, on any device.

    -> (coeffs [frames*total_blocks, 64] int32 plane-major,
        mcu_counts [S] int32 lane-local MCUs decoded when the lane died).
    """
    check_shape(plan, frames, spf, ri, total_blocks)
    counts, em_key, em_val, _ = scan_lanes(plan, words, nbits)
    bpm = plan.blocks_per_mcu
    region = place_region(em_key, em_val, bpm, ri * bpm)
    return region_to_coeffs(plan, region, frames, spf, ri), counts


def kernel_tables(plan: ScanPlan) -> np.ndarray:
    """The plan's decode tables and block affinities, packed for the kernel.

    A lane-local MCU ``mcu`` of lane ``k`` is MCU ``gm = k*ri + mcu`` of its
    frame; its block for ``slot`` is ``c0 + (gm // m_x)*c1 + (gm % m_x)*c2``
    (``kernel_m_x`` gives the divisor).
    """
    T = plan.maxcode.shape[0]
    bpm = plan.blocks_per_mcu
    if T > T_MAX or bpm > SLOTS or plan.n_comps > C_MAX:
        raise UnsupportedError(
            f"decode_segments takes <= {T_MAX} tables, <= {SLOTS} blocks "
            f"per MCU and <= {C_MAX} components"
        )
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
    po = plan.slot_plane_offset
    if plan.interleaved:
        c0 = po + plan.slot_v * plan.slot_bx + plan.slot_h
        c1 = plan.slot_V * plan.slot_bx
        c2 = plan.slot_H
    else:
        # Ns=1: block = po + gm*bpm + slot_h; one "row" spans every MCU.
        c0 = po + plan.slot_h
        c1 = np.zeros(bpm, np.int64)
        c2 = np.full(bpm, bpm, np.int64)
    t[OFF_C0 : OFF_C0 + bpm] = c0
    t[OFF_C1 : OFF_C1 + bpm] = c1
    t[OFF_C2 : OFF_C2 + bpm] = c2
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


def decode_segments(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                    frames: int, spf: int, ri: int, total_blocks: int):
    """Decode ``frames * spf`` restart segments into plane-major blocks.

    ``words`` [S, Wn] int32 (big-endian u32 segment words, ``pack_words``),
    ``nbits`` [S] int32, lanes frame-major.  -> (coeffs [frames *
    total_blocks, 64] int32, mcu_counts [S] int32).  A CUDA tensor
    launches the kernel (and counts the launch in
    ``decode_segments.launches``); a CPU tensor runs
    ``decode_segments_ref``.  Anything else raises.
    """
    if words.device.type == "cpu":
        return decode_segments_ref(plan, words, nbits, frames, spf, ri,
                                   total_blocks)
    if words.device.type != "cuda":
        raise ValueError(f"decode_segments: unsupported device {words.device}")
    check_shape(plan, frames, spf, ri, total_blocks)
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

    from ..kernels import load_library

    lib = load_library().lib
    tables = _device_tables(plan, dev)
    coeffs = torch.zeros(frames * total_blocks, 64, dtype=torch.int32,
                         device=dev)
    counts = torch.empty(S, dtype=torch.int32, device=dev)
    vpad = ((plan.max_codes + 3) // 4) * 4
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jt_decode_segments(
            tables.data_ptr(), words.data_ptr(), nbits.data_ptr(),
            coeffs.data_ptr(), counts.data_ptr(),
            S, wn, spf, ri, total_blocks, plan.blocks_per_mcu, plan.n_mcus,
            int(plan.interleaved), kernel_m_x(plan), vpad,
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"decode_segments launch failed: CUDA error {rc}")
    decode_segments.launches += 1
    return coeffs, counts


decode_segments.launches = 0
