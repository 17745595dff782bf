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
  each segment twice (count its MCUs and whether it died mid-MCU, and in
  the same launch the layout: each lane's first MCU, ``lane_layout``, and
  the MCUs two lanes write, ``contested_rows``; place), and a third walk
  resolves the contested MCUs only: three launches a call.  On a CPU
  tensor the plain version ``decode_segments_general_ref`` runs the eager
  scan and ``place_emissions``.  With a lane order (``perm``: the rows
  sorted by learned length) it ports jpeg_tpu's phased scan,
  ``lockstep_jax._scan_lanes_phased`` with ``_place_emissions(perm=...)``.

The kernels decode codes of up to ``LUT_BITS`` bits with one lookup in
``lookup_table`` and stage each CTA's segment words in shared memory when
they fit ``STAGE_BYTES`` (else a register lookahead reads them).

The two semantics differ only on damaged lanes (a region drops a lane's
writes past ``ri`` MCUs; the prefix sum moves the next lanes along), so
the dispatch keeps the JAX package's rule, ``RB_MAX`` included.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..constants import ZIGZAG
from ..device import cuda_stream
from ..errors import CorruptStream, UnsupportedError
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
OFF_LUT = OFF_ZIGZAG + 64  # uint16 [T_MAX, 2**LUT_BITS], see lookup_table
LUT_BITS = 12
TABLE_INTS = OFF_LUT + T_MAX * (1 << LUT_BITS) // 2

# Lanes (segments) per CTA of the CUDA walks (csrc/decode_segments.cu's
# CTA_LANES, checked when the library loads), and the shared-memory budget
# of a CTA's staged segment words (rows that do not fit take the
# register-lookahead route).  Calls per route are counted in
# ROUTE_LAUNCHES.
CTA_LANES = 64
STAGE_BYTES = 64 * 1024
ROUTE_LAUNCHES = {"staged": 0, "lookahead": 0}

# ``lane_base`` of the general decode: the lane MCU counts [S] int32 ->
# an int32 tensor (a scalar or [S]) on their device, added to each lane's
# first MCU before placement.
LaneBase = Optional[Callable[[torch.Tensor], torch.Tensor]]


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
                    spf: int, total_blocks: int,
                    checks: bool = False,
                    seg_offset: Optional[torch.Tensor] = None,
                    perm: Optional[torch.Tensor] = None) -> torch.Tensor:
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

    ``checks`` is the JAX placement's sanitizer tier (``JPEG_TPU_CHECKS=2``,
    ``lockstep_jax.py:665-680``): a valid-key emission whose coefficient
    lands outside the output raises ``CorruptStream`` ("sanitizer: ...")
    where the production scatter drops it.

    ``seg_offset`` [S], where given, is each frame-major lane's first MCU
    in place of the per-frame cumsum: the JAX placement's ``seg_offset``
    argument, which the context-parallel frame decode gives the global
    offsets of a slice of one frame's lanes.

    ``perm`` [S] (sorted lane -> frame-major lane), where given, is the
    JAX placement's ``perm`` (``lockstep_jax.py:619-625``, the phased
    scan's): ``mcu_counts`` and the emission stream's lanes are then in
    sorted order, a lane's frame and first MCU are those of ``perm[lane]``,
    and the latest emission wins in (step, sorted lane) order -- the
    order of jpeg_tpu's phase-by-phase scatter.
    """
    dev = em_key.device
    S = mcu_counts.shape[0]
    fm = (torch.arange(S, device=dev) if perm is None
          else perm.to(device=dev, dtype=torch.int64))
    if seg_offset is None:
        per_frame = _to_frame_major(mcu_counts, perm).to(torch.int64) \
            .reshape(frames, spf)
        seg_offset = (per_frame.cumsum(1) - per_frame).reshape(S)
    seg_offset = seg_offset.to(torch.int64)
    keys = em_key.reshape(-1).to(torch.int64)
    upd = torch.nonzero(keys > 0).squeeze(1)  # (step, lane) order
    lane = fm[upd % S]
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
    n = frames * total_blocks * 64
    if checks and bool((good & ((flat < 0) | (flat >= n))).any()):
        raise CorruptStream("sanitizer: coefficient placement out of bounds "
                            "(kernel bug)")
    flat, upd = flat[good], upd[good]
    last = torch.full((n,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, flat, upd, "amax")
    win = last[flat] == upd
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    out[flat[win]] = em_val.reshape(-1)[upd[win]].to(torch.int32)
    return out.reshape(frames * total_blocks, 64)


def _check_perm_ref(perm: Optional[torch.Tensor], S: int) -> None:
    """The plain version's check of a lane order: ``perm``, where given,
    must hold each of ``range(S)`` once, else ValueError."""
    if perm is not None and not torch.equal(
            torch.sort(perm.reshape(-1).to(torch.int64)).values,
            torch.arange(S, device=perm.device)):
        raise ValueError(f"perm is not a permutation of the {S} lanes")


def _to_frame_major(x: torch.Tensor,
                    perm: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-lane values in sorted order -> frame-major (``out[perm] = x``);
    ``x`` itself when ``perm`` is None."""
    if perm is None:
        return x
    out = torch.empty_like(x)
    out[perm.to(device=x.device, dtype=torch.int64)] = x
    return out


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
                                total_blocks: int, checks: bool = False,
                                lane_base: LaneBase = None,
                                perm: Optional[torch.Tensor] = None,
                                want_nsteps: bool = False):
    """Plain PyTorch version of the general kernel, on any device: the
    eager scan, then ``place_emissions`` (``checks``: both with the
    sanitizer's checks).  -> (coeffs, mcu_counts) as
    ``decode_segments_ref``, and with ``want_nsteps`` the lanes' steps
    begun alive (``scan_lanes``' ``nsteps``) third.  ``lane_base``,
    ``perm`` and the frame-major order of the lane outputs as
    ``decode_segments_general`` (the offsets go to ``place_emissions`` as
    its ``seg_offset``)."""
    check_shape(plan, frames, spf, total_blocks)
    _check_perm_ref(perm, words.shape[0])
    counts, em_key, em_val, nsteps = scan_lanes(plan, words, nbits, checks)
    counts_fm = _to_frame_major(counts, perm)
    seg_offset = None
    if lane_base is not None:
        off, _ = _layout(counts_fm.to(torch.int64).reshape(frames, spf))
        seg_offset = off.reshape(-1) + lane_base(counts_fm).to(torch.int64)
    coeffs = place_emissions(plan, counts, em_key, em_val, frames, spf,
                             total_blocks, checks, seg_offset, perm)
    if want_nsteps:
        return coeffs, counts_fm, _to_frame_major(nsteps, perm)
    return coeffs, counts_fm


def huffval_pad(plan: ScanPlan) -> int:
    """The huffval index clip of the scans: ``vidx <= huffval_pad - 1``."""
    return ((plan.max_codes + 3) // 4) * 4


def lookup_table(plan: ScanPlan, bits: int = LUT_BITS) -> np.ndarray:
    """First-level decode table: [T_MAX, 2**bits] uint16.

    Entry ``p`` of table ``t`` is what the canonical compare (the first
    length ``l`` with ``prefix_l <= maxcode[t][l]``, then ``huffval[t]
    [clip(valptr + prefix_l - mincode, 0, vpad - 1)]``) gives for a code
    whose first ``bits`` bits are ``p``, when that length is at most
    ``bits``: ``length << 8 | value``.  0 marks a prefix that no code of
    up to ``bits`` bits matches; the kernel then continues the compare at
    length ``bits + 1``.  Unused tables are all 0 (maxcode -1 matches
    nothing), so hostile and incomplete tables decode as the compare does.
    """
    T = plan.maxcode.shape[0]
    vpad = huffval_pad(plan)
    pref = np.arange(1 << bits, dtype=np.int64)
    out = np.zeros((T_MAX, 1 << bits), dtype=np.uint16)
    for t in range(T):
        length = np.zeros_like(pref)
        vidx = np.zeros_like(pref)
        for l in range(bits, 0, -1):  # the shortest match is applied last
            p = pref >> (bits - l)
            hit = p <= plan.maxcode[t, l]
            length = np.where(hit, l, length)
            vidx = np.where(hit, plan.valptr[t, l] + p - plan.mincode[t, l],
                            vidx)
        value = plan.huffval[t, np.clip(vidx, 0, vpad - 1)]
        if value.min() < 0 or value.max() > 255:
            raise UnsupportedError("Huffman symbol values must be bytes")
        out[t] = np.where(length > 0, (length << 8) | value, 0)
    return out


def kernel_tables(plan: ScanPlan) -> np.ndarray:
    """The plan's decode tables and block affinities, packed for the kernel.

    A frame-local MCU ``gm`` has, for ``slot``, the frame-relative block
    ``c0 + (gm // m_x)*c1 + (gm % m_x)*c2`` (``kernel_m_x`` gives the
    divisor; Ns=1 scans never divide); the block lies inside its component
    when it is below ``blk_end = plane offset + slot_nblocks``.  The
    first-level ``lookup_table`` follows at ``OFF_LUT``.
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
    t[OFF_LUT:] = lookup_table(plan).reshape(-1).view(np.int32)
    return t.astype(np.int32)


def _staged_ints(plan: ScanPlan) -> int:
    """Ints of the packed tables a CTA stages: all but the unused LUTs."""
    return OFF_LUT + plan.maxcode.shape[0] * (1 << LUT_BITS) // 2


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


def _route(words: torch.Tensor) -> int:
    """1 when each CTA's [CTA_LANES, wn] slab of words is staged in shared
    memory (it fits ``STAGE_BYTES`` and 16-byte copies can move it), 0 for
    the register-lookahead route; counted in ``ROUTE_LAUNCHES``, once per
    call.  The route is that of the walks that decode whole lanes (the one
    pass; count and place); the general path's resolve walk always reads
    words from device memory and is not counted."""
    wn = words.shape[1]
    staged = (wn % 4 == 0 and words.data_ptr() % 16 == 0
              and CTA_LANES * (wn + 4) * 4 <= STAGE_BYTES)
    ROUTE_LAUNCHES["staged" if staged else "lookahead"] += 1
    return int(staged)


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
    # Every block belongs to exactly one lane's region, and the kernel
    # stores each of them whole: no zero fill.
    coeffs = torch.empty(frames * total_blocks, 64, dtype=torch.int32,
                         device=dev)
    counts = torch.empty(S, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.jt_decode_segments(
            tables.data_ptr(), words.data_ptr(), nbits.data_ptr(),
            coeffs.data_ptr(), counts.data_ptr(),
            S, wn, spf, ri, total_blocks, plan.blocks_per_mcu, plan.n_mcus,
            int(plan.interleaved), kernel_m_x(plan), huffval_pad(plan),
            _staged_ints(plan), _route(words),
            cuda_stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"decode_segments launch failed: CUDA error {rc}")
    decode_segments.launches += 1
    return coeffs, counts


decode_segments.launches = 0


def _layout(per: torch.Tensor):
    """[frames, spf] int64 lane MCU counts -> (first MCU of each lane,
    first lane of the frame with that first MCU), both [frames, spf]."""
    off = per.cumsum(1) - per
    return off, torch.searchsorted(off, off)  # offsets never decrease


def lane_layout(counts: torch.Tensor, frames: int, spf: int):
    """Per-lane (first MCU, first lane of the frame with that first MCU),
    both [S] int32, from the lane MCU counts: the general kernel's
    placement inputs."""
    off, first = _layout(counts.to(torch.int64).reshape(frames, spf))
    return (off.reshape(-1).to(torch.int32).contiguous(),
            first.reshape(-1).to(torch.int32).contiguous())


def contested_rows(counts: torch.Tensor, partial: torch.Tensor, frames: int,
                   spf: int, n_mcus: int) -> torch.Tensor:
    """Lane-boundary MCUs that two lanes write: [frames * (spf + 1)] int32.

    Row ``r`` of a frame is the MCU where lane ``r`` starts (row ``spf``:
    where the last lane ends); lanes that start at one MCU share the row of
    the first of them, as the owner keys do.  Its writers are the lane that
    decodes it whole (the first lane from ``r`` on with a nonzero count)
    and every ``partial`` lane (one that wrote into the MCU it died in,
    ``counts[k]``) ending there: row ``k + 1``, or its own first row when it
    decoded no whole MCU.  A row is contested when it has two writers and
    its MCU lies in the frame.  Torch ops only, no host sync.
    """
    per = counts.to(torch.int64).reshape(frames, spf)
    off, first = _layout(per)
    start = torch.cat([off, off[:, -1:] + per[:, -1:]], 1)
    k1 = torch.arange(1, spf + 1, device=per.device).expand(frames, spf)
    row = torch.where(per == 0, first, k1)
    writers = torch.zeros(frames, spf + 1, dtype=torch.int64,
                          device=per.device).scatter_add_(
        1, row, partial.to(torch.int64).reshape(frames, spf))
    whole = (per > 0).to(torch.int64).flip(1).cummax(1).values.flip(1)
    writers[:, :spf] += whole
    return ((start < n_mcus) & (writers >= 2)).to(torch.int32).reshape(-1)


def partial_lanes(counts: torch.Tensor, em_key: torch.Tensor) -> torch.Tensor:
    """[S] int32, 1 where a lane of the plain scan (``scan_lanes``) emitted
    a write into its MCU ``counts[lane]``, the one it died in."""
    mcu = (em_key.to(torch.int64) - 1) >> 10
    hit = (em_key > 0) & (mcu == counts.to(torch.int64)[None, :])
    return hit.any(0).to(torch.int32)


def _check_perm(perm: Optional[torch.Tensor], S: int,
                device: torch.device, checked: bool = False) -> int:
    """Validate a lane order for a CUDA launch; -> its pointer (0 for
    None).  ``perm`` must be a permutation of ``range(S)``, as
    ``DeviceDecoder.prepare(..., lane_order=True)`` gives it
    (``Prepared.perm``): the kernel writes each lane's outputs at
    ``perm[lane]`` and counts a frame laid out when ``spf`` of its lanes
    have stored, so a lane repeated or out of range writes outside them.
    Its dtype, device and length are checked; unless ``checked`` (the
    caller built it as a permutation), its values too, by the plain
    version's check on a host copy (one host read, ValueError)."""
    if perm is None:
        return 0
    _check_tensor("perm", perm, 1, device)
    if perm.shape[0] != S:
        raise ValueError(f"perm holds {perm.shape[0]} lanes, words {S}")
    if not checked:
        _check_perm_ref(perm.cpu(), S)
    return perm.data_ptr()


def _count_walk(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                frames: int, spf: int, tickets: torch.Tensor, staged: int,
                perm: Optional[torch.Tensor] = None,
                nsteps: Optional[torch.Tensor] = None):
    """The general path's first launch on a CUDA tensor: the count walk
    with the layout folded in, on the word route ``staged`` (``_route``).
    ``tickets`` holds ``frames`` int32 zeros (the walk's per-frame count of
    lanes stored; zeros again when it ends).  ``perm`` (checked by the
    caller, ``_check_perm``) is the lane order of ``words`` and ``nbits``;
    ``nsteps``, where given, an [S] int32 tensor that receives each lane's
    steps begun alive.  -> (counts, partial, lane_off, lane_first [S],
    contested [frames * (spf + 1)], all int32 and frame-major; bkey, the
    owner keys with the contested rows zeroed).  The caller has run
    ``_check_launch``."""
    dev = words.device
    S, wn = words.shape

    from ..kernels import load_library

    lib = load_library().lib
    bpm = plan.blocks_per_mcu
    counts, partial, off, first = (
        torch.empty(S, dtype=torch.int32, device=dev) for _ in range(4))
    contested = torch.empty(frames * (spf + 1), dtype=torch.int32,
                            device=dev)
    # Owner keys; the walk zeroes the contested rows, the only ones used.
    bkey = torch.empty(frames * (spf + 1) * bpm * 64, dtype=torch.int64,
                       device=dev)
    with torch.cuda.device(dev):
        rc = lib.jt_decode_segments_count(
            _device_tables(plan, dev).data_ptr(), words.data_ptr(),
            nbits.data_ptr(), counts.data_ptr(), partial.data_ptr(),
            off.data_ptr(), first.data_ptr(), contested.data_ptr(),
            bkey.data_ptr(), tickets.data_ptr(),
            0 if perm is None else perm.data_ptr(),
            0 if nsteps is None else nsteps.data_ptr(), S, wn, spf,
            bpm, plan.n_mcus, int(plan.interleaved), kernel_m_x(plan),
            huffval_pad(plan), _staged_ints(plan), staged, cuda_stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"decode_segments_general pass 1 failed: CUDA error {rc}")
    return counts, partial, off, first, contested, bkey


def _general_layout(plan: ScanPlan, words: torch.Tensor, nbits: torch.Tensor,
                    frames: int, spf: int, total_blocks: int,
                    perm: Optional[torch.Tensor] = None,
                    perm_checked: bool = False):
    """The general path's placement inputs, for checks: (counts, partial,
    lane_off, lane_first [S], contested [frames * (spf + 1)]), all int32
    and frame-major (``perm`` and ``perm_checked`` as
    ``decode_segments_general``).  A CUDA
    tensor runs the count walk alone (its layout folded in; no launch
    counted); a CPU tensor the plain scan (``scan_lanes``,
    ``partial_lanes``), ``lane_layout`` and ``contested_rows``.  Anything
    else raises."""
    if words.device.type == "cpu":
        check_shape(plan, frames, spf, total_blocks)
        _check_perm_ref(perm, words.shape[0])
        counts, key, _, _ = scan_lanes(plan, words, nbits)
        partial = _to_frame_major(partial_lanes(counts, key), perm)
        counts = _to_frame_major(counts, perm)
        return (counts, partial, *lane_layout(counts, frames, spf),
                contested_rows(counts, partial, frames, spf, plan.n_mcus))
    dev = _check_launch(plan, words, nbits, frames, spf, total_blocks)
    _check_perm(perm, words.shape[0], dev, perm_checked)
    tickets = torch.zeros(frames, dtype=torch.int32, device=dev)
    return _count_walk(plan, words, nbits, frames, spf, tickets,
                       _route(words), perm)[:5]


def decode_segments_general(plan: ScanPlan, words: torch.Tensor,
                            nbits: torch.Tensor, frames: int, spf: int,
                            total_blocks: int, lane_base: LaneBase = None,
                            perm: Optional[torch.Tensor] = None,
                            want_nsteps: bool = False,
                            perm_checked: bool = False):
    """Decode ``frames * spf`` restart segments of any shape the kernel
    tables hold (prefix-sum placement).  Arguments and result as
    ``decode_segments``; the restart interval plays no part.

    A CUDA tensor launches the walks of ``csrc/decode_segments.cu`` (count
    with partial flags and the layout; place; resolve the contested MCUs),
    counted once per call in ``decode_segments_general.launches`` (and,
    with a ``perm``, in ``decode_segments_general.lane_order_launches``);
    a CPU tensor runs ``decode_segments_general_ref``.  Anything else
    raises.

    ``lane_base`` (default none) maps the lane MCU counts to an MCU base
    added to every lane's first MCU after the count walk and before the
    place walk, on the device and with no host sync: the context-parallel
    frame decode (``parallel.sharding``) decodes a slice of one frame's
    lanes and places them after the earlier slices' MCUs, the JAX
    placement's ``seg_offset``.  The contested rows stay those of the
    slice's own offsets: a row past the frame by the global offset is
    marked where it may not be, and there every write is dropped anyway.

    ``perm`` (default none) is a lane order: an [S] int32 permutation,
    sorted lane -> frame-major lane, with the rows of ``words`` and
    ``nbits`` in sorted order (``DeviceDecoder``'s sorted rows prep, the
    input of jpeg_tpu's phased scan: take it from that prep's
    ``Prepared.perm``).  One that is not a permutation raises ValueError:
    the plain version checks it on the device, the CUDA launch on a host
    copy (one host read, ``_check_perm``), unless ``perm_checked`` says
    the caller built it as one (``DeviceDecoder``'s own order, so that a
    batch keeps its one host read).  Lanes decode in that order, where
    two lanes write one coefficient the latest in (step, sorted lane)
    order wins (jpeg_tpu's ``_place_emissions(perm=...)``), and the MCU
    counts come back frame-major all the same.  ``want_nsteps`` adds a
    third result, each lane's steps begun alive ([S] int32, frame-major:
    the lockstep scan's ``nsteps``, which the phased scan's learning pass
    reads), written by the count walk.
    """
    if words.device.type == "cpu":
        return decode_segments_general_ref(plan, words, nbits, frames, spf,
                                           total_blocks, lane_base=lane_base,
                                           perm=perm, want_nsteps=want_nsteps)
    dev = _check_launch(plan, words, nbits, frames, spf, total_blocks)
    S, wn = words.shape
    perm_ptr = _check_perm(perm, S, dev, perm_checked)
    staged = _route(words)
    # One zero fill serves the coefficients (the place walk writes into
    # zeros) and, past them, the count walk's per-frame tickets.
    n = frames * total_blocks * 64
    buf = torch.zeros(n + frames, dtype=torch.int32, device=dev)
    nsteps = (torch.empty(S, dtype=torch.int32, device=dev) if want_nsteps
              else None)
    counts, partial, off, first, contested, bkey = _count_walk(
        plan, words, nbits, frames, spf, buf[n:], staged, perm, nsteps)
    coeffs = buf[:n].view(frames * total_blocks, 64)
    if lane_base is not None:
        off.add_(lane_base(counts).to(torch.int32))

    from ..kernels import load_library

    with torch.cuda.device(dev):
        rc = load_library().lib.jt_decode_segments_place(
            _device_tables(plan, dev).data_ptr(), words.data_ptr(),
            nbits.data_ptr(), counts.data_ptr(), off.data_ptr(),
            first.data_ptr(), partial.data_ptr(), contested.data_ptr(),
            bkey.data_ptr(), coeffs.data_ptr(), perm_ptr, S, wn, spf,
            total_blocks, plan.blocks_per_mcu, plan.n_mcus,
            int(plan.interleaved), kernel_m_x(plan), huffval_pad(plan),
            _staged_ints(plan), staged, cuda_stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"decode_segments_general passes 2-3 failed: CUDA error {rc}")
    decode_segments_general.launches += 1
    if perm is not None:
        decode_segments_general.lane_order_launches += 1
    if want_nsteps:
        return coeffs, counts, nsteps
    return coeffs, counts


decode_segments_general.launches = 0
decode_segments_general.lane_order_launches = 0  # those with a ``perm``
