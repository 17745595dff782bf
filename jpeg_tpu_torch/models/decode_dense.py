"""Dense decode tail: plane-major coefficients -> pixel frames.

``coeffs_to_pixels`` is the port of the JAX package's dense device
program (``jpeg_tpu/models/device_decode.py:149``: dequantize -> IDCT ->
level shift -> nearest-neighbour upsample -> colour -> round/clip ->
uint8/uint16).
On a CUDA tensor it launches the hand-written kernel
``csrc/decode_dense.cu``, a persistent grid whose CTAs walk the tiles of
MCUs (``tile_plan``), each tile's coefficients copied in by its runs
(``tile_runs``) one tile ahead; on a CPU tensor it runs the plain version
``coeffs_to_pixels_ref``, built from the port's plain ops the same way
the JAX program is built from its own.

Contract (both versions): ``coeffs`` [F, total_blocks, 64] int32,
plane-major (components in geometry order, each component's blocks in
raster order, each block in raster order); ``qtables`` [F, 4, 64] int32,
one set of tables per frame, contiguous or with a frame stride of 0 (an
``expand`` of one set).  Output [F, H, W, C] contiguous, uint8 up to 8
bits and uint16 above, C = 3 for three or four components (the K of YCCK
is dropped) and 1 for grayscale.  The kernel runs a separable float32
IDCT where the plain version multiplies by the [64, 64] Kronecker
operator, so the two agree within +-1 per sample.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..device import check_tensor, cuda_stream
from ..errors import UnsupportedError
from ..geometry import FrameGeometry
from ..models.batch import decode_blocks_batch
from ..ops.color import to_rgb, ycc_to_rgb_planar
from ..ops.dct import lut_on
from ..ops.resample import upsample_nn
from ..utils.floatops import roundf

# Per-component int32 record shared with csrc/decode_dense.cu: sampling
# factors h, v; upsampling steps step_y, step_x; first block of the
# component's plane in a frame; blocks per component row b_x;
# quantization table selector tq; first block of the component in an MCU.
COMP_INTS = 8
C_MAX = 4
TILE_BLOCKS = 64  # blocks of one tile; csrc/decode_dense.cu
# A run of a tile (csrc RUN_INTS): component j, block row r of the MCU row,
# the run's first stage slot per MCU (first_j + r * h_j) and its blocks per
# MCU (h_j).  A tile of n MCUs copies run (j, r) from plane block
# first_block_j + (my * v_j + r) * b_x_j + tx * mcus * h_j, n * h_j blocks,
# to stage slot n * (first_j + r * h_j).  One run per component block row:
# at most 10 for a baseline MCU, RUN_MAX for any C_MAX components.
RUN_INTS = 4
RUN_MAX = 16
PLAN_INTS = C_MAX * COMP_INTS + RUN_MAX * RUN_INTS  # csrc PLAN_INTS


def check_geometry(geom: FrameGeometry) -> None:
    """Raise ``UnsupportedError`` for frames the dense tail does not take:
    a component count other than 1, 3 or 4, or a component whose
    nearest-neighbour upsampled plane does not cover the frame (its
    sampling factors do not divide the largest ones)."""
    if geom.nf not in (1, 3, 4):
        raise UnsupportedError(
            f"dense decode takes 1, 3 or 4 components, not {geom.nf}")
    for c in geom.components:
        if geom.max_h % c.h or geom.max_v % c.v:
            raise UnsupportedError(
                f"component {c.cid}'s sampling (h={c.h}, v={c.v}) does not "
                f"divide the frame's largest (h={geom.max_h}, "
                f"v={geom.max_v}): its upsampled plane would not cover "
                "the frame")


def coeffs_to_pixels_ref(coeffs: torch.Tensor, qtables: torch.Tensor,
                         geom: FrameGeometry) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    check_geometry(geom)
    size_y, size_x = geom.size_y, geom.size_x
    chans = []
    off = 0
    for comp in geom.components:
        n = comp.n_blocks
        plane = decode_blocks_batch(
            coeffs[:, off : off + n], qtables[:, comp.tq, None, :],
            comp.b_y, comp.b_x, geom.precision,
        )
        off += n
        chans.append(
            upsample_nn(plane, size_y // (comp.b_y * 8), size_x // (comp.b_x * 8))
        )
    maxval = (1 << geom.precision) - 1
    out_dt = torch.uint8 if geom.precision <= 8 else torch.uint16
    h, w = geom.height, geom.width

    def quantize(p):
        return roundf(p).clamp(0, maxval).to(out_dt)

    if geom.nf == 3:
        # Planar color math; crop before the one interleave.
        r, g, b = ycc_to_rgb_planar(chans[0], chans[1], chans[2],
                                    geom.precision)
        return torch.stack(
            [quantize(c[:, :h, :w]) for c in (r, g, b)], dim=-1
        )
    rgb = to_rgb(torch.stack(chans, dim=-1), geom.precision)
    # Drop the dummy K channel of YCCK frames (write_frame semantics,
    # frame.c:548-567): deliverable is RGB (or one gray channel).
    nch = 3 if geom.nf >= 3 else 1
    return quantize(rgb[:, :h, :w, :nch]).contiguous()


@dataclass(frozen=True)
class TilePlan:
    """How ``csrc/decode_dense.cu`` cuts a frame into tiles: a tile is up
    to ``mcus`` MCUs of one MCU row (the row's last tile may hold fewer),
    so its blocks are at most ``TILE_BLOCKS`` and its pixels ``mcu_h``
    rows of ``mcus * mcu_w`` columns of the MCU-padded frame."""

    mcus: int  # MCUs of a full tile
    tiles_x: int  # tiles per MCU row
    mcu_w: int  # pixel columns of one MCU
    mcu_h: int  # pixel rows of one MCU (and of a tile)
    bpm: int  # blocks per MCU
    comps: np.ndarray  # [C_MAX, COMP_INTS] int32, geometry order
    runs: np.ndarray  # [n_runs, RUN_INTS] int32: a tile's copies


def tile_plan(geom: FrameGeometry) -> TilePlan:
    """The kernel's tiles of ``geom`` (which ``check_geometry`` takes)."""
    bpm = sum(c.h * c.v for c in geom.components)
    mcus = max(1, min(TILE_BLOCKS // bpm, geom.m_x))
    t = np.zeros((C_MAX, COMP_INTS), np.int32)
    runs = []
    off = first = 0
    for j, c in enumerate(geom.components):
        t[j] = (c.h, c.v, geom.max_v // c.v, geom.max_h // c.h, off, c.b_x,
                c.tq, first)
        runs += [(j, r, first + r * c.h, c.h) for r in range(c.v)]
        off += c.n_blocks
        first += c.h * c.v
    return TilePlan(mcus=mcus, tiles_x=-(-geom.m_x // mcus),
                    mcu_w=8 * geom.max_h, mcu_h=8 * geom.max_v, bpm=bpm,
                    comps=t, runs=np.array(runs, np.int32).reshape(-1,
                                                                   RUN_INTS))


def tile_runs(plan: TilePlan, m_x: int, my: int, tx: int) -> list:
    """The copies of tile (``my``, ``tx``) of a frame ``m_x`` MCUs wide,
    as the kernel issues them: [(component, first plane block (frame-
    relative, components in geometry order), blocks, first stage slot)].
    Each is one contiguous run of 256-byte blocks in the plane, copied a
    block (one bulk copy) to a stage slot, so every copy is 16-byte
    aligned wherever the frame's coefficients are."""
    n = min(plan.mcus, m_x - tx * plan.mcus)
    out = []
    for j, r, slot, h in plan.runs.tolist():
        c = plan.comps[j]
        first = int(c[4]) + (my * int(c[1]) + r) * int(c[5]) + \
            tx * plan.mcus * int(c[0])
        out.append((j, first, n * h, n * slot))
    return out


@lru_cache(maxsize=16)
def _device_consts(geom: FrameGeometry, device: torch.device):
    plan = tile_plan(geom)
    if plan.runs.shape[0] > RUN_MAX:
        raise UnsupportedError(f"{plan.runs.shape[0]} block rows an MCU, "
                               f"more than {RUN_MAX}")
    packed = np.zeros(PLAN_INTS, np.int32)
    packed[:C_MAX * COMP_INTS] = plan.comps.reshape(-1)
    packed[C_MAX * COMP_INTS:C_MAX * COMP_INTS + plan.runs.size] = \
        plan.runs.reshape(-1)
    return lut_on(device), torch.from_numpy(packed).to(device), plan


def coeffs_to_pixels(coeffs: torch.Tensor, qtables: torch.Tensor,
                     geom: FrameGeometry) -> torch.Tensor:
    """[F, total_blocks, 64] int32 coefficients and [F, 4, 64] int32
    tables -> [F, H, W, C] pixels (uint8, or uint16 above 8 bits).

    A CUDA tensor launches the kernel (counted in
    ``coeffs_to_pixels.launches``); a CPU tensor runs
    ``coeffs_to_pixels_ref``.  Anything else raises, as does a geometry
    ``check_geometry`` refuses.
    """
    check_geometry(geom)
    if coeffs.device.type == "cpu":
        return coeffs_to_pixels_ref(coeffs, qtables, geom)
    if coeffs.device.type != "cuda":
        raise ValueError(f"coeffs_to_pixels: unsupported device "
                         f"{coeffs.device}")
    dev = coeffs.device
    f = int(coeffs.shape[0])
    tb = sum(c.n_blocks for c in geom.components)
    check_tensor("coeffs", coeffs, (torch.int32,), (f, tb, 64), dev)
    if tuple(qtables.shape) != (f, 4, 64):
        raise ValueError(f"qtables must have shape {(f, 4, 64)}, got "
                         f"{tuple(qtables.shape)}")
    # One set of tables per frame, or one set for all (frame stride 0).
    shared = qtables.stride(0) == 0
    check_tensor("qtables", qtables[:1] if shared else qtables,
                 (torch.int32,), (1 if shared else f, 4, 64), dev)

    from ..kernels import load_library

    lut, ctab, plan = _device_consts(geom, dev)
    nc = 3 if geom.nf >= 3 else 1
    out_dt = torch.uint8 if geom.precision <= 8 else torch.uint16
    out = torch.empty(f, geom.height, geom.width, nc, dtype=out_dt,
                      device=dev)
    if f == 0:
        return out
    with torch.cuda.device(dev):
        rc = load_library().lib.jt_coeffs_to_pixels(
            coeffs.data_ptr(), qtables.data_ptr(), lut.data_ptr(),
            ctab.data_ptr(), out.data_ptr(), int(out_dt == torch.uint16), f,
            geom.height, geom.width, geom.nf, nc, geom.precision, tb,
            geom.m_x, geom.m_y, plan.mcus, plan.tiles_x, plan.mcu_w,
            plan.mcu_h, plan.bpm, 0 if shared else 4 * 64,
            plan.runs.shape[0], cuda_stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"coeffs_to_pixels launch failed: CUDA error {rc}")
    coeffs_to_pixels.launches += 1
    return out


coeffs_to_pixels.launches = 0
