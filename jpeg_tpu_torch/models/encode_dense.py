"""Dense encode stage: pixel frames -> quantized zig-zag blocks.

``pixels_to_zz`` is the port of the JAX package's device program
``device_encode._pixels_to_zz`` (colour convert -> box downsample -> level
shift -> FDCT -> quantize -> zig-zag -> differential DC).  On a CUDA
tensor it launches the hand-written kernel ``csrc/encode_dense.cu``,
which encodes one tile of MCUs per CTA step (``tile_plan``); on a CPU
tensor it runs the plain version ``pixels_to_zz_ref``, built from the
port's plain ops the same way the JAX program is built from its own.

Output contract (both versions, as in JAX): ``[F * Bf, 64]`` int32 blocks
in NATURAL order (component-major raster, components sorted by id), each
row in zig-zag order, with the DC of every block replaced by its
difference to the previous same-component block of its restart interval
(``prev_idx``: natural row -> natural row, -1 at interval starts).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..constants import INV_ZIGZAG, ZIGZAG
from ..device import check_tensor
from ..geometry import FrameGeometry
from ..models.batch import encode_plane_batch
from ..ops.color import rgb_to_ycc
from ..ops.dct import _kron_mats
from ..ops.resample import downsample_box

# Per-component int32 record shared with csrc/encode_dense.cu: sampling
# factors h, v; box steps step_y, step_x; first natural row; blocks per
# component row b_x; quantization table; first block of the component in
# an MCU.
COMP_INTS = 8
C_MAX = 3
TILE_BLOCKS = 64  # blocks of one tile; csrc/encode_dense.cu


def raster_to_zz(allz: torch.Tensor, prev_idx: torch.Tensor) -> torch.Tensor:
    """[F, Bf, 64] raster-order quantized blocks (natural row order) ->
    [F * Bf, 64] zig-zag rows with differential DC."""
    f, bf, _ = allz.shape
    zig = torch.from_numpy(ZIGZAG.astype(np.int64)).to(allz.device)
    zz = allz.index_select(2, zig)
    dc = zz[:, :, 0]
    prev = prev_idx.to(device=allz.device, dtype=torch.int64)
    pred = torch.where(prev >= 0, dc.index_select(1, prev.clamp(min=0)),
                       torch.zeros_like(dc))
    zz = torch.cat([(dc - pred)[:, :, None], zz[:, :, 1:]], dim=2)
    return zz.reshape(f * bf, 64)


def _padded(x: torch.Tensor, geom: FrameGeometry) -> torch.Tensor:
    """Edge-replicate [F, H, W, C] up to the MCU-aligned frame size."""
    if geom.size_y == geom.height and geom.size_x == geom.width:
        return x
    dev = x.device
    ys = torch.arange(geom.size_y, device=dev).clamp(max=geom.height - 1)
    xs = torch.arange(geom.size_x, device=dev).clamp(max=geom.width - 1)
    return x.index_select(1, ys).index_select(2, xs)


def pixels_to_zz_ref(pixels: torch.Tensor, qtables: torch.Tensor,
                     prev_idx: torch.Tensor, geom: FrameGeometry):
    """Plain PyTorch version of the kernel, on any device.

    ``pixels`` [F, H, W, C] uint8/uint16, ``qtables`` [2, 64] int32 (luma,
    chroma, raster order), ``prev_idx`` [Bf] int32.
    """
    x = _padded(pixels.to(torch.float32), geom)
    comps = sorted(geom.components, key=lambda c: c.cid)
    if len(comps) == 3:
        ycc = rgb_to_ycc(x, geom.precision)
        if geom.size_y != geom.height or geom.size_x != geom.width:
            # Reference quirk (frame_to_ycc, frame.c:162-163): colour
            # conversion only touches the true [height, width] window; the
            # MCU padding keeps raw replicated RGB into the DCT.
            dev = x.device
            in_y = torch.arange(geom.size_y, device=dev)[:, None] < geom.height
            in_x = torch.arange(geom.size_x, device=dev)[None, :] < geom.width
            ycc = torch.where((in_y & in_x)[None, :, :, None], ycc, x)
        chans = [ycc[..., 0], ycc[..., 1], ycc[..., 2]]
    else:
        chans = [x[..., 0]]
    parts = []
    for comp, chan in zip(comps, chans):
        sy = geom.size_y // (comp.b_y * 8)
        sx = geom.size_x // (comp.b_x * 8)
        if sy > 1 or sx > 1:
            chan = downsample_box(chan, sy, sx)
        qt = qtables[0] if comp.tq == 0 else qtables[1]
        parts.append(encode_plane_batch(chan, qt, geom.precision))
    return raster_to_zz(torch.cat(parts, dim=1), prev_idx)


@dataclass(frozen=True)
class TilePlan:
    """How ``csrc/encode_dense.cu`` cuts a frame into tiles: a tile is up
    to ``mcus`` MCUs of one MCU row (the row's last tile may hold fewer),
    so its pixels are ``mcu_h`` rows of ``mcus * mcu_w`` columns of the
    MCU-padded frame and its blocks at most ``TILE_BLOCKS``."""

    mcus: int  # MCUs of a full tile
    tiles_x: int  # tiles per MCU row
    mcu_w: int  # pixel columns of one MCU
    mcu_h: int  # pixel rows of one MCU (and of a tile)
    bpm: int  # blocks per MCU
    comps: np.ndarray  # [C_MAX, COMP_INTS] int32, components sorted by id


def tile_plan(geom: FrameGeometry) -> TilePlan:
    """The kernel's tiles of ``geom``.  Raises ``ValueError`` unless every
    component's box (its downsampling steps) is 1 x 1 or the frame's
    largest, with steps of 1 or 2: what every encoder geometry has, and
    what the kernel's sample phase takes."""
    comps = sorted(geom.components, key=lambda c: c.cid)
    bpm = sum(c.h * c.v for c in comps)
    mcus = max(1, min(TILE_BLOCKS // bpm, geom.m_x))
    t = np.zeros((C_MAX, COMP_INTS), np.int32)
    off = first = 0
    for j, c in enumerate(comps):
        t[j] = (c.h, c.v, geom.size_y // (c.b_y * 8),
                geom.size_x // (c.b_x * 8), off, c.b_x,
                0 if c.tq == 0 else 1, first)
        off += c.n_blocks
        first += c.h * c.v
    steps = {(int(y), int(x)) for y, x in t[:len(comps), 2:4]}
    cell = (max(y for y, _ in steps), max(x for _, x in steps))
    if not steps <= {(1, 1), cell} or max(cell) > 2:
        raise ValueError(f"pixels_to_zz: component boxes {sorted(steps)} "
                         "are not 1 x 1 or one common box of steps 1..2")
    return TilePlan(mcus=mcus, tiles_x=-(-geom.m_x // mcus),
                    mcu_w=8 * geom.max_h, mcu_h=8 * geom.max_v, bpm=bpm,
                    comps=t)


@lru_cache(maxsize=16)
def _device_consts(geom: FrameGeometry, device: torch.device):
    fdct = torch.from_numpy(_kron_mats()[1]).to(device)
    inv = torch.from_numpy(INV_ZIGZAG.astype(np.int32)).to(device)
    plan = tile_plan(geom)
    return fdct, inv, torch.from_numpy(plan.comps).to(device), plan


def pixels_to_zz(pixels: torch.Tensor, qtables: torch.Tensor,
                 prev_idx: torch.Tensor, geom: FrameGeometry) -> torch.Tensor:
    """[F, H, W, C] pixels -> [F * Bf, 64] int32 natural-order zig-zag
    blocks with differential DC.

    A CUDA tensor launches the kernel (counted in
    ``pixels_to_zz.launches``); a CPU tensor runs ``pixels_to_zz_ref``.
    Anything else raises.
    """
    if pixels.device.type == "cpu":
        return pixels_to_zz_ref(pixels, qtables, prev_idx, geom)
    if pixels.device.type != "cuda":
        raise ValueError(f"pixels_to_zz: unsupported device {pixels.device}")
    dev = pixels.device
    comps = sorted(geom.components, key=lambda c: c.cid)
    nc = len(comps)
    if nc not in (1, 3):
        raise ValueError("pixels_to_zz takes 1 or 3 components")
    f = int(pixels.shape[0])
    check_tensor("pixels", pixels, (torch.uint8, torch.uint16),
                 (f, geom.height, geom.width, nc), dev)
    check_tensor("qtables", qtables, (torch.int32,), (2, 64), dev)
    bf = sum(c.n_blocks for c in comps)
    check_tensor("prev_idx", prev_idx, (torch.int32,), (bf,), dev)

    from ..kernels import load_library

    lib = load_library().lib
    fdct, inv, ctab, plan = _device_consts(geom, dev)
    zz = torch.empty(f * bf, 64, dtype=torch.int32, device=dev)
    dc_raw = torch.empty(f * bf, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jt_pixels_to_zz(
            pixels.data_ptr(), int(pixels.dtype == torch.uint16),
            fdct.data_ptr(), inv.data_ptr(), ctab.data_ptr(),
            qtables.data_ptr(), prev_idx.data_ptr(), zz.data_ptr(),
            dc_raw.data_ptr(), f, geom.height, geom.width, nc,
            geom.precision, bf, geom.m_x, geom.m_y, plan.mcus, plan.tiles_x,
            plan.mcu_w, plan.mcu_h, plan.bpm, ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"pixels_to_zz launch failed: CUDA error {rc}")
    pixels_to_zz.launches += 1
    return zz


pixels_to_zz.launches = 0
