"""The fast mode's dense stages: coefficients <-> float frames (K11, K12).

``decode_frame_fast`` (K11) is the port of the JAX package's jitted
``api._jitted_decode_frame(geom, exact=False)`` (``models/pipeline.
decode_frame``: dequantize -> float32 IDCT -> level shift -> blocks to
plane -> nearest-neighbour upsample -> float32 colour), and
``encode_frame_fast`` (K12) of ``encoder._jitted_encode_frame(geom,
exact=False)`` (``models/pipeline.encode_frame``: float32 RGB -> YCbCr in
the true window -> box downsample -> level shift -> FDCT -> quantize).
On a CUDA tensor each launches its kernel of ``csrc/dense_fast.cu`` and
counts the launch in ``<wrapper>.launches``; on a CPU tensor it runs its
plain version (``*_ref``), the eager PyTorch chain of the JAX program;
anything else raises.

Contract (both versions): ``coeffs`` int32 ``[total_blocks, 64]``,
plane-major (components in geometry order, each component's blocks in
raster order, each block in raster order); ``qtables`` int32 ``[4, 64]``.
The decode output is the float32 frame ``[size_y, size_x, Nf]`` before
any rounding or clipping, channels in ascending component id; the encode
input is that float32 padded RGB raster, its output the int32 plane-major
raster.  The kernels sum their DCTs in another order than the plain
versions' products, so floats agree within ~1e-4 and quantized values
within +-1 where ``c / q`` sits on a rounding boundary.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..device import check_tensor, cuda_stream
from ..errors import UnsupportedError
from ..geometry import FrameGeometry
from ..ops.blocks import blocks_to_plane, plane_to_blocks
from ..ops.color import rgb_to_ycc, to_rgb
from ..ops.dct import fdct8x8_matmul, idct8x8_matmul, lut_on
from ..ops.quant import dequantize, quantize
from ..ops.resample import downsample_box, upsample_nn
from .encode_dense import TILE_BLOCKS  # K12 cuts its tiles as K5 does

# Per-component int32 record shared with csrc/dense_fast.cu, geometry
# order: sampling factors h, v; steps step_y, step_x (size // plane size:
# the upsampling patch, or the downsampling box); first block of the
# component's plane; blocks per component row b_x; quantization table
# selector tq; frame channel (decode: the output channel, the rank of the
# component id; encode: the input channel, the geometry index).
COMP_INTS = 8
C_MAX = 4
TILE_COLS = 128  # pixel columns a decode tile aims at; whole MCUs
BLOCK_FLOATS = 72  # csrc BP: a block's floats in a CTA's stage
# Shared memory a CTA may ask for (the H100's 227 KB, less headroom).
SMEM_MAX = 200 * 1024


def _first_blocks(geom: FrameGeometry) -> dict:
    """cid -> first block of the component's plane, geometry order."""
    out, off = {}, 0
    for c in geom.components:
        out[c.cid] = off
        off += c.n_blocks
    return out


def decode_frame_fast_ref(coeffs: torch.Tensor, qtables: torch.Tensor,
                          geom: FrameGeometry) -> torch.Tensor:
    """Plain PyTorch version of K11, on any device."""
    size_y, size_x = geom.size_y, geom.size_x
    first = _first_blocks(geom)
    chans = []
    # The reference assembles channels by ASCENDING component id
    # (transform_components_to_frame walks ids 0..255, frame.c:49-81),
    # not SOF order; the lowest id becomes channel 0 (= Y for color).
    for comp in sorted(geom.components, key=lambda c: c.cid):
        off = first[comp.cid]
        flt = dequantize(coeffs[off:off + comp.n_blocks],
                         qtables[comp.tq]).reshape(-1, 8, 8)
        shifted = idct8x8_matmul(flt) + float(1 << (geom.precision - 1))
        plane = blocks_to_plane(shifted, comp.b_y, comp.b_x)
        c_y, c_x = comp.b_y * 8, comp.b_x * 8
        step_y = size_y // c_y if c_y else 1
        step_x = size_x // c_x if c_x else 1
        up = upsample_nn(plane, step_y, step_x)
        if tuple(up.shape[-2:]) != (size_y, size_x):
            # Non-dividing sampling ratio (corrupt/exotic SOF): the
            # reference paints step_y x step_x patches and NEVER touches
            # the remaining frame margin -- malloc'd storage, which for
            # the fresh context pages reads as 0.0 (frame.c:28,60-76).
            full = torch.zeros(size_y, size_x, dtype=up.dtype,
                               device=up.device)
            crop = up[..., :size_y, :size_x]
            full[: crop.shape[-2], : crop.shape[-1]] = crop
            up = full
        chans.append(up)
    return to_rgb(torch.stack(chans, dim=-1), geom.precision)


def encode_frame_fast_ref(frame: torch.Tensor, qtables: torch.Tensor,
                          geom: FrameGeometry) -> torch.Tensor:
    """Plain PyTorch version of K12, on any device.

    Color conversion only touches the true [height, width] window, exactly
    like frame_to_ycc (frame.c:162-163): the MCU padding keeps its raw
    replicated RGB values and flows into the DCT unconverted.  (A quirk,
    but required for byte-identical output with the reference encoder.)
    """
    ycc = rgb_to_ycc(frame, geom.precision)
    size_y, size_x = geom.size_y, geom.size_x
    if (size_y, size_x) != (geom.height, geom.width):
        dev = frame.device
        in_y = torch.arange(size_y, device=dev)[:, None] < geom.height
        in_x = torch.arange(size_x, device=dev)[None, :] < geom.width
        ycc = torch.where((in_y & in_x)[..., None], ycc, frame)
    shift = float(1 << (geom.precision - 1))
    out = []
    for comp in geom.components:
        c_y, c_x = comp.b_y * 8, comp.b_x * 8
        chan = downsample_box(ycc[..., geom.index_of(comp.cid)],
                              size_y // c_y, size_x // c_x)
        blocks = plane_to_blocks(chan, comp.b_y, comp.b_x)
        fdct = fdct8x8_matmul(blocks - shift)
        out.append(quantize(fdct.reshape(-1, 64), qtables[comp.tq]))
    return torch.cat(out)


def comp_records(geom: FrameGeometry, mode: str) -> np.ndarray:
    """The kernels' per-component records, ``[C_MAX, COMP_INTS]`` int32
    in geometry order; ``mode`` "decode" or "encode" picks the channel."""
    rank = {c.cid: i for i, c in enumerate(
        sorted(geom.components, key=lambda c: c.cid))}
    t = np.zeros((C_MAX, COMP_INTS), np.int32)
    off = 0
    for j, c in enumerate(geom.components):
        t[j] = (c.h, c.v, geom.size_y // (c.b_y * 8),
                geom.size_x // (c.b_x * 8), off, c.b_x, c.tq,
                rank[c.cid] if mode == "decode" else j)
        off += c.n_blocks
    return t


def _span(p0: int, p1: int, step: int, painted: int) -> tuple:
    """(first block, blocks) of a component's plane that the pixels
    [p0, p1) of one axis read: the samples p // step of the pixels below
    ``painted`` (the plane's size times its step; the pixels past it read
    no sample).  csrc/dense_fast.cu ``span``."""
    end = min(p1, painted)
    if p0 >= end:
        return 0, 0
    first = (p0 // step) // 8
    return first, ((end - 1) // step) // 8 - first + 1


@dataclass(frozen=True)
class DecodeTiles:
    """How K11 cuts a frame: tiles of ``tile_h`` x ``tile_w`` pixels of
    the padded frame (one MCU row high and whole MCUs wide where their
    blocks fit a CTA's shared memory; the last tile of a row or column
    may be smaller), a CTA each.  A CTA's stage holds the blocks its
    pixels read, per component, at most ``stage_blocks``."""

    tile_h: int
    tile_w: int
    tiles_y: int
    tiles_x: int
    stage_blocks: int


def tile_sources(geom: FrameGeometry, tiles: DecodeTiles, ty: int,
                 tx: int) -> list:
    """The blocks tile (``ty``, ``tx``) IDCTs into its stage, as the
    kernel computes them: per component in geometry order (br0, rows,
    bc0, cols), a rectangle of the component's block grid, stored
    component after component, each in raster order."""
    recs = comp_records(geom, "decode")
    y0, x0 = ty * tiles.tile_h, tx * tiles.tile_w
    y1 = min(y0 + tiles.tile_h, geom.size_y)
    x1 = min(x0 + tiles.tile_w, geom.size_x)
    out = []
    for j, c in enumerate(geom.components):
        sy, sx = int(recs[j, 2]), int(recs[j, 3])
        br0, nbr = _span(y0, y1, sy, c.b_y * 8 * sy)
        bc0, nbc = _span(x0, x1, sx, c.b_x * 8 * sx)
        out.append((br0, nbr, bc0, nbc))
    return out


def _tiles(geom: FrameGeometry, tile_h: int, tile_w: int) -> DecodeTiles:
    tiles = DecodeTiles(tile_h=tile_h, tile_w=tile_w,
                        tiles_y=-(-geom.size_y // tile_h),
                        tiles_x=-(-geom.size_x // tile_w), stage_blocks=0)
    # A tile's blocks per component are its row span times its column
    # span, so the largest total comes from the rows and columns apart.
    rows = np.array([[s[1] for s in tile_sources(geom, tiles, ty, 0)]
                     for ty in range(tiles.tiles_y)])
    cols = np.array([[s[3] for s in tile_sources(geom, tiles, 0, tx)]
                     for tx in range(tiles.tiles_x)])
    most = int((rows[:, None, :] * cols[None, :, :]).sum(-1).max())
    return DecodeTiles(tile_h, tile_w, tiles.tiles_y, tiles.tiles_x, most)


@lru_cache(maxsize=32)
def decode_tiles(geom: FrameGeometry) -> DecodeTiles:
    """K11's tiles of ``geom``: one MCU row of ~``TILE_COLS`` columns,
    halved (columns first, in steps of 8 pixels) while their blocks
    overflow a CTA's shared memory.  An 8 x 8 tile reads at most 2 x 2
    blocks a component, so every geometry gets tiles."""
    mcu_w, mcu_h = 8 * geom.max_h, 8 * geom.max_v
    tile_h, tile_w = mcu_h, mcu_w * max(1, min(TILE_COLS // mcu_w,
                                               geom.m_x))
    while True:
        tiles = _tiles(geom, tile_h, tile_w)
        if decode_smem(tiles) <= SMEM_MAX or tile_h == tile_w == 8:
            return tiles
        if tile_w > 8:
            tile_w = max(8, tile_w // 16 * 8)
        else:
            tile_h = max(8, tile_h // 16 * 8)


def decode_smem(tiles: DecodeTiles) -> int:
    """Shared memory bytes of a K11 CTA (csrc ``decode_smem``): the LUT,
    the tables, the records, each component's span, then the stage."""
    return (64 + 4 * 64 + C_MAX * COMP_INTS + C_MAX * 8) * 4 + \
        tiles.stage_blocks * BLOCK_FLOATS * 4


@dataclass(frozen=True)
class EncodeTiles:
    """How K12 cuts a frame, as K5 does: a tile is up to ``mcus`` MCUs of
    one MCU row (the row's last tile may hold fewer), a CTA each, so its
    pixels are ``mcu_h`` rows of ``mcus * mcu_w`` columns of the padded
    frame and its blocks at most ``TILE_BLOCKS``."""

    mcus: int
    tiles_x: int
    mcu_w: int
    mcu_h: int
    bpm: int


def encode_tiles(geom: FrameGeometry) -> EncodeTiles:
    """K12's tiles of ``geom``.  Raises ``ValueError`` if a component's
    sampling does not divide the frame's largest (its box would not tile
    the frame; the plain version cannot encode it either)."""
    for c in geom.components:
        if geom.max_h % c.h or geom.max_v % c.v:
            raise ValueError(
                f"encode_frame_fast: component {c.cid}'s sampling (h={c.h},"
                f" v={c.v}) does not divide the frame's largest")
    bpm = sum(c.h * c.v for c in geom.components)
    mcus = max(1, min(TILE_BLOCKS // bpm, geom.m_x))
    return EncodeTiles(mcus=mcus, tiles_x=-(-geom.m_x // mcus),
                       mcu_w=8 * geom.max_h, mcu_h=8 * geom.max_v, bpm=bpm)


def encode_smem(tiles: EncodeTiles, nc: int) -> int:
    """Shared memory bytes of a K12 CTA (csrc ``encode_smem``): the LUT,
    the tables, the records, the stage of the tile's blocks, then its
    float pixels."""
    return (64 + 4 * 64 + C_MAX * COMP_INTS) * 4 + \
        tiles.mcus * tiles.bpm * BLOCK_FLOATS * 4 + \
        tiles.mcu_h * tiles.mcus * tiles.mcu_w * nc * 4


@lru_cache(maxsize=32)
def _records_on(geom: FrameGeometry, mode: str, device: torch.device):
    return torch.from_numpy(comp_records(geom, mode)).to(device)


def decode_frame_fast(coeffs: torch.Tensor, qtables: torch.Tensor,
                      geom: FrameGeometry) -> torch.Tensor:
    """int32 ``[total_blocks, 64]`` plane-major coefficients and int32
    ``[4, 64]`` tables -> float32 ``[size_y, size_x, Nf]`` frame.

    A CUDA tensor launches K11 (counted in ``decode_frame_fast.
    launches``); a CPU tensor runs ``decode_frame_fast_ref``.  Anything
    else raises, as does a component count other than 1, 3 or 4; every
    sampling is taken.
    """
    if geom.nf not in (1, 3, 4):  # as ops.color.to_rgb refuses them
        raise ValueError(f"unsupported component count {geom.nf}")
    if coeffs.device.type == "cpu":
        return decode_frame_fast_ref(coeffs, qtables, geom)
    if coeffs.device.type != "cuda":
        raise ValueError(f"decode_frame_fast: unsupported device "
                         f"{coeffs.device}")
    dev = coeffs.device
    tb = sum(c.n_blocks for c in geom.components)
    check_tensor("coeffs", coeffs, (torch.int32,), (tb, 64), dev)
    check_tensor("qtables", qtables, (torch.int32,), (4, 64), dev)
    tiles = decode_tiles(geom)

    from ..kernels import load_library

    recs = _records_on(geom, "decode", dev)
    out = torch.empty(geom.size_y, geom.size_x, geom.nf,
                      dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = load_library().lib.jt_decode_frame_fast(
            coeffs.data_ptr(), qtables.data_ptr(), lut_on(dev).data_ptr(),
            recs.data_ptr(), out.data_ptr(), geom.size_y, geom.size_x,
            geom.nf, geom.precision, geom.m_y, tiles.tile_h, tiles.tile_w,
            tiles.tiles_y, tiles.tiles_x, decode_smem(tiles),
            cuda_stream(dev))
    if rc != 0:
        raise RuntimeError(f"decode_frame_fast launch failed: CUDA error "
                           f"{rc}")
    decode_frame_fast.launches += 1
    return out


decode_frame_fast.launches = 0


def encode_frame_fast(frame: torch.Tensor, qtables: torch.Tensor,
                      geom: FrameGeometry) -> torch.Tensor:
    """float32 ``[size_y, size_x, Nf]`` padded RGB (or gray) raster and
    int32 ``[4, 64]`` tables -> int32 ``[total_blocks, 64]`` plane-major
    quantized coefficients, raster order (no zig-zag, no DC difference).

    A CUDA tensor launches K12 (counted in ``encode_frame_fast.
    launches``); a CPU tensor runs ``encode_frame_fast_ref``.  Anything
    else raises, as does a component count other than 1 or 3.
    """
    if geom.nf not in (1, 3):
        raise ValueError(f"encode_frame_fast takes 1 or 3 components, not "
                         f"{geom.nf}")
    if frame.device.type == "cpu":
        return encode_frame_fast_ref(frame, qtables, geom)
    if frame.device.type != "cuda":
        raise ValueError(f"encode_frame_fast: unsupported device "
                         f"{frame.device}")
    dev = frame.device
    check_tensor("frame", frame, (torch.float32,),
                 (geom.size_y, geom.size_x, geom.nf), dev)
    check_tensor("qtables", qtables, (torch.int32,), (4, 64), dev)
    tiles = encode_tiles(geom)
    smem = encode_smem(tiles, geom.nf)
    if smem > SMEM_MAX:
        raise UnsupportedError(f"an encode tile needs {smem} bytes of "
                               "shared memory")

    from ..kernels import load_library

    recs = _records_on(geom, "encode", dev)
    tb = sum(c.n_blocks for c in geom.components)
    out = torch.empty(tb, 64, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = load_library().lib.jt_encode_frame_fast(
            frame.data_ptr(), qtables.data_ptr(), lut_on(dev).data_ptr(),
            recs.data_ptr(), out.data_ptr(), geom.size_y, geom.size_x,
            geom.height, geom.width, geom.nf, geom.precision, geom.m_x,
            geom.m_y, tiles.mcus, tiles.tiles_x, tiles.mcu_w, tiles.mcu_h,
            tiles.bpm, smem, cuda_stream(dev))
    if rc != 0:
        raise RuntimeError(f"encode_frame_fast launch failed: CUDA error "
                           f"{rc}")
    encode_frame_fast.launches += 1
    return out


encode_frame_fast.launches = 0
