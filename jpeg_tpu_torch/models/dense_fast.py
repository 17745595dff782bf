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
anything else raises.  The kernels take the cosine LUT and the component
records by value from host memory (no device copy of either a call), and
the helpers below compute, for the CPU tests, what the kernels compute for
a tile: K11's copy runs (``tile_runs``) and sampling path
(``pow2_sampling``), K12's box cell (``box_cell``) and block stores
(``block_stores``).

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
from ..ops.dct import dct_lut_f32, fdct8x8_matmul, idct8x8_matmul
from ..ops.quant import dequantize, quantize
from ..ops.resample import downsample_box, upsample_nn

# Per-component int32 record shared with csrc/dense_fast.cu, geometry
# order: sampling factors h, v; steps step_y, step_x (size // plane size:
# the upsampling patch, or the downsampling box); first block of the
# component's plane; blocks per component row b_x; quantization table
# selector tq; frame channel (decode: the output channel, the rank of the
# component id; encode: the input channel, the geometry index).
COMP_INTS = 8
C_MAX = 4
TILE_COLS = 64  # pixel columns a decode tile aims at; whole MCUs
BLOCK_FLOATS = 72  # csrc BP: a block's floats in a CTA's float stage
STAGES = 2  # csrc STAGES: the input stages of a CTA's ring
HEAD_BYTES = 16 + 4 * 64 * 4  # csrc HEAD_BYTES: mbarriers, the tables
# Blocks of a K12 tile (K5 cuts at 64): with two pixel stages, 3 CTAs of a
# 4:2:0 frame fit an SM's shared memory.
ENCODE_TILE_BLOCKS = 48
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
    pow2: bool  # the kernel's shift path (``pow2_sampling``)


def pow2_sampling(geom: FrameGeometry) -> bool:
    """Whether K11 takes ``geom`` by its shift path: every upsampling step
    1 or 2 and every component's plane painted over the whole padded
    frame (true of every sampling that divides, 4:2:0, 4:2:2, 4:4:0, 4:4:4,
    gray, YCCK 1:1), so a pixel's sample is ``y >> (step_y - 1)``, ``x >>
    (step_x - 1)`` and no pixel reads the margin."""
    recs = comp_records(geom, "decode")
    return all(
        int(recs[j, 2]) in (1, 2) and int(recs[j, 3]) in (1, 2)
        and c.b_y * 8 * int(recs[j, 2]) >= geom.size_y
        and c.b_x * 8 * int(recs[j, 3]) >= geom.size_x
        for j, c in enumerate(geom.components))


@lru_cache(maxsize=32)
def channel_records(geom: FrameGeometry) -> np.ndarray:
    """K11's records: ``comp_records(geom, "decode")`` in output channel
    order (ascending component id), ``[C_MAX, COMP_INTS]`` int32, the
    rows past the components zero.  The kernel stages each tile's blocks
    channel after channel."""
    recs = comp_records(geom, "decode")
    out = np.zeros_like(recs)
    out[:geom.nf] = recs[np.argsort(recs[:geom.nf, 7], kind="stable")]
    return out


def tile_runs(geom: FrameGeometry, tiles: "DecodeTiles", ty: int,
              tx: int) -> list:
    """The copies of tile (``ty``, ``tx``) as K11 issues them: [(channel,
    first plane block (frame-relative, planes in geometry order), blocks,
    first stage block)], one for each block row of each channel's span,
    channel after channel.  Each is a contiguous run of 256-byte blocks
    in the plane: one bulk copy, 16-byte aligned wherever the frame's
    coefficients are."""
    recs = channel_records(geom)
    y0, x0 = ty * tiles.tile_h, tx * tiles.tile_w
    y1 = min(y0 + tiles.tile_h, geom.size_y)
    x1 = min(x0 + tiles.tile_w, geom.size_x)
    out, slot = [], 0
    for k in range(geom.nf):
        _, v, sy, sx, first, b_x = (int(i) for i in recs[k, :6])
        br0, nbr = _span(y0, y1, sy, geom.m_y * v * 8 * sy)
        bc0, nbc = _span(x0, x1, sx, b_x * 8 * sx)
        out += [(k, first + (br0 + rb) * b_x + bc0, nbc, slot + rb * nbc)
                for rb in range(nbr) if nbc]
        slot += nbr * nbc
    return out


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
                        tiles_x=-(-geom.size_x // tile_w), stage_blocks=0,
                        pow2=pow2_sampling(geom))
    # A tile's blocks per component are its row span times its column
    # span, so the largest total comes from the rows and columns apart.
    rows = np.array([[s[1] for s in tile_sources(geom, tiles, ty, 0)]
                     for ty in range(tiles.tiles_y)])
    cols = np.array([[s[3] for s in tile_sources(geom, tiles, 0, tx)]
                     for tx in range(tiles.tiles_x)])
    most = int((rows[:, None, :] * cols[None, :, :]).sum(-1).max())
    return DecodeTiles(tile_h, tile_w, tiles.tiles_y, tiles.tiles_x, most,
                       tiles.pow2)


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
    """Shared memory bytes of a K11 CTA: the mbarriers and the tables,
    the ring of coefficient stages (64 ints a block), then two float
    stages (``BLOCK_FLOATS`` a block)."""
    return HEAD_BYTES + STAGES * tiles.stage_blocks * (64 + BLOCK_FLOATS) * 4


@dataclass(frozen=True)
class EncodeTiles:
    """How K12 cuts a frame: a tile is up to ``mcus`` MCUs of one MCU row
    (the row's last tile may hold fewer), so its pixels are ``mcu_h`` rows
    of ``mcus * mcu_w`` columns of the padded frame and its blocks at most
    ``ENCODE_TILE_BLOCKS``; ``cell`` is the box cell of the kernel's
    common samplings, (0, 0) for its general code (``box_cell``)."""

    mcus: int
    tiles_x: int
    mcu_w: int
    mcu_h: int
    bpm: int
    cell: tuple


def box_cell(geom: FrameGeometry) -> tuple:
    """(cy, cx): the pixels one sample of the most subsampled component
    averages, where every component's box is 1 x 1 or that cell and the
    cell is at most 2 x 2 (4:2:0, 4:2:2, 4:4:0, 4:4:4, gray, luma h=1
    v=2): K12 then reads each cell's pixels once, a thread a cell.  (0, 0)
    for any other sampling (its general code, a thread a sample)."""
    boxes = [(geom.max_v // c.v, geom.max_h // c.h)
             for c in geom.components]
    cell = (max(b[0] for b in boxes), max(b[1] for b in boxes))
    if max(cell) <= 2 and all(b in ((1, 1), cell) for b in boxes):
        return cell
    return (0, 0)


@lru_cache(maxsize=32)
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
    mcus = max(1, min(ENCODE_TILE_BLOCKS // bpm, geom.m_x))
    return EncodeTiles(mcus=mcus, tiles_x=-(-geom.m_x // mcus),
                       mcu_w=8 * geom.max_h, mcu_h=8 * geom.max_v, bpm=bpm,
                       cell=box_cell(geom))


def block_stores(geom: FrameGeometry, tiles: EncodeTiles, my: int,
                 tx: int) -> list:
    """K12's stores of tile (``my``, ``tx``): [(first stage block, first
    plane row (frame-relative, planes in geometry order), blocks)], one
    for each block row of each component: its ``n * h`` blocks of the
    tile are consecutive in the stage and in the plane, stored as whole
    256-byte blocks."""
    n = min(tiles.mcus, geom.m_x - tx * tiles.mcus)
    out, first, f = [], 0, 0
    for c in geom.components:
        out += [(n * (f + rb * c.h),
                 first + (my * c.v + rb) * c.b_x + tx * tiles.mcus * c.h,
                 n * c.h) for rb in range(c.v)]
        first += c.n_blocks
        f += c.h * c.v
    return out


def encode_smem(tiles: EncodeTiles, nc: int) -> int:
    """Shared memory bytes of a K12 CTA: the mbarriers and the tables,
    the ring of pixel stages, then the tile's blocks (``BLOCK_FLOATS``
    each)."""
    return HEAD_BYTES + \
        STAGES * tiles.mcu_h * tiles.mcus * tiles.mcu_w * nc * 4 + \
        tiles.mcus * tiles.bpm * BLOCK_FLOATS * 4


@lru_cache(maxsize=32)
def _encode_records(geom: FrameGeometry) -> np.ndarray:
    return comp_records(geom, "encode")


def kernel_resources(geom: FrameGeometry, kind: str) -> dict:
    """What the instance of K11 (``kind`` "decode") or K12 ("encode")
    that ``geom`` launches takes on the current CUDA device: registers a
    thread, spilled bytes a thread, CTAs an SM (at its shared memory),
    SMs, and its shared memory bytes.  Builds the kernels if needed."""
    import ctypes

    from ..kernels import load_library

    if kind == "decode":
        tiles = decode_tiles(geom)
        args, smem = (0, geom.nf, int(tiles.pow2), 0), decode_smem(tiles)
    else:
        tiles = encode_tiles(geom)
        args, smem = (1, geom.nf, *tiles.cell), encode_smem(tiles, geom.nf)
    got = (ctypes.c_int * 4)()
    rc = load_library().lib.jt_dense_fast_resources(*args, smem, got)
    if rc != 0:
        raise RuntimeError(f"jt_dense_fast_resources: CUDA error {rc}")
    return {"registers": got[0], "spill_bytes": got[1],
            "ctas_per_sm": got[2], "sms": got[3], "smem_bytes": smem}


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

    out = torch.empty(geom.size_y, geom.size_x, geom.nf,
                      dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = load_library().lib.jt_decode_frame_fast(
            coeffs.data_ptr(), qtables.data_ptr(), dct_lut_f32().ctypes.data,
            channel_records(geom).ctypes.data, out.data_ptr(), geom.size_y,
            geom.size_x, geom.nf, geom.precision, geom.m_y, tiles.tile_h,
            tiles.tile_w, tiles.tiles_y, tiles.tiles_x, tiles.stage_blocks,
            int(tiles.pow2), decode_smem(tiles), cuda_stream(dev))
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

    tb = sum(c.n_blocks for c in geom.components)
    out = torch.empty(tb, 64, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = load_library().lib.jt_encode_frame_fast(
            frame.data_ptr(), qtables.data_ptr(), dct_lut_f32().ctypes.data,
            _encode_records(geom).ctypes.data, out.data_ptr(), geom.size_x,
            geom.height, geom.width, geom.nf, geom.precision, geom.m_x,
            geom.m_y, tiles.mcus, tiles.tiles_x, tiles.mcu_w, tiles.mcu_h,
            *tiles.cell, smem, cuda_stream(dev))
    if rc != 0:
        raise RuntimeError(f"encode_frame_fast launch failed: CUDA error "
                           f"{rc}")
    encode_frame_fast.launches += 1
    return out


encode_frame_fast.launches = 0
