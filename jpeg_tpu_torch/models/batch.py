"""Batched (multi-frame) dense pipelines -- the Motion-JPEG workhorse.

Same math as models/pipeline.py but with an explicit leading frame-batch
axis on every tensor: the batch axis is the data-parallel axis (frames
are fully independent), the block axis the tile-parallel axis (8x8
blocks have no cross-block dependence).  The port of
``jpeg_tpu/models/batch.py``.

``decode_blocks_batch`` and ``encode_plane_batch`` are plain PyTorch on
any device.  ``decode_batch_ycc``, ``encode_batch_ycc`` and
``roundtrip_step_ycc`` take the three coefficient planes of a
``BatchConfig`` frame batch:

* on a CUDA tensor they launch the port's kernels -- the fast mode
  (``exact=False``) K11 ``decode_frame_fast`` and K12
  ``encode_frame_fast`` once a frame, on ``batch_geometry(cfg)``: a
  3-component frame whose height and width are the padded grid, so K11
  computes the kron IDCT -> ``upsample_nn`` -> float ``to_rgb`` chain and
  K12's true-window colour covers the whole raster, as the JAX chain
  does; the exact mode (``exact=True``) K4 ``idct_exact``,
  ``color_exact`` and ``fdct_exact`` over the whole batch;
* on a CPU tensor their plain versions (``*_ref``), the JAX package's
  chains op for op.

The roundtrip's DC-category histogram is a 16-bin reduction the JAX
package leaves to XLA; it stays plain torch ops on every device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import torch

from ..geometry import Component, FrameGeometry, with_block_grid
from ..ops.color import rgb_to_ycc, to_rgb
from ..ops.dct import fdct8x8_exact, fdct8x8_kron, idct8x8_exact, idct8x8_kron
from ..ops.quant import dequantize, quantize
from ..ops.resample import downsample_box, upsample_nn


def decode_blocks_batch(
    coeffs: torch.Tensor,  # int32 [B, b_y*b_x, 64] raster order
    qtable: torch.Tensor,  # [64]
    b_y: int,
    b_x: int,
    precision: int,
    exact: bool = False,
) -> torch.Tensor:
    """dequant -> IDCT -> +shift -> float32 [B, b_y*8, b_x*8] planes.

    Fast path: dequant feeds the flattened Kronecker-DCT matmul
    ([B*n, 64] @ [64, 64]); exact: the ordered float32 IDCT.
    """
    flt = dequantize(coeffs, qtable)
    b = flt.shape[0]
    shift = float(1 << (precision - 1))
    if exact:
        blocks = idct8x8_exact(flt.reshape(b, b_y, b_x, 8, 8)) + shift
    else:
        blocks = (idct8x8_kron(flt) + shift).reshape(b, b_y, b_x, 8, 8)
    return blocks.permute(0, 1, 3, 2, 4).reshape(b, b_y * 8, b_x * 8)


def encode_plane_batch(
    plane: torch.Tensor,  # float32 [B, b_y*8, b_x*8]
    qtable: torch.Tensor,  # [64]
    precision: int,
    exact: bool = False,
) -> torch.Tensor:
    """-shift -> FDCT -> quantize -> int32 [B, b_y*b_x, 64] raster order."""
    b, h, w = plane.shape
    b_y, b_x = h // 8, w // 8
    blocks = plane.reshape(b, b_y, 8, b_x, 8).permute(0, 1, 3, 2, 4)
    blocks = blocks - float(1 << (precision - 1))
    if exact:
        fdct = fdct8x8_exact(blocks).reshape(b, b_y * b_x, 64)
    else:
        fdct = fdct8x8_kron(blocks.reshape(b, b_y * b_x, 64))
    return quantize(fdct, qtable)


@dataclass(frozen=True)
class BatchConfig:
    """Static geometry of a batched color pipeline (4:2:0/4:2:2/4:4:4)."""

    height: int
    width: int
    h: int = 2  # luma sampling factors
    v: int = 2
    precision: int = 8

    @property
    def m_x(self) -> int:
        return -(-self.width // (8 * self.h))

    @property
    def m_y(self) -> int:
        return -(-self.height // (8 * self.v))

    @property
    def luma_grid(self) -> Tuple[int, int]:
        return self.m_y * self.v, self.m_x * self.h

    @property
    def chroma_grid(self) -> Tuple[int, int]:
        return self.m_y, self.m_x

    @property
    def n_luma_blocks(self) -> int:
        by, bx = self.luma_grid
        return by * bx

    @property
    def n_chroma_blocks(self) -> int:
        by, bx = self.chroma_grid
        return by * bx


@lru_cache(maxsize=32)
def batch_geometry(cfg: BatchConfig) -> FrameGeometry:
    """The frame K11 and K12 see for one frame of ``cfg``: Y (id 1, the
    luma sampling, table 0), Cb and Cr (ids 2, 3, 1x1, table 1), height
    and width the padded luma grid, so the frame holds no margin."""
    by, bx = cfg.luma_grid
    return with_block_grid(FrameGeometry(
        precision=cfg.precision, height=by * 8, width=bx * 8,
        components=(Component(1, cfg.h, cfg.v, 0), Component(2, 1, 1, 1),
                    Component(3, 1, 1, 1))))


def _table_pair(qt_luma: torch.Tensor, qt_chroma: torch.Tensor,
                device: torch.device) -> torch.Tensor:
    """[4, 64] int32 tables on ``device``: luma, chroma, then zeros."""
    qt = torch.zeros(4, 64, dtype=torch.int32, device=device)
    qt[0] = qt_luma.to(device=device, dtype=torch.int32)
    qt[1] = qt_chroma.to(device=device, dtype=torch.int32)
    return qt


def decode_batch_ycc_ref(cfg: BatchConfig, y, cb, cr, qt_luma, qt_chroma,
                         exact: bool = False) -> torch.Tensor:
    """Plain version: 3 coefficient planes -> float32 RGB [B, H, W, 3]."""
    lby, lbx = cfg.luma_grid
    cby, cbx = cfg.chroma_grid
    yp = decode_blocks_batch(y, qt_luma, lby, lbx, cfg.precision, exact)
    cbp = decode_blocks_batch(cb, qt_chroma, cby, cbx, cfg.precision, exact)
    crp = decode_blocks_batch(cr, qt_chroma, cby, cbx, cfg.precision, exact)
    cbp = upsample_nn(cbp, cfg.v, cfg.h)
    crp = upsample_nn(crp, cfg.v, cfg.h)
    frame = torch.stack([yp, cbp, crp], dim=-1)
    return to_rgb(frame, cfg.precision, exact=exact)


def encode_batch_ycc_ref(cfg: BatchConfig, rgb, qt_luma, qt_chroma,
                         exact: bool = False):
    """Plain version: RGB [B, H, W, 3] -> 3 coefficient planes."""
    ycc = rgb_to_ycc(rgb, cfg.precision, exact=exact)
    yp = ycc[..., 0]
    cbp = downsample_box(ycc[..., 1], cfg.v, cfg.h)
    crp = downsample_box(ycc[..., 2], cfg.v, cfg.h)
    y = encode_plane_batch(yp, qt_luma, cfg.precision, exact)
    cb = encode_plane_batch(cbp, qt_chroma, cfg.precision, exact)
    cr = encode_plane_batch(crp, qt_chroma, cfg.precision, exact)
    return y, cb, cr


def _planes_to_frame(planes: torch.Tensor, b: int, b_y: int,
                     b_x: int) -> torch.Tensor:
    """[B * b_y * b_x, 64] raster blocks -> [B, b_y*8, b_x*8] planes."""
    x = planes.reshape(b, b_y, b_x, 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(b, b_y * 8, b_x * 8)


def _frame_to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """[B, b_y*8, b_x*8] planes -> [B * b_y * b_x, 64] raster blocks."""
    b, h, w = plane.shape
    x = plane.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    return x.reshape(-1, 64).contiguous()


def _decode_exact(cfg: BatchConfig, y, cb, cr, qt_luma, qt_chroma):
    """The exact decode on the card: ``idct_exact`` on each plane of the
    batch, ``upsample_nn``, then ``color_exact``."""
    from .dense_exact import color_exact, idct_exact

    b = y.shape[0]
    dev = y.device
    lby, lbx = cfg.luma_grid
    cby, cbx = cfg.chroma_grid
    ql = qt_luma.to(device=dev, dtype=torch.int32).contiguous()
    qc = qt_chroma.to(device=dev, dtype=torch.int32).contiguous()

    def plane(c, q, by, bx):
        px = idct_exact(c.reshape(-1, 64).contiguous(), q, cfg.precision)
        return _planes_to_frame(px, b, by, bx)

    yp = plane(y, ql, lby, lbx)
    cbp = upsample_nn(plane(cb, qc, cby, cbx), cfg.v, cfg.h)
    crp = upsample_nn(plane(cr, qc, cby, cbx), cfg.v, cfg.h)
    frame = torch.stack([yp, cbp, crp], dim=-1).contiguous()
    return color_exact(frame, cfg.precision, "to_rgb")


def _encode_exact(cfg: BatchConfig, rgb, qt_luma, qt_chroma):
    """The exact encode on the card: ``color_exact`` to YCbCr,
    ``downsample_box``, then ``fdct_exact`` on each plane of the batch."""
    from .dense_exact import color_exact, fdct_exact

    dev = rgb.device
    b = rgb.shape[0]
    ycc = color_exact(rgb.to(torch.float32).contiguous(), cfg.precision,
                      "to_ycc")
    ql = qt_luma.to(device=dev, dtype=torch.int32).contiguous()
    qc = qt_chroma.to(device=dev, dtype=torch.int32).contiguous()

    def plane(p, q):
        out = fdct_exact(_frame_to_blocks(p), q, cfg.precision)
        return out.reshape(b, -1, 64)

    return (plane(ycc[..., 0], ql),
            plane(downsample_box(ycc[..., 1], cfg.v, cfg.h), qc),
            plane(downsample_box(ycc[..., 2], cfg.v, cfg.h), qc))


def decode_batch_ycc(cfg: BatchConfig, y, cb, cr, qt_luma, qt_chroma,
                     exact: bool = False) -> torch.Tensor:
    """Batched color decode: 3 coefficient planes (int32 [B, n, 64] raster
    blocks) -> float32 RGB [B, H, W, 3] (the padded grid, unclipped).

    A CUDA tensor runs K11 once a frame (``exact=False``) or K4 over the
    batch (``exact=True``); a CPU tensor ``decode_batch_ycc_ref``.
    """
    if y.device.type == "cpu":
        return decode_batch_ycc_ref(cfg, y, cb, cr, qt_luma, qt_chroma, exact)
    if y.device.type != "cuda":
        raise ValueError(f"decode_batch_ycc: unsupported device {y.device}")
    if exact:
        return _decode_exact(cfg, y, cb, cr, qt_luma, qt_chroma)
    from .dense_fast import decode_frame_fast

    geom = batch_geometry(cfg)
    qt = _table_pair(qt_luma, qt_chroma, y.device)
    coeffs = torch.cat([y, cb, cr], dim=1).to(torch.int32)
    return torch.stack([decode_frame_fast(coeffs[i], qt, geom)
                        for i in range(coeffs.shape[0])])


def encode_batch_ycc(cfg: BatchConfig, rgb, qt_luma, qt_chroma,
                     exact: bool = False):
    """Batched color encode: float RGB [B, H, W, 3] (the padded grid) ->
    3 coefficient planes int32 [B, n, 64] (Y, Cb, Cr).

    A CUDA tensor runs K12 once a frame (``exact=False``) or K4 over the
    batch (``exact=True``); a CPU tensor ``encode_batch_ycc_ref``.
    """
    if rgb.device.type == "cpu":
        return encode_batch_ycc_ref(cfg, rgb, qt_luma, qt_chroma, exact)
    if rgb.device.type != "cuda":
        raise ValueError(f"encode_batch_ycc: unsupported device "
                         f"{rgb.device}")
    if exact:
        return _encode_exact(cfg, rgb, qt_luma, qt_chroma)
    from .dense_fast import encode_frame_fast

    geom = batch_geometry(cfg)
    qt = _table_pair(qt_luma, qt_chroma, rgb.device)
    frames = rgb.to(torch.float32)
    out = torch.stack([encode_frame_fast(frames[i].contiguous(), qt, geom)
                       for i in range(frames.shape[0])])
    nl, nc = cfg.n_luma_blocks, cfg.n_chroma_blocks
    return (out[:, :nl], out[:, nl:nl + nc], out[:, nl + nc:])


def dc_histogram(y: torch.Tensor) -> torch.Tensor:
    """16-bin histogram of the DC magnitude categories of luma blocks
    ``y`` [..., 64] (0 for a zero DC, else floor(log2|dc|) + 1), int64."""
    dc = y[..., 0].abs().to(torch.float64)
    cats = torch.where(dc == 0, torch.zeros_like(dc),
                       torch.floor(torch.log2(dc.clamp(min=1))) + 1)
    return torch.bincount(cats.reshape(-1).to(torch.int64),
                          minlength=16)[:16]


def roundtrip_step_ycc(cfg: BatchConfig, y, cb, cr, qt_luma, qt_chroma):
    """Decode + re-encode + dry-pass histogram: the full-pipeline step.

    The histogram is the parallel analog of the reference's dry pass
    (encoder.c:525-558); the sharded step all-reduces it over the mesh.
    -> (y2, cb2, cr2, hist [16] int64).
    """
    rgb = decode_batch_ycc(cfg, y, cb, cr, qt_luma, qt_chroma)
    y2, cb2, cr2 = encode_batch_ycc(cfg, rgb, qt_luma, qt_chroma)
    return y2, cb2, cr2, dc_histogram(y2)
