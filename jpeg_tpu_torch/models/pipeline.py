"""Dense per-image pipelines: coefficients <-> pixels, on one device.

The port of the JAX package's ``models/pipeline.py``: the decoder
epilogue (decoder.c:456-470: dequantize -> IDCT -> level shift ->
blocks-to-frame -> upsample -> color) and the encoder prologue
(encoder.c:176-193: downsample -> frame-to-blocks -> level shift -> FDCT
-> quantize) as tensor programs over the ``[n_blocks, 8, 8]`` blocks of
each component, on the device the tensors live on.

``exact=True`` runs the bit-exact kernels of ``models/dense_exact.py``
(ordered float32 DCTs, mixed float64 color); ``exact=False`` the fast
mode's kernels of ``models/dense_fast.py`` (K11 and K12: float32 DCTs and
float32 color, one launch a frame).  Kernels on a CUDA tensor, their
plain versions on a CPU tensor.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..geometry import FrameGeometry
from ..ops.blocks import blocks_to_plane, plane_to_blocks
from ..ops.resample import downsample_box, upsample_nn
from .dense_exact import color_exact, fdct_exact, idct_exact
from .dense_fast import decode_frame_fast, encode_frame_fast


def decode_component_plane(coeffs: torch.Tensor, qtable: torch.Tensor,
                           b_y: int, b_x: int,
                           precision: int) -> torch.Tensor:
    """int32 [n_blocks, 64] raster coefficients -> dequant -> exact IDCT
    -> +level shift -> float32 planar raster [b_y*8, b_x*8]."""
    shifted = idct_exact(coeffs, qtable, precision).reshape(-1, 8, 8)
    return blocks_to_plane(shifted, b_y, b_x)


def encode_component_plane(plane: torch.Tensor, qtable: torch.Tensor,
                           precision: int) -> torch.Tensor:
    """float32 [b_y*8, b_x*8] samples -> -level shift -> exact FDCT ->
    quantize -> int32 [n_blocks, 64] raster."""
    b_y, b_x = plane.shape[-2] // 8, plane.shape[-1] // 8
    blocks = plane_to_blocks(plane.to(torch.float32), b_y, b_x)
    return fdct_exact(blocks.reshape(-1, 64).contiguous(), qtable, precision)


def _qtables_on(qtables, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(qtables, np.int32), device=device)


def _plane_major(planes: Dict[int, np.ndarray], geom: FrameGeometry,
                 device: torch.device) -> torch.Tensor:
    """The host planes as one int32 [total_blocks, 64] tensor on
    ``device``, components in geometry order, in one upload."""
    flat = np.concatenate([np.asarray(planes[c.cid], np.int32)
                           for c in geom.components])
    return torch.from_numpy(flat).to(device)


def decode_frame(planes: Dict[int, torch.Tensor], geom: FrameGeometry,
                 qtables, exact: bool = True, *,
                 device) -> torch.Tensor:
    """Full dense decode: coefficient planes -> float32 [size_y, size_x,
    Nf] frame on ``device`` after color conversion (the reference's
    write_image pre-PNM state, decoder.c:433-454)."""
    dev = torch.device(device)
    qt = _qtables_on(qtables, dev)
    if not exact:
        return decode_frame_fast(_plane_major(planes, geom, dev), qt, geom)
    size_y, size_x = geom.size_y, geom.size_x
    chans = []
    # The reference assembles channels by ASCENDING component id
    # (transform_components_to_frame walks ids 0..255, frame.c:49-81),
    # not SOF order; the lowest id becomes channel 0 (= Y for color).
    for comp in sorted(geom.components, key=lambda c: c.cid):
        coeffs = torch.as_tensor(planes[comp.cid], dtype=torch.int32,
                                 device=dev).contiguous()
        plane = decode_component_plane(coeffs, qt[comp.tq], comp.b_y,
                                       comp.b_x, geom.precision)
        c_y, c_x = comp.b_y * 8, comp.b_x * 8
        step_y = size_y // c_y if c_y else 1
        step_x = size_x // c_x if c_x else 1
        up = upsample_nn(plane, step_y, step_x)
        if tuple(up.shape[-2:]) != (size_y, size_x):
            # Non-dividing sampling ratio (corrupt/exotic SOF): the
            # reference paints step_y x step_x patches and NEVER touches
            # the remaining frame margin -- malloc'd storage, which for
            # the fresh context pages reads as 0.0 (frame.c:28,60-76).
            full = torch.zeros(size_y, size_x, dtype=up.dtype, device=dev)
            crop = up[..., :size_y, :size_x]
            full[: crop.shape[-2], : crop.shape[-1]] = crop
            up = full
        chans.append(up)
    frame = torch.stack(chans, dim=-1)
    return color_exact(frame.contiguous(), geom.precision, "to_rgb")


def encode_frame(frame: torch.Tensor, geom: FrameGeometry, qtables,
                 exact: bool = True) -> Dict[int, torch.Tensor]:
    """Full dense encode: padded RGB raster float32 [size_y, size_x, Nf]
    -> coefficient planes {cid: int32 [n_blocks, 64]}, on the frame's
    device.

    Color conversion only touches the true [height, width] window, exactly
    like frame_to_ycc (frame.c:162-163): the MCU padding keeps its raw
    replicated RGB values and flows into the DCT unconverted.  (A quirk,
    but required for byte-identical output with the reference encoder.)
    """
    dev = frame.device
    frame = frame.to(torch.float32).contiguous()
    qt = _qtables_on(qtables, dev)
    if not exact:
        coeffs = encode_frame_fast(frame, qt, geom)
        out, off = {}, 0
        for comp in geom.components:
            out[comp.cid] = coeffs[off:off + comp.n_blocks]
            off += comp.n_blocks
        return out
    ycc = color_exact(frame, geom.precision, "to_ycc")
    size_y, size_x = geom.size_y, geom.size_x
    if (size_y, size_x) != (geom.height, geom.width):
        in_y = torch.arange(size_y, device=dev)[:, None] < geom.height
        in_x = torch.arange(size_x, device=dev)[None, :] < geom.width
        ycc = torch.where((in_y & in_x)[..., None], ycc, frame)
    out = {}
    for comp in geom.components:
        c_y, c_x = comp.b_y * 8, comp.b_x * 8
        step_y, step_x = size_y // c_y, size_x // c_x
        chan = downsample_box(ycc[..., geom.index_of(comp.cid)], step_y,
                              step_x)
        out[comp.cid] = encode_component_plane(chan, qt[comp.tq],
                                               geom.precision)
    return out
