"""Encoder parameters and frame geometry (copied from jpeg_tpu.encoder).

Only ``EncodeParams`` and ``geometry_for_image`` are carried over,
unchanged, for ``DeviceEncoder``.  The single-image entry point
``encode_jpeg`` (and ``encode_jpeg_from_planes``) needs the dense
per-image pipeline ``models/pipeline.py``, which the port does not have
yet: it comes with the single-image slice.
"""

from __future__ import annotations

from dataclasses import dataclass

from .errors import UnsupportedError
from .geometry import Component, FrameGeometry, with_block_grid
from .utils.pnm import PnmImage


@dataclass
class EncodeParams:
    """CLI-equivalent parameters (encoder.c:67-88) + extensions."""

    h: int = 2  # luma horizontal sampling factor (1..2)
    v: int = 1  # luma vertical sampling factor (1..2)
    quality: int = 75
    optimize: bool = True
    restart_interval: int = 0  # extension: MCUs per restart interval
    exact: bool = True  # bit-exact float path vs fast MXU path
    entropy_backend: str = "numpy"  # "numpy" (host), "jax" (on-device),
    # or "native" (threaded C++ host kernel; falls back to numpy)


def geometry_for_image(img: PnmImage, params: EncodeParams) -> FrameGeometry:
    """Component layout + table assignment (encoder.c:109-152)."""
    if img.components == 1:
        comps = (Component(cid=1, h=1, v=1, tq=0, td=0, ta=0),)
    elif img.components == 3:
        if not (1 <= params.h <= 2 and 1 <= params.v <= 2):
            raise UnsupportedError("sampling factors must be 1..2")
        comps = (
            Component(cid=1, h=params.h, v=params.v, tq=0, td=0, ta=0),
            Component(cid=2, h=1, v=1, tq=1, td=1, ta=1),
            Component(cid=3, h=1, v=1, tq=1, td=1, ta=1),
        )
    else:
        raise UnsupportedError("PNM must have 1 or 3 components")
    geom = FrameGeometry(
        precision=img.precision,
        height=img.height,
        width=img.width,
        components=comps,
    )
    return with_block_grid(geom)
