"""Frame/component geometry: the data model of a JPEG frame.

Replaces the reference's mutable ``struct context`` (common.h:124-156) with
immutable dataclasses.  All MCU-grid math matches
compute_no_blocks_and_alloc_buffers (common.c:156-195):

  m_x = ceil(X / (8*max_H)),  m_y = ceil(Y / (8*max_V))
  component block grid: b_x = m_x * H,  b_y = m_y * V
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .errors import CorruptStream


def ceil_div(n: int, d: int) -> int:
    return (n + d - 1) // d


@dataclass(frozen=True)
class Component:
    """One frame component (common.h:59-80, minus the buffers)."""

    cid: int  # JPEG component identifier C (1..255, sparse)
    h: int  # horizontal sampling factor
    v: int  # vertical sampling factor
    tq: int  # quantization table selector
    td: int = 0  # DC entropy table selector (set by SOS)
    ta: int = 0  # AC entropy table selector (set by SOS)
    b_x: int = 0  # blocks horizontally
    b_y: int = 0  # blocks vertically

    @property
    def n_blocks(self) -> int:
        return self.b_x * self.b_y


@dataclass(frozen=True)
class FrameGeometry:
    """Frame header state + derived MCU grid (SOF0/SOF1 contents)."""

    precision: int  # P: sample precision (8 or 12)
    height: int  # Y
    width: int  # X
    components: Tuple[Component, ...]  # in SOF order

    @property
    def nf(self) -> int:
        return len(self.components)

    @property
    def max_h(self) -> int:
        return max(c.h for c in self.components)

    @property
    def max_v(self) -> int:
        return max(c.v for c in self.components)

    @property
    def m_x(self) -> int:
        return ceil_div(self.width, 8 * self.max_h)

    @property
    def m_y(self) -> int:
        return ceil_div(self.height, 8 * self.max_v)

    @property
    def n_mcus(self) -> int:
        return self.m_x * self.m_y

    @property
    def size_x(self) -> int:
        """Padded frame width (frame.c:21): MCU-aligned."""
        return self.m_x * 8 * self.max_h

    @property
    def size_y(self) -> int:
        return self.m_y * 8 * self.max_v

    def by_id(self, cid: int) -> Component:
        c = self.by_id_or_none(cid)
        if c is None:
            # A corrupt scan can reference an id the SOF never declared;
            # raising a JpegError keeps every engine on the documented
            # reject-at-worst contract (the serial oracle handles the
            # reference's exact skip semantics itself, serial.py).
            raise CorruptStream(f"no component with id {cid}")
        return c

    def by_id_or_none(self, cid: int) -> Optional[Component]:
        for c in self.components:
            if c.cid == cid:
                return c
        return None

    def index_of(self, cid: int) -> int:
        for i, c in enumerate(self.components):
            if c.cid == cid:
                return i
        raise CorruptStream(f"no component with id {cid}")


def with_block_grid(geom: FrameGeometry) -> FrameGeometry:
    """Fill in each component's block grid from the frame MCU grid."""
    comps = tuple(
        Component(
            cid=c.cid,
            h=c.h,
            v=c.v,
            tq=c.tq,
            td=c.td,
            ta=c.ta,
            b_x=geom.m_x * c.h,
            b_y=geom.m_y * c.v,
        )
        for c in geom.components
    )
    return FrameGeometry(
        precision=geom.precision,
        height=geom.height,
        width=geom.width,
        components=comps,
    )


@dataclass(frozen=True)
class ScanInfo:
    """SOS header contents (decoder.c:197-259)."""

    component_ids: Tuple[int, ...]  # Cs[j] in scan order
    td: Tuple[int, ...]  # DC table per scan component
    ta: Tuple[int, ...]  # AC table per scan component

    @property
    def ns(self) -> int:
        return len(self.component_ids)
