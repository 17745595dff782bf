"""Codestream emission: marker segments byte-identical to the reference
encoder (encoder.c:195-410, ordering per produce_codestream 589-645).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, List, Tuple

import numpy as np

from ..constants import (
    M_DHT,
    M_DQT,
    M_DRI,
    M_EOI,
    M_RST0,
    M_SOF0,
    M_SOI,
    M_SOS,
    ZIGZAG,
)
from ..geometry import FrameGeometry, ScanInfo
from ..tables import HuffSpec


def _marker(m: int) -> bytes:
    return struct.pack(">H", m)


def emit_soi() -> bytes:
    return _marker(M_SOI)


def emit_eoi() -> bytes:
    return _marker(M_EOI)


def emit_dqt(qtable: np.ndarray, tq: int) -> bytes:
    """DQT, Pq=0 8-bit entries in zig-zag order (encoder.c:205-234)."""
    body = bytes([(0 << 4) | tq]) + bytes(
        int(qtable[ZIGZAG[i]]) & 0xFF for i in range(64)
    )
    return _marker(M_DQT) + struct.pack(">H", 2 + len(body)) + body


def emit_sof0(geom: FrameGeometry) -> bytes:
    """SOF0 (encoder.c:236-274); components ascending by id."""
    comps = sorted(geom.components, key=lambda c: c.cid)
    body = struct.pack(
        ">BHHB", geom.precision, geom.height, geom.width, geom.nf
    )
    for c in comps:
        body += bytes([c.cid, (c.h << 4) | c.v, c.tq])
    return _marker(M_SOF0) + struct.pack(">H", 2 + len(body)) + body


def emit_dht(spec: HuffSpec, tc: int, th: int) -> bytes:
    """DHT (encoder.c:276-316)."""
    body = bytes([(tc << 4) | th]) + spec.dht_payload()
    return _marker(M_DHT) + struct.pack(">H", 2 + len(body)) + body


def emit_dri(ri: int) -> bytes:
    """DRI (B.2.4.4) -- our extension; the reference never emits it."""
    return _marker(M_DRI) + struct.pack(">HH", 4, ri)


def emit_sos(info: ScanInfo) -> bytes:
    """SOS (encoder.c:345-400): Ss=0, Se=63, Ah=Al=0."""
    body = bytes([info.ns])
    for cid, td, ta in zip(info.component_ids, info.td, info.ta):
        body += bytes([cid, (td << 4) | ta])
    body += bytes([0, 63, 0])
    return _marker(M_SOS) + struct.pack(">H", 2 + len(body)) + body


def emit_scan_body(segments: List[bytes]) -> bytes:
    """ECS segments joined with RST0..RST7 markers (modulo-8 count)."""
    out = bytearray()
    for k, seg in enumerate(segments):
        if k:
            out += _marker(M_RST0 + ((k - 1) & 7))
        out += seg
    return bytes(out)
