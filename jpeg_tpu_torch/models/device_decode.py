"""Full on-device JPEG decode: compressed bytes in, pixel frames out.

The Motion-JPEG ingestion path of the port.  Only the entropy-coded
segment words go to the device; both stages run there --

  restart-segment decode   (entropy.place_cuda.decode_segments)
  -> [F * total_blocks, 64] plane-major coefficients in device memory
  dense decode             (models.decode_dense.coeffs_to_pixels:
                            dequant -> IDCT -> upsample -> color -> u8)
  -> uint8 frames [F, H, W, C] that stay on the device.

Frames of a Motion-JPEG stream share geometry and Huffman tables, so a
chunk of frames decodes in one kernel launch with lanes = frames x
restart segments (one lane per frame when the stream has no restart
markers).  Their quantization tables may differ (a camera's rate
control): each frame dequantizes with its own.  The segment kernel
decodes each lane to its end, so there is no step bound to learn and no
starvation retry.  A chunk whose frames do not share the stream's
geometry or Huffman tables decodes frame by frame on the host path
instead (``_fallback_chunk``).

``decode_frame_device`` is the single-frame entry: every scan of a
multi-scan (e.g. non-interleaved) frame decodes on the device into its
slice of the planes, then the dense stage runs once.
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve
from ..entropy.lockstep import ScanPlan
from ..entropy.lockstep_torch import _cached_plan, pack_words
from ..entropy.place_cuda import (
    check_shape,
    decode_segments,
    decode_segments_general,
    region_path,
)
from ..errors import UnsupportedError
from ..format.parse import parse_codestream, unstuff, unstuff_ranges
from ..geometry import FrameGeometry
from ..models.decode_dense import coeffs_to_pixels
from ..models.flat_rows import rows_from_flat
from ..utils.metrics import default_metrics, trace

PREP_MODES = ("auto", "rows", "flat")
_UPLOAD_RATE: dict = {}  # measured host->device B/s by device, once each


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``: a pageable copy to a card, the array
    itself on the CPU."""
    return torch.from_numpy(a).to(dev)


def _measured_upload_rate(device: torch.device) -> float:
    """The sustained host->device rate of ``_upload`` in bytes a second,
    measured once per process and device; "auto" prep picks by it.

    A 4 MB warm-up, then a 32 MB buffer timed to a synchronize (jpeg_tpu's
    probe, ``jpeg_tpu/models/device_decode.py:50``), recorded in
    ``device_decode.upload_Bps``.  A failed upload raises.  On the CPU
    nothing is uploaded (the prep's tensors are its arrays): the rate is
    infinite, "auto" takes rows, and nothing is recorded."""
    key = str(device)
    if key in _UPLOAD_RATE:
        return _UPLOAD_RATE[key]
    if device.type == "cpu":
        _UPLOAD_RATE[key] = float("inf")
        return _UPLOAD_RATE[key]
    _upload(np.ones(1 << 20, np.uint32), device)
    torch.cuda.synchronize(device)
    buf = np.ones(8 << 20, np.uint32)
    t0 = time.perf_counter()
    _upload(buf, device)
    torch.cuda.synchronize(device)
    rate = _UPLOAD_RATE[key] = buf.nbytes / (time.perf_counter() - t0)
    default_metrics.counters["device_decode.upload_Bps"] = int(rate)
    return rate


# "auto" takes rows at or above this measured upload rate, flat below it.
# It is the break-even of the 8-frame 1080p 4:2:0 q75 ri=4 chunk: the
# 2,277,632 bytes that rows upload beyond flat's, over the 0.00279 ms that
# K13 (flat's one extra step) takes on the card, device only, as
# chip_smoke.py phase 17 derives it on an NVIDIA H100 80GB HBM3 at
# 700.00 W.  Later runs there derived 6.26e11-6.59e11 B/s (K13 at
# 0.0035-0.0036 ms); the constant keeps the first reading, since any
# value in that range picks the same mode.  That card's pageable uploads
# measured 4.8e9-7.7e9 B/s, so "auto" is flat on it, and so it stays on
# any PCIe-class link (PCIe 5.0 x16 peaks at 6.4e10 B/s), even against a
# break-even timed by K13's whole call (0.0228-0.0330 ms: 6.9e10-1.0e11
# B/s).  jpeg_tpu's 800 MB/s is a TPU figure, not used.
ROWS_MIN_UPLOAD_BPS = 8.16e11


def _dense_from_coeffs(coeffs: torch.Tensor, geom: FrameGeometry,
                       qtables: torch.Tensor) -> torch.Tensor:
    """[F, total_blocks, 64] plane-ordered coefficients and [F, 4, 64]
    per-frame tables -> device pixels [F, H, W, C] (uint8, or uint16
    above 8 bits): the dense tail kernel, or its plain version on CPU."""
    return coeffs_to_pixels(coeffs, qtables, geom)


@dataclass
class DeviceDecoder:
    """Whole-chunk decoder for streams sharing one geometry and Huffman
    tables (each frame keeps its own quantization tables).

    Build once from a representative frame with ``for_stream``, then
    ``decode_batch`` lists of JPEG byte strings (e.g. the frames of a
    Motion-JPEG stream).  Pixels stay on ``device``.
    """

    plan: ScanPlan
    geom: FrameGeometry
    ri: int
    segs_per_frame: int
    htable_key: tuple
    device: torch.device
    qtables_host: np.ndarray  # [4, 64] int32 of the sample frame
    qtables: torch.Tensor  # the same on ``device``, [1, 4, 64]
    # The native prep (``_prepare_native``): the sample frame's bytes up
    # to its first entropy-coded byte, that byte's offset, and the width
    # of the lane rows in u32 words (pack_words' padding; it only grows).
    header: bytes
    scan_start: int
    wn: int
    # The native prep's mode, jpeg_tpu's ``prep_mode``: "rows" writes the
    # zero-padded [S, wn] lane matrix on the host and uploads it; "flat"
    # packs the segments back to back in one buffer (about the compressed
    # size), uploads that and rebuilds the matrix on the device
    # (``rows_from_flat``, K13); "auto" measures the upload rate once
    # (``_measured_upload_rate``) and becomes "rows" at or above
    # ``ROWS_MIN_UPLOAD_BPS``, else "flat".  ``JPEG_TPU_PREP`` overrides.
    prep_mode: str = "auto"
    flat_blen: int = 0  # sticky flat buffer length in words (only grows)

    @staticmethod
    def for_stream(sample_jpeg: bytes, device) -> "DeviceDecoder":
        dev = resolve(device)
        cs = parse_codestream(sample_jpeg)
        if cs.geometry is None or len(cs.scans) != 1:
            raise UnsupportedError("device decoder needs a single-scan frame")
        scan = cs.scans[0]
        htable_key = tuple(sorted(scan.htables.items()))
        plan = _cached_plan(cs.geometry, scan.info, htable_key)
        # Any restart layout, none included (one lane per frame): shapes
        # that tile the MCU rows take the one-pass region kernel, the
        # rest the general one (entropy.place_cuda.decode_segments).
        spf = len(scan.ecs_ranges)
        total_blocks = sum(c.n_blocks for c in cs.geometry.components)
        check_shape(plan, 1, spf, total_blocks)
        qt = cs.qtables.astype(np.int32)
        maxlen = int(_segment_bytes(sample_jpeg, scan.ecs_ranges).max())
        scan_start = scan.ecs_ranges[0][0]
        return DeviceDecoder(
            plan=plan,
            geom=cs.geometry,
            ri=scan.ri,
            segs_per_frame=spf,
            htable_key=htable_key,
            device=dev,
            qtables_host=qt,
            qtables=torch.from_numpy(qt[None]).to(dev),
            header=sample_jpeg[:scan_start],
            scan_start=scan_start,
            wn=_row_words(maxlen),
        )

    @property
    def total_blocks(self) -> int:
        return sum(c.n_blocks for c in self.geom.components)

    def prepare(self, jpegs: Sequence[bytes]):
        """Host prep: parse + batch-unstuff + word packing, then upload.

        -> (words [S, Wn] int32, nbits [S] int32, qtables [F, 4, 64]
        int32), all on ``device``; ``qtables`` holds each frame's own
        tables.  When every frame's tables equal the sample frame's,
        nothing is uploaded for them: ``qtables`` is the cached set
        expanded over the frames (frame stride 0).

        A chunk whose frames all start with the sample frame's header
        takes the native prep (``_prepare_native``) when the native
        library is available; every other chunk, and one the native prep
        refuses, the Python prep (``parse_codestream``, ``unstuff_ranges``,
        ``pack_words``).  They give equal bit counts and tables, and equal
        words over each lane's segment: past it, the Python prep and the
        native "rows" mode hold zeros, the native "flat" mode the next
        segment's words (which no decode consumes).
        ``device_decode.native_prep_chunks`` and ``python_prep_chunks``
        count which prep ran, ``rows_prep_chunks`` and
        ``flat_prep_chunks`` the native chunks by mode.
        """
        prepared = self._prepare_native(jpegs)
        if prepared is not None:
            default_metrics.count("device_decode.native_prep_chunks")
            return prepared
        spf = self.segs_per_frame
        parts: List[np.ndarray] = []
        lens_parts: List[np.ndarray] = []
        qts: List[np.ndarray] = []
        for data in jpegs:
            cs = parse_codestream(data)
            if cs.geometry != self.geom or len(cs.scans) != 1:
                raise UnsupportedError(
                    "frame geometry differs from the stream's -- decode it "
                    "separately"
                )
            scan = cs.scans[0]
            if tuple(sorted(scan.htables.items())) != self.htable_key:
                raise UnsupportedError(
                    "frame's Huffman tables differ from the stream's -- "
                    "re-encode with shared (e.g. default MJPEG) tables or "
                    "decode it separately"
                )
            seg_bytes, seg_offsets = unstuff_ranges(data, scan.ecs_ranges)
            # Surplus segments are dropped; missing ones become empty lanes
            # (contribute zero MCUs, caught by the MCU accounting).
            seg_offsets = seg_offsets[: spf + 1]
            lens = np.zeros(spf, dtype=np.int64)
            lens[: seg_offsets.size - 1] = np.diff(seg_offsets)
            parts.append(seg_bytes[: seg_offsets[-1]])
            lens_parts.append(lens)
            qts.append(cs.qtables.astype(np.int32))
        words, nbits = pack_words(
            np.concatenate(parts) if parts else np.zeros(0, np.uint8),
            np.concatenate(lens_parts) if lens_parts else np.zeros(0, np.int64),
        )
        dev = self.device
        words_t = torch.from_numpy(words.view(np.int32)).to(dev)
        nbits_t = torch.from_numpy(nbits.astype(np.int32)).to(dev)
        if all(np.array_equal(q, self.qtables_host) for q in qts):
            qt = self.qtables.expand(len(qts), 4, 64)
        else:
            qt = torch.from_numpy(np.stack(qts)).to(dev)
        default_metrics.count("device_decode.python_prep_chunks")
        return words_t, nbits_t, qt

    def _prepare_native(self, jpegs: Sequence[bytes]):
        """The native prep, in the mode ``prep_mode`` (or
        ``JPEG_TPU_PREP``) names; "auto" resolves once, by the measured
        upload rate, and the decoder keeps the mode it picked.  Frames
        that start with the sample frame's header bytes share its
        geometry, Huffman tables, restart interval and quantization
        tables, so the tables are the cached set, with no upload.
        -> ``prepare``'s triple, or None for the Python prep: the library
        is not available, a frame's header differs (e.g. a DQT that
        changes from frame to frame), or a frame is not ``segs_per_frame``
        segments closed by EOI (malformed, truncated, other markers), so
        that every bad frame fails one way.  A "rows" chunk the rows
        refuse (rows that still overflow after their widenings, or a bad
        frame) goes to the flat prep, as in jpeg_tpu."""
        from .. import native

        if not native.available() or \
                not all(d.startswith(self.header) for d in jpegs):
            return None
        mode = os.environ.get("JPEG_TPU_PREP", self.prep_mode)
        if mode not in PREP_MODES:
            raise ValueError(f"prep mode {mode!r}: one of {PREP_MODES}")
        if mode == "auto":
            self.prep_mode = mode = (
                "rows"
                if _measured_upload_rate(self.device) >= ROWS_MIN_UPLOAD_BPS
                else "flat")
        if mode == "rows":
            prepared = self._prepare_native_rows(jpegs)
            if prepared is not None:
                default_metrics.count("device_decode.rows_prep_chunks")
                return prepared
        flat = self._pack_flat(jpegs)
        if flat is None:
            return None
        buf, starts, lens, packed = flat
        lens *= 8  # bit counts, in place: one upload carries all three
        S, dev = starts.size, self.device
        up = _upload(packed, dev)
        words = rows_from_flat(up[2 * S:], up[:S], self.wn)
        default_metrics.count("device_decode.flat_prep_chunks")
        return words, up[S:2 * S], self.qtables.expand(len(jpegs), 4, 64)

    def _prepare_native_rows(self, jpegs: Sequence[bytes]):
        """The "rows" mode: one C++ pass a frame (``jt_prep_ecs``)
        unstuffs its restart segments into its ``segs_per_frame`` rows of
        the zero-padded [S, wn] word matrix that ``decode_segments``
        reads, and the matrix is uploaded.  A row that overflows, or
        keeps less than ``pack_words``' 8 bytes of slack, widens ``wn``
        and redoes the chunk.  -> ``prepare``'s triple, or None."""
        from .. import native

        spf, frames = self.segs_per_frame, len(jpegs)
        for _ in range(4):
            rows = np.zeros((frames * spf, self.wn), np.uint32)
            lens = np.zeros(frames * spf, np.int32)
            for f, data in enumerate(jpegs):
                lane = slice(f * spf, (f + 1) * spf)
                rc = native.prep_ecs_native(data, self.scan_start, rows[lane],
                                            lens[lane])
                if rc != spf:
                    break
            else:
                need = _row_words(int(lens.max(initial=0)))
                if need <= self.wn:
                    dev = self.device
                    return (_upload(rows.view(np.int32), dev),
                            _upload(lens * 8, dev),
                            self.qtables.expand(frames, 4, 64))
                self.wn = need
                continue
            if rc != -2:
                return None
            self.wn = self.wn * 3 // 2 // 16 * 16 + 16
        return None

    def _pack_flat(self, jpegs: Sequence[bytes]):
        """The "flat" mode's host half (jpeg_tpu's, :406-439): one C++
        pass a frame (``jt_prep_ecs_flat``) packs its restart segments
        back to back at word offsets of one u32 buffer.  ``wn`` grows to
        hold the longest segment and a lookahead word (a multiple of 16);
        the buffer is rounded up to 65,536 words with at least ``wn + 1``
        words of zeros past the last segment, and its length only grows
        (``flat_blen``).  -> (buf [blen] u32, starts [S] int32 word
        offsets, lens [S] int32 bytes, packed), the first three views of
        ``packed`` [2 S + blen] int32 = starts, lens, buf; or None for
        the Python prep."""
        from .. import native

        spf, frames = self.segs_per_frame, len(jpegs)
        S = frames * spf
        cap = sum(len(d) for d in jpegs) // 4 + frames * (spf + 16)
        # Room for the rounded length: no segment is longer than its frame,
        # so wn cannot grow past ``widest``.
        widest = max(self.wn, (max(map(len, jpegs), default=0) + 3) // 4 + 17)
        room = max((cap + widest + 1 + 65535) // 65536 * 65536,
                   self.flat_blen)
        packed = np.zeros(2 * S + room, np.int32)
        starts, lens = packed[:S], packed[S:2 * S]
        buf = packed[2 * S:].view(np.uint32)
        base = 0
        for f, data in enumerate(jpegs):
            lane = slice(f * spf, (f + 1) * spf)
            rc, used = native.prep_ecs_flat_native(
                data, self.scan_start, buf[:cap], base, starts[lane],
                lens[lane])
            if rc != spf:
                return None
            starts[lane] += base  # the C++ gives frame-relative offsets
            base += used
        need = (int(lens.max(initial=0)) + 3) // 4 + 2
        if need > self.wn:
            self.wn = (need + 15) // 16 * 16
        blen = max((base + self.wn + 1 + 65535) // 65536 * 65536,
                   self.flat_blen)
        self.flat_blen = blen
        packed = packed[:2 * S + blen]
        return packed[2 * S:].view(np.uint32), starts, lens, packed

    def decode_prepared(self, words: torch.Tensor, nbits: torch.Tensor,
                        frames: int, place_ri: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prepared chunk -> (coeffs [frames, total_blocks, 64] int32,
        mcu_counts [S] int32), on ``device``.

        ``place_ri`` picks the placement as the JAX stream decoder's
        argument of that name: None (the default) routes by the stream's
        restart interval (``decode_segments``); 0 takes the general
        prefix-sum kernel (``decode_segments_general``); ``ri > 0`` the
        one-pass region kernel, which must take the shape
        (``region_path``), else ``UnsupportedError``."""
        tb, spf = self.total_blocks, self.segs_per_frame
        if place_ri == 0:
            coeffs, counts = decode_segments_general(
                self.plan, words, nbits, frames, spf, tb)
        else:
            ri = self.ri if place_ri is None else place_ri
            if place_ri is not None and not region_path(self.plan, spf, ri,
                                                        tb):
                raise UnsupportedError(
                    f"place_ri={ri}: the region placement does not take "
                    f"{spf} segments a frame of this scan")
            coeffs, counts = decode_segments(self.plan, words, nbits,
                                             frames, spf, ri, tb)
        return coeffs.reshape(frames, tb, 64), counts

    def _run(self, jpegs: Sequence[bytes], chunk: int, finish,
             fallback=None) -> torch.Tensor:
        """Decode in ``chunk``-frame chunks; ``finish(coeffs, qtables)``
        maps each chunk's coefficients [F, total_blocks, 64] and its
        per-frame tables [F, 4, 64] to its output.  With ``fallback``,
        a chunk whose frames the stream's plan does not take
        (``prepare`` raises ``UnsupportedError``: a mixed stream) becomes
        ``fallback(frames)`` instead of killing the batch."""
        n = len(jpegs)
        if n == 0:
            raise ValueError("no frames to decode")
        if chunk <= 0 or n <= chunk:
            bounds = [(0, n)]
        else:
            bounds = [(i, min(i + chunk, n)) for i in range(0, n, chunk)]
        outs, sums, checked = [], [], []
        for lo, hi in bounds:
            try:
                with trace("device_decode.prepare"):
                    words, nbits, qt = self.prepare(jpegs[lo:hi])
            except UnsupportedError:
                if fallback is None:
                    raise
                # Mixed stream (SURVEY §5 failure-isolation row).
                default_metrics.count("device_decode.mixed_fallbacks")
                outs.append(fallback(jpegs[lo:hi]))
                continue
            with trace("device_decode.dispatch"):
                coeffs, counts = self.decode_prepared(words, nbits, hi - lo)
                outs.append(finish(coeffs, qt))
            sums.append(counts.sum())
            checked.append((lo, hi))
        # Always-on decoded-MCU accounting (common.c:174): a truncated or
        # corrupt frame must not ship silent black blocks.  All chunks'
        # sums come back in one device round trip.
        got_all = torch.stack(sums).tolist() if sums else []
        for (lo, hi), got in zip(checked, got_all):
            want = self.plan.n_mcus * (hi - lo)
            if got != want:
                default_metrics.count("device_decode.short_mcus")
                warnings.warn(
                    f"chunk decoded {got} MCUs, geometry expects {want} "
                    "(truncated or corrupt frames?)",
                    RuntimeWarning,
                    stacklevel=3,
                )
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def decode_batch(self, jpegs: Sequence[bytes], chunk: int = 8):
        """-> device-resident pixel batch [F, H, W, C] (uint8/uint16)."""
        px = len(jpegs) * self.geom.height * self.geom.width
        with default_metrics.stage("device_decode.batch", items=px):
            return self._run(
                jpegs, chunk,
                lambda c, qt: _dense_from_coeffs(c, self.geom, qt),
                fallback=self._fallback_chunk,
            )

    def _fallback_chunk(self, jpegs: Sequence[bytes]) -> torch.Tensor:
        """Per-frame decode for frames the stream's plan rejects (other
        Huffman tables or sampling than the stream's): the host entropy
        decode and the fast dense stage of ``api.decode_jpeg``, pixels
        uploaded to ``device``.  Sizes must still match so the batch can
        concatenate."""
        return torch.stack([
            _host_pixels(f, self.geom, self.device) for f in jpegs
        ])

    def decode_coeffs_batch(self, jpegs: Sequence[bytes], chunk: int = 8):
        """-> plane-major coefficients [F, total_blocks, 64] int32 on
        ``device`` (components in geometry order)."""
        return self._run(jpegs, chunk, lambda c, qt: c)


def _segment_bytes(data: bytes, ranges) -> np.ndarray:
    """Each ECS range's unstuffed byte count (the differences of
    ``unstuff_ranges``' offsets) without building the bytes: the range's
    length less the stuffing zeros (a 0x00 after a 0xFF) inside it."""
    buf = np.frombuffer(data, dtype=np.uint8)
    zeros = np.flatnonzero((buf[:-1] == 0xFF) & (buf[1:] == 0x00)) + 1
    r = np.asarray(ranges, dtype=np.int64).reshape(-1, 2)
    return (r[:, 1] - r[:, 0]) - (np.searchsorted(zeros, r[:, 1])
                                  - np.searchsorted(zeros, r[:, 0]))


def _row_words(maxlen: int) -> int:
    """``pack_words``' row width in u32 words for a longest segment of
    ``maxlen`` bytes: 8 bytes of slack, rounded up to 64 bytes."""
    return (maxlen + 8 + 63) // 64 * 16


def _host_pixels(data: bytes, geom: FrameGeometry,
                 device: torch.device) -> torch.Tensor:
    """``api.decode_jpeg(data, device, exact=False).pixels()`` of a frame
    of ``geom``'s size, as [H, W, C] uint8/uint16 on ``device``."""
    from ..api import decode_jpeg

    c = 3 if geom.nf >= 3 else 1
    dt = np.uint8 if geom.precision <= 8 else np.uint16
    px = decode_jpeg(data, device, exact=False).pixels().astype(dt)
    if px.shape != (geom.height, geom.width, c):
        raise UnsupportedError("mixed-size frame in batch: decode it "
                               "separately")
    return torch.from_numpy(px).to(device)


def _dense_only(geom: FrameGeometry, coeffs: torch.Tensor,
                qtables: torch.Tensor) -> torch.Tensor:
    """[F, total_blocks, 64] coefficients and [F, 4, 64] tables ->
    [F, H, W, C] device pixels."""
    return _dense_from_coeffs(coeffs, geom, qtables)


def decode_frame_device(data: bytes, device) -> torch.Tensor:
    """One JPEG (any scan structure the kernel tables hold) -> pixels
    [H, W, C] on ``device``.

    The single-frame device entry: every scan of a multi-scan
    (non-interleaved, decoder.c:274-302) frame decodes on the device
    through ``decode_segments`` into its slice of the concatenated planes
    (scans cover whole components, so the slices are disjoint), then the
    dense stage runs once over the assembled frame.  Raises
    ``UnsupportedError`` for scans the kernels do not take (more than 16
    blocks per MCU); callers fall back to ``api.decode_jpeg``.
    """
    dev = resolve(device)
    cs = parse_codestream(data)
    geom = cs.geometry
    if geom is None or not cs.scans:
        raise UnsupportedError("no decodable frame")
    comp_off = {}
    off = 0
    for c in geom.components:
        comp_off[c.cid] = off
        off += c.n_blocks
    coeffs = torch.zeros(off, 64, dtype=torch.int32, device=dev)
    for scan in cs.scans:
        if scan.info.ns == 0:
            continue
        plan = _cached_plan(geom, scan.info,
                            tuple(sorted(scan.htables.items())))
        nb = sum(geom.by_id(cid).n_blocks for cid in scan.info.component_ids)
        spf = len(scan.ecs_ranges)
        check_shape(plan, 1, spf, nb)
        segments = [unstuff(data[s:e]) for s, e in scan.ecs_ranges]
        lens = np.array([s.size for s in segments], dtype=np.int64)
        words, nbits = pack_words(
            np.concatenate(segments) if lens.sum() else np.zeros(0, np.uint8),
            lens)
        c_i, _ = decode_segments(
            plan, torch.from_numpy(words.view(np.int32)).to(dev),
            torch.from_numpy(nbits.astype(np.int32)).to(dev), 1, spf,
            scan.ri, nb)
        o = comp_off[scan.info.component_ids[0]]
        coeffs[o : o + nb] = c_i
    qt = torch.from_numpy(cs.qtables.astype(np.int32)[None]).to(dev)
    return _dense_only(geom, coeffs[None], qt)[0]


def _rstless_scan(data: bytes, geom=None, htable_key=None):
    """Parse an RST-less single-scan frame -> (codestream, its unstuffed
    segment, htable key); ``UnsupportedError`` for any other layout, or
    when ``geom`` / ``htable_key`` are given and the frame's differ (a
    mixed stream)."""
    cs = parse_codestream(data)
    if cs.geometry is None or len(cs.scans) != 1 or \
            len(cs.scans[0].ecs_ranges) != 1:
        raise UnsupportedError("the RST-less engine takes single-scan frames "
                               "without restart markers")
    scan = cs.scans[0]
    key = tuple(sorted(scan.htables.items()))
    if geom is not None and (cs.geometry != geom or key != htable_key):
        raise UnsupportedError("mixed stream; decode per frame")
    s, e = scan.ecs_ranges[0]
    return cs, unstuff(data[s:e]), key


def decode_stream_rstless(parts: Sequence[bytes], device,
                          chunk: int = 8) -> torch.Tensor:
    """RST-less frames of one geometry and Huffman tables -> pixels [F, H,
    W, C] on ``device``.

    Each ``chunk`` frames ride one batch of the speculative engine
    (``entropy/speculative.py``: K8-K10 on the card), then the dense tail
    (``coeffs_to_pixels``, K3) with each frame's own quantization tables.
    Raises ``UnsupportedError`` for a mixed stream (another geometry,
    more than one scan, restart markers, other Huffman tables: the checks
    of ``jpeg_tpu/models/device_decode.py:941-954``) or when the engine
    refuses a batch (counted in ``speculative.fallbacks``).
    """
    from ..entropy.speculative import speculative_core_batch

    dev = resolve(device)
    if not parts:
        raise ValueError("no frames to decode")
    cs0, _, key0 = _rstless_scan(parts[0])
    geom = cs0.geometry
    plan = _cached_plan(geom, cs0.scans[0].info, key0)
    tb = sum(c.n_blocks for c in geom.components)
    step = chunk if chunk > 0 else len(parts)
    outs = []
    for lo in range(0, len(parts), step):
        segs, qts = [], []
        for p in parts[lo : lo + step]:
            cs, seg, _ = _rstless_scan(p, geom, key0)
            segs.append(seg)
            qts.append(cs.qtables.astype(np.int32))
        res = speculative_core_batch(plan, tb, segs, dev)
        if res is None:
            raise UnsupportedError("speculative resolution refused the batch; "
                                   "decode frame by frame")
        qt = torch.from_numpy(np.stack(qts)).to(dev)
        outs.append(_dense_only(geom, res[0].reshape(len(segs), tb, 64), qt))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def decode_frame_rstless(data: bytes, device) -> torch.Tensor:
    """One RST-less frame -> pixels [H, W, C] on ``device``: the engine
    on one frame, then the dense tail.  Raises ``UnsupportedError`` when
    the frame has restart markers or more than one scan, or the engine
    refuses it (a damaged stream): decode it on the host then."""
    return decode_stream_rstless([data], device)[0]
