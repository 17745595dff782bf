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
control): each frame dequantizes with its own.  The segment kernels
decode each lane to its end, so no chunk starves for steps.  A chunk
whose frames do not share the stream's geometry or Huffman tables
decodes frame by frame on the host path instead (``_fallback_chunk``).

jpeg_tpu's learned lane order (its phased scan) is kept: on the general
kernel (K2) in "rows" prep, the first batch of a kept decoder learns each
segment's symbol count (``_learn``), and later batches write their rows
longest first (``"mats"`` chunks) and decode them with that lane order,
so that a warp's lanes are of like length.  ``decode_batch`` takes the
order, as jpeg_tpu does, for parity with it (on the H100 it has shown no
gain over frame-major rows yet); ``prepare`` gives it only when asked,
and ``decode_prepared`` decodes its frame-major rows.  jpeg_tpu's step
bounds (``max_steps``, ``_phases_for``) are tracked as jpeg_tpu tracks
them; the phase schedule decides only whether a chunk would have starved
there (``device_decode.phase_inflate``: it is then redone frame-major,
learning again, as jpeg_tpu redoes it).

``decode_frame_device`` is the single-frame entry: every scan of a
multi-scan (e.g. non-interleaved) frame decodes on the device into its
slice of the planes, then the dense stage runs once.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve
from ..device import upload as _upload
from ..entropy.lockstep import ScanPlan
from ..entropy.lockstep_torch import _cached_plan, pack_words
from ..entropy.place_cuda import (
    check_shape,
    decode_segments,
    decode_segments_general,
    region_path,
)
from ..entropy.steps import _grow_steps, _max_steps_for
from ..errors import JpegError, UnsupportedError
from ..format.parse import parse_codestream, unstuff, unstuff_ranges
from ..geometry import FrameGeometry
from ..models.decode_dense import coeffs_to_pixels
from ..models.flat_rows import rows_from_flat
from ..utils.metrics import default_metrics, trace

PREP_MODES = ("rows", "flat")


def default_prep_mode(device: torch.device) -> str:
    """The native prep's mode on ``device``: "flat" on a CUDA card, else
    "rows".  On the CPU the upload hands back the host array itself, so
    the rows cost no copy.  On a card, rows would beat flat only over a
    link of 6.3e11-8.2e11 B/s or more: the 2,277,632 bytes a rows upload
    moves beyond flat's per 8-frame 1080p 4:2:0 ri=4 chunk, over K13's
    0.0028-0.0036 ms of device time (chip_smoke.py phase 17, H100 80GB
    HBM3 at 700 W, whose pageable uploads ran at 4.8e9-7.7e9 B/s).  PCIe
    5.0 x16 peaks at 6.4e10 B/s, Grace Hopper's C2C at about 4.5e11."""
    return "flat" if device.type == "cuda" else "rows"


class Prepared(tuple):
    """``DeviceDecoder.prepare``'s (words, nbits, qtables), with what the
    dispatch needs beside them: ``kind``, jpeg_tpu's tag of the prepared
    tuple ("mat": frame-major rows, "mats": rows in the learned lane
    order, "flat": rows rebuilt from the flat upload), ``perm`` (for
    "mats": [S] int32 on the device, sorted lane -> frame-major lane) and
    ``max_bits`` (the longest segment's bits, for the step bounds)."""

    kind: str
    perm: Optional[torch.Tensor]
    max_bits: int

    def __new__(cls, words, nbits, qtables, kind: str, max_bits: int,
                perm: Optional[torch.Tensor] = None):
        self = super().__new__(cls, (words, nbits, qtables))
        self.kind, self.perm, self.max_bits = kind, perm, int(max_bits)
        return self


@dataclass
class _Chunk:
    """One chunk of ``DeviceDecoder._run`` between its dispatch and its
    checks: its frames ``[lo, hi)``, its prepared input, the step bound
    jpeg_tpu would have given it (``steps``), its device per-lane steps
    when it learns, and, after the one host read, its decoded MCUs,
    whether it starved and its longest lane's steps."""

    lo: int
    hi: int
    slot: int  # its place in the batch's outputs
    prepared: Prepared
    steps: int
    nsteps: Optional[torch.Tensor] = None
    mcus: int = 0
    starved: bool = False
    longest: Optional[int] = None


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
    # jpeg_tpu's step bound of the stream's lockstep scan (its
    # ``max_steps``): the port's kernels need none, but the learned phase
    # schedule ends on it, so it moves as jpeg_tpu moves it.
    max_steps: int
    # The native prep's mode, jpeg_tpu's ``prep_mode``: "rows" writes the
    # zero-padded [S, wn] lane matrix on the host and uploads it; "flat"
    # packs the segments back to back in one buffer (about the compressed
    # size), uploads that and rebuilds the matrix on the device
    # (``rows_from_flat``, K13).  ``for_stream`` sets it from the device
    # (``default_prep_mode``); a caller may set either mode later.
    prep_mode: str
    flat_blen: int = 0  # sticky flat buffer length in words (only grows)
    # jpeg_tpu's learned lane order: each segment's predicted steps (the
    # most any frame's lane took in the learning pass, plus 4, max-folded
    # over chunks) and the segments by descending prediction.  Set by the
    # first batch of "mat" chunks on the general kernel; "rows" chunks
    # after it are written in this order ("mats").
    lane_steps: Optional[np.ndarray] = None  # [spf] predicted steps
    sort_order: Optional[np.ndarray] = None  # [spf] seg ids, desc pred
    # The placement, jpeg_tpu's ``place_ri``: the stream's restart
    # interval for the one-pass region kernel (K1), 0 for the general
    # kernel (K2).  ``for_stream`` takes K1 wherever ``region_path``
    # holds; set 0 before the first batch to force K2.  Only K2 learns a
    # lane order.
    place_ri: int = 0
    # The last lane order, (key, perm on the device, perm), and the phase
    # budgets of its last schedule, (key, frame-major budgets): a "mats"
    # chunk uploads neither while the order and schedule stand.
    _lane_order: tuple = field(default=(None, None, None), repr=False)
    _budgets: tuple = field(default=(None, None), repr=False)

    @staticmethod
    def for_stream(sample_jpeg: bytes, device) -> "DeviceDecoder":
        """The decoder of the stream whose frames are like ``sample_jpeg``.

        While the native library is available, only the frame's header is
        parsed, and one ``jt_walk_ecs_flat`` walk from its first
        entropy-coded byte gives the segments' unstuffed lengths
        (``_native_head``); a frame that walk or the header parse refuses
        is parsed whole (``_parsed_head``), and raises as that parse
        does.  Both give equal decoders.  ``device_decode.native_for_stream``
        and ``python_for_stream`` count which ran."""
        dev = resolve(device)
        head = _native_head(sample_jpeg)
        if head is None:
            default_metrics.count("device_decode.python_for_stream")
            head = _parsed_head(sample_jpeg)
        else:
            default_metrics.count("device_decode.native_for_stream")
        cs, scan, htable_key, plan, lens = head
        # Any restart layout, none included (one lane per frame): shapes
        # that tile the MCU rows take the one-pass region kernel, the
        # rest the general one (entropy.place_cuda.decode_segments).
        spf = lens.size
        total_blocks = sum(c.n_blocks for c in cs.geometry.components)
        check_shape(plan, 1, spf, total_blocks)
        qt = cs.qtables.astype(np.int32)
        scan_start = scan.ecs_ranges[0][0]
        return DeviceDecoder(
            plan=plan,
            geom=cs.geometry,
            ri=scan.ri,
            segs_per_frame=spf,
            htable_key=htable_key,
            device=dev,
            qtables_host=qt,
            qtables=_upload(qt[None], dev),
            header=sample_jpeg[:scan_start],
            scan_start=scan_start,
            wn=_row_words(int(lens.max())),
            max_steps=_max_steps_for(lens * 8, plan, scan.ri),
            prep_mode=default_prep_mode(dev),
            place_ri=(scan.ri if region_path(plan, spf, scan.ri, total_blocks)
                      else 0),
        )

    @property
    def total_blocks(self) -> int:
        return sum(c.n_blocks for c in self.geom.components)

    def prepare(self, jpegs: Sequence[bytes], lane_order: bool = False):
        """Host prep: parse + batch-unstuff + word packing, then upload.

        -> ``Prepared`` (words [S, Wn] int32, nbits [S] int32, qtables
        [F, 4, 64] int32), all on ``device``; ``qtables`` holds each
        frame's own tables.  When every frame's tables equal the sample
        frame's, nothing is uploaded for them: ``qtables`` is the cached
        set expanded over the frames (frame stride 0).  The rows are
        frame-major (lane ``f * segs_per_frame + k``), as
        ``decode_prepared`` and the sharded decoders read them, unless
        ``lane_order`` asks for the learned order: in the native "rows"
        mode, once ``sort_order`` is learned, the chunk is then "mats",
        its rows and bit counts in that order, and its ``perm`` must go
        to ``decode_prepared`` with them (``decode_batch`` does this).

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
        prepared = self._prepare_native(jpegs, lane_order)
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
        words_t = _upload(words.view(np.int32), dev)
        nbits_t = _upload(nbits.astype(np.int32), dev)
        if all(np.array_equal(q, self.qtables_host) for q in qts):
            qt = self.qtables.expand(len(qts), 4, 64)
        else:
            qt = _upload(np.stack(qts), dev)
        default_metrics.count("device_decode.python_prep_chunks")
        return Prepared(words_t, nbits_t, qt, "mat", nbits.max(initial=0))

    def _prepare_native(self, jpegs: Sequence[bytes],
                        lane_order: bool = False):
        """The native prep, in the mode ``prep_mode`` names (any other
        value raises ValueError).  Frames that start with the sample
        frame's header bytes share its geometry, Huffman tables, restart
        interval and quantization tables, so the tables are the cached
        set, with no upload.  -> ``prepare``'s ``Prepared``, or None for
        the Python prep: the library is not available, a frame's header
        differs (e.g. a DQT that changes from frame to frame), or a frame
        is not ``segs_per_frame`` segments closed by EOI (malformed,
        truncated, other markers), so that every bad frame fails one way.
        A "rows" chunk the rows refuse (rows that still overflow after
        their widenings, or a bad frame) goes to the flat prep, as in
        jpeg_tpu."""
        from .. import native

        if self.prep_mode not in PREP_MODES:
            raise ValueError(f"prep mode {self.prep_mode!r}: one of "
                             f"{PREP_MODES}")
        if not native.available() or \
                not all(d.startswith(self.header) for d in jpegs):
            return None
        if self.prep_mode == "rows":
            prepared = self._prepare_native_rows(jpegs, lane_order)
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
        return Prepared(words, up[S:2 * S],
                        self.qtables.expand(len(jpegs), 4, 64), "flat",
                        lens.max(initial=0))

    def _prepare_native_rows(self, jpegs: Sequence[bytes],
                             lane_order: bool = False):
        """The "rows" mode: one C++ pass a frame unstuffs its restart
        segments into its ``segs_per_frame`` rows of the zero-padded [S, wn]
        word matrix that ``decode_segments`` reads, and the matrix is
        uploaded.  A row that overflows, or keeps less than ``pack_words``'
        8 bytes of slack, widens ``wn`` and redoes the chunk.

        Asked for the lane order (``lane_order``), once one is learned
        (``sort_order``), the rows are written in it, as
        jpeg_tpu's (``jpeg_tpu/models/device_decode.py:441-499``,
        ``jt_prep_ecs_rows``): row ``rank * frames + f`` holds frame
        ``f``'s segment of rank ``rank``, the bit counts follow the rows,
        and ``perm`` maps a row to its frame-major lane ("mats").  Else
        ``jt_walk_ecs_rows`` with no row map writes them frame-major
        ("mat").  -> ``prepare``'s ``Prepared``, or None."""
        from .. import native

        spf, frames = self.segs_per_frame, len(jpegs)
        sort = self.sort_order if lane_order else None
        if sort is not None:
            rank_of = np.empty(spf, np.int64)
            rank_of[sort] = np.arange(spf)
        for _ in range(4):
            rows = np.zeros((frames * spf, self.wn), np.uint32)
            lens = np.zeros(frames * spf, np.int32)
            for f, data in enumerate(jpegs):
                lane = slice(f * spf, (f + 1) * spf)
                if sort is None:
                    rc = native.prep_ecs_native(data, self.scan_start,
                                                rows[lane], lens[lane])
                else:
                    rc = native.prep_ecs_rows_native(
                        data, self.scan_start, rows,
                        (rank_of * frames + f).astype(np.int32), lens[lane])
                if rc != spf:
                    break
            else:
                need = _row_words(int(lens.max(initial=0)))
                if need > self.wn:
                    self.wn = need
                    continue
                dev = self.device
                qt = self.qtables.expand(frames, 4, 64)
                words = _upload(rows.view(np.int32), dev)
                if sort is None:
                    return Prepared(words, _upload(lens * 8, dev), qt, "mat",
                                    lens.max(initial=0) * 8)
                nbits = (lens.reshape(frames, spf)[:, sort].T * 8).reshape(-1)
                default_metrics.count("device_decode.mats_chunks")
                return Prepared(words, _upload(nbits.astype(np.int32), dev),
                                qt, "mats", lens.max(initial=0) * 8,
                                self._perm(frames, sort))
            if rc != -2:
                return None
            self.wn = self.wn * 3 // 2 // 16 * 16 + 16
        return None

    def _perm(self, frames: int, sort: np.ndarray) -> torch.Tensor:
        """The sorted rows' lane order on ``device``, [S] int32: row
        ``rank * frames + f`` is frame ``f``'s segment ``sort[rank]``
        (jpeg_tpu's ``perm``); uploaded once while the order stands."""
        key = (frames, sort.tobytes())
        if self._lane_order[0] != key:
            S = frames * self.segs_per_frame
            perm = ((np.arange(S) % frames) * self.segs_per_frame
                    + sort[np.arange(S) // frames]).astype(np.int32)
            self._lane_order = (key, _upload(perm, self.device), perm)
        return self._lane_order[1]

    def _pack_flat(self, jpegs: Sequence[bytes]):
        """The "flat" mode's host half (jpeg_tpu's, :406-439): one C++
        pass a frame (``jt_walk_ecs_flat``) packs its restart segments
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
                        frames: int, place_ri: Optional[int] = None,
                        perm: Optional[torch.Tensor] = None,
                        want_nsteps: bool = False):
        """Prepared chunk -> (coeffs [frames, total_blocks, 64] int32,
        mcu_counts [S] int32 frame-major), on ``device``.

        ``place_ri`` picks the placement as the JAX stream decoder's
        argument of that name: None (the default) routes by the stream's
        restart interval (``decode_segments``); 0 takes the general
        prefix-sum kernel (``decode_segments_general``); ``ri > 0`` the
        one-pass region kernel, which must take the shape
        (``region_path``), else ``UnsupportedError``.  ``perm`` (a "mats"
        chunk's ``Prepared.perm``: the rows are in that lane order) and
        ``want_nsteps`` (a third result, each lane's steps begun alive,
        frame-major) take the general kernel, whatever ``place_ri`` says
        short of the region kernel.  A ``perm`` other than this decoder's
        own order must be a permutation of the rows, else ValueError (on
        the card a host read checks it; the decoder's own is trusted)."""
        tb, spf = self.total_blocks, self.segs_per_frame
        if perm is not None or want_nsteps:
            if place_ri:
                raise UnsupportedError("a lane order and step counts are "
                                       "the general kernel's")
            place_ri = 0
        if place_ri == 0:
            out = decode_segments_general(
                self.plan, words, nbits, frames, spf, tb, perm=perm,
                want_nsteps=want_nsteps,
                perm_checked=perm is self._lane_order[1])
        else:
            ri = self.ri if place_ri is None else place_ri
            if place_ri is not None and not region_path(self.plan, spf, ri,
                                                        tb):
                raise UnsupportedError(
                    f"place_ri={ri}: the region placement does not take "
                    f"{spf} segments a frame of this scan")
            out = decode_segments(self.plan, words, nbits, frames, spf, ri,
                                  tb)
        return (out[0].reshape(frames, tb, 64), *out[1:])

    def _steps_for(self, prepared: Prepared, optimistic: bool = True) -> int:
        """jpeg_tpu's step bound of a chunk (``_max_steps_for`` of its
        longest segment): optimistic, or the hard cap."""
        return _max_steps_for(np.array([prepared.max_bits]), self.plan,
                              self.ri, optimistic)

    def _phase_budgets(self, frames: int, max_steps: int) -> torch.Tensor:
        """``phase_budgets`` of ``_phases_for(frames, max_steps)`` moved to
        the frame-major lanes of the lane order in force (``_perm``'s
        last), on ``device``; uploaded once while order and schedule
        stand."""
        key = (frames, max_steps, self.lane_steps.tobytes(),
               self._lane_order[0])
        if self._budgets[0] != key:
            phases = self._phases_for(frames, max_steps)
            out = np.empty(frames * self.segs_per_frame, np.int32)
            out[self._lane_order[2]] = phase_budgets(phases, out.size)
            self._budgets = (key, _upload(out, self.device))
        return self._budgets[1]

    def _dispatch(self, prepared: Prepared, frames: int, learn: bool):
        """One prepared chunk on ``device`` -> (coeffs, mcu_counts, its
        lanes' steps when it learns, else None, for a "mats" chunk the
        count of its starved lanes as a 0-d int64 device tensor, else
        None).  A "mats" chunk decodes in its lane order on the general
        kernel, with its steps; a lane starved when it took more steps
        than jpeg_tpu's phase schedule gave it, which is where
        ``_scan_lanes_phased`` finds it alive or with its last DC still
        pending.  A learning chunk is a "mat" chunk on the general kernel
        that also returns its steps (jpeg_tpu's ``_decode_device_learn``)."""
        words, nbits, _ = prepared
        if prepared.kind == "mats":
            coeffs, counts, nsteps = self.decode_prepared(
                words, nbits, frames, perm=prepared.perm, want_nsteps=True)
            steps = max(self.max_steps, self._steps_for(prepared))
            starved = (nsteps > self._phase_budgets(frames, steps)).sum()
            return coeffs, counts, None, starved
        if learn:
            coeffs, counts, nsteps = self.decode_prepared(
                words, nbits, frames, want_nsteps=True)
            default_metrics.count("device_decode.learn_chunks")
            return coeffs, counts, nsteps, None
        coeffs, counts = self.decode_prepared(words, nbits, frames,
                                              place_ri=self.place_ri)
        return coeffs, counts, None, None

    def _run(self, jpegs: Sequence[bytes], chunk: int, finish,
             fallback=None) -> torch.Tensor:
        """Decode in ``chunk``-frame chunks; ``finish(coeffs, qtables)``
        maps each chunk's coefficients [F, total_blocks, 64] and its
        per-frame tables [F, 4, 64] to its output.  With ``fallback``,
        a chunk whose frames the stream's plan does not take
        (``prepare`` raises ``UnsupportedError``: a mixed stream) becomes
        ``fallback(frames)`` instead of killing the batch.

        The learned lane order follows jpeg_tpu's ``decode_batch``
        (``jpeg_tpu/models/device_decode.py:694-813``): while none is
        learned, every "mat" chunk on the general kernel learns from its
        steps (read back in the batch's one host read, with the MCU sums)
        capped at the bound jpeg_tpu's scan would have run (``steps``);
        jpeg_tpu's starvation ladder (``_grow_steps`` up to the hard cap)
        moves ``max_steps`` as far as the uncapped steps would have taken
        it, with no relaunch.  A "mats" chunk that starved is redone
        frame-major, learning again, and counted in
        ``device_decode.phase_inflate``: the port's kernel never starves,
        but the redo gives jpeg_tpu's classic result on a damaged chunk
        (where two lanes write one coefficient, the lane order picks the
        winner) and moves the learned bounds as jpeg_tpu's does.  The
        frames of the "mats" chunks that stand, decoded in the learned
        order, count in ``device_decode.lane_order_frames``."""
        n = len(jpegs)
        if n == 0:
            raise ValueError("no frames to decode")
        if chunk <= 0 or n <= chunk:
            bounds = [(0, n)]
        else:
            bounds = [(i, min(i + chunk, n)) for i in range(0, n, chunk)]
        outs, flight, sums, flags = [], [], [], []
        for lo, hi in bounds:
            try:
                with trace("device_decode.prepare"):
                    prepared = self.prepare(jpegs[lo:hi], lane_order=True)
            except UnsupportedError:
                if fallback is None:
                    raise
                # Mixed stream (SURVEY §5 failure-isolation row).
                default_metrics.count("device_decode.mixed_fallbacks")
                outs.append(fallback(jpegs[lo:hi]))
                continue
            learn = (self.lane_steps is None and prepared.kind == "mat"
                     and not self.place_ri)
            with trace("device_decode.dispatch"):
                coeffs, counts, nsteps, starved = self._dispatch(
                    prepared, hi - lo, learn)
                flight.append(_Chunk(lo, hi, len(outs), prepared, max(
                    self.max_steps, self._steps_for(prepared)), nsteps))
                outs.append(finish(coeffs, prepared[2]))
            sums.append(counts.sum())
            if starved is not None:
                flags.append((flight[-1], starved))
        # Always-on decoded-MCU accounting (common.c:174): a truncated or
        # corrupt frame must not ship silent black blocks.  All chunks'
        # sums, "mats" chunks' starved lanes and learning chunks' steps
        # come back in one device round trip.
        if sums:
            learning = [rec for rec in flight if rec.nsteps is not None]
            with trace("device_decode.readback"):
                got = torch.cat([s.reshape(1) for s in sums] + [
                    f.reshape(1) for _, f in flags] + [
                    rec.nsteps.to(torch.int64) for rec in learning]
                ).cpu().numpy()
            for rec, mcus in zip(flight, got[:len(sums)].tolist()):
                rec.mcus = mcus
            at = len(sums)
            for rec, _ in flags:
                rec.starved, at = bool(got[at] > 0), at + 1
            for rec in learning:
                n = rec.nsteps.numel()
                self._learn_chunk(rec, got[at:at + n])
                at += n
        for rec in flight:
            if rec.starved:
                outs[rec.slot] = self._inflate(jpegs[rec.lo:rec.hi], rec,
                                               finish)
            elif rec.prepared.kind == "mats":
                default_metrics.count("device_decode.lane_order_frames",
                                      rec.hi - rec.lo)
            self._ladder(rec)
            self.max_steps = max(self.max_steps, rec.steps)
            want = self.plan.n_mcus * (rec.hi - rec.lo)
            if rec.mcus != want:
                default_metrics.count("device_decode.short_mcus")
                warnings.warn(
                    f"chunk decoded {rec.mcus} MCUs, geometry expects {want} "
                    "(truncated or corrupt frames?)",
                    RuntimeWarning,
                    stacklevel=3,
                )
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def _learn_chunk(self, rec: _Chunk, nsteps: np.ndarray) -> None:
        """Learn from a chunk's steps (read back to the host, frame-major)
        as jpeg_tpu learns from its capped scan counters (each lane's
        steps, at most the bound ``rec.steps`` its scan ran); keep its
        longest lane for the ladder."""
        rec.longest = int(nsteps.max(initial=0))
        self._learn(np.minimum(nsteps, rec.steps), rec.hi - rec.lo)

    def _inflate(self, jpegs: Sequence[bytes], rec: _Chunk, finish):
        """Redo a starved "mats" chunk as jpeg_tpu does (:761-782): the
        frame-major prep, a decode that learns (max-folded into the lane
        order), one host read of its MCUs and steps, all in the span
        ``device_decode.inflate``.  -> its output."""
        default_metrics.count("device_decode.phase_inflate")
        with trace("device_decode.inflate"):
            prepared = self.prepare(jpegs)
            coeffs, counts, nsteps, _ = self._dispatch(
                prepared, len(jpegs), learn=prepared.kind == "mat")
            out = finish(coeffs, prepared[2])
            rec.prepared, rec.nsteps, rec.starved = prepared, nsteps, False
            rec.steps = max(self.max_steps, self._steps_for(prepared))
            with trace("device_decode.readback"):
                got = torch.cat([counts.sum()[None]] + (
                    [] if nsteps is None else [nsteps.to(torch.int64)])
                ).cpu().numpy()
        rec.mcus = int(got[0])
        if nsteps is not None:
            self._learn_chunk(rec, got[1:])
        return out

    def _ladder(self, rec: _Chunk) -> None:
        """jpeg_tpu's starvation retries of a learning chunk (:783-795),
        without the relaunches: while its longest lane outlasts the bound,
        and the bound is below the hard cap, ``max_steps`` grows a rung
        (``_grow_steps``) and the bound becomes what jpeg_tpu's next
        attempt would run."""
        if rec.longest is None:
            return
        hard_cap = self._steps_for(rec.prepared, optimistic=False)
        while rec.longest > rec.steps and rec.steps < hard_cap:
            self.max_steps = _grow_steps(rec.steps, hard_cap)
            rec.steps = max(self.max_steps, self._steps_for(rec.prepared))

    def _phases_for(self, frames: int, max_steps: int):
        """Static phase schedule from the learned per-segment bounds.

        Lanes (rank-major rows) are sorted descending, so each cut
        retires the short tail; a phase's cumulative budget must cover
        the LONGEST lane retiring in it (= the first lane past the next
        cut).  The final budget is the stream's classic step bound so a
        misprediction degrades to the single-phase cost, not an error.
        """
        spf = self.segs_per_frame
        S = frames * spf
        pred = np.repeat(self.lane_steps[self.sort_order], frames)
        cuts = [S]
        # Geometric cut ladder: photographic per-segment symbol counts
        # are TIGHT (p50~152, p95~165 on the bench stream), so the waste
        # is prediction slack, not tail lanes -- many shallow cuts at a
        # fine quantum track the sorted curve closely (host-measured
        # attempts ratio 1.50 -> 1.14 with the tightened learner).
        for d in np.unique(np.geomspace(1.2, 120, 24).astype(int)):
            n = max(128, S // int(d) // 128 * 128)
            if n < cuts[-1]:
                cuts.append(n)
        bounds = []
        for i in range(len(cuts)):
            if i + 1 < len(cuts):
                b = int(pred[min(cuts[i + 1], S - 1)])
            else:
                # the longest lane's budget: the classic bound, raised to
                # the learned max (pred may legitimately exceed the
                # optimistic classic estimate)
                b = max(max_steps, int(pred[0]) + 32)
            # 8-step quanta: fine enough to hug the lane spread, few
            # enough values that the schedule (a static jit key) settles
            bounds.append(max(64, (b + 7) // 8 * 8))
        bounds = list(np.maximum.accumulate(bounds))
        phases = []
        acc = 0
        for n, b in zip(cuts, bounds):
            if b - acc <= 0:
                continue  # this cut saves nothing; retire with previous
            phases.append((int(n), int(b - acc)))
            acc = b
        return tuple(phases)

    def _learn(self, nsteps: np.ndarray, frames: int) -> None:
        """Fold one chunk's per-lane consumed steps into the per-segment
        prediction (content is spatially stable across frames of a
        stream, so segment position k's cost repeats)."""
        per_seg = nsteps.reshape(frames, self.segs_per_frame).max(axis=0)
        # Tight slack: +4 steps, no multiplier.  The old x1.15+16 margin
        # alone cost a 1.35x attempts ratio; content drifting past the
        # bound is caught by the starvation flag and the chunk redoes
        # classically WITH learning (max-fold), so mispredictions cost
        # one retrace, not correctness.
        pred = per_seg.astype(np.int64) + 4
        if self.lane_steps is not None:
            pred = np.maximum(pred, self.lane_steps)
        self.lane_steps = pred
        self.sort_order = np.argsort(-pred, kind="stable")

    def decode_batch(self, jpegs: Sequence[bytes], chunk: int = 8):
        """-> device-resident pixel batch [F, H, W, C] (uint8/uint16)."""
        with trace("device_decode.batch"):
            return self._run(
                jpegs, chunk,
                lambda c, qt: coeffs_to_pixels(c, qt, self.geom),
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


def phase_budgets(phases, lanes: int) -> np.ndarray:
    """Each sorted lane's step budget under a phase schedule (jpeg_tpu's
    ``_scan_lanes_phased``: phase ``p`` runs ``t_p`` steps over the first
    ``n_p`` lanes, so lanes ``[n_{p+1}, n_p)`` retire after it): the steps
    of every phase up to its own.  A lane starves there exactly when it
    begins more steps alive than its budget (``_dispatch``).  -> [lanes]
    int32."""
    out = np.zeros(lanes, np.int32)
    acc = 0
    for p, (n, t) in enumerate(phases):
        acc += t
        out[phases[p + 1][0] if p + 1 < len(phases) else 0:n] = acc
    return out


def _parsed_head(data: bytes):
    """``for_stream``'s whole-frame parse: -> (codestream, its one scan,
    the scan's Huffman table key, its plan, each segment's unstuffed
    length [S] int64)."""
    cs = parse_codestream(data)
    if cs.geometry is None or len(cs.scans) != 1:
        raise UnsupportedError("device decoder needs a single-scan frame")
    scan = cs.scans[0]
    htable_key = tuple(sorted(scan.htables.items()))
    plan = _cached_plan(cs.geometry, scan.info, htable_key)
    return cs, scan, htable_key, plan, _segment_bytes(data, scan.ecs_ranges)


def _native_head(data: bytes):
    """``_parsed_head``'s result without the whole-frame parse, or None.

    ``parse_codestream`` reads only the header, closed by an EOI after
    its last byte (``_first_ecs_byte``), and one ``jt_walk_ecs_flat``
    walk from there gives the segments' unstuffed lengths.  None, for
    the whole parse, when the library is not available, the header parse
    raises or does not end its one scan's header there, the walk refuses
    the rest (a marker other than RST and EOI: a second scan, a DNL, a
    table; garbage; no EOI), or the frame has more segments than its
    restart interval gives.  Else the whole parse reads the same header
    bytes and only segments after them, so it gives the same result."""
    from .. import native

    if not native.available():
        return None
    data = bytes(data)
    k = _first_ecs_byte(data)
    if k is None:
        return None
    try:
        cs = parse_codestream(data[:k] + b"\xff\xd9")
    except JpegError:
        return None
    if cs.geometry is None or len(cs.scans) != 1 or \
            cs.scans[0].ecs_ranges[0][0] != k:
        return None
    # Every segment after the first follows a 2-byte RST marker.
    rows = (len(data) - k) // 2 + 1
    starts = np.empty(rows, np.int32)
    lens = np.empty(rows, np.int32)
    words = np.empty((len(data) - k) // 4 + rows + 1, np.uint32)
    nsegs, _ = native.prep_ecs_flat_native(data, k, words, 0, starts, lens)
    if nsegs < 0:
        return None
    scan = cs.scans[0]
    htable_key = tuple(sorted(scan.htables.items()))
    plan = _cached_plan(cs.geometry, scan.info, htable_key)
    if nsegs > (-(-plan.n_mcus // scan.ri) if scan.ri else 1):
        return None  # surplus restart markers
    return cs, scan, htable_key, plan, lens[:nsegs].astype(np.int64)


def _first_ecs_byte(data: bytes) -> Optional[int]:
    """The offset after the first SOS segment by its length field, from a
    walk of the marker segments before it (``_Reader.read_marker``'s
    rules); None when it meets EOI, a length under 2 or the end first."""
    n, p = len(data), 0
    while True:
        p = data.find(b"\xff", p) + 1
        if p == 0:
            return None
        while p < n and data[p] == 0xFF:  # fill bytes
            p += 1
        if p + 2 >= n:
            return None
        m = data[p]
        p += 1
        if m in (0x00, 0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            continue  # no marker (stuffing), or no payload
        if m == 0xD9:
            return None
        seglen = (data[p] << 8) | data[p + 1]
        if seglen < 2:
            return None
        if m == 0xDA:
            return p + seglen
        p += seglen


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
    return _upload(px, device)


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
            plan, _upload(words.view(np.int32), dev),
            _upload(nbits.astype(np.int32), dev), 1, spf, scan.ri, nb)
        o = comp_off[scan.info.component_ids[0]]
        coeffs[o : o + nb] = c_i
    qt = _upload(cs.qtables.astype(np.int32)[None], dev)
    return coeffs_to_pixels(coeffs[None], qt, geom)[0]


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


def decode_stream_rstless(parts: Sequence[bytes], device, chunk: int = 8,
                          dec: Optional[DeviceDecoder] = None
                          ) -> torch.Tensor:
    """RST-less frames of one geometry and Huffman tables -> pixels [F, H,
    W, C] on ``device``.

    Each ``chunk`` frames ride one batch of the speculative engine
    (``entropy/speculative.py``: K8-K10 on the card), then the dense tail
    (``coeffs_to_pixels``, K3) with each frame's own quantization tables.
    ``dec``, the stream's ``DeviceDecoder`` on ``device`` (as
    ``mjpeg.decode_stream_device`` builds it), gives the geometry, plan
    and Huffman tables, so no frame is parsed for them; without it the
    first frame's are taken.  With ``dec``, a chunk whose frames all start
    with ``dec.header`` takes the native prep (``prepare_batch_native``:
    no parse, the cached tables); every other chunk, and one the native
    pass refuses, the Python prep (``_rstless_scan`` a frame, then
    ``prepare_batch``).  Raises ``UnsupportedError`` for a mixed stream
    (another geometry, more than one scan, restart markers, other Huffman
    tables: the checks of ``jpeg_tpu/models/device_decode.py:941-954``)
    or when the engine refuses a batch (counted in
    ``speculative.fallbacks``).
    """
    from .. import native
    from ..entropy import speculative

    dev = resolve(device)
    if not parts:
        raise ValueError("no frames to decode")
    if dec is None:
        with trace("device_decode.spec_parse"):
            cs0, _, key0 = _rstless_scan(parts[0])
            geom = cs0.geometry
            plan = _cached_plan(geom, cs0.scans[0].info, key0)
    else:
        geom, plan, key0 = dec.geom, dec.plan, dec.htable_key
    tb = sum(c.n_blocks for c in geom.components)
    step = chunk if chunk > 0 else len(parts)
    outs = []
    for lo in range(0, len(parts), step):
        batch = parts[lo : lo + step]
        prepared = None
        if dec is not None and native.available() and \
                all(p.startswith(dec.header) for p in batch):
            with trace("device_decode.spec_prepare"):
                prepared = speculative.prepare_batch_native(
                    batch, dec.scan_start, dev)
        if prepared is not None:
            res = speculative.speculative_core(plan, tb, *prepared)
            qt = dec.qtables.expand(len(batch), 4, 64)
        else:
            segs, qts = [], []
            with trace("device_decode.spec_parse"):
                for p in batch:
                    cs, seg, _ = _rstless_scan(p, geom, key0)
                    segs.append(seg)
                    qts.append(cs.qtables.astype(np.int32))
            res = speculative.speculative_core_batch(plan, tb, segs, dev)
        if res is None:
            raise UnsupportedError("speculative resolution refused the batch; "
                                   "decode frame by frame")
        with trace("device_decode.spec_dense"):
            if prepared is None:
                qt = _upload(np.stack(qts), dev)
            outs.append(coeffs_to_pixels(
                res[0].reshape(len(batch), tb, 64), qt, geom))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def decode_frame_rstless(data: bytes, device) -> torch.Tensor:
    """One RST-less frame -> pixels [H, W, C] on ``device``: the engine
    on one frame, then the dense tail.  Raises ``UnsupportedError`` when
    the frame has restart markers or more than one scan, or the engine
    refuses it (a damaged stream): decode it on the host then."""
    return decode_stream_rstless([data], device)[0]
