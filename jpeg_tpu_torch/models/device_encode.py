"""Full on-device JPEG encode: pixel frames in, compressed bytes out.

The mirror of ``device_decode.DeviceDecoder``: frames that already live
in device memory compress on the card --

  dense stage      (models.encode_dense.pixels_to_zz: colour convert ->
                    box downsample -> FDCT -> quantize -> zig-zag ->
                    differential DC)
  -> [F * Bf, 64] natural-order zig-zag blocks in device memory
  entropy stage    (entropy.encode_cuda.encode_scan: per-segment Huffman
                    bits, prefix sums of the segments' words, pack)
  -> one tight u32 word stream + per-segment bit counts, its length
     still on the device

-- and only the words (~the compressed size) come back to the host, which
finishes with the byte-serial work: 1-padding, 0xFF byte stuffing and
marker assembly, in one native pass over the chunk
(``native.finalize_flat_native``) or, where the native library is not
available, in its plain version (vectorized numpy over the whole chunk):
the JAX package's ``_finalize_flat`` with one fix, that an empty (0-bit)
segment pads nothing, where the JAX package's last write of its clipped
offset could undo the pad bits of the byte before it.  On a card a
failed build of the library raises instead.  With ``optimize=True`` the
chunks' symbol histograms (entropy.encode_cuda.block_histogram) sum into
per-batch Annex K.2 tables first, and the entropy stage re-packs the
quantized blocks still in device memory.  With ``optimize="frame"`` each
frame gets the Annex K.2 tables of its own symbols and its own DHT, as
``cjpeg -optimize`` writes a file: a chunk's per-frame histograms (the
histogram kernel with each frame's table rows apart) come to the host in
one read, the tables are built in one native call
(``native.optimal_tables_native``; ``tables.optimize_table`` where the
library is not available), and the entropy stage codes each frame with
its own tables.

Output is byte-identical to the JAX package's ``DeviceEncoder`` wherever
the quantized blocks agree (they may differ by 1 on rare rounding
boundaries, as the JAX package's device and host encoders do).

Reference semantics covered here: libjpeg-compatible quality scaling
(encoder.c:38-65), K.1 base tables (encoder.c:14-34), edge-replication
padding (frame.c:277-350), box chroma downsample (frame.c:84-132),
differential DC with per-restart-interval reset (encoder.c:442-456,
decoder.c:371-373), RST0..7 cycling (encoder.c write_ecs path).

Left out on purpose, against the JAX module: the sticky capacities and
their retry loop, the learned slot phases, the device word compaction and
the 17-bit chunk cap all work around XLA's static shapes, which a
per-segment kernel writing at exact offsets does not have.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..constants import (
    DEFAULT_HTABLES,
    STD_CHROMINANCE_QUANT,
    STD_LUMINANCE_QUANT,
    scale_qtable,
)
from .. import native
from ..device import resolve
from ..encoder import EncodeParams, geometry_for_image
from ..entropy.encode import build_visit_order
from ..entropy.encode_cuda import T_MAX, block_histogram, encode_scan
from ..errors import UnsupportedError
from ..format import emit
from ..geometry import FrameGeometry, ScanInfo
from ..models.encode_dense import pixels_to_zz
from ..tables import HuffSpec, derive_table, optimize_table
from ..utils.metrics import default_metrics, trace


@dataclass
class _Shape:
    components: int
    precision: int
    height: int
    width: int


def _dht_keys(geom) -> tuple:
    """(class, id) of each DHT segment, in the order the header has them
    (the single-image encoder's, encoder.c:614-630)."""
    return ((0, 0), (1, 0), (0, 1), (1, 1)) if geom.nf > 1 else ((0, 0),
                                                                 (1, 0))


def _header_ends(geom, qtables, ri, info) -> Tuple[bytes, bytes]:
    """(SOI, DQT, SOF0; DRI, SOS): a header's bytes before and after its
    DHT segments."""
    head = emit.emit_soi() + emit.emit_dqt(qtables[0].astype(np.uint16), 0)
    if geom.nf > 1:
        head += emit.emit_dqt(qtables[1].astype(np.uint16), 1)
    head += emit.emit_sof0(geom)
    return head, emit.emit_dri(ri) + emit.emit_sos(info)


def _build_header(geom, qtables, specs, ri, info) -> bytes:
    """SOI..SOS marker bytes for the given qtables/Huffman specs."""
    return _build_header_from(_header_ends(geom, qtables, ri, info), specs,
                              geom)


def _build_header_from(ends, specs, geom) -> bytes:
    """A header from its bytes around the DHT segments (``_header_ends``)
    and the Huffman specs of its DHT segments."""
    return ends[0] + b"".join(emit.emit_dht(specs[k], *k)
                              for k in _dht_keys(geom)) + ends[1]


def _code_tables(specs: dict, keys) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked [T, 256] ehufco/ehufsi of ``specs`` in ``keys`` order."""
    tables = {k: derive_table(specs[k], build_lut=False) for k in keys}
    ehufco = np.stack([tables[k].ehufco for k in keys]).astype(np.int32)
    ehufsi = np.stack([tables[k].ehufsi for k in keys]).astype(np.int32)
    return ehufco, ehufsi


@dataclass
class DeviceEncoder:
    """Whole-chunk encoder for frames sharing one geometry.

    Build once with ``for_config``, then ``encode_batch`` a [F, H, W, C]
    pixel batch on ``device`` -> list of JPEG byte strings.  Streaming
    shape: shared Huffman tables (the MJPEG defaults, ``htables=``, or
    per-batch optimized ones) or each frame's own optimized tables,
    restart markers every ``restart_interval`` MCUs, so the output is
    itself parallel-decodable by DeviceDecoder.
    """

    # encode_batch's ``optimize``: shared tables, per-batch Annex K.2
    # tables, or each frame's own.
    OPTIMIZE_MODES = (False, True, "frame")

    geom: FrameGeometry
    info: ScanInfo
    ri: int
    n_segments: int
    qtables: np.ndarray  # [2, 64] int32 (luma, chroma)
    header: bytes
    visit_src: np.ndarray  # [Bf] bitstream position -> natural row
    prev_idx: np.ndarray  # [Bf] natural row -> previous same-comp row, -1
    dc_tab: np.ndarray  # [Bf] natural (component-major) order
    ac_tab: np.ndarray  # [Bf] natural order
    seg_of: np.ndarray  # [Bf] bitstream (visit) order
    ehufco: np.ndarray  # [T, 256] int32
    ehufsi: np.ndarray
    table_keys: tuple  # (class, id) per stacked code-table row
    device: torch.device
    _dev: dict = field(default_factory=dict, repr=False)

    @staticmethod
    def for_config(
        height: int,
        width: int,
        components: int = 3,
        params: Optional[EncodeParams] = None,
        htables: Optional[dict] = None,
        precision: int = 8,
        *,
        device,
    ) -> "DeviceEncoder":
        """Build the stream encoder for frames of this shape on ``device``.

        ``htables`` optionally supplies fixed Huffman table specs
        ({(class, id): HuffSpec}) shared by every frame.  Default: the
        implicit Annex K.3 (MJPEG) tables.
        """
        dev = resolve(device)
        params = params or EncodeParams(h=2, v=2, optimize=False, exact=False)
        if params.optimize:
            raise UnsupportedError(
                "DeviceEncoder streams with shared tables; pass per-stream "
                "specs via htables= or encode_batch(optimize=True) for "
                "per-batch optimized tables"
            )
        if not params.restart_interval:
            raise UnsupportedError(
                "DeviceEncoder needs a restart interval (the parallel axis)"
            )
        geom = geometry_for_image(
            _Shape(components, precision, height, width),  # type: ignore[arg-type]
            params,
        )
        comps = sorted(geom.components, key=lambda c: c.cid)
        info = ScanInfo(
            component_ids=tuple(c.cid for c in comps),
            td=tuple(c.td for c in comps),
            ta=tuple(c.ta for c in comps),
        )
        ri = params.restart_interval
        comp_idx, block_seq = build_visit_order(geom, info)
        offsets = np.zeros(len(comps), np.int64)
        off = 0
        for j, c in enumerate(comps):
            offsets[j] = off
            off += c.n_blocks
        visit_src = offsets[comp_idx] + block_seq

        bpm = comp_idx.size // geom.n_mcus if info.ns > 1 else (
            comps[0].h * comps[0].v
        )
        mcu_of = np.arange(comp_idx.size) // bpm
        seg_of = mcu_of // ri
        n_segments = int(seg_of.max()) + 1

        # Previous same-component block within the restart interval, as a
        # NATURAL-row -> NATURAL-row map (the DC prediction chain runs in
        # visit order; rows stay component-major on device).
        prev_visit = np.full(comp_idx.size, -1, np.int64)
        for j in range(len(comps)):
            sel = np.nonzero(comp_idx == j)[0]
            same_seg = seg_of[sel][1:] == seg_of[sel][:-1]
            prev_visit[sel[1:][same_seg]] = sel[:-1][same_seg]
        prev_idx = np.full(comp_idx.size, -1, np.int64)
        prev_idx[visit_src] = np.where(
            prev_visit >= 0, visit_src[np.clip(prev_visit, 0, None)], -1
        )

        keys: List[Tuple[int, int]] = []
        for td in info.td:
            if (0, td) not in keys:
                keys.append((0, td))
        for ta in info.ta:
            if (1, ta) not in keys:
                keys.append((1, ta))
        specs = {k: HuffSpec.from_pair(v) for k, v in DEFAULT_HTABLES.items()}
        if htables:
            specs.update(htables)
        ehufco, ehufsi = _code_tables(specs, keys)
        tmap = {k: i for i, k in enumerate(keys)}
        td_arr = np.asarray([tmap[(0, info.td[j])] for j in range(info.ns)])
        ta_arr = np.asarray([tmap[(1, info.ta[j])] for j in range(info.ns)])

        qtables = np.ones((2, 64), dtype=np.int32)
        qtables[0] = scale_qtable(STD_LUMINANCE_QUANT, params.quality)
        qtables[1] = scale_qtable(STD_CHROMINANCE_QUANT, params.quality)

        dc_nat = np.empty(comp_idx.size, np.int32)
        ac_nat = np.empty(comp_idx.size, np.int32)
        dc_nat[visit_src] = td_arr[comp_idx]
        ac_nat[visit_src] = ta_arr[comp_idx]
        return DeviceEncoder(
            geom=geom,
            info=info,
            ri=ri,
            n_segments=n_segments,
            qtables=qtables,
            header=_build_header(geom, qtables, specs, ri, info),
            visit_src=visit_src.astype(np.int32),
            prev_idx=prev_idx.astype(np.int32),
            dc_tab=dc_nat,
            ac_tab=ac_nat,
            seg_of=seg_of.astype(np.int32),
            ehufco=ehufco,
            ehufsi=ehufsi,
            table_keys=tuple(keys),
            device=dev,
        )

    @staticmethod
    def tables_for_stream(sample_pnm: bytes, params: EncodeParams,
                          device) -> dict:
        """Optimize Huffman tables on a representative frame (host
        two-pass, Annex K.2) for use as a stream's fixed ``htables`` --
        smaller output than the MJPEG defaults at zero per-frame cost.
        The sample's dense encode runs on ``device``."""
        from ..entropy.encode import histogram, symbolize_scan
        from ..models.pipeline import encode_frame
        from ..utils.pnm import read_pnm

        probe = read_pnm(sample_pnm)
        geom = geometry_for_image(probe, params)
        img = read_pnm(sample_pnm, pad_to=(8 * geom.max_v, 8 * geom.max_h))
        qtables = np.ones((4, 64), dtype=np.int32)
        qtables[0] = scale_qtable(STD_LUMINANCE_QUANT, params.quality)
        qtables[1] = scale_qtable(STD_CHROMINANCE_QUANT, params.quality)
        planes = encode_frame(torch.from_numpy(img.data).to(resolve(device)),
                              geom, qtables, exact=False)
        planes = {cid: p.cpu().numpy() for cid, p in planes.items()}
        comps = sorted(geom.components, key=lambda c: c.cid)
        info = ScanInfo(
            component_ids=tuple(c.cid for c in comps),
            td=tuple(c.td for c in comps),
            ta=tuple(c.ta for c in comps),
        )
        symbols = symbolize_scan(planes, geom, info, params.restart_interval)
        # Seed every symbol later frames could legally need (the sample
        # frame may not exercise them): DC categories up to 11 (8-bit) /
        # 15 (12-bit), AC EOB/ZRL and (run, size) up to size 10/14 --
        # the baseline symbol sets per T.81.  Negligible code-length
        # cost, total robustness for the fixed-table stream.
        dc_cats = 12 if probe.precision <= 8 else 16
        ac_size = 10 if probe.precision <= 8 else 14
        out = {}
        for k, counts in histogram(symbols).items():
            counts = counts.copy()
            if k[0] == 0:
                counts[:dc_cats] += 1
            else:
                counts[0x00] += 1
                counts[0xF0] += 1
                for r in range(16):
                    for s in range(1, ac_size + 1):
                        counts[(r << 4) | s] += 1
            out[k] = optimize_table(counts)
        return out

    @property
    def blocks_per_frame(self) -> int:
        return int(self.visit_src.size)

    def _on_device(self, name: str, arr: np.ndarray) -> torch.Tensor:
        t = self._dev.get(name)
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
            self._dev[name] = t
        return t

    @property
    def frames_per_scan(self) -> int:
        """Frames one scan codes with per-frame tables: the kernels take
        ``T_MAX`` stacked tables."""
        return T_MAX // len(self.table_keys)

    def chunk_tables(self, frames: int, per_frame: bool = False):
        """(order, seg_of, dc_tab, ac_tab) for a ``frames``-frame chunk,
        on the device: bitstream positions and segments run frame-major.
        With ``per_frame`` frame f's table ids are offset by f times the
        encoder's tables, so each frame has rows of its own."""
        key = ("tiled", frames, per_frame)
        got = self._dev.get(key)
        if got is None:
            bf = self.blocks_per_frame
            fr = np.repeat(np.arange(frames, dtype=np.int64), bf)
            tab = fr * len(self.table_keys) if per_frame else 0
            got = tuple(
                torch.from_numpy(a.astype(np.int32)).to(self.device)
                for a in (np.tile(self.visit_src, frames) + fr * bf,
                          np.tile(self.seg_of, frames)
                          + fr * self.n_segments,
                          np.tile(self.dc_tab, frames) + tab,
                          np.tile(self.ac_tab, frames) + tab))
            self._dev[key] = got
        return got

    def _pixels(self, pixels) -> torch.Tensor:
        if isinstance(pixels, np.ndarray):
            pixels = torch.from_numpy(pixels)
        if pixels.dim() != 4:
            raise UnsupportedError("encode_batch wants [F, H, W, C]")
        want = (self.geom.height, self.geom.width, self.geom.nf)
        if tuple(pixels.shape[1:]) != want:
            raise UnsupportedError(
                f"frames are {tuple(pixels.shape[1:])}, the encoder was "
                f"built for {want}"
            )
        out_dt = torch.uint8 if self.geom.precision <= 8 else torch.uint16
        if pixels.dtype != out_dt:
            raise UnsupportedError(
                f"{self.geom.precision}-bit frames must be {out_dt}, got "
                f"{pixels.dtype}"
            )
        return pixels.to(self.device).contiguous()

    def dense(self, pixels: torch.Tensor) -> torch.Tensor:
        """[f, H, W, C] device pixels -> [f * Bf, 64] int32 zig-zag blocks
        (natural order, differential DC): the dense stage alone."""
        return pixels_to_zz(pixels, self._on_device("qtables", self.qtables),
                            self._on_device("prev_idx", self.prev_idx),
                            self.geom)

    def histogram(self, zz: torch.Tensor,
                  out: Optional[torch.Tensor] = None,
                  per_frame: bool = False) -> torch.Tensor:
        """Symbol counts [T, 256] int32 of a chunk's blocks (the dry pass),
        added into ``out`` where one is given.  With ``per_frame`` each
        frame's apart: [frames * T, 256], frame f's tables at rows f * T
        on, T the encoder's tables (``table_keys``)."""
        frames = zz.shape[0] // self.blocks_per_frame
        _, _, dc_tab, ac_tab = self.chunk_tables(frames, per_frame)
        tables = len(self.table_keys) * (frames if per_frame else 1)
        return block_histogram(zz, dc_tab, ac_tab, tables, out=out)

    def scan(self, zz: torch.Tensor, ehufco=None, ehufsi=None,
             per_frame: bool = False):
        """Entropy-code a chunk's blocks with the given (default: the
        encoder's) code tables, with ``per_frame`` each frame's own rows
        of them (``histogram``'s layout) -> (words, seg_wbase, seg_bits,
        missing, n_words) on the device, the stream being
        ``words[:n_words]`` (``encode_cuda.encode_scan``; on the card
        ``words`` is a capacity buffer as large as ``zz``, to trim or drop
        before keeping)."""
        frames = zz.shape[0] // self.blocks_per_frame
        order, seg_of, dc_tab, ac_tab = self.chunk_tables(frames, per_frame)
        if ehufco is None:
            ehufco = self._on_device("ehufco", self.ehufco)
            ehufsi = self._on_device("ehufsi", self.ehufsi)
        return encode_scan(zz, order, seg_of, dc_tab, ac_tab, ehufco, ehufsi,
                           frames * self.n_segments)

    def pack(self, zz: torch.Tensor, ehufco=None, ehufsi=None,
             header: Union[None, bytes, Sequence[bytes]] = None,
             per_frame: bool = False) -> List[bytes]:
        """A chunk's blocks -> one JPEG byte string per frame; ``header``
        one for the chunk or, with per-frame tables, one a frame."""
        frames = zz.shape[0] // self.blocks_per_frame
        with trace("device_encode.scan"):
            words, _, seg_bits, missing, n_words = self.scan(
                zz, ehufco, ehufsi, per_frame)
        with trace("device_encode.pull"):
            # One sync for both flags; the capacity buffer is dropped here.
            missing, n_words = torch.stack(
                (missing.to(torch.int64), n_words)).tolist()
            if missing:
                raise UnsupportedError(
                    "a symbol has no code in the selected Huffman tables "
                    "(content exceeds table range; use optimize=True)"
                )
            words_h = words[:n_words].cpu().numpy().view(np.uint32)
            seg_bits_h = seg_bits.cpu().numpy()
        with trace("device_encode.finalize"):
            return self._finalize_flat(words_h, seg_bits_h, frames,
                                       header or self.header)

    def _optimal_tables(self, hist: np.ndarray):
        """Annex K.2 tables of each row of ``hist`` [n, 256] -> (bits
        [n, 16], values [n, 256], ehufco, ehufsi [n, 256]) on the host
        (``native.optimal_tables_native``'s form): one native call while
        the library is available, else ``tables.optimize_table`` a row;
        the tables are equal.  ``device_encode.native_table_builds`` and
        ``python_table_builds`` count the tables each built.  An encoder
        on a card raises where the library failed to build."""
        n = int(hist.shape[0])
        if native.available():
            default_metrics.count("device_encode.native_table_builds", n)
            return native.optimal_tables_native(hist)
        if self.device.type != "cpu" and native.load_error():
            raise RuntimeError("the native table builder is unavailable on "
                               f"{self.device}: {native.load_error()}")
        default_metrics.count("device_encode.python_table_builds", n)
        bits = np.zeros((n, 16), np.uint8)
        values = np.zeros((n, 256), np.uint8)
        ehufco = np.zeros((n, 256), np.int32)
        ehufsi = np.zeros((n, 256), np.int32)
        for t in range(n):
            spec = optimize_table(hist[t])
            bits[t] = spec.counts
            values[t, :len(spec.values)] = spec.values
            table = derive_table(spec, build_lut=False)
            ehufco[t], ehufsi[t] = table.ehufco, table.ehufsi
        return bits, values, ehufco, ehufsi

    def frame_tables(self, hist: np.ndarray):
        """The Annex K.2 tables of a chunk's frames from their histograms
        [frames * T, 256] (``histogram(..., per_frame=True)``) ->
        (ehufco, ehufsi [frames * T, 256] on the device, one header a
        frame: its DQT, SOF0, its own DHT, DRI, SOS)."""
        bits, values, ehufco, ehufsi = self._optimal_tables(hist)
        codes = torch.from_numpy(np.stack((ehufco, ehufsi))).to(self.device)
        ends = self._dev.get("header_ends")  # host bytes, built once
        if ends is None:
            ends = self._dev["header_ends"] = _header_ends(
                self.geom, self.qtables, self.ri, self.info)
        tmap = {k: i for i, k in enumerate(self.table_keys)}
        T = len(self.table_keys)
        count = bits.sum(1, dtype=np.int64)
        headers = []
        for f in range(hist.shape[0] // T):
            specs = {k: HuffSpec(tuple(bits[f * T + t].tolist()), tuple(
                values[f * T + t, :count[f * T + t]].tolist()))
                for k, t in tmap.items()}
            headers.append(_build_header_from(ends, specs, self.geom))
        return codes[0], codes[1], headers

    def optimized_tables(self, hist: np.ndarray):
        """Per-batch Annex K.2 tables from a [T, 256] histogram ->
        (ehufco, ehufsi on the device, header bytes)."""
        ehufco, ehufsi, (header,) = self.frame_tables(hist)
        return ehufco, ehufsi, header

    def encode_batch(self, pixels, optimize: Union[bool, str] = False,
                     chunk: int = 8) -> List[bytes]:
        """[F, H, W, C] uint8/uint16 frames -> JPEG bytes, one per frame.

        ``optimize=True`` runs the two-pass Annex K.2 optimization on the
        card: pass 1 sums every chunk's symbol histogram (the
        write_ecs_dry analog, encoder.c:525-558) while the quantized
        blocks stay in device memory, the host derives per-BATCH optimal
        tables, and pass 2 re-packs the same blocks with them.

        ``optimize="frame"`` gives each frame the optimal tables of its
        own symbols, chunk by chunk (at most ``frames_per_scan`` frames a
        chunk): the dense stage, the per-frame histograms and their one
        read (span ``device_encode.frame_hist``), the tables and headers
        (``frame_tables``, span ``device_encode.frame_tables``), the
        entropy stage with each frame's tables, the pull and the host
        tail.  Each frame is the single-image encoder's
        (``encoder.encode_jpeg_from_planes`` with ``optimize=True``) on
        the same quantized blocks, byte for byte.
        """
        if optimize not in self.OPTIMIZE_MODES:
            raise ValueError(f"optimize={optimize!r}: one of "
                             f"{self.OPTIMIZE_MODES}")
        px = self._pixels(pixels)
        frames = int(px.shape[0])
        if frames == 0:
            return []
        step = chunk if chunk > 0 else frames
        if optimize == "frame":
            step = min(step, self.frames_per_scan)
        spans = [(i, min(i + step, frames)) for i in range(0, frames, step)]
        with trace("device_encode.batch"):
            if optimize == "frame":
                out: List[bytes] = []
                for lo, hi in spans:
                    with trace("device_encode.dense"):
                        zz = self.dense(px[lo:hi])
                    with trace("device_encode.frame_hist"):
                        hist = self.histogram(zz, per_frame=True).cpu()
                    with trace("device_encode.frame_tables"):
                        ehufco, ehufsi, headers = self.frame_tables(
                            hist.numpy())
                    out.extend(self.pack(zz, ehufco, ehufsi, headers,
                                         per_frame=True))
                return out
            if not optimize:
                out = []
                for lo, hi in spans:
                    with trace("device_encode.dense"):
                        zz = self.dense(px[lo:hi])
                    out.extend(self.pack(zz))
                return out
            # One accumulator a batch: each chunk's counts are added in.
            blocks = []
            hist = torch.zeros(len(self.table_keys), 256, dtype=torch.int32,
                               device=self.device)
            for lo, hi in spans:
                with trace("device_encode.dense"):
                    zz = self.dense(px[lo:hi])
                with trace("device_encode.histogram"):
                    self.histogram(zz, out=hist)
                blocks.append(zz)
            with trace("device_encode.tables"):
                ehufco, ehufsi, header = self.optimized_tables(
                    hist.cpu().numpy())
            out = []
            for zz in blocks:
                out.extend(self.pack(zz, ehufco, ehufsi, header))
            return out

    def _finalize_flat(self, flat_words: np.ndarray, seg_bits: np.ndarray,
                       frames: int,
                       header: Union[bytes, Sequence[bytes]] = b""
                       ) -> List[bytes]:
        """The device-compacted word stream of ``frames`` frames -> one
        JPEG byte string a frame, behind ``header`` (the encoder's where
        empty) or each frame's own, ``header[f]``: one native pass while
        the native library is available (as ``DeviceDecoder.prepare``'s
        native prep), else the plain ``_finalize_flat_ref``; the bytes are
        equal.
        ``device_encode.native_finalize_chunks`` and
        ``python_finalize_chunks`` count which ran.  An encoder on a card
        raises where the library failed to build: there the plain version
        would take most of the frame's time."""
        if native.available():
            default_metrics.count("device_encode.native_finalize_chunks")
            return native.finalize_flat_native(
                flat_words, seg_bits, frames, self.n_segments,
                header or self.header)
        if self.device.type != "cpu" and native.load_error():
            raise RuntimeError("the native encode host tail is unavailable "
                               f"on {self.device}: {native.load_error()}")
        default_metrics.count("device_encode.python_finalize_chunks")
        return self._finalize_flat_ref(flat_words, seg_bits, frames, header)

    def _finalize_flat_ref(self, flat_words: np.ndarray,
                           seg_bits: np.ndarray, frames: int,
                           header: Union[bytes, Sequence[bytes]] = b""
                           ) -> List[bytes]:
        """The plain version of ``native.finalize_flat_native``: vectorized
        NumPy passes over the chunk, per-segment live bytes straight from
        word offsets."""
        nbytes = (seg_bits + 7) // 8
        nw = (seg_bits + 31) // 32
        base = np.cumsum(nw) - nw
        arr = np.ascontiguousarray(flat_words[: int(nw.sum())]).byteswap(
        ).view(np.uint8)
        if arr.size == 0:
            return self._assemble(arr, nbytes, frames, header)
        # Only segments with bytes have a last byte to pad: an empty
        # segment's offset is the next segment's first byte.
        live_seg = nbytes > 0
        pad = (nbytes * 8 - seg_bits)[live_seg]
        arr[4 * base[live_seg] + nbytes[live_seg] - 1] |= (
            (1 << pad) - 1).astype(np.uint8)
        off = np.arange(arr.size) - np.repeat(4 * base, 4 * nw)
        live = off < np.repeat(nbytes, 4 * nw)
        return self._assemble(arr[live], nbytes, frames, header)

    def _assemble(self, flat: np.ndarray, nbytes: np.ndarray, frames: int,
                  header: Union[bytes, Sequence[bytes]] = b""):
        """Shared tail: byte-stuff the concatenated live segment bytes,
        then drop RSTn/EOI markers into the per-frame gaps."""
        with trace("device_encode.stuff"):
            ends = np.cumsum(nbytes)
            is_ff = flat == 0xFF
            out = np.zeros(flat.size + int(is_ff.sum()), dtype=np.uint8)
            dst = np.arange(flat.size) + np.cumsum(is_ff) - is_ff
            out[dst] = flat
            ffcum = np.concatenate(([0], np.cumsum(is_ff)))
            s_end = ends + ffcum[ends]  # stuffed end offset per segment
            s_start = np.concatenate(([0], s_end[:-1]))

        # Assemble each frame in one vectorized pass: every stuffed byte
        # shifts right by 2 per preceding in-frame segment boundary (the
        # RSTn marker), then the markers drop into the gaps.
        res: List[bytes] = []
        ns = self.n_segments
        one = isinstance(header, (bytes, bytearray))
        hdrs = [np.frombuffer(h, np.uint8) for h in
                ([header or self.header] if one else header)]
        with trace("device_encode.assemble"):
            for f in range(frames):
                hdr = hdrs[0 if one else f]
                seg_lens = (s_end[f * ns:(f + 1) * ns]
                            - s_start[f * ns:(f + 1) * ns])
                body = out[s_start[f * ns]:s_end[(f + 1) * ns - 1]]
                buf = np.empty(hdr.size + body.size + 2 * (ns - 1) + 2,
                               np.uint8)
                buf[: hdr.size] = hdr
                shift = np.repeat(np.arange(ns, dtype=np.int64), seg_lens)
                buf[hdr.size + np.arange(body.size) + 2 * shift] = body
                gap = (hdr.size + np.cumsum(seg_lens[:-1])
                       + 2 * np.arange(ns - 1))
                buf[gap] = 0xFF
                buf[gap + 1] = 0xD0 + (np.arange(ns - 1) & 7)
                buf[-2:] = (0xFF, 0xD9)
                res.append(buf.tobytes())
        return res
