"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout (the package
``jpeg_tpu_torch`` and the committed corpus ``tests/data/torch_port``).
It never imports JAX.  Phases, in order; any failure raises and the
process exits non-zero without printing the result line:

1. environment: a CUDA card, its name and power limit, TF32 off;
2. build: compile ``jpeg_tpu_torch/csrc/*.cu`` with nvcc and load it;
3. kernel vs plain: ``decode_segments`` on the card against
   ``decode_segments_ref`` on the same card inputs, integer for integer,
   on every corpus stream and on an 8-frame 1080p chunk (16,320 lanes),
   each intact, with seeded damage to its segment words, and with the
   damaged words under hostile Huffman tables, so that every way a lane
   can die runs through the kernel;
4. against JAX: every corpus frame's coefficients against the sha256
   digests jpeg_tpu produced (``digests.json``);
5. the slice: ``mjpeg.decode_stream_device`` on a 16-frame 1080p stream,
   with the kernel's launch count, checked against the CPU decode;
6. times: end-to-end stream rate, device-resident rate, host prep, per
   8-frame chunk the kernel against its plain version and the dense
   tail, and the card's busy share of one stream decode under
   ``torch.profiler``;
7. encode kernels vs plain, on the card: ``pixels_to_zz`` against
   ``pixels_to_zz_ref`` within +-1 and with at most ``DENSE_DIFF_SHARE``
   of the coefficients differing, on an 8-frame 1080p chunk of
   ``bench.make_frame_ppm`` content and on seeded noise in small
   grayscale, 12-bit 4:2:2, 4:4:4 and padded 4:2:0 frames, and equal on
   a grayscale frame of exact rounding ties (``synth.tie_frame``: half
   away from zero, as ``roundf``); ``encode_scan`` and ``block_histogram`` against
   ``encode_scan_ref`` and ``hist_from_blocks_ref``, integer for
   integer, on that chunk's blocks and on a hand-made 12-bit chunk that
   holds every symbol kind, once with tables that code every symbol and
   once with one symbol left without a code (``missing``);
8. encode against JAX: the coefficients of every corpus stream the port
   decodes, re-encoded by ``encode_scan`` and the host tail, must be
   byte-identical to the committed frames jpeg_tpu encoded;
9. the encode slice: ``DeviceEncoder.encode_batch`` on 16 frames of
   1080p pixels on the card, chunk 8, with ``optimize`` False and then
   True, with each kernel's launch count; every output decodes on the
   card with ``DeviceDecoder`` to exactly the encoder's blocks, and
   frames 0 and 1 to within +-1 of the committed bench frames, with at
   most ``DENSE_DIFF_SHARE["committed"]`` of the coefficients differing;
10. encode times: ``device_encode_Mpix_s`` (pixels on the card to
    ``List[bytes]``, host clock), ``device_encode_compute_Mpix_s``
    (dense stage and segment encode with the words left on the card,
    CUDA events), ``device_encode_optimized_Mpix_s``, per 8-frame chunk
    each kernel against its plain version, and the card's busy share of
    one encode under ``torch.profiler`` with its host spans.

The line before the last is a JSON object describing the kernels; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import jpeg_tpu_torch
from jpeg_tpu_torch import kernels
from jpeg_tpu_torch.constants import (
    STD_LUMINANCE_QUANT,
    ZIGZAG,
    scale_qtable,
)
from jpeg_tpu_torch.device import set_precision
from jpeg_tpu_torch.encoder import EncodeParams
from jpeg_tpu_torch.entropy.encode_cuda import block_histogram, encode_scan
from jpeg_tpu_torch.entropy.encode_torch import (
    encode_scan_ref,
    hist_from_blocks_ref,
)
from jpeg_tpu_torch.entropy.lockstep import ScanPlan, build_scan_plan
from jpeg_tpu_torch.entropy.place_cuda import (
    decode_segments,
    decode_segments_ref,
)
from jpeg_tpu_torch.errors import UnsupportedError
from jpeg_tpu_torch.format.parse import parse_codestream
from jpeg_tpu_torch.tables import HuffSpec, derive_table
from jpeg_tpu_torch.models.device_decode import (
    DeviceDecoder,
    _dense_from_coeffs,
)
from jpeg_tpu_torch.models.device_encode import DeviceEncoder
from jpeg_tpu_torch.ops.dct import _kron_mats
from jpeg_tpu_torch.models.encode_dense import (
    pixels_to_zz,
    pixels_to_zz_ref,
    raster_to_zz,
)
from jpeg_tpu_torch.utils import synth

CORPUS = Path(__file__).resolve().parent / "tests" / "data" / "torch_port"
STREAMS = ("bench", "yuv420_ri2", "yuv444_ri3", "gray_ri4", "p12_422_ri2")
CHUNK = 8  # frames per chunk, as bench.py decodes the stream
STREAM_FRAMES = 16
E2E_RUNS = 5
# bench.py's encode shape (bench.py:55-58, 484-529): 1080p 4:2:0 q75,
# restart interval 4, default tables, fast dense path.
BENCH_PARAMS = EncodeParams(h=2, v=2, quality=75, optimize=False,
                            restart_interval=4, exact=False)
# Corpus quality (tools/make_torch_fixtures.py): bench q75, the rest q80.
CORPUS_QUALITY = {"bench": 75}
# Small dense-stage shapes: (components, h, v, height, width, bits).
DENSE_SHAPES = ((1, 1, 1, 37, 45, 8), (3, 2, 1, 32, 48, 12),
                (3, 1, 1, 24, 40, 8), (3, 2, 2, 38, 54, 8))
# The dense kernel differs from its plain version only in the FDCT's
# summation order, so a quantized value moves by 1 only where c / q sits
# on a rounding boundary: rare on smooth content, less rare on noise.  A
# kernel that truncates, rounds ties to even or computes in lower
# precision moves far more coefficients than these shares allow.
DENSE_DIFF_SHARE = {"chunk": 1e-5, "noise": 1e-3, "committed": 1e-4}

# Hostile Huffman tables, by class (0 DC, 1 AC): incomplete codes, so some
# bit patterns match nothing, and DC categories 17 and 20, which kill the
# lane that decodes one.  "00" is DC category 0 and "00" is EOB, so
# all-zero words walk empty blocks until the lane passes its frame's MCUs.
HOSTILE = {
    0: HuffSpec(counts=(0, 3, 1, 1, 1) + (0,) * 11,
                values=(0, 1, 2, 5, 17, 20)),
    1: HuffSpec(counts=(0, 2, 2, 1) + (0,) * 12,
                values=(0x00, 0x01, 0xF0, 0x11, 0x02)),
}


def log(*a) -> None:
    print(*a, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def frames_of(name: str):
    return jpeg_tpu_torch.mjpeg.split_stream(
        (CORPUS / f"{name}.mjpeg").read_bytes()
    )


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back runs."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_window(run, span_prefix: str, card: str, what: str) -> None:
    """Card busy share of one ``run()`` under torch.profiler: the union of
    the device events' intervals over the host-clock window, with the
    package's host spans (``span_prefix``*) and the top device kernels."""
    os.environ["JPEG_TPU_PROFILE"] = "1"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    os.environ.pop("JPEG_TPU_PROFILE")
    events = prof.events()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(span_prefix)]
    busy = busy_us((e.time_range.start, e.time_range.end) for e in on_card)
    log(f"profile: window {wall_us / 1e3} ms, device busy {busy / 1e3} ms "
        f"({100 * busy / wall_us}% busy), {len(on_card)} device events, "
        f"{what} [{card}]")
    spans = {}
    for e in events:
        if e.name.startswith(span_prefix) and \
                e.device_type == DeviceType.CPU:
            spans[e.name] = spans.get(e.name, 0.0) + e.cpu_time_total
    for name, us in sorted(spans.items()):
        log(f"profile: host span {name} {us / 1e3} ms [{card}]")
    by_kernel = {}
    for e in on_card:
        n, us = by_kernel.get(e.name, (0, 0.0))
        by_kernel[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, us) in top:
        log(f"profile: device {us / 1e3} ms x{n} {name[:100]}")


def median_s(run, runs: int) -> tuple:
    """(median seconds, sorted run seconds) of ``run()`` closed by a
    synchronize, host clock, after one warm-up run."""
    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times = sorted(times[1:])
    return times[len(times) // 2], times


def hostile_plan(frame: bytes) -> ScanPlan:
    """The frame's scan plan with every Huffman table replaced by HOSTILE."""
    cs = parse_codestream(frame)
    scan = cs.scans[0]
    tables = {key: derive_table(HOSTILE[key[0]]) for key in scan.htables}
    return build_scan_plan(cs.geometry, scan.info, tables)


def damage(words: torch.Tensor, nbits: torch.Tensor, seed: int):
    """Seeded damage to a chunk's segment words, returned on their device.

    Of every 8 lanes, on average: one becomes pure noise, one is cut
    short, one becomes all-zero words over its whole row, three get 3
    flipped bits each and two stay intact.
    """
    rng = np.random.default_rng(seed)
    w = words.cpu().numpy().view(np.uint32).copy()
    nb = nbits.cpu().numpy().copy()
    S, wn = w.shape
    kind = rng.integers(0, 8, S)
    noise = kind == 0
    w[noise] = rng.integers(0, 1 << 32, (int(noise.sum()), wn),
                            dtype=np.uint32)
    cut = kind == 1
    nb[cut] = (nb[cut] * rng.random(int(cut.sum()))).astype(np.int32)
    zero = kind == 2
    w[zero] = 0
    nb[zero] = 32 * wn
    flip = np.flatnonzero((kind >= 3) & (kind < 6) & (nb > 0))
    for _ in range(3):
        pos = (rng.random(flip.size) * nb[flip]).astype(np.int64)
        w[flip, pos >> 5] ^= np.uint32(1) << (31 - (pos & 31)).astype(np.uint32)
    return (torch.from_numpy(w.view(np.int32)).to(words.device),
            torch.from_numpy(nb).to(words.device))


def compare_kernel(label: str, plan: ScanPlan, words: torch.Tensor,
                   nbits: torch.Tensor, dec: DeviceDecoder, frames: int):
    """Kernel vs plain version on the same card inputs.

    -> (max |coeff diff|, mcu_counts).
    """
    args = (plan, words, nbits, frames, dec.segs_per_frame, dec.ri,
            dec.total_blocks)
    got_c, got_n = decode_segments(*args)
    ref_c, ref_n = decode_segments_ref(*args)
    torch.cuda.synchronize()
    err = int((got_c.to(torch.int64) - ref_c).abs().max().item())
    if not (torch.equal(got_c, ref_c) and torch.equal(got_n, ref_n)):
        raise AssertionError(
            f"{label}: decode_segments differs from decode_segments_ref "
            f"(max |coeff diff| {err}, mcu_counts equal: "
            f"{torch.equal(got_n, ref_n)})"
        )
    dead = int((got_n < dec.ri).sum())
    log(f"kernel-vs-plain {label}: {words.shape[0]} lanes ({dead} died "
        f"short of ri), coeffs {tuple(got_c.shape)} and mcu_counts equal "
        f"(sum {int(got_n.sum())})")
    return err, got_n


def check_dense(label: str, diff: torch.Tensor, share: float) -> int:
    """Hold a difference of quantized blocks to max |diff| <= 1 with at
    most ``share`` of its entries nonzero; -> max |diff|."""
    diff = diff.to(torch.int64).abs()
    err = int(diff.max()) if diff.numel() else 0
    n = int((diff != 0).sum())
    if err > 1 or n > share * diff.numel():
        raise AssertionError(f"pixels_to_zz, {label}: max |diff| {err} "
                             f"(allowed 1), {n} of {diff.numel()} differ "
                             f"(allowed {share})")
    log(f"kernel-vs-plain pixels_to_zz {label}: max |diff| {err}, {n} of "
        f"{diff.numel()} coefficients differ (allowed {share})")
    return err


def check_ties(dev: torch.device) -> None:
    """``pixels_to_zz`` on a grayscale frame of exact rounding ties
    (``synth.tie_frame``) must equal its plain version and round half away
    from zero: a kernel that rounds half to even fails here."""
    tie_q = scale_qtable(STD_LUMINANCE_QUANT, 50)
    frame, want = synth.tie_frame(_kron_mats()[1], tie_q)
    e = DeviceEncoder.for_config(
        8, frame.shape[1], 1, EncodeParams(h=1, v=1, quality=50,
                                           optimize=False, restart_interval=1,
                                           exact=False), device=dev)
    if not (np.array_equal(e.qtables[0], tie_q) and (e.prev_idx == -1).all()):
        raise AssertionError("tie frame: unexpected tables or DC prediction")
    args = (torch.from_numpy(frame[None]).to(dev),
            torch.from_numpy(e.qtables).to(dev),
            torch.from_numpy(e.prev_idx).to(dev), e.geom)
    got = pixels_to_zz(*args)
    want = torch.from_numpy(want[:, ZIGZAG]).to(dev)
    if not (torch.equal(got, pixels_to_zz_ref(*args))
            and torch.equal(got, want)):
        raise AssertionError("pixels_to_zz does not round the tie frame's "
                             "exact ties half away from zero")
    log(f"kernel-vs-plain pixels_to_zz tie frame {tuple(frame.shape)}: "
        f"{want.shape[0]} blocks with exact ties, equal to its plain "
        f"version and rounded half away from zero")


def compare_scan(label: str, enc: DeviceEncoder, zz: torch.Tensor,
                 ehufco: torch.Tensor, ehufsi: torch.Tensor,
                 want_missing: bool) -> tuple:
    """``encode_scan`` and ``block_histogram`` against their plain versions
    on the same card inputs, integer for integer.

    -> (max |diff| of encode_scan's outputs, of the histogram): (0, 0).
    """
    frames = zz.shape[0] // enc.blocks_per_frame
    order, seg_of, dc_tab, ac_tab = enc.chunk_tables(frames)
    args = (zz, order, seg_of, dc_tab, ac_tab, ehufco, ehufsi,
            frames * enc.n_segments)
    got = encode_scan(*args)
    ref = encode_scan_ref(*args)
    T = ehufco.shape[0]
    got_h = block_histogram(zz, dc_tab, ac_tab, T)
    ref_h = hist_from_blocks_ref(zz, dc_tab, ac_tab, T)
    torch.cuda.synchronize()
    names = ("words", "seg_wbase", "seg_bits", "missing")
    err = 0
    for name, a, b in zip(names, got, ref):
        if a.shape != b.shape:
            raise AssertionError(f"{label}: encode_scan {name} shape "
                                 f"{tuple(a.shape)} vs plain {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                               .abs().max()))
    hist_err = int((got_h.to(torch.int64) - ref_h).abs().max())
    if err or hist_err or bool(got[3]) != want_missing:
        raise AssertionError(f"{label}: kernels differ from their plain "
                             f"versions (max |diff| {err} and {hist_err}, "
                             f"missing {bool(got[3])}, want {want_missing})")
    log(f"kernel-vs-plain {label}: encode_scan {zz.shape[0]} blocks -> "
        f"{got[0].numel()} words, {int(got[2].sum())} bits, missing "
        f"{bool(got[3])}; block_histogram {int(got_h.sum())} symbols; equal")
    return err, hist_err


def encode_phases(card: str, streams: dict, decs: dict,
                  dev: torch.device) -> list:
    """Phases 7-10 (the encoder); -> the encode kernels' JSON entries."""
    enc = DeviceEncoder.for_config(1080, 1920, 3, BENCH_PARAMS, device=dev)
    uniq = [torch.from_numpy(synth.make_frame(s)) for s in range(2)]
    px = torch.stack([uniq[i % 2] for i in range(STREAM_FRAMES)]).to(dev)
    qt = torch.from_numpy(enc.qtables).to(dev)
    prev = torch.from_numpy(enc.prev_idx).to(dev)
    geom = enc.geom
    T = len(enc.table_keys)

    # ---- 7. encode kernels vs plain versions -----------------------------
    chunk = px[:CHUNK]
    zz = pixels_to_zz(chunk, qt, prev, geom)
    zz_ref = pixels_to_zz_ref(chunk, qt, prev, geom)
    torch.cuda.synchronize()
    if zz.shape != zz_ref.shape:
        raise AssertionError(f"pixels_to_zz gives {tuple(zz.shape)}, its "
                             f"plain version {tuple(zz_ref.shape)}")
    dense_err = check_dense(f"{tuple(chunk.shape)} bench chunk",
                            zz - zz_ref, DENSE_DIFF_SHARE["chunk"])
    # The kernel's other branches: grayscale, 12-bit (uint16) samples,
    # 4:2:2 and 4:4:4, and MCU padding on both edges, on seeded noise.
    rng = np.random.default_rng(5)
    for comps, h, v, height, width, bits in DENSE_SHAPES:
        e = DeviceEncoder.for_config(
            height, width, comps, EncodeParams(h=h, v=v, quality=80,
                                               optimize=False,
                                               restart_interval=2,
                                               exact=False),
            precision=bits, device=dev)
        dt = np.uint8 if bits <= 8 else np.uint16
        noise = torch.from_numpy(rng.integers(
            0, 1 << bits, (3, height, width, comps)).astype(dt)).to(dev)
        args = (noise, torch.from_numpy(e.qtables).to(dev),
                torch.from_numpy(e.prev_idx).to(dev), e.geom)
        err = check_dense(f"{comps} comps {height}x{width} {bits}-bit "
                          f"h={h} v={v} noise",
                          pixels_to_zz(*args) - pixels_to_zz_ref(*args),
                          DENSE_DIFF_SHARE["noise"])
        dense_err = max(dense_err, err)
    check_ties(dev)
    errs = [compare_scan(f"bench chunk x{CHUNK}", enc, zz,
                         torch.from_numpy(enc.ehufco).to(dev),
                         torch.from_numpy(enc.ehufsi).to(dev), False)]
    small = DeviceEncoder.for_config(
        48, 64, 3, EncodeParams(h=2, v=2, quality=80, optimize=False,
                                restart_interval=2, exact=False),
        precision=12, device=dev)
    blocks = torch.from_numpy(
        synth.symbol_blocks(2 * small.blocks_per_frame)).to(dev)
    _, _, dc_tab, ac_tab = small.chunk_tables(2)
    hist = hist_from_blocks_ref(blocks, dc_tab, ac_tab,
                                len(small.table_keys)).cpu().numpy()
    co, si, _ = small.optimized_tables(hist)
    errs.append(compare_scan("hand-made 12-bit symbols", small, blocks, co,
                             si, False))
    hist[0, 15] = 0  # luma DC category 15 (one block) gets no code
    co, si, _ = small.optimized_tables(hist)
    errs.append(compare_scan(
        "hand-made 12-bit symbols, DC category 15 uncoded", small, blocks,
        co, si, True))
    scan_err = max(e[0] for e in errs)
    hist_err = max(e[1] for e in errs)

    # ---- 8. encode against JAX (the committed frames) -------------------
    for name, fr in streams.items():
        cs = parse_codestream(fr[0])
        g, scan = cs.geometry, cs.scans[0]
        comps = sorted(g.components, key=lambda c: c.cid)
        if list(g.components) != comps:
            raise AssertionError(f"{name}: components not in id order")
        params = EncodeParams(h=comps[0].h, v=comps[0].v,
                              quality=CORPUS_QUALITY.get(name, 80),
                              optimize=False, restart_interval=scan.ri,
                              exact=False)
        e = DeviceEncoder.for_config(
            g.height, g.width, g.nf, params,
            htables=scan.htables if name == "p12_422_ri2" else None,
            precision=g.precision, device=dev)
        coeffs = decs[name].decode_coeffs_batch(fr)
        out = e.pack(raster_to_zz(coeffs, torch.from_numpy(e.prev_idx)
                                  .to(dev)))
        same = sum(a == b for a, b in zip(out, fr))
        if len(out) != len(fr) or same != len(fr):
            raise AssertionError(f"{name}: {same} of {len(fr)} re-encoded "
                                 "frames byte-identical to jpeg_tpu's")
        log(f"re-encode {name}: {len(fr)} frames byte-identical to "
            f"jpeg_tpu's ({sum(map(len, fr))} bytes)")

    # ---- 9. the encode slice ---------------------------------------------
    counts = {}
    outs = {}
    for opt in (False, True):
        pixels_to_zz.launches = encode_scan.launches = 0
        block_histogram.launches = 0
        outs[opt] = enc.encode_batch(px, optimize=opt, chunk=CHUNK)
        torch.cuda.synchronize()
        counts[opt] = (pixels_to_zz.launches, encode_scan.launches,
                       block_histogram.launches)
        log(f"slice: encode_batch {tuple(px.shape)} optimize={opt} -> "
            f"{len(outs[opt])} frames, {sum(map(len, outs[opt]))} bytes; "
            f"launches pixels_to_zz {counts[opt][0]}, encode_scan "
            f"{counts[opt][1]}, block_histogram {counts[opt][2]}")
    if min(counts[False][:2] + counts[True]) <= 0:
        raise AssertionError(f"the encode path skipped a kernel: {counts}")
    want = torch.cat([enc.dense(px[i:i + CHUNK])
                      for i in range(0, STREAM_FRAMES, CHUNK)])
    for opt, out in outs.items():
        if len(out) != STREAM_FRAMES:
            raise AssertionError(f"optimize={opt}: {len(out)} frames")
        d = DeviceDecoder.for_stream(out[0], dev)
        coeffs = d.decode_coeffs_batch(out, chunk=CHUNK)
        if not torch.equal(raster_to_zz(coeffs, prev), want):
            raise AssertionError(f"optimize={opt}: the decoded blocks "
                                 "differ from the encoder's")
        if not opt:
            committed = decs["bench"].decode_coeffs_batch(streams["bench"])
            check_dense("frames 0-1 vs the committed jpeg_tpu frames",
                        coeffs[:2] - committed,
                        DENSE_DIFF_SHARE["committed"])
        log(f"slice: optimize={opt}: {STREAM_FRAMES} frames decode on the "
            f"card to exactly the encoder's blocks")

    # ---- 10. encode times -------------------------------------------------
    mpix = STREAM_FRAMES * 1920 * 1080 / 1e6
    for key, opt in (("device_encode_Mpix_s", False),
                     ("device_encode_optimized_Mpix_s", True)):
        med, runs = median_s(
            lambda: enc.encode_batch(px, optimize=opt, chunk=CHUNK), E2E_RUNS)
        log(f"time {key}={mpix / med} (median of {len(runs)} runs of "
            f"{STREAM_FRAMES} frames from pixels on the card to bytes, host "
            f"clock; run ms {[round(r * 1e3, 3) for r in runs]}) [{card}]")

    def compute():
        for i in range(0, STREAM_FRAMES, CHUNK):
            enc.scan(enc.dense(px[i:i + CHUNK]))

    compute()
    reps = 5
    ms = cuda_ms(compute, reps)
    log(f"time device_encode_compute_Mpix_s={mpix / (ms / 1e3)} ({ms} ms "
        f"per {STREAM_FRAMES} frames, dense stage + segment encode, words "
        f"left on the card, mean of {reps}) [{card}]")

    order, seg_of, dc_tab, ac_tab = enc.chunk_tables(CHUNK)
    sargs = (zz, order, seg_of, dc_tab, ac_tab,
             torch.from_numpy(enc.ehufco).to(dev),
             torch.from_numpy(enc.ehufsi).to(dev), CHUNK * enc.n_segments)
    times = {
        "pixels_to_zz": (
            cuda_ms(lambda: pixels_to_zz(chunk, qt, prev, geom), 20),
            cuda_ms(lambda: pixels_to_zz_ref(chunk, qt, prev, geom), 2)),
        "encode_scan": (cuda_ms(lambda: encode_scan(*sargs), 20),
                        cuda_ms(lambda: encode_scan_ref(*sargs), 2)),
        "block_histogram": (
            cuda_ms(lambda: block_histogram(zz, dc_tab, ac_tab, T), 20),
            cuda_ms(lambda: hist_from_blocks_ref(zz, dc_tab, ac_tab, T), 2)),
    }
    for name, (k_ms, p_ms) in times.items():
        log(f"time {name}_ms={k_ms} plain_ms={p_ms} per {CHUNK}-frame 1080p "
            f"chunk [{card}]")
    profile_window(
        lambda: enc.encode_batch(px, optimize=False, chunk=CHUNK),
        "device_encode.", card, f"{STREAM_FRAMES}-frame encode")

    rows = (
        ("pixels_to_zz", "encode_dense.cu",
         "jpeg_tpu/models/device_encode.py:62",
         counts[False][0] + counts[True][0], dense_err),
        ("encode_scan", "encode_scan.cu",
         "jpeg_tpu/entropy/encode_jax.py:547",
         counts[False][1] + counts[True][1], scan_err),
        ("block_histogram", "encode_scan.cu",
         "jpeg_tpu/entropy/encode_jax.py:919", counts[True][2], hist_err),
    )
    return [{"name": name, "route": "cuda",
             "source": f"jpeg_tpu_torch/csrc/{src}", "replaces": replaces,
             "launches": n, "max_abs_err": err, "ms": times[name][0],
             "plain_ms": times[name][1]}
            for name, src, replaces, n, err in rows]


def main() -> None:
    t_start = time.perf_counter()
    # ---- 1. environment ------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = card_label()
    log(card)
    set_precision()
    kind = torch.cuda.get_device_name(0)
    log(f"env: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")

    # ---- 2. build ------------------------------------------------------
    lib = kernels.load_library()
    log(f"build: {lib.path.name} in {lib.build_seconds:.2f} s [{card}]")

    # ---- 3. kernel vs plain version ----------------------------------
    streams = {name: frames_of(name) for name in STREAMS}
    decs = {name: DeviceDecoder.for_stream(fr[0], "cuda")
            for name, fr in streams.items()}
    bench = streams["bench"]
    cases = [(name, decs[name], fr) for name, fr in streams.items()]
    cases.append((f"bench chunk x{CHUNK}", decs["bench"],
                  [bench[i % len(bench)] for i in range(CHUNK)]))
    max_err = 0
    for seed, (label, dec, fr) in enumerate(cases):
        words, nbits, _ = dec.prepare(fr)
        err, counts = compare_kernel(label, dec.plan, words, nbits, dec,
                                     len(fr))
        max_err = max(max_err, err)
        if not bool((counts == dec.ri).all()):
            raise AssertionError(f"{label}: intact stream lost MCUs")
        bad_w, bad_n = damage(words, nbits, seed)
        for tag, plan in (("damaged", dec.plan),
                          ("damaged, hostile tables", hostile_plan(fr[0]))):
            err, counts = compare_kernel(f"{label} {tag}", plan, bad_w,
                                         bad_n, dec, len(fr))
            max_err = max(max_err, err)
            if not bool((counts < dec.ri).any()):
                raise AssertionError(f"{label} {tag}: no lane died")
    try:
        DeviceDecoder.for_stream(frames_of("ineligible_420_ri3")[0], "cuda")
    except UnsupportedError:
        log("ineligible stream: UnsupportedError as expected")
    else:
        raise AssertionError("ineligible stream was accepted")

    # ---- 4. against JAX (committed digests) ----------------------------
    digests = json.loads((CORPUS / "digests.json").read_text())
    for name, fr in streams.items():
        coeffs = decs[name].decode_coeffs_batch(fr).cpu()
        got = [hashlib.sha256(coeffs[i].numpy().tobytes()).hexdigest()
               for i in range(len(fr))]
        if got != digests[name]:
            raise AssertionError(f"{name}: coefficient digests differ "
                                 "from jpeg_tpu's")
        log(f"digests {name}: {len(fr)} frames equal to jpeg_tpu")

    # ---- 5. the slice ----------------------------------------------------
    stream_frames = [bench[i % len(bench)] for i in range(STREAM_FRAMES)]
    stream = b"".join(stream_frames)
    decode_segments.launches = 0
    px = jpeg_tpu_torch.mjpeg.decode_stream_device(stream, "cuda",
                                                   chunk=CHUNK)
    torch.cuda.synchronize()
    launches = decode_segments.launches
    if launches <= 0:
        raise AssertionError("main path never launched decode_segments")
    want = (STREAM_FRAMES, 1080, 1920, 3)
    if tuple(px.shape) != want or px.dtype != torch.uint8 or not px.is_cuda:
        raise AssertionError(f"stream output {tuple(px.shape)} {px.dtype} "
                             f"on {px.device}, want {want} uint8 on cuda")
    for i in range(STREAM_FRAMES):  # repeated content decodes identically
        if not torch.equal(px[i], px[i % len(bench)]):
            raise AssertionError(f"frame {i} differs from its repeat")
    cpu = DeviceDecoder.for_stream(bench[0], "cpu").decode_batch(bench[:1])
    diff = int((px[0].cpu().to(torch.int16) - cpu[0].to(torch.int16))
               .abs().max())
    if diff > 1:
        raise AssertionError(f"frame 0 differs from the CPU decode by {diff}")
    log(f"slice: decode_stream_device {want} uint8 on cuda, "
        f"decode_segments launches {launches}, frame 0 vs CPU max diff "
        f"{diff}")

    # ---- 6. times ---------------------------------------------------------
    mpix = STREAM_FRAMES * 1920 * 1080 / 1e6
    e2e = []
    for _ in range(E2E_RUNS + 1):  # the first run is the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        jpeg_tpu_torch.mjpeg.decode_stream_device(stream, "cuda", chunk=CHUNK)
        torch.cuda.synchronize()
        e2e.append(time.perf_counter() - t0)
    runs = sorted(e2e[1:])
    med = runs[len(runs) // 2]
    log(f"time e2e_stream_Mpix_s={mpix / med} (median of {len(runs)} runs "
        f"of {STREAM_FRAMES} frames from bytes; run ms "
        f"{[round(r * 1e3, 3) for r in runs]}) [{card}]")

    dec = decs["bench"]
    prep = []
    for _ in range(E2E_RUNS):
        t0 = time.perf_counter()
        prepared = [dec.prepare(stream_frames[i:i + CHUNK])
                    for i in range(0, STREAM_FRAMES, CHUNK)]
        torch.cuda.synchronize()
        prep.append(time.perf_counter() - t0)
    prep = sorted(prep)
    log(f"time host_prep_ms={prep[len(prep) // 2] * 1e3} (median of "
        f"{len(prep)} runs: parse, unstuff, pack and upload of "
        f"{STREAM_FRAMES} frames, host clock; run ms "
        f"{[round(r * 1e3, 3) for r in prep]}) [{card}]")

    def resident():
        for words, nbits, qt in prepared:
            c, _ = dec.decode_prepared(words, nbits, CHUNK)
            _dense_from_coeffs(c, dec.geom, qt)

    resident()
    reps = 10
    ms = cuda_ms(resident, reps)
    log(f"time device_resident_Mpix_s={mpix / (ms / 1e3)} "
        f"({ms} ms per {STREAM_FRAMES} frames, mean of {reps}) [{card}]")

    words, nbits, qt = prepared[0]
    args = (dec.plan, words, nbits, CHUNK, dec.segs_per_frame, dec.ri,
            dec.total_blocks)
    k_ms = cuda_ms(lambda: decode_segments(*args), 20)
    p_ms = cuda_ms(lambda: decode_segments_ref(*args), 2)
    log(f"time decode_segments_ms={k_ms} decode_segments_ref_ms={p_ms} "
        f"per {CHUNK}-frame 1080p chunk ({words.shape[0]} lanes) [{card}]")
    coeffs, _ = dec.decode_prepared(words, nbits, CHUNK)
    d_ms = cuda_ms(lambda: _dense_from_coeffs(coeffs, dec.geom, qt), 10)
    log(f"time dense_tail_ms={d_ms} per {CHUNK}-frame 1080p chunk "
        f"(plain torch) [{card}]")

    # Card busy share of one stream decode.  The decoder's spans (prepare
    # / dispatch) are recorded as host events.
    profile_window(
        lambda: jpeg_tpu_torch.mjpeg.decode_stream_device(stream, "cuda",
                                                          chunk=CHUNK),
        "device_decode.", card, f"{STREAM_FRAMES}-frame stream decode")

    entries = [{
        "name": "decode_segments",
        "route": "cuda",
        "source": "jpeg_tpu_torch/csrc/decode_segments.cu",
        "replaces": "jpeg_tpu/entropy/place_pallas.py:121",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]
    entries += encode_phases(card, streams, decs, torch.device("cuda"))
    log(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
