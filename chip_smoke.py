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
   ``torch.profiler``.

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
from jpeg_tpu_torch.device import set_precision
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

CORPUS = Path(__file__).resolve().parent / "tests" / "data" / "torch_port"
STREAMS = ("bench", "yuv420_ri2", "yuv444_ri3", "gray_ri4", "p12_422_ri2")
CHUNK = 8  # frames per chunk, as bench.py decodes the stream
STREAM_FRAMES = 16
E2E_RUNS = 5

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

    # Card busy share of one stream decode: the union of the device
    # events' intervals over the host-clock window.  The decoder's spans
    # (prepare / dispatch) are recorded as host events.
    os.environ["JPEG_TPU_PROFILE"] = "1"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        jpeg_tpu_torch.mjpeg.decode_stream_device(stream, "cuda", chunk=CHUNK)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    os.environ.pop("JPEG_TPU_PROFILE")
    events = prof.events()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("device_decode.")]
    busy = busy_us((e.time_range.start, e.time_range.end) for e in on_card)
    log(f"profile: window {wall_us / 1e3} ms, device busy {busy / 1e3} ms "
        f"({100 * busy / wall_us}% busy), {len(on_card)} device events, "
        f"{STREAM_FRAMES} frames [{card}]")
    spans = {}
    for e in events:
        if e.name.startswith("device_decode.") and \
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
    log(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "decode_segments",
        "route": "cuda",
        "source": "jpeg_tpu_torch/csrc/decode_segments.cu",
        "replaces": "jpeg_tpu/entropy/place_pallas.py:121",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
