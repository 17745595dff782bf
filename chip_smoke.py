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
   on every small corpus stream whose segments tile MCU rows and on an
   8-frame chunk of the 1080p bench frames (16,320 lanes), and
   ``decode_segments_general`` against ``decode_segments_general_ref`` on
   a 3-frame chunk of every other corpus stream (a short last segment, a
   restart interval that does not divide the MCU row, 4:2:2, 12-bit,
   grayscale, no restart markers), each intact, with seeded damage to its
   segment words, and with the damaged words under hostile Huffman
   tables, so that every way a lane can die runs through the kernels;
   each kernel call runs on both word routes (segment words staged in
   shared memory, and with a zero staging budget the register
   lookahead), and both routes must have run;
3b. the dense decode tail: ``coeffs_to_pixels`` against
   ``coeffs_to_pixels_ref`` within +-1 and with at most
   ``TAIL_DIFF_SHARE`` of the samples differing, on the 8-frame bench
   chunk, on every small corpus stream, each also with seeded noise
   (+-40) on its coefficients (both clip ends hit), and on YCCK and luma
   h=1 v=2 frames of seeded coefficients and per-frame tables; the bench
   chunk's blocks at an address 4 bytes past a 16-byte boundary (the
   kernel's 4-byte copies in place of its bulk copies) to the same pixels
   as aligned; a warm
   call under ``torch.cuda.set_sync_debug_mode("error")``; a stream whose
   quality changes from frame to frame (``MIXED_QUALITY``, encoded by the
   port) through ``DeviceDecoder.decode_batch`` with no fallback, each
   frame within +-1 of its own ``decode_jpeg(exact=False)``;
4. against JAX: every single-scan corpus frame's coefficients against the
   sha256 digests jpeg_tpu produced (``digests.json``);
5. the slice: ``mjpeg.decode_stream_device`` on a 16-frame 1080p stream,
   with the kernels' launch counts (``coeffs_to_pixels`` and, the
   decoder's default prep on the card being flat, ``rows_from_flat``
   exactly once per chunk, every chunk counted flat), checked against the
   CPU decode;
6. times, each labelled with the prep mode (flat):
   end-to-end stream rate, device-resident rate, host prep, per
   8-frame chunk each kernel (``decode_segments``, ``coeffs_to_pixels``:
   ``dense_tail_ms``) against its plain version, their bounds and
   roofline shares, and the card's busy share of one stream decode under
   ``torch.profiler``;
7. encode kernels vs plain, on the card: ``pixels_to_zz`` against
   ``pixels_to_zz_ref`` within +-1 and with at most ``DENSE_DIFF_SHARE``
   of the coefficients differing, on an 8-frame 1080p chunk of
   ``bench.make_frame_ppm`` content and on seeded noise in small
   grayscale, 12-bit 4:2:2, 4:4:4 and padded 4:2:0 frames, and equal on
   a grayscale frame of exact rounding ties (``synth.tie_frame``: half
   away from zero, as ``roundf``); ``encode_scan`` and ``block_histogram`` against
   ``encode_scan_ref`` and ``hist_from_blocks_ref``, integer for
   integer, on that chunk's blocks, on the same pixels encoded with
   restart interval 7 (1,166 segments per frame, the last short), 67
   (segments of two pieces) and with one segment per frame, on a
   hand-made 12-bit chunk that holds
   every symbol kind, once with tables that code every symbol and once
   with one symbol left without a code (``missing``), and on a frame of
   worst-case blocks under 16-bit codes (every block at or near
   ``word_capacity``); ``block_histogram`` also on every case of
   ``synth.hostile_hist`` (INT_MIN and +-32767, no EOB, zero runs of 16,
   31 and 47, eight tables), alone and added into a caller's histogram
   (``out=``); a warm call of ``encode_scan`` and of
   ``pixels_to_zz`` runs under ``torch.cuda.set_sync_debug_mode("error")``,
   so neither may sync with the host;
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
    one encode under ``torch.profiler`` with its host spans;
11. general shape at full width: 16 frames of 1080p 4:2:0 q75 encoded on
    the card with restart interval 7 (1,166 segments per frame, the last
    one short) decode through ``mjpeg.decode_stream_device`` on the
    general kernel alone (and the dense tail kernel), to exactly the
    encoder's blocks and within +-1 of the CPU decode; the kernel equals
    its plain version on an 8-frame
    chunk of it, intact, damaged and under hostile tables; three kernel
    launches a general call (count walk with the layout, place, resolve:
    the library's own count, ``jt_decode_segments_launches``); the intact
    and damaged chunk's contested MCUs (from the plain scan), with the
    count walk's counts, partial flags and layout (its launch alone,
    ``place_cuda._general_layout``) equal to the plain scan's,
    ``lane_layout`` and ``contested_rows`` on both; times, bounds and
    roofline shares of the general kernel and of the count walk with its
    layout against their plain versions, the one-pass kernel's time on
    the ri=4 bench chunk, and the stream's end-to-end rate;
12. single image: ``decode_jpeg(..., exact=True)`` of the 1080p bench frame
    and of every small corpus frame on the card, hashed against
    jpeg_tpu's exact ``to_pnm()`` digests (``exact.json``); the device
    entropy path, ``decode_jpeg(..., exact=True, entropy="lockstep-jax")``
    of bench frame 0 (ri=4) and of phase 11's frame 0 (ri=7) with every
    plain version and host engine made to raise, to jpeg_tpu's digest
    (frame 0) and to ``entropy="lockstep"``'s coefficients, MCU counts
    and pixels, each decode one ``decode_segments_general`` call (three
    kernel launches), ``idct_exact`` a component and ``color_exact``
    once; a damaged ri=7 frame (an invalid code in every 37th segment)
    to equal coefficients on the card and on the CPU;
    ``decode_frame_device`` on the multi-scan frames within +-1 of its CPU
    run; ``encode_jpeg(..., exact=True)`` of the 1080p bench frame
    byte-identical to jpeg_tpu's committed digests; a mixed stream falls
    back frame by frame and counts it; each exact kernel (``idct_exact``,
    ``fdct_exact``, ``color_exact``) bitwise equal to its plain version
    on 1080p planes and on seeded random inputs (``idct_exact`` also on
    the Y plane 4 bytes past a 16-byte boundary and on block counts that
    are not a multiple of 4; ``fdct_exact`` also on every case of
    ``synth.hostile_fdct``: 12-bit samples, exact .5 ties, Q = 1 and
    255, and on the Y plane 4 bytes past a 16-byte boundary), with
    times, and ``exact_decode_ms`` with host and with device entropy;
13. RST-less: 16 frames of 1080p 4:2:0 q75 encoded on the card with no
    restart markers (bench.py's ``p_rl``) decode through
    ``mjpeg.decode_stream_device`` on the speculative engine (the
    kernels ``rstless_sync`` K8, ``rstless_resolve`` K9 and
    ``rstless_final`` K10, then the dense tail), each launched once per
    8-frame batch (K8's head and tail walks counted apart, once each a
    batch), with no fallback and no host frame; the decoded blocks
    equal the encoder's and the pixels ``coeffs_to_pixels`` of them; at
    most ``RSTLESS_MAX_SYNCS`` host syncs in one batch, each logged with
    its site; each kernel bit for bit against its plain version (K8's
    links, membership and marks; K9's rows, stats and pieces; K10's
    coefficients and ok bits; K9 and K10 on the kernel outputs of the
    stage before) on an 8-frame batch and on three-frame batches of
    4:2:0, 4:2:2, 4:4:4, gray and 12-bit gray content at the default
    chunk and piece, at 64-byte chunks with 24-byte pieces (a short last
    piece), at 16-byte chunks with a 4-byte strip and 4-byte pieces
    (blocks cut by chunks and pieces, and re-decode rounds) and, damaged
    (``damage``), at 64-byte chunks with 16-byte pieces; times, bounds
    and plain times of the three kernels (K8's bound counts the segment,
    tables, links and marks, not its membership map: that is the design's
    scratch), ``rstless_e2e_stream_Mpix_s``,
    ``rstless_device_resident_Mpix_s``, the card's busy share, the
    device time of K8's head and tail walks, K9, and K10's piece walk and
    DC pass apart, and K8's survivors (the distinct decodes that walk past
    the strip) in the 8-frame batch; every batch of the main path takes
    the native prep (``speculative.native_prep_chunks``), and the prep's
    run walk packs every frame and the sample frame and refuses none
    (``native.ecs_walk_frames`` / ``ecs_walk_refused``);
14. fast mode: ``decode_frame_fast`` (K11) against ``decode_frame_fast_ref``
    on bench frame 0, every frame of the small corpus streams and the
    crafted frames of ``synth.CRAFTED`` (a sampling ratio that does not
    divide, YCCK, SOF ids 3, 1, 2), each also with seeded +-40 noise on
    its coefficients, and seeded coefficients of ``FAST_GEOMETRY``
    (tiles below one MCU): the floats within ``fast_tol`` and their pixels
    within +-1 with at most ``TAIL_DIFF_SHARE`` differing;
    ``encode_frame_fast`` (K12) against ``encode_frame_fast_ref`` on bench
    frame 0 and seeded noise in ``DENSE_SHAPES`` (the kernel's box cells)
    and ``FAST_ENCODE_GEOMETRY`` (its general code), within +-1 under
    ``DENSE_DIFF_SHARE``; a warm call of each under
    ``torch.cuda.set_sync_debug_mode("error")``; bench frame 0's
    coefficients and pixels 4 bytes off a 16-byte boundary (the kernels'
    4-byte copies in place of their bulk copies) to the aligned calls'
    outputs; each kernel's registers a thread and CTAs an SM; the paths
    with their
    launch counts: ``decode_jpeg(exact=False)`` of bench frame 0 (1, its
    pixels within +-1 of the CPU run's) and of each crafted frame,
    ``mjpeg.decode_stream`` of the 16-frame stream (16), phase 12's mixed
    stream (one a fallback frame), ``encode_jpeg(exact=False)`` of bench
    frame 0 (1: its coefficients within +-1 of the CPU encode's) and
    ``DeviceEncoder.tables_for_stream`` (1); each kernel's times, bound
    and share beside the plain eager chain's time and device launches,
    and ``fast_decode_ms`` / ``fast_encode_ms`` (host clock, median of 2)
    with their host entropy, dense stage and the decode's copy of the
    float frame to the host timed apart;
15. the native host layer and the CLI: ``jpeg_tpu_torch/native`` built
    with g++ (its seconds logged; a failed build fails the run) and
    ``available()``; on the 16-frame ri=4 bench stream the native prep
    in its rows mode (``jt_walk_ecs_rows``; phase 17 holds the flat mode)
    against the Python prep, chunk by chunk: words
    equal over ``pack_words``' width and zero past it, bit counts and
    tables equal, the word routes (``place_cuda.ROUTE_LAUNCHES``) equal;
    ``mjpeg.decode_stream_device`` with every chunk counted native
    (``device_decode.native_prep_chunks``, none in
    ``python_prep_chunks``) and one launch of each kernel a chunk, its
    stream entry on the native walks (``mjpeg.native_splits`` and
    ``device_decode.native_for_stream`` once, neither ``python_*``
    counter), the prep's run walk packing every frame and the sample
    frame and refusing none, its pixels equal to the Python prep's
    (which takes the Python walks too); ``host_prep_ms`` and the stream
    rate under each prep, in turns; ``encode_batch`` of the 16 bench
    frames with every chunk counted in
    ``device_encode.native_finalize_chunks`` (none in
    ``python_finalize_chunks``), byte-identical to the NumPy host tail's,
    each timed; ``decode_jpeg(..., exact=True,
    entropy="native")`` of bench frame 0 to jpeg_tpu's digest and
    ``encode_jpeg`` with ``entropy_backend="native"`` byte-identical to
    the numpy backend and to jpeg_tpu's digests; ``exact_decode_ms``,
    ``fast_decode_ms`` and ``exact_encode_ms`` with native host entropy,
    each with its entropy part apart and the host thread count; and
    ``python -m jpeg_tpu_torch.cli`` as three subprocesses on the card:
    ``decode`` of bench frame 0 (jpeg_tpu's digest), ``encode`` (the
    committed bytes) and ``mjpeg`` of the stream (each frame equal to
    ``decode_stream_device``'s), each exiting 0;
16. multi-device (``jpeg_tpu_torch.parallel``): (a) in this process, an
    NCCL group of one rank and a (1, 1) mesh on the card: the sharded
    stream decoder on the 16 bench frames at ri=4 (``place_ri=4``: K1 and
    K3) and on 16 ri=7 frames (``place_ri=0``: K2 and K3) against
    ``DeviceDecoder.decode_batch``, ``decode_frame_sharded`` of bench
    frame 0, ri=7 frame 0 and an ri=9 frame (907 lanes) against
    ``decode_coefficients(entropy="lockstep-jax")``, the sharded stream
    encoder (16 frames, with the histogram) against ``encode_batch`` and
    the single-device histogram, ``make_sharded_decoder`` (K11; exact:
    K4) and ``make_sharded_roundtrip`` (K11, K12) at ``BatchConfig(1080,
    1920, 2, 2)``, batch 8, on seeded coefficients against
    ``decode_batch_ycc`` / ``roundtrip_step_ycc``, all bit for bit, and
    the batch kernels against their plain versions (K11 within
    ``fast_tol``, K12 within +-1 under ``DENSE_DIFF_SHARE["noise"]``,
    K4 equal); (b) the same paths in two spawned ranks sharing the card
    over gloo (meshes (2, 1), (1, 2) for the tile gather, and a 1-D
    'frame' mesh of two for the frame decode, the ri=9 frame padded with
    a lane), plus ``global_frame_batch`` of each rank's decode, every
    gathered output (sha256) equal to (a)'s; each path twice (cold,
    warm), its wall time, peak device memory (per rank) and kernel
    launches printed, and the launches of both runs added to the kernels
    line (``sharded_launches``);
17. the flat prep (``DeviceDecoder.prep_mode`` "flat", the default on
    the card): K13 ``rows_from_flat`` against
    ``rows_from_flat_ref`` bit for bit on the flat buffers of the 16-frame
    ri=4 and ri=7 streams' chunks, of 8-frame chunks damaged
    (``damage_frame``) and cut (``cut_frame``: segments that end inside a
    symbol), and on rows that clip at both ends; the flat decode against
    the rows decode on each (coefficients, lane MCU counts and pixels
    equal, word routes equal, the ri=4 chunks staged);
    ``decode_stream_device`` of the 16 ri=4 frames (counts set to 0
    before it): K13, the segment kernel and the dense tail once a chunk,
    every chunk counted flat, the run walk refusing no frame, its pixels
    equal to those of a rows decoder (``stream_decode``); K13's times,
    bound and share; the upload bytes of a chunk in each mode;
    ``host_prep_ms[rows]`` / ``[flat]`` and the
    ri=4 and ri=7 stream rates in each mode, in turns; the break-even
    upload rate derived from the bytes and K13's device-only time (each
    batch there is a fresh decoder's first, frame-major, and its counts
    come from ``prepare``'s frame-major rows);
18. the learned lane order (jpeg_tpu's phased scan): on the 8-frame ri=7
    1080p chunk in the order its learning batch gives it, K2
    ``decode_segments_general`` with ``perm`` and ``want_nsteps`` against
    its plain version, integer for integer (coefficients, frame-major MCU
    counts, steps) on both word routes, intact, damaged and damaged under
    hostile tables, and without ``perm`` on the frame-major chunk (equal
    to the sorted decode); the count walk's layout with ``perm`` against
    the plain scan's, intact and damaged; a kept ``DeviceDecoder`` in
    "rows" prep decodes the 16-frame ri=7 stream twice: the first batch
    learns, the second (counts set to 0 before it) runs 2 "mats" chunks,
    K2 with a lane order twice (``lane_order_launches``, the kernels
    line's launches), no ``phase_inflate``, pixels equal to the first's,
    and a third decode gives the encoder's blocks; the same on the ri=4
    bench stream with ``place_ri = 0`` (K2); times in turns of K2 sorted
    and frame-major (a call and device-only) and of the count walk with
    its layouts, K2's bound, the plain version's time; what a
    misprediction costs (bounds of 8 steps: both chunks redone
    frame-major, pixels equal to the sorted batch's), timed against the
    sorted batch in turns; and the sorted batch's profile;
19. the RST-less engine's host preps: an 8-frame chunk of phase 13's
    stream through the native prep (``prepare_batch_native``) and the
    Python prep (``prepare_batch`` of each frame's parsed segment): words
    equal over ``pack_words``' width and zero past it, bit counts and
    rows equal, the engine's coefficients equal, and
    ``decode_stream_rstless`` with the stream's decoder to equal pixels
    with and without the native library (one chunk counted by each
    prep); both preps timed a frame (``rstless_host_prep_ms``);
20. per-frame optimized tables (``frame_tables_phase``): on an 8-frame
    chunk of 8 distinct 1080p frames on the card, ``block_histogram``
    with each frame's table rows apart (32 tables) against
    ``hist_from_blocks_ref``, and ``encode_scan`` with each frame's own
    Annex K.2 tables against ``encode_scan_ref``, integer for integer;
    the frames ``pack`` makes from the card's blocks byte for byte
    against the CPU path's on the first two frames' blocks (the plain
    versions, the same native builder and tail); ``encode_batch(optimize=
    "frame")`` of 16 frames at chunk 8 to the same bytes, with
    ``pixels_to_zz``, ``block_histogram`` and ``encode_scan`` launched
    once a chunk and every table built natively; times: ``block_histogram``
    at 32 tables and at 4, ``encode_scan`` with 32 tables and with the
    4 shared ones, each with its bound, the per-frame and default
    ``encode_batch`` of the 16 frames (host clock), and a profile of the
    per-frame call with its host spans;
21. the prep's run walk (``ecs_walk_phase``, on the host): its two
    entry points (``jt_walk_ecs_flat``, ``jt_walk_ecs_rows`` with a
    permuted row map) against the byte-at-a-time loop of the same
    contract in ``scanner.cpp`` on the bench frames and on
    two clip frames of each decode configuration of the benchmark
    (restart every 4 and 7 MCUs, none), made from ``WALK_SEED``: return
    code, ``used_words``, ``end_off``, starts, lengths and the whole
    output (dirty before the walk) equal; both timed a frame
    (``ecs_walk_ms``, host clock).

Every kernel's time is printed beside its bound (``bound``: the bytes it
must move at 3.35 TB/s or its operations at the peak rate of their type
(``PEAK_OPS_PER_S``), whichever is larger) and its roofline share: a
call's time with its wrapper (CUDA events over back-to-back calls,
``ms``) and its device-only time (the same calls captured in one CUDA
graph and replayed, ``device_ms``, which the share is taken of).  The
line before the last is a JSON object describing the kernels; the last
line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --compare PARENT . . PARENT

times the decode kernels and the encode kernels of each checkout given
(a directory holding its ``jpeg_tpu_torch``, e.g. ``git archive
<commit>`` unpacked under ``build/``), in that order, each in a process
of its own, so that a parent and a change measured in turns on one card
compare fairly: ``decode_segments`` on the 8-frame ri=4 bench chunk, the
dense tail on its coefficients, the device-resident decode of the 16
prepared bench frames (segment decode and dense tail),
``decode_segments_general`` on an 8-frame ri=7 chunk, intact and
damaged (on the register lookahead too where the checkout has that
route), ``pixels_to_zz`` on the 8-frame bench pixels, and
``encode_scan`` on their blocks at restart intervals 4 and 7 and with
one segment per frame, ``block_histogram`` on the ri=4 blocks,
``fdct_exact`` on the 1080p Y plane of bench frame 0 and ``idct_exact``
on its coefficients, and where the checkout has them ``decode_frame_fast``
and ``encode_frame_fast`` on bench frame 0 (20 back-to-back
calls, CUDA events, and device only: the 20 calls in one CUDA graph,
three times each), the end-to-end ``encode_batch`` of the 16 bench frames,
default and optimized, and where the checkout has the RST-less engine
the end-to-end decode of phase 13's stream (host clock, median of 5,
three times), each with
the peak of device memory allocated during one call and a per-kernel
device profile of one call (the record keeps its launches by kernel)
and, for device cases, the host time a call to enqueue 20 calls.  Every
checkout's outputs must be equal (the
encode stream hashed up to its word count, whichever return form the
checkout has), the dense tail's and the device-resident decode's
included: a checkout's dense tail kernel must give the pixels of every
other's byte for byte.  It prints one JSON line per checkout and no
result line.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

if __name__ == "__main__" and sys.argv[1:2] == ["--time-tree"]:
    # A worker of --compare: import the package of the checkout it times.
    sys.path.insert(0, os.path.abspath(sys.argv[2]))

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import jpeg_tpu_torch
from jpeg_tpu_torch import kernels
from jpeg_tpu_torch.constants import (
    STD_CHROMINANCE_QUANT,
    STD_LUMINANCE_QUANT,
    ZIGZAG,
    scale_qtable,
)
from jpeg_tpu_torch.device import set_precision
from jpeg_tpu_torch.encoder import (
    EncodeParams,
    encode_jpeg_from_planes,
    geometry_for_image,
)
from jpeg_tpu_torch.entropy.encode_cuda import block_histogram, encode_scan
from jpeg_tpu_torch.entropy.encode_torch import (
    encode_scan_ref,
    hist_from_blocks_ref,
)
from jpeg_tpu_torch.entropy import place_cuda
from jpeg_tpu_torch.entropy.lockstep import ScanPlan, build_scan_plan
from jpeg_tpu_torch.entropy.lockstep_torch import _cached_plan, scan_lanes
from jpeg_tpu_torch.entropy.place_cuda import (
    decode_segments,
    decode_segments_general,
    decode_segments_general_ref,
    decode_segments_ref,
    region_path,
)
from jpeg_tpu_torch.format.parse import parse_codestream
from jpeg_tpu_torch.geometry import Component, FrameGeometry, with_block_grid
from jpeg_tpu_torch.tables import HuffSpec, derive_table
try:
    from jpeg_tpu_torch.models.decode_dense import (
        coeffs_to_pixels,
        coeffs_to_pixels_ref,
    )
except ImportError:
    # A --time-tree worker may import a checkout older than the dense
    # tail kernel; it times that checkout's _dense_from_coeffs instead.
    if sys.argv[1:2] != ["--time-tree"]:
        raise
    from jpeg_tpu_torch.models.device_decode import _dense_from_coeffs

    def coeffs_to_pixels(coeffs, qtables, geom):
        return _dense_from_coeffs(coeffs, geom, qtables)
try:
    from jpeg_tpu_torch.models.dense_fast import (
        decode_frame_fast,
        decode_frame_fast_ref,
        encode_frame_fast,
        encode_frame_fast_ref,
    )
except ImportError:
    # A --time-tree worker may import a checkout older than the fast
    # mode's kernels; it skips their cases.
    if sys.argv[1:2] != ["--time-tree"]:
        raise
from jpeg_tpu_torch.models.device_decode import DeviceDecoder
try:
    from jpeg_tpu_torch.models.flat_rows import rows_from_flat
except ImportError:
    # A --time-tree worker may import a checkout older than the flat prep.
    if sys.argv[1:2] != ["--time-tree"]:
        raise
from jpeg_tpu_torch.models.dense_exact import (
    color_exact,
    color_exact_ref,
    fdct_exact,
    fdct_exact_ref,
    idct_exact,
    idct_exact_ref,
)
from jpeg_tpu_torch.models.device_encode import DeviceEncoder
from jpeg_tpu_torch.models.pipeline import decode_frame, encode_frame
from jpeg_tpu_torch.ops.blocks import plane_to_blocks
from jpeg_tpu_torch.ops.dct import _kron_mats
from jpeg_tpu_torch.ops.resample import downsample_box
from jpeg_tpu_torch.models.encode_dense import (
    pixels_to_zz,
    pixels_to_zz_ref,
    raster_to_zz,
)
from jpeg_tpu_torch.utils import synth
from jpeg_tpu_torch.utils.floatops import roundf
from jpeg_tpu_torch.utils.metrics import default_metrics
from jpeg_tpu_torch.utils.pnm import read_pnm, write_pnm

CORPUS = Path(__file__).resolve().parent / "tests" / "data" / "torch_port"
STREAMS = ("bench", "yuv420_ri2", "yuv444_ri3", "gray_ri4", "p12_422_ri2")
# Corpus streams of general shape (tools/make_torch_fixtures.py).
GENERAL = ("ineligible_420_ri3", "short_422_ri5", "short_p12_420_ri5",
           "row_420_ri3", "short_gray_ri4", "rstless_420")
MULTISCAN = ("multiscan_ri4", "multiscan_ri0")
CHUNK = 8  # frames per chunk, as bench.py decodes the stream
STREAM_FRAMES = 16
E2E_RUNS = 5
# Host syncs one RST-less engine batch may make: the uploads of its words,
# bit counts and rows, and the one read of its frame checks.
RSTLESS_MAX_SYNCS = 4
# bench.py's encode shape (bench.py:55-58, 484-529): 1080p 4:2:0 q75,
# restart interval 4, default tables, fast dense path.
BENCH_PARAMS = EncodeParams(h=2, v=2, quality=75, optimize=False,
                            restart_interval=4, exact=False)
# The general-shape stream: bench.py's shape with restart interval 7,
# which does not divide the 120-MCU row (8,160 MCUs: 1,166 segments, the
# last of 5 MCUs).
GENERAL_PARAMS = EncodeParams(h=2, v=2, quality=75, optimize=False,
                              restart_interval=7, exact=False)
# Corpus quality (tools/make_torch_fixtures.py): bench q75, the rest q80.
CORPUS_QUALITY = {"bench": 75}
# Small dense-stage shapes: (components, h, v, height, width, bits).
DENSE_SHAPES = ((1, 1, 1, 37, 45, 8), (3, 2, 1, 32, 48, 12),
                (3, 1, 1, 24, 40, 8), (3, 2, 2, 38, 54, 8),
                (3, 1, 2, 38, 54, 8))
# The dense kernel differs from its plain version only in the FDCT's
# summation order, so a quantized value moves by 1 only where c / q sits
# on a rounding boundary: rare on smooth content, less rare on noise.  A
# kernel that truncates, rounds ties to even or computes in lower
# precision moves far more coefficients than these shares allow.
DENSE_DIFF_SHARE = {"chunk": 1e-5, "noise": 1e-3, "committed": 1e-4}
# The dense decode tail kernel differs from its plain version only in the
# IDCT's summation order (separable fmaf chains against cuBLAS's [64, 64]
# product), so a pixel sample moves by 1 only where its value sits on a
# rounding boundary: a few per million of the bench frames' samples, and
# at most one of a small corpus stream's, in the CPU model of the kernel
# (tests/test_torch_dense.py).  A kernel that reads a wrong table, block
# or sample, or computes in lower precision, moves far more.  The small
# bound allows 6 samples of the smallest case (3,200 samples).
TAIL_DIFF_SHARE = {"chunk": 1e-4, "small": 2e-3}
# Crafted dense-tail geometries (no stream needed): name -> components as
# (id, h, v, tq), at 4 frames of 270 x 481, so rows end in a short tile
# and in unaligned pixel rows.
TAIL_GEOMETRIES = {
    "YCCK": ((1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1), (4, 1, 1, 0)),
    "luma h=1 v=2": ((1, 1, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)),
}
# A geometry for K11 without a stream: the largest sampling a SOF holds
# (YCCK, every component 15 x 15), whose MCU's 900 blocks overflow a CTA,
# so K11's tiles shrink below one MCU; (id, h, v, tq), height, width.
FAST_GEOMETRY = (tuple((i, 15, 15, i % 2) for i in (1, 2, 3, 4)), 130, 130)
# A geometry for K12's general code (a thread a sample), as FAST_GEOMETRY:
# the second chroma component sampled h=1 v=2, so its 2 x 1 box is neither
# 1 x 1 nor the frame's 2 x 2 cell.  The encoder's EncodeParams never make
# such a frame (chroma is 1 x 1); encode_frame_fast takes any sampling
# that divides.
FAST_ENCODE_GEOMETRY = (((1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 2, 1)), 38, 54)
# Phase 21: the benchmark's decode configurations whose clip frames the
# prep's run walk is held on, the seed they are made from, the rounds
# each walk is timed over, and the two contracts as (the byte-at-a-time
# loop of scanner.cpp, the run walk of ecs_walk.cpp).
WALK_CONFIGS = ("rtp-jpeg-1080p-420-q75-ri4", "rtp-jpeg-1080p-420-q75-ri7",
                "rtp-jpeg-1080p-420-q75-rstless")
WALK_SEED = 3_000_000_019
WALK_ROUNDS = 21
WALK_KINDS = {"flat": ("jt_prep_ecs_flat", "jt_walk_ecs_flat"),
              "rows": ("jt_prep_ecs_rows", "jt_walk_ecs_rows")}
WALK_DIRT = 0xA5C3E1F7  # the output's words before a walk
# The run walk's counters: frames it packed, frames it refused.
WALK_COUNTERS = ("native.ecs_walk_frames", "native.ecs_walk_refused")

# The mixed-quality stream's frames: (bench content seed, quality).
MIXED_QUALITY = ((0, 50), (1, 95), (0, 75), (1, 50))

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


# Peak rates of one H100 SXM at its full 700 W: device memory, and
# operations outside the tensor cores by type.  float32 and float64 are
# NVIDIA's data-sheet rates; the sheet lists no int32 rate, and an SM
# issues half as many 32-bit integer operations per clock as float32 ones
# (64 against 128, the CUDA programming guide's throughput table for
# compute capability 9.0), so int32 is half the float32 rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12, "int32": 33.5e12}

T0 = [time.perf_counter()]  # the run's start, reset by main()


def log(*a) -> None:
    print(*a, flush=True)


def mark(phase: str) -> None:
    """Log the seconds since the run started, at a phase's start."""
    log(f"phase {phase} starts at {time.perf_counter() - T0[0]:.1f} s")


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_err(got, ref) -> int:
    """The largest absolute difference between pairs of integer tensors."""
    return max((int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                for a, b in zip(got, ref) if a.numel()), default=0)


def bound(moved: int, ops: float, kind: str) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of ``moved`` bytes (each input read once, each output written once)
    at the memory rate and ``ops`` operations of type ``kind`` at its peak
    rate.  -> the kernels line's bound keys; no single PyTorch call
    computes any of these kernels' functions, so ``library_ms`` is null."""
    b_ms = moved / HBM_BYTES_PER_S * 1e3
    o_ms = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None}


def segment_bound(plan: ScanPlan, nbits: torch.Tensor, coeffs: torch.Tensor,
                  counts: torch.Tensor) -> dict:
    """``bound`` of a segment decode: each lane's coded bits (``nbits``,
    in whole bytes: the zero padding of its words row is not needed), the
    bit counts and the staged tables in, coefficients and MCU counts out;
    one int32 operation per coded bit (every bit is looked at once)."""
    nb = nbits.to(torch.int64)
    return bound(int(((nb + 7) // 8).sum()) + nbytes(nbits, coeffs, counts)
                 + 4 * place_cuda._staged_ints(plan), int(nb.sum()), "int32")


def log_bound(name: str, ms: float, b: dict, card: str,
              dev_ms: float) -> None:
    """Log a kernel's bound and its roofline share, of the device-only time
    (``dev_ms``) and of the time per call with the wrapper (``ms``)."""
    log(f"bound {name}: {b['bound_ms']} ms by {b['bound_by']}, roofline "
        f"share {b['bound_ms'] / dev_ms} of the device-only {dev_ms} ms, "
        f"{b['bound_ms'] / ms} of {ms} ms a call (wrapper share "
        f"{1 - dev_ms / ms}) [{card}]")


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


def enqueue_ms(fn, reps: int) -> float:
    """Host milliseconds a call to enqueue ``reps`` back-to-back runs of
    ``fn()`` (the wrapper's host time while the card is busy)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def device_ms(fn, reps: int) -> float:
    """Device-only milliseconds of one ``fn()``, the host time of the
    wrapper that launches its work left out: ``reps`` calls captured in
    one CUDA graph, whose replay is timed with CUDA events, over
    ``reps``."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def kernel_ms(name: str, fn, reps: int, card: str) -> tuple:
    """(ms a call from CUDA events over ``reps`` back-to-back calls, the
    wrapper's host time included; device-only ms a call, ``device_ms``),
    logged with the host ms a call to enqueue the same calls.  The
    device-only time comes from a graph, not from torch.profiler: on the
    H100 machine the profiler drops a growing share of device events as a
    run goes on (all of phase 6's kept, ~90% of phase 12's, none of K9's
    in phase 13)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    dev_ms = device_ms(fn, reps)
    log(f"wrapper {name}: {ms} ms a call (CUDA events), device-only "
        f"{dev_ms} ms (CUDA graph of {reps} calls), host {host} ms a call "
        f"to enqueue [{card}]")
    return ms, dev_ms


def profile_window(run, span_prefix: str, card: str, what: str,
                   top: int = 8) -> dict:
    """Card busy share of one ``run()`` under torch.profiler: the union of
    the device events' intervals over the host-clock window, with the
    package's host spans (``span_prefix``*) and the top device kernels.
    -> {device event name: (count, microseconds)}."""
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
    for name, (n, us) in sorted(by_kernel.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        log(f"profile: device {us / 1e3} ms x{n} {name[:100]}")
    return by_kernel


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
    flipped bits each and two stay intact.  Lane 0 is always noise, so
    a chunk of two lanes is damaged too.
    """
    rng = np.random.default_rng(seed)
    w = words.cpu().numpy().view(np.uint32).copy()
    nb = nbits.cpu().numpy().copy()
    S, wn = w.shape
    kind = rng.integers(0, 8, S)
    kind[0] = 0
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


def lane_mcus(dec: DeviceDecoder, frames: int) -> torch.Tensor:
    """Each lane's MCU count in an intact chunk of ``frames`` frames."""
    per = dec.ri or dec.plan.n_mcus
    ends = np.minimum(np.arange(1, dec.segs_per_frame + 1) * per,
                      dec.plan.n_mcus)
    return torch.from_numpy(np.tile(np.diff(ends, prepend=0), frames)
                            .astype(np.int32))


def segment_kernel(dec: DeviceDecoder, plan: ScanPlan, words: torch.Tensor,
                   nbits: torch.Tensor, frames: int):
    """(kernel wrapper, plain version, their arguments) of the segment
    decode a chunk of ``dec``'s stream takes."""
    spf, tb = dec.segs_per_frame, dec.total_blocks
    if region_path(dec.plan, spf, dec.ri, tb):
        return (decode_segments, decode_segments_ref,
                (plan, words, nbits, frames, spf, dec.ri, tb))
    return (decode_segments_general, decode_segments_general_ref,
            (plan, words, nbits, frames, spf, tb))


def compare_kernel(label: str, plan: ScanPlan, words: torch.Tensor,
                   nbits: torch.Tensor, dec: DeviceDecoder, frames: int):
    """Kernel vs plain version on the same card inputs.

    -> (kernel name, max |coeff diff|, mcu_counts - intact lane counts).
    """
    kern, ref, args = segment_kernel(dec, plan, words, nbits, frames)
    ref_c, ref_n = ref(*args)
    err = 0
    # Once on the route the wrapper picks, once with a zero shared-memory
    # budget: every row then exceeds it and takes the register lookahead.
    for budget in (place_cuda.STAGE_BYTES, 0):
        saved, place_cuda.STAGE_BYTES = place_cuda.STAGE_BYTES, budget
        try:
            got_c, got_n = kern(*args)
        finally:
            place_cuda.STAGE_BYTES = saved
        torch.cuda.synchronize()
        err = max(err, int((got_c.to(torch.int64) - ref_c).abs().max()))
        if not (torch.equal(got_c, ref_c) and torch.equal(got_n, ref_n)):
            raise AssertionError(
                f"{label}: {kern.__name__} (stage budget {budget} bytes) "
                f"differs from {ref.__name__} (max |coeff diff| {err}, "
                f"mcu_counts equal: {torch.equal(got_n, ref_n)})"
            )
    short = got_n.cpu() - lane_mcus(dec, frames)
    log(f"kernel-vs-plain {kern.__name__} {label}: {words.shape[0]} lanes "
        f"({int((short < 0).sum())} died short of their MCUs), coeffs "
        f"{tuple(got_c.shape)} and mcu_counts equal on both word routes "
        f"(sum {int(got_n.sum())})")
    return kern.__name__, err, short


def compare_all(cases) -> dict:
    """``compare_kernel`` on each (label, decoder, frames, seed) case
    intact, with damage from ``seed``, and damaged under hostile tables;
    -> max |diff| per kernel name.  Both word routes must have run."""
    routes = dict(place_cuda.ROUTE_LAUNCHES)
    errs = {}
    for label, dec, fr, seed in cases:
        words, nbits, _ = dec.prepare(fr)
        name, err, short = compare_kernel(label, dec.plan, words, nbits, dec,
                                          len(fr))
        errs[name] = max(errs.get(name, 0), err)
        if bool((short != 0).any()):
            raise AssertionError(f"{label}: intact stream lost MCUs")
        bad_w, bad_n = damage(words, nbits, seed)
        for tag, plan in (("damaged", dec.plan),
                          ("damaged, hostile tables", hostile_plan(fr[0]))):
            name, err, short = compare_kernel(f"{label} {tag}", plan, bad_w,
                                              bad_n, dec, len(fr))
            errs[name] = max(errs[name], err)
            if not bool((short < 0).any()):
                raise AssertionError(f"{label} {tag}: no lane died")
    ran = {k: v - routes[k] for k, v in place_cuda.ROUTE_LAUNCHES.items()}
    if min(ran.values()) <= 0:
        raise AssertionError(f"a word route never ran: {ran}")
    log(f"kernel-vs-plain launches by word route: {ran}")
    return errs


def check_dense(label: str, diff: torch.Tensor, share: float,
                name: str = "pixels_to_zz") -> int:
    """Hold a difference of quantized blocks to max |diff| <= 1 with at
    most ``share`` of its entries nonzero; -> max |diff|."""
    diff = diff.to(torch.int64).abs()
    err = int(diff.max()) if diff.numel() else 0
    n = int((diff != 0).sum())
    if err > 1 or n > share * diff.numel():
        raise AssertionError(f"{name}, {label}: max |diff| {err} "
                             f"(allowed 1), {n} of {diff.numel()} differ "
                             f"(allowed {share})")
    log(f"kernel-vs-plain {name} {label}: max |diff| {err}, {n} of "
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
    from jpeg_tpu_torch.entropy.encode_cuda import word_capacity

    frames = zz.shape[0] // enc.blocks_per_frame
    order, seg_of, dc_tab, ac_tab = enc.chunk_tables(frames)
    args = (zz, order, seg_of, dc_tab, ac_tab, ehufco, ehufsi,
            frames * enc.n_segments)
    out = encode_scan(*args)
    ref = encode_scan_ref(*args)
    T = ehufco.shape[0]
    got_h = block_histogram(zz, dc_tab, ac_tab, T)
    ref_h = hist_from_blocks_ref(zz, dc_tab, ac_tab, T)
    torch.cuda.synchronize()
    n_words, cap = int(out[4]), word_capacity(zz.shape[0])
    if n_words > min(cap, out[0].numel()) or \
            (zz.is_cuda and out[0].numel() != cap):
        raise AssertionError(f"{label}: {n_words} words in a buffer of "
                             f"{out[0].numel()}, capacity {cap}")
    got = (out[0][:n_words], *out[1:4])
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
    log(f"kernel-vs-plain {label}: encode_scan {zz.shape[0]} blocks, "
        f"{args[-1]} segments -> {n_words} words ({n_words / cap} of "
        f"word_capacity), {int(got[2].sum())} bits, missing "
        f"{bool(got[3])}; block_histogram {int(got_h.sum())} symbols; equal")
    return err, hist_err


def compare_hist_hostile(dev: torch.device) -> int:
    """``block_histogram`` against ``hist_from_blocks_ref`` on every case
    of ``synth.hostile_hist`` (INT_MIN and +-32767, no EOB, zero runs of
    16, 31 and 47, eight tables; a short last group of blocks), exactly,
    and once added into a caller's histogram (``out=``).  -> max |diff|
    (0)."""
    err = 0
    for case in synth.HIST_CASES:
        zz, dc_tab, ac_tab, T = synth.hostile_hist(case)
        zz, dc_tab, ac_tab = (torch.from_numpy(a).to(dev)
                              for a in (zz, dc_tab, ac_tab))
        ref = hist_from_blocks_ref(zz, dc_tab, ac_tab, T)
        acc = torch.randint(0, 1000, (T, 256), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(3)
                            ).to(dev)
        want = acc + ref
        got = block_histogram(zz, dc_tab, ac_tab, T)
        into = block_histogram(zz, dc_tab, ac_tab, T, out=acc)
        torch.cuda.synchronize()
        err = max(err, int((got.to(torch.int64) - ref).abs().max()),
                  int((into.to(torch.int64) - want).abs().max()))
        if err or into is not acc:
            raise AssertionError(f"block_histogram hostile {case}: differs "
                                 f"from its plain version by {err}")
        log(f"kernel-vs-plain block_histogram hostile {case}: "
            f"{zz.shape[0]} blocks, T={T}, {int(ref.sum())} symbols; equal, "
            f"and added into out=")
    return err


def check_no_sync(label: str, run) -> None:
    """A warm ``run()`` (its constants and chunk tables already on the
    card, whose first upload from pageable memory syncs by design) under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync raises."""
    run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"sync-free: a warm {label} call ran under "
        f"set_sync_debug_mode('error') without a host sync")


def check_tail(label: str, coeffs: torch.Tensor, qt: torch.Tensor,
               geom: FrameGeometry, share: float, clip: bool) -> int:
    """``coeffs_to_pixels`` against ``coeffs_to_pixels_ref`` on the same
    card tensors: max |diff| <= 1 with at most ``share`` of the samples
    differing, and, where ``clip``, both clip ends hit; -> max |diff|."""
    got = coeffs_to_pixels(coeffs, qt, geom)
    want = coeffs_to_pixels_ref(coeffs, qt, geom)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype or \
            not got.is_contiguous():
        raise AssertionError(f"coeffs_to_pixels, {label}: {tuple(got.shape)}"
                             f" {got.dtype} vs plain {tuple(want.shape)} "
                             f"{want.dtype}")
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    err, n = int(diff.max()), int((diff != 0).sum())
    top = (1 << geom.precision) - 1
    lo, hi = int((want == 0).sum()), int((want == top).sum())
    if err > 1 or n > share * diff.numel() or (clip and not (lo and hi)):
        raise AssertionError(f"coeffs_to_pixels, {label}: max |diff| {err} "
                             f"(allowed 1), {n} of {diff.numel()} differ "
                             f"(allowed {share}); clipped {lo} low, {hi} "
                             "high")
    log(f"kernel-vs-plain coeffs_to_pixels {label}: {tuple(got.shape)} "
        f"{got.dtype}, max |diff| {err}, {n} of {diff.numel()} samples "
        f"differ (allowed {share}); clipped {lo} low, {hi} high")
    return err


def mixed_quality_frames(dev: torch.device) -> list:
    """64x48 crops of the bench content encoded by the port at the
    qualities of ``MIXED_QUALITY``, restart interval 2: one geometry and
    the default Huffman tables, each frame its own DQT."""
    out = []
    for seed, q in MIXED_QUALITY:
        ppm = write_pnm(synth.make_frame(seed)[:48, :64].astype(np.float32),
                        64, 48, 8)
        out.append(jpeg_tpu_torch.encode_jpeg(ppm, EncodeParams(
            h=2, v=2, quality=q, optimize=False, restart_interval=2,
            exact=False), dev))
    return out


def dense_tail_phase(card: str, dev: torch.device, streams: dict,
                     decs: dict) -> int:
    """Phase 3b (the dense decode tail); -> the kernel's max |diff| from
    its plain version."""
    mark("3b")
    bench = streams["bench"]
    dec = decs["bench"]
    chunk = [bench[i % len(bench)] for i in range(CHUNK)]
    words, nbits, qt_b = dec.prepare(chunk)
    coeffs, _ = dec.decode_prepared(words, nbits, CHUNK)
    err = check_tail(f"bench chunk x{CHUNK}", coeffs, qt_b, dec.geom,
                     TAIL_DIFF_SHARE["chunk"], False)
    # The same blocks 4 bytes past a 16-byte boundary: the kernel copies
    # them with 4-byte cp.async in place of bulk copies, to the same pixels.
    buf = torch.empty(coeffs.numel() + 1, dtype=torch.int32, device=dev)
    off = buf[1:].view(coeffs.shape)
    off.copy_(coeffs)
    if off.data_ptr() % 16 == 0 or not torch.equal(
            coeffs_to_pixels(off, qt_b, dec.geom),
            coeffs_to_pixels(coeffs, qt_b, dec.geom)):
        raise AssertionError("coeffs_to_pixels: an unaligned view of the "
                             "bench chunk's blocks decodes differently")
    log(f"coeffs_to_pixels: the bench chunk's blocks at an address "
        f"{off.data_ptr() % 16} mod 16 give the same pixels")
    del buf, off
    rng = np.random.default_rng(21)
    for name, fr in streams.items():
        if name == "bench":
            continue
        d = decs[name]
        words, nbits, qt = d.prepare(fr)
        c, _ = d.decode_prepared(words, nbits, len(fr))
        noise = torch.from_numpy(rng.integers(-40, 41, tuple(c.shape))
                                 .astype(np.int32)).to(dev)
        for label, cc, clip in ((name, c, False),
                                (f"{name} + noise", c + noise, True)):
            err = max(err, check_tail(label, cc, qt, d.geom,
                                      TAIL_DIFF_SHARE["small"], clip))
    # Geometries without a stream, seeded coefficients (DC up to +-60, AC
    # up to +-8) and per-frame tables (entries 1..24), both clip ends.
    for label, comps in TAIL_GEOMETRIES.items():
        geom = with_block_grid(FrameGeometry(8, 270, 481, tuple(
            Component(cid=i, h=h, v=v, tq=tq) for i, h, v, tq in comps)))
        tb = sum(c.n_blocks for c in geom.components)
        c = rng.integers(-8, 9, (4, tb, 64)).astype(np.int32)
        c[:, :, 0] = rng.integers(-60, 61, (4, tb))
        q = rng.integers(1, 25, (4, 4, 64)).astype(np.int32)
        err = max(err, check_tail(
            f"{label} 4 x 270x481, seeded", torch.from_numpy(c).to(dev),
            torch.from_numpy(q).to(dev), geom, TAIL_DIFF_SHARE["small"],
            True))
    check_no_sync("coeffs_to_pixels",
                  lambda: coeffs_to_pixels(coeffs, qt_b, dec.geom))

    # A stream whose quality changes from frame to frame decodes on the
    # device path, each frame with its own tables.
    frames = mixed_quality_frames(dev)
    before = default_metrics.counters.get("device_decode.mixed_fallbacks", 0)
    coeffs_to_pixels.launches = 0
    px = DeviceDecoder.for_stream(frames[0], dev).decode_batch(frames,
                                                               chunk=CHUNK)
    torch.cuda.synchronize()
    fell = default_metrics.counters.get("device_decode.mixed_fallbacks",
                                        0) - before
    diffs = []
    for i, f in enumerate(frames):
        own = jpeg_tpu_torch.decode_jpeg(f, dev, exact=False).pixels()
        diffs.append(int(np.abs(px[i].cpu().numpy().astype(np.int64)
                                - own.astype(np.int64)).max()))
    if fell or coeffs_to_pixels.launches != 1 or max(diffs) > 1:
        raise AssertionError(f"mixed-quality stream: {fell} fallbacks, "
                             f"{coeffs_to_pixels.launches} launches, max "
                             f"|diff| per frame {diffs}")
    log(f"mixed quality: {len(frames)} frames at q "
        f"{[q for _, q in MIXED_QUALITY]} decode_batch on {dev}, no "
        f"fallback, 1 coeffs_to_pixels launch; each frame within "
        f"{max(diffs)} of its own decode_jpeg(exact=False) ({diffs})")
    return err


def long_codes(T: int, dev: torch.device):
    """[T, 256] code tables of 16-bit codes for every symbol (not
    prefix-free: the segment encode and the histogram only count and pack
    them), so that worst-case blocks take the most bits."""
    sym = torch.arange(T * 256, dtype=torch.int64).reshape(T, 256)
    return (((sym * 40503) & 0xFFFF).to(torch.int32).to(dev),
            torch.full((T, 256), 16, dtype=torch.int32, device=dev))


def encode_phases(card: str, streams: dict, decs: dict,
                  dev: torch.device) -> list:
    """Phases 7-10 (the encoder); -> the encode kernels' JSON entries."""
    enc = DeviceEncoder.for_config(1080, 1920, 3, BENCH_PARAMS, device=dev)
    px = bench_pixels(dev)
    qt = torch.from_numpy(enc.qtables).to(dev)
    prev = torch.from_numpy(enc.prev_idx).to(dev)
    geom = enc.geom
    T = len(enc.table_keys)

    # ---- 7. encode kernels vs plain versions -----------------------------
    mark("7")
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
    # 4:2:2, 4:4:4 and luma h=1 v=2 (box cells 2x1, 1x1 and 1x2 beside
    # the chunk's 2x2), and MCU padding on both edges, on seeded noise.
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
    # The same pixels at restart interval 7 (the last segment of a frame
    # short), 67 (402-block segments, cut in two pieces) and with one
    # segment per frame (48,960 blocks, cut in pieces of 256).
    for ri in (7, 67, geom.n_mcus):
        e = DeviceEncoder.for_config(
            1080, 1920, 3, EncodeParams(h=2, v=2, quality=75, optimize=False,
                                        restart_interval=ri, exact=False),
            device=dev)
        z = e.dense(chunk)
        errs.append(compare_scan(
            f"bench chunk x{CHUNK} ri={ri} ({e.n_segments} segments per "
            f"frame)", e, z, torch.from_numpy(e.ehufco).to(dev),
            torch.from_numpy(e.ehufsi).to(dev), False))
        if ri == geom.n_mcus:
            largs = (z, *e.chunk_tables(CHUNK),
                     torch.from_numpy(e.ehufco).to(dev),
                     torch.from_numpy(e.ehufsi).to(dev),
                     CHUNK * e.n_segments)
            log(f"time encode_scan_ms={cuda_ms(lambda: encode_scan(*largs), 3)}"
                f" per {CHUNK}-frame 1080p chunk of one segment per frame "
                f"[{card}]")
    # Worst-case blocks: every block takes 1.5-2 KB of bits.
    worst = torch.from_numpy(
        synth.worst_blocks(enc.blocks_per_frame, 16, 16)).to(dev)
    errs.append(compare_scan(
        "worst-case blocks (1 frame, category 16, 16-bit codes)", enc, worst,
        *long_codes(T, dev), False))
    scan_err = max(e[0] for e in errs)
    hist_err = max(max(e[1] for e in errs), compare_hist_hostile(dev))
    order, seg_of, dc_tab, ac_tab = enc.chunk_tables(CHUNK)
    sargs = (zz, order, seg_of, dc_tab, ac_tab,
             torch.from_numpy(enc.ehufco).to(dev),
             torch.from_numpy(enc.ehufsi).to(dev), CHUNK * enc.n_segments)
    check_no_sync("encode_scan", lambda: encode_scan(*sargs))
    check_no_sync("pixels_to_zz", lambda: pixels_to_zz(chunk, qt, prev, geom))

    # ---- 8. encode against JAX (the committed frames) -------------------
    mark("8")
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
    mark("9")
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
    mark("10")
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

    calls = {
        "pixels_to_zz": (lambda: pixels_to_zz(chunk, qt, prev, geom),
                         lambda: pixels_to_zz_ref(chunk, qt, prev, geom)),
        "encode_scan": (lambda: encode_scan(*sargs),
                        lambda: encode_scan_ref(*sargs)),
        "block_histogram": (
            lambda: block_histogram(zz, dc_tab, ac_tab, T),
            lambda: hist_from_blocks_ref(zz, dc_tab, ac_tab, T)),
    }
    # name -> (ms a call, device-only ms, plain ms)
    times = {name: (*kernel_ms(name, kern, 20, card), cuda_ms(plain, 2))
             for name, (kern, plain) in calls.items()}
    scan_out = encode_scan(*sargs)
    hist = block_histogram(zz, dc_tab, ac_tab, T)
    bounds = {
        # The separable 8x8 FDCT: 2 passes of 64 eight-term sums per block,
        # a multiply and an add each
        "pixels_to_zz": bound(nbytes(chunk, qt, prev, zz),
                              zz.shape[0] * 2 * 64 * 8 * 2, "float32"),
        # one operation per coefficient examined
        "encode_scan": bound(nbytes(*sargs[:7], *scan_out[1:3])
                             + 4 * int(scan_out[4]), zz.numel(), "int32"),
        "block_histogram": bound(nbytes(zz, dc_tab, ac_tab, hist),
                                 zz.numel(), "int32"),
    }
    for name, (k_ms, d_ms, p_ms) in times.items():
        log(f"time {name}_ms={k_ms} device_ms={d_ms} plain_ms={p_ms} per "
            f"{CHUNK}-frame 1080p chunk [{card}]")
        log_bound(name, k_ms, bounds[name], card, d_ms)
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
             "device_ms": times[name][1], "plain_ms": times[name][2],
             **bounds[name]}
            for name, src, replaces, n, err in rows]

def frame_tables_phase(card: str, dev: torch.device) -> dict:
    """Phase 20: per-frame optimized tables on the card; -> the per-frame
    histogram kernel's JSON entry."""
    mark("20")
    size = (synth.HEIGHT, synth.WIDTH, 3)
    enc = DeviceEncoder.for_config(*size, BENCH_PARAMS, device=dev)
    cpu = DeviceEncoder.for_config(*size, BENCH_PARAMS, device="cpu")
    px = torch.stack([torch.from_numpy(synth.make_frame(s))
                      for s in range(CHUNK)]).to(dev)
    T = len(enc.table_keys) * CHUNK
    zz = enc.dense(px)
    order, seg_of, dc_tab, ac_tab = enc.chunk_tables(CHUNK, per_frame=True)
    hist = enc.histogram(zz, per_frame=True)
    ref_h = hist_from_blocks_ref(zz, dc_tab, ac_tab, T)
    torch.cuda.synchronize()
    if hist.shape != (T, 256) or not torch.equal(hist.to(torch.int64),
                                                 ref_h.to(torch.int64)):
        raise AssertionError("per-frame block_histogram differs from its "
                             "plain version")
    hist_h = hist.cpu().numpy()
    co, si, headers = enc.frame_tables(hist_h)
    n = CHUNK * enc.n_segments
    args = (zz, order, seg_of, dc_tab, ac_tab, co, si, n)
    out = encode_scan(*args)
    ref = encode_scan_ref(*args)
    torch.cuda.synchronize()
    n_words = int(out[4])
    got = (out[0][:n_words], *out[1:4])
    for name, a, b in zip(("words", "seg_wbase", "seg_bits", "missing"),
                          got, ref):
        if a.shape != b.shape or not torch.equal(a.to(torch.int64),
                                                 b.to(torch.int64)):
            raise AssertionError(f"encode_scan with per-frame tables: "
                                 f"{name} differs from its plain version")
    log(f"kernel-vs-plain per-frame tables x{CHUNK}: block_histogram "
        f"T={T} {int(hist_h.sum())} symbols, encode_scan {zz.shape[0]} "
        f"blocks, {n} segments -> {n_words} words; equal [{card}]")
    # The CPU path on the same blocks of the first two frames: plain
    # kernels, the same native builder and host tail.
    zz_h = zz[:2 * cpu.blocks_per_frame].cpu()
    hist_c = cpu.histogram(zz_h, per_frame=True).numpy()
    co_c, si_c, headers_c = cpu.frame_tables(hist_c)
    want = cpu.pack(zz_h, co_c, si_c, headers_c, per_frame=True)
    frames = enc.pack(zz, co, si, headers, per_frame=True)
    if frames[:2] != want or not (hist_c == hist_h[:len(hist_c)]).all():
        raise AssertionError("per-frame tables: the card's frames differ "
                             "from the CPU path's on the same blocks")
    px16 = torch.cat([px, px.flip(0)])
    counts = ("device_encode.native_table_builds",
              "device_encode.python_table_builds")
    before = [default_metrics.counters[k] for k in counts]
    launches = [f.launches for f in (pixels_to_zz, block_histogram,
                                     encode_scan)]
    batch = enc.encode_batch(px16, optimize="frame", chunk=CHUNK)
    torch.cuda.synchronize()
    launches = [f.launches - b for f, b in zip(
        (pixels_to_zz, block_histogram, encode_scan), launches)]
    builds = [default_metrics.counters[k] - b
              for k, b in zip(counts, before)]
    if batch[:CHUNK] != frames or batch[CHUNK:] != frames[::-1] or \
            launches != [2, 2, 2] or builds != [2 * T, 0]:
        raise AssertionError(f"encode_batch(optimize='frame'): launches "
                             f"(K5, K7, K6) {launches}, (native, python) "
                             f"table builds {builds}, want [2, 2, 2] and "
                             f"[{2 * T}, 0], or bytes that differ")
    log(f"slice: encode_batch(optimize='frame') 16 frames, chunk {CHUNK}: "
        f"launches (K5, K7, K6) {launches} (once a chunk), table builds "
        f"(native, python) {builds}, {len(set(headers))} distinct headers "
        f"of {CHUNK}, {sum(map(len, batch))} bytes; equal to pack [{card}]")
    # Times: the kernels with per-frame and shared tables.
    shared = enc.chunk_tables(CHUNK)
    hist4 = enc.histogram(zz).cpu().numpy()
    co4, si4, _ = enc.optimized_tables(hist4)
    coef_bytes = zz.numel() * 4
    h_ms, hd_ms = kernel_ms(f"block_histogram T={T}",
                            lambda: enc.histogram(zz, per_frame=True), 20,
                            card)
    h4_ms, h4d_ms = kernel_ms("block_histogram T=4",
                              lambda: enc.histogram(zz), 20, card)
    # Each coefficient read once at 2 bytes, the fewest that hold a
    # baseline coefficient (hist_roofline.opt's count), and the [T, 256]
    # int32 histograms written once.
    hist_bound = bound(zz.numel() * 2 + T * 256 * 4, 0, "int32")
    log_bound(f"block_histogram T={T}", h_ms, hist_bound, card, hd_ms)
    log_bound("block_histogram T=4", h4_ms, hist_bound, card, h4d_ms)
    s_ms, sd_ms = kernel_ms(f"encode_scan T={T}",
                            lambda: encode_scan(*args), 20, card)
    s4_ms, s4d_ms = kernel_ms(
        "encode_scan T=4", lambda: encode_scan(zz, *shared, co4, si4, n),
        20, card)
    scan_bound = bound(coef_bytes + n_words * 4, 0, "int32")
    log_bound(f"encode_scan T={T}", s_ms, scan_bound, card, sd_ms)
    log_bound("encode_scan T=4", s4_ms, scan_bound, card, s4d_ms)
    mpix = px16.shape[0] * synth.WIDTH * synth.HEIGHT / 1e6
    for mode in ("frame", False):
        med, runs = median_s(
            lambda: enc.encode_batch(px16, optimize=mode, chunk=CHUNK), 5)
        log(f"time encode_batch[optimize={mode!r}]_Mpix_s={mpix / med} "
            f"(median of 5 runs of 16 frames, host clock; run ms "
            f"{[round(r * 1e3, 3) for r in runs]}) [{card}]")
    profile_window(lambda: enc.encode_batch(px16, optimize="frame",
                                            chunk=CHUNK),
                   "device_encode.", card,
                   "16-frame encode, per-frame tables")
    return {"name": "block_histogram (per-frame tables)", "route": "cuda",
            "source": "jpeg_tpu_torch/csrc/encode_scan.cu",
            "replaces": "jpeg_tpu_torch/tables.py optimize_table per frame",
            "launches": launches[1], "max_abs_err": 0, "ms": h_ms,
            "device_ms": hd_ms, **hist_bound}


def walk_call(lib, fn: str, kind: str, data: bytes, start: int, rows: int,
              cap: int) -> tuple:
    """One walk of ``data`` from ``start`` by ``fn`` under ``kind``'s
    contract, ``rows`` segments at most, ``cap`` words (the flat buffer's,
    or a row's) -> (a call that walks it again into the same buffers,
    (rc, used_words, end_off, starts, lens, out))."""
    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    buf = np.frombuffer(data, np.uint8)
    starts = np.zeros(rows, np.int32)
    lens = np.zeros(rows, np.int32)
    used, end = ctypes.c_int64(-7), ctypes.c_int64(-7)
    head = (ptr(buf, ctypes.c_uint8), buf.size, start)
    if kind == "flat":
        out = np.full(cap, WALK_DIRT, np.uint32)
        args = (*head, ptr(out, ctypes.c_uint32), cap,
                ptr(starts, ctypes.c_int32), ptr(lens, ctypes.c_int32), rows,
                ctypes.byref(used), ctypes.byref(end))
    else:  # the learned order's rows: a permutation
        out = np.full((rows, cap), WALK_DIRT, np.uint32)
        row_map = np.random.default_rng(rows).permutation(rows).astype(
            np.int32)
        args = (*head, ptr(out, ctypes.c_uint32), cap,
                ptr(row_map, ctypes.c_int32), rows,
                ptr(lens, ctypes.c_int32), ctypes.byref(end))
    fn = getattr(lib, fn)
    rc = fn(*args)
    return (lambda: fn(*args)), (rc, used.value, end.value, starts, lens, out)


def ecs_walk_phase(card: str) -> None:
    """Phase 21: the prep's run walk against scanner.cpp's byte-at-a-time
    loops on this host, frame for frame, and both timed."""
    mark("21")
    from jpeg_tpu_torch import native
    from jpeg_tpu_torch.models.device_decode import _first_ecs_byte
    from perfbench import corpus

    lib = native.load_library().lib
    sets = {"bench": frames_of("bench")}
    for name in WALK_CONFIGS:
        path = Path(__file__).resolve().parent / "perfbench" / "configs"
        config = json.loads((path / f"{name}.json").read_text())
        config["name"] = name
        sets[name] = corpus.frames(config, WALK_SEED, 2)[0]
    for label, frames in sets.items():
        for kind, (old_fn, new_fn) in WALK_KINDS.items():
            calls = {"old": [], "new": []}
            for data in frames:
                start = _first_ecs_byte(data)
                _, oracle = walk_call(lib, WALK_KINDS["flat"][0], "flat",
                                      data, start,
                                      data.count(b"\xff", start) + 1,
                                      len(data) // 4 + 16)
                rows, lens = oracle[0], oracle[4]
                if rows <= 0:
                    raise AssertionError(f"ecs walk {label}: the old loop "
                                         f"refused a frame ({rows})")
                cap = len(data) // 4 + 16 if kind == "flat" else \
                    (int(lens[:rows].max()) + 3) // 4 + 1
                again_old, old = walk_call(lib, old_fn, kind, data, start,
                                           rows, cap)
                again_new, new = walk_call(lib, new_fn, kind, data, start,
                                           rows, cap)
                if old[:3] != new[:3] or old[0] != rows or not (
                        np.array_equal(old[3], new[3])
                        and np.array_equal(old[4], new[4])
                        and np.array_equal(old[5], new[5])):
                    raise AssertionError(
                        f"ecs walk {label} {kind}: {new_fn} gives "
                        f"{new[:3]}, {old_fn} {old[:3]}, or their starts, "
                        f"lengths or words differ")
                calls["old"].append(again_old)
                calls["new"].append(again_new)
            ms = {"old": [], "new": []}
            for _ in range(WALK_ROUNDS):
                for which, again in calls.items():
                    t0 = time.perf_counter()
                    for call in again:
                        call()
                    ms[which].append((time.perf_counter() - t0) * 1e3
                                     / len(again))
            old_ms, new_ms = (sorted(ms[w])[WALK_ROUNDS // 2]
                              for w in ("old", "new"))
            log(f"time ecs_walk_ms[{label},{kind}] old={old_ms} "
                f"new={new_ms} ratio={old_ms / new_ms} a frame ({len(frames)}"
                f" frames of {sum(map(len, frames)) // len(frames)} bytes, "
                f"{rows} segments, median of {WALK_ROUNDS} rounds, host "
                f"clock; equal rc, used_words, end_off, starts, lengths "
                f"and words) [{card}]")


def bench_pixels(dev: torch.device) -> torch.Tensor:
    """The 16 frames of 1080p pixels the encode phases use, on ``dev``."""
    uniq = [torch.from_numpy(synth.make_frame(s)) for s in range(2)]
    return torch.stack([uniq[i % 2] for i in range(STREAM_FRAMES)]).to(dev)


def general_launches() -> int:
    """Kernel launches ``csrc/decode_segments.cu`` has made so far (the
    library's own count, kept where it launches)."""
    return int(kernels.load_library().lib.jt_decode_segments_launches())


def general_phase(card: str, dev: torch.device, corpus_err: int,
                  region_ms: float) -> tuple:
    """Phase 11 (general shape at full width); -> (the JSON entries of the
    general kernel and of its layout, which runs in its count walk; frame
    0 of the ri=7 stream).  ``corpus_err`` is the general kernel's max
    |diff| on the corpus (phase 3), ``region_ms`` the one-pass kernel's
    time on the ri=4 bench chunk."""
    mark("11")
    enc = DeviceEncoder.for_config(synth.HEIGHT, synth.WIDTH, 3,
                                   GENERAL_PARAMS, device=dev)
    n_mcus = enc.geom.n_mcus
    if enc.n_segments != -(-n_mcus // 7) or n_mcus % 7 == 0 or \
            enc.geom.m_x % 7 == 0:
        raise AssertionError(f"ri=7 encoder has {enc.n_segments} segments")
    px = bench_pixels(dev)
    frames = enc.encode_batch(px, optimize=False, chunk=CHUNK)
    stream = b"".join(frames)
    decode_segments.launches = decode_segments_general.launches = 0
    coeffs_to_pixels.launches = 0
    walks0 = general_launches()
    out = jpeg_tpu_torch.mjpeg.decode_stream_device(stream, dev,
                                                    chunk=CHUNK)
    torch.cuda.synchronize()
    launches = decode_segments_general.launches
    # The general path's device launches, each counted where the library
    # launches it: count (with the layout), place, resolve.
    walks = general_launches() - walks0
    tail_launches = coeffs_to_pixels.launches
    if launches <= 0 or walks != 3 * launches or tail_launches <= 0 or \
            decode_segments.launches:
        raise AssertionError(
            f"ri=7 stream: decode_segments_general launched {launches} "
            f"times ({walks} kernel launches, want 3 a call), "
            f"coeffs_to_pixels {tail_launches}, decode_segments "
            f"{decode_segments.launches}")
    want = (STREAM_FRAMES, synth.HEIGHT, synth.WIDTH, 3)
    if tuple(out.shape) != want or out.dtype != torch.uint8 or \
            out.device.type != dev.type:
        raise AssertionError(f"ri=7 output {tuple(out.shape)} {out.dtype}")
    dec = DeviceDecoder.for_stream(frames[0], dev)
    coeffs = dec.decode_coeffs_batch(frames, chunk=CHUNK)
    blocks = torch.cat([enc.dense(px[i:i + CHUNK])
                        for i in range(0, STREAM_FRAMES, CHUNK)])
    prev = torch.from_numpy(enc.prev_idx).to(dev)
    if not torch.equal(raster_to_zz(coeffs, prev), blocks):
        raise AssertionError("ri=7 stream: decoded blocks differ from the "
                             "encoder's")
    cpu = DeviceDecoder.for_stream(frames[0], "cpu").decode_batch(frames[:1])
    diff = int((out[0].cpu().to(torch.int16) - cpu[0].to(torch.int16))
               .abs().max())
    if diff > 1:
        raise AssertionError(f"ri=7 frame 0 differs from the CPU decode by "
                             f"{diff}")
    log(f"general: decode_stream_device of {STREAM_FRAMES} ri=7 frames "
        f"({dec.segs_per_frame} segments per frame) -> {want} uint8, "
        f"decode_segments_general launches {launches} ({walks} kernel "
        f"launches: count with the layout, place, resolve), "
        f"coeffs_to_pixels {tail_launches}, decode_segments 0; "
        f"blocks equal to the encoder's, frame 0 vs CPU max diff {diff}")

    chunk = frames[:CHUNK]
    errs = compare_all([(f"ri=7 1080p chunk x{CHUNK}", dec, chunk, 0)])
    words, nbits, _ = dec.prepare(chunk)
    spf = dec.segs_per_frame
    args = (dec.plan, words, nbits, CHUNK, spf, dec.total_blocks)
    # Contested MCUs (two lanes write them; only these take owner keys),
    # from the plain scan: none on the intact chunk.  The layout the count
    # walk computes (its launch alone, ``_general_layout``) against the
    # plain scan's counts and partial flags, ``lane_layout`` and
    # ``contested_rows``, integer for integer.
    layout_err = 0
    names = ("counts", "partial", "lane_off", "lane_first", "contested")
    for tag, (w, n) in (("damaged", damage(words, nbits, 0)),
                        ("intact", (words, nbits))):
        largs = (dec.plan, w, n, CHUNK, spf, dec.total_blocks)
        got = place_cuda._general_layout(*largs)
        counts, key, _, _ = scan_lanes(dec.plan, w, n)
        partial = place_cuda.partial_lanes(counts, key)
        want = (counts, partial, *place_cuda.lane_layout(counts, CHUNK, spf),
                place_cuda.contested_rows(counts, partial, CHUNK, spf,
                                          dec.plan.n_mcus))
        torch.cuda.synchronize()
        for name, a, b in zip(names, got, want):
            if a.dtype != torch.int32 or not torch.equal(a, b):
                raise AssertionError(
                    f"the count walk's {name} differs from the plain "
                    f"version on the {tag} chunk (max |diff| "
                    f"{int((a.to(torch.int64) - b).abs().max())})")
        n_rows = int(want[4].sum())
        log(f"general: {tag} ri=7 chunk x{CHUNK}: {int(partial.sum())} "
            f"lanes died mid-MCU, {n_rows} contested MCUs; the count walk's "
            f"counts, partial flags and layout equal to the plain scan's, "
            f"lane_layout and contested_rows")
        if tag == "intact" and n_rows:
            raise AssertionError("intact ri=7 chunk has contested MCUs")
        if tag == "damaged" and not n_rows:
            raise AssertionError("damaged ri=7 chunk contests no MCU")
    walks0 = general_launches()
    decode_segments_general(*args)
    torch.cuda.synchronize()
    if general_launches() - walks0 != 3:
        raise AssertionError(f"decode_segments_general made "
                             f"{general_launches() - walks0} kernel "
                             f"launches, want 3")
    # The layout has no launch of its own: time the count walk it rides
    # (ms and device-only) on the intact chunk, against the plain scan and
    # layout, with the count walk's bound (the coded bits, tables and bit
    # counts in; the counts, flags and layout out; an operation a coded
    # bit).
    l_ms, ld_ms = kernel_ms("count walk with its layout",
                            lambda: place_cuda._general_layout(*largs), 20,
                            card)
    lp_ms = cuda_ms(lambda: (place_cuda.lane_layout(counts, CHUNK, spf),
                             place_cuda.contested_rows(
                                 counts, partial, CHUNK, spf,
                                 dec.plan.n_mcus)), 20)

    def plain_layout():
        c, k, _, _ = scan_lanes(dec.plan, w, n)
        pl = place_cuda.partial_lanes(c, k)
        return (place_cuda.lane_layout(c, CHUNK, spf),
                place_cuda.contested_rows(c, pl, CHUNK, spf,
                                          dec.plan.n_mcus))
    sp_ms = cuda_ms(plain_layout, 1)
    nb64 = n.to(torch.int64)
    lb = bound(int(((nb64 + 7) // 8).sum()) + nbytes(n, *got)
               + 4 * place_cuda._staged_ints(dec.plan), int(nb64.sum()),
               "int32")
    log(f"time boundary_layout_ms={l_ms} device_ms={ld_ms} (the count walk "
        f"with the layout folded in) plain_ms={sp_ms} (plain scan and "
        f"layout), plain layout alone {lp_ms} ms, per "
        f"{CHUNK}-frame ri=7 chunk [{card}]")
    log_bound("boundary_layout (count walk)", l_ms, lb, card, ld_ms)
    k_ms, kd_ms = kernel_ms("decode_segments_general",
                            lambda: decode_segments_general(*args), 20, card)
    p_ms = cuda_ms(lambda: decode_segments_general_ref(*args), 2)
    log(f"time decode_segments_general_ms={k_ms} device_ms={kd_ms} "
        f"plain_ms={p_ms} per "
        f"{CHUNK}-frame ri=7 1080p chunk ({words.shape[0]} lanes); "
        f"decode_segments_ms={region_ms} on the ri=4 bench chunk [{card}]")
    b = segment_bound(dec.plan, nbits, *decode_segments_general(*args))
    log_bound("decode_segments_general", k_ms, b, card, kd_ms)
    mpix = STREAM_FRAMES * synth.WIDTH * synth.HEIGHT / 1e6
    med, runs = median_s(lambda: jpeg_tpu_torch.mjpeg.decode_stream_device(
        stream, dev, chunk=CHUNK), E2E_RUNS)
    log(f"time general_e2e_stream_Mpix_s={mpix / med} (median of {len(runs)} "
        f"runs of {STREAM_FRAMES} ri=7 frames from bytes; run ms "
        f"{[round(r * 1e3, 3) for r in runs]}) [{card}]")
    return [{"name": "decode_segments_general", "route": "cuda",
             "source": "jpeg_tpu_torch/csrc/decode_segments.cu",
             "replaces": "jpeg_tpu/entropy/lockstep_jax.py:568",
             "launches": launches,
             "max_abs_err": max(corpus_err, errs["decode_segments_general"]),
             "ms": k_ms, "device_ms": kd_ms, "plain_ms": p_ms, **b},
            {"name": "boundary_layout", "route": "cuda",
             "source": "jpeg_tpu_torch/csrc/decode_segments.cu (frame_layout,"
                       " in the count walk of decode_segments_general)",
             "replaces": "jpeg_tpu/entropy/lockstep_jax.py:595",
             "launches": launches, "max_abs_err": layout_err,
             "ms": l_ms, "device_ms": ld_ms, "plain_ms": sp_ms, **lb}], \
        frames[0]


def bitwise(name: str, label: str, got: torch.Tensor,
            ref: torch.Tensor) -> float:
    """Hold a K4 kernel's output to its plain version's, bit for bit;
    -> max |diff| (0.0)."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name} {label}: {tuple(got.shape)} "
                             f"{got.dtype} vs plain {tuple(ref.shape)} "
                             f"{ref.dtype}")
    err = float((got.to(torch.float64) - ref.to(torch.float64)).abs().max())
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        n = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        raise AssertionError(f"{name} {label}: {n} of {got.numel()} values "
                             f"differ from the plain version (max |diff| "
                             f"{err})")
    log(f"kernel-vs-plain {name} {label}: {got.numel()} values bitwise equal")
    return err


def plain_versions():
    """(module, name) of every plain version the single-image device
    entropy path could reach instead of a kernel: the segment decodes' and
    the exact dense kernels' plain versions, and the host engines."""
    from jpeg_tpu_torch.entropy import lockstep, lockstep_jax, serial
    from jpeg_tpu_torch.entropy import lockstep_torch
    from jpeg_tpu_torch.entropy import native as native_entropy
    from jpeg_tpu_torch.models import dense_exact

    return ((place_cuda, "decode_segments_general_ref"),
            (place_cuda, "decode_segments_ref"),
            (place_cuda, "scan_lanes"), (place_cuda, "place_emissions"),
            (lockstep_torch, "scan_lanes"),
            (lockstep_jax, "decode_segments_general_ref"),
            (dense_exact, "idct_exact_ref"), (dense_exact, "color_exact_ref"),
            (serial, "decode_scan_serial"),
            (lockstep, "decode_scan_lockstep"),
            (native_entropy, "decode_scan_native"))


@contextlib.contextmanager
def no_plain_version():
    """Every ``plain_versions()`` entry raises while the block runs."""
    saved = [(mod, name, getattr(mod, name))
             for mod, name in plain_versions()]

    def trap(name):
        def run(*args, **kwargs):
            raise AssertionError(f"{name} (a plain version or host engine) "
                                 "ran on the device entropy path")
        return run

    for mod, name, _ in saved:
        setattr(mod, name, trap(name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def damage_frame(frame: bytes, every: int) -> bytes:
    """A JPEG frame with two stuffed 0xFF bytes (16 one-bits, no code of
    the K.3 tables) in the middle of every ``every``-th restart segment
    from the second on, each lane dying there; segments whose middle
    follows a 0xFF byte are skipped, so no marker is made."""
    out = bytearray(frame)
    ranges = parse_codestream(frame).scans[0].ecs_ranges
    for s, e in ranges[1::every]:
        mid = (s + e) // 2
        if e - s > 8 and out[mid - 1] != 0xFF:
            out[mid : mid + 4] = b"\xff\x00\xff\x00"
    return bytes(out)


def cut_frame(frame: bytes, every: int) -> bytes:
    """A JPEG frame with the second half of every ``every``-th restart
    segment cut out, its marker kept: those lanes run out of bits inside
    a symbol, where the flat prep's words past the segment are the next
    segment's."""
    out, prev = bytearray(), 0
    for i, (s, e) in enumerate(parse_codestream(frame).scans[0].ecs_ranges):
        if i % every == 1 and e - s > 2:
            mid = s + (e - s) // 2
            mid -= frame[mid - 1] == 0xFF  # keep a stuffed 0xFF 0x00 whole
            out += frame[prev:mid]
            prev = e
    return bytes(out + frame[prev:])


def device_entropy_checks(dev: torch.device, bench0: bytes, ri7: bytes,
                          want_pnm: str) -> dict:
    """The single-image device entropy path (``entropy="lockstep-jax"``):
    the exact decode of bench frame 0 (ri=4) and of a ri=7 frame on
    ``dev``, with every plain version trapped, to jpeg_tpu's digest
    (``want_pnm``, frame 0) and to the host lockstep engine's
    coefficients and pixels; each decode's launches (one general decode,
    3 kernel launches, ``idct_exact`` a component, ``color_exact`` once);
    a damaged ri=7 frame to the same coefficients on ``dev`` and on the
    CPU.  -> {kernel: launches over the two decodes}."""
    total = {"decode_segments_general": 0, "general kernel launches": 0,
             "idct_exact": 0, "color_exact": 0}
    serial_scans = default_metrics.counters.get("lockstep_jax.serial_scans",
                                                0)
    for label, frame in (("bench frame 0, ri=4", bench0),
                         ("ri=7 frame 0", ri7)):
        host = jpeg_tpu_torch.decode_jpeg(frame, dev, exact=True,
                                          entropy="lockstep")
        decode_segments.launches = decode_segments_general.launches = 0
        idct_exact.launches = color_exact.launches = 0
        walks0 = general_launches()
        with no_plain_version():
            img = jpeg_tpu_torch.decode_jpeg(frame, dev, exact=True,
                                             entropy="lockstep-jax")
            torch.cuda.synchronize()
        got = {"decode_segments_general": decode_segments_general.launches,
               "general kernel launches": general_launches() - walks0,
               "idct_exact": idct_exact.launches,
               "color_exact": color_exact.launches}
        want = {"decode_segments_general": 1, "general kernel launches": 3,
                "idct_exact": len(img.geometry.components),
                "color_exact": 1}
        if got != want or decode_segments.launches:
            raise AssertionError(f"lockstep-jax {label}: launches {got}, "
                                 f"want {want} and no decode_segments")
        for k, v in got.items():
            total[k] += v
        pnm = img.to_pnm()
        if pnm != host.to_pnm() or img.codestream.mcus_decoded != \
                host.codestream.mcus_decoded:
            raise AssertionError(f"lockstep-jax {label}: pixels or MCU "
                                 f"counts differ from entropy='lockstep'")
        for cid, plane in host.coefficients.items():
            if not np.array_equal(img.coefficients[cid], plane):
                raise AssertionError(f"lockstep-jax {label}: component "
                                     f"{cid} differs from entropy="
                                     f"'lockstep'")
        if frame is bench0 and hashlib.sha256(pnm).hexdigest() != want_pnm:
            raise AssertionError("lockstep-jax exact 1080p decode differs "
                                 "from jpeg_tpu's to_pnm() digest")
        log(f"single: decode_jpeg({label}, {dev}, exact=True, "
            f"entropy='lockstep-jax'): coefficients, MCU counts and "
            f"to_pnm() equal to entropy='lockstep'"
            f"{' and to jpeg_tpu digest' if frame is bench0 else ''}; "
            f"launches {got}; no plain version ran")
    if default_metrics.counters.get("lockstep_jax.serial_scans", 0) != \
            serial_scans:
        raise AssertionError("lockstep-jax sent a 1080p scan to the serial "
                             "oracle")
    bad = damage_frame(ri7, 37)
    cs_d, planes_d = jpeg_tpu_torch.decode_coefficients(
        bad, entropy="lockstep-jax", device=dev)
    cs_c, planes_c = jpeg_tpu_torch.decode_coefficients(
        bad, entropy="lockstep-jax", device="cpu")
    n_mcus = cs_d.geometry.n_mcus
    if cs_d.mcus_decoded != cs_c.mcus_decoded or any(
            not np.array_equal(planes_d[c], planes_c[c]) for c in planes_c):
        raise AssertionError("lockstep-jax: the damaged ri=7 frame decodes "
                             "differently on the card and on the CPU")
    if cs_d.mcus_decoded[0] >= n_mcus:
        raise AssertionError("the damaged ri=7 frame lost no MCU")
    log(f"single: damaged ri=7 frame ({cs_d.mcus_decoded[0]} of {n_mcus} "
        f"MCUs decoded): lockstep-jax coefficients equal on {dev} and on "
        f"the CPU (plain versions)")
    return total


def single_image_phase(card: str, dev: torch.device, streams: dict,
                       ri7: bytes) -> list:
    """Phase 12 (the single-image API, exact mode, host and device
    entropy); -> the K4 kernels' JSON entries.  ``ri7`` is frame 0 of
    phase 11's ri=7 stream."""
    mark("12")
    exact = json.loads((CORPUS / "exact.json").read_text())
    bench0 = streams["bench"][0]
    # -- the exact decode path, at 1080p
    idct_exact.launches = color_exact.launches = 0
    img = jpeg_tpu_torch.decode_jpeg(bench0, dev, exact=True)
    torch.cuda.synchronize()
    dec_launches = (idct_exact.launches, color_exact.launches)
    if min(dec_launches) <= 0:
        raise AssertionError(f"exact decode skipped a kernel: {dec_launches}")
    got = hashlib.sha256(img.to_pnm()).hexdigest()
    if got != exact["pnm"]["bench"][0]:
        raise AssertionError("exact 1080p decode differs from jpeg_tpu's "
                             "to_pnm() digest")
    log(f"single: decode_jpeg(bench frame 0, {dev}, exact=True).to_pnm() "
        f"equals jpeg_tpu's digest; launches idct_exact {dec_launches[0]}, "
        f"color_exact {dec_launches[1]}")
    for name, want in exact["pnm"].items():
        if name == "bench":
            continue
        fr = frames_of(name)
        got = [hashlib.sha256(jpeg_tpu_torch.decode_jpeg(f, dev)
                              .to_pnm()).hexdigest() for f in fr]
        if got != want:
            raise AssertionError(f"{name}: exact decode differs from "
                                 "jpeg_tpu's to_pnm() digests")
    log(f"single: exact to_pnm() of {len(exact['pnm']) - 1} small corpus "
        f"streams equal to jpeg_tpu's digests")
    lj_launches = device_entropy_checks(dev, bench0, ri7,
                                        exact["pnm"]["bench"][0])
    for name in MULTISCAN:
        frame = frames_of(name)[0]
        got = jpeg_tpu_torch.decode_frame_device(frame, dev)
        cpu = jpeg_tpu_torch.decode_frame_device(frame, "cpu")
        diff = int((got.cpu().to(torch.int16) - cpu.to(torch.int16))
                   .abs().max())
        if got.device.type != dev.type or got.shape != cpu.shape or diff > 1:
            raise AssertionError(f"{name}: decode_frame_device differs from "
                                 f"its CPU run by {diff}")
        log(f"single: decode_frame_device {name} {tuple(got.shape)} on {dev}, "
            f"max diff {diff} against the CPU run")
    mixed = frames_of("mixed_420_ri2")
    before = default_metrics.counters.get("device_decode.mixed_fallbacks", 0)
    decode_frame_fast.launches = 0
    px = DeviceDecoder.for_stream(mixed[0], dev).decode_batch(mixed, chunk=1)
    fell = default_metrics.counters["device_decode.mixed_fallbacks"] - before
    # chunk=1: a chunk that falls back is one frame, one K11 launch
    if fell != 1 or px.device.type != dev.type or px.shape[0] != len(mixed) \
            or decode_frame_fast.launches != fell:
        raise AssertionError(f"mixed stream: {fell} fallbacks, want 1, and "
                             f"{decode_frame_fast.launches} K11 launches")
    log(f"single: mixed stream {tuple(px.shape)} on {dev}, 1 chunk fell back "
        f"to per-frame decode (device_decode.mixed_fallbacks), "
        f"{decode_frame_fast.launches} K11 launch")

    # -- the exact encode path, at 1080p
    ppm = synth.make_frame_ppm(0)
    fdct_exact.launches = 0
    enc_color = 0
    for name, rec in exact["encode"].items():
        color_exact.launches = 0
        data = jpeg_tpu_torch.encode_jpeg(
            ppm, EncodeParams(exact=True, **rec["params"]), dev)
        enc_color += color_exact.launches
        if hashlib.sha256(data).hexdigest() != rec["sha256"] or \
                len(data) != rec["bytes"]:
            raise AssertionError(f"exact encode {name}: {len(data)} bytes, "
                                 "differs from jpeg_tpu's digest")
        log(f"single: encode_jpeg({name}, {dev}, exact=True) byte-identical "
            f"to jpeg_tpu's ({len(data)} bytes)")
    if fdct_exact.launches <= 0 or enc_color <= 0:
        raise AssertionError("exact encode skipped a kernel")
    launches = {"idct_exact": dec_launches[0],
                "fdct_exact": fdct_exact.launches,
                "color_exact": dec_launches[1] + enc_color}

    # -- each K4 kernel against its plain version
    cs, planes = jpeg_tpu_torch.decode_coefficients(bench0)
    qt = torch.from_numpy(cs.qtables.astype(np.int32)).to(dev)
    rgb = torch.from_numpy(synth.make_frame(0)).to(dev).to(torch.float32)
    ycc = color_exact_ref(rgb, 8, "to_ycc")
    rng = np.random.default_rng(12)
    rnd_c = torch.from_numpy(rng.integers(-1024, 1024, (4096, 64))
                             .astype(np.int32)).to(dev)
    rnd_q = torch.from_numpy(rng.integers(1, 256, 64).astype(np.int32)
                             ).to(dev)
    rnd_s = torch.from_numpy(rng.uniform(0, 4095, (4096, 64))
                             .astype(np.float32)).to(dev)
    rnd_px = torch.from_numpy(rng.uniform(-100, 4200, (65536, 4))
                              .astype(np.float32)).to(dev)
    errs = {n: 0.0 for n in launches}
    for comp in cs.geometry.components:
        c = torch.from_numpy(planes[comp.cid]).to(dev)
        args = (c, qt[comp.tq], 8)
        errs["idct_exact"] = max(errs["idct_exact"], bitwise(
            "idct_exact", f"1080p component {comp.cid} {tuple(c.shape)}",
            idct_exact(*args), idct_exact_ref(*args)))
    for prec in (8, 12):
        args = (rnd_c, rnd_q, prec)
        errs["idct_exact"] = max(errs["idct_exact"], bitwise(
            "idct_exact", f"random {prec}-bit blocks", idct_exact(*args),
            idct_exact_ref(*args)))
    # The Y plane at an address 4 bytes past a 16-byte boundary (the
    # kernel's scalar loads and stores), and block counts that leave a
    # warp step part empty.
    c_y = torch.from_numpy(planes[cs.geometry.components[0].cid]).to(dev)
    c_off = torch.empty(c_y.numel() + 1, dtype=torch.int32,
                        device=dev)[1:].view(-1, 64)
    c_off.copy_(c_y)
    for label, c, q, prec in (
            ("1080p Y plane 4 bytes off 16", c_off, qt[0], 8),
            ("1080p Y plane less 3 blocks", c_y[:-3], qt[0], 8),
            ("random 12-bit blocks less 1", rnd_c[:-1], rnd_q, 12)):
        args = (c, q, prec)
        errs["idct_exact"] = max(errs["idct_exact"], bitwise(
            "idct_exact", f"{label} {tuple(c.shape)}", idct_exact(*args),
            idct_exact_ref(*args)))
    y_blocks = plane_to_blocks(ycc[..., 0], 135, 240).reshape(-1, 64)
    cb_blocks = plane_to_blocks(downsample_box(ycc[:1072, :, 1], 2, 2), 67,
                                120).reshape(-1, 64)
    # the hostile cases of the CPU tests, and the Y plane at an address 4
    # bytes past a 16-byte boundary (the kernel's scalar loads and stores)
    hostile = []
    for case in synth.FDCT_CASES:
        samples, q, bits = synth.hostile_fdct(case)
        hostile.append((f"hostile {case}", torch.from_numpy(samples).to(dev),
                        torch.from_numpy(q).to(dev), bits))
    shifted = torch.empty(y_blocks.numel() + 1, dtype=torch.float32,
                          device=dev)[1:].view(-1, 64)
    shifted.copy_(y_blocks)
    for label, blocks, q, prec in (
            ("1080p Y plane", y_blocks, qt[0], 8),
            ("1080p Cb plane (box 2x2)", cb_blocks, qt[1], 8),
            ("random 12-bit samples", rnd_s, rnd_q, 12),
            ("1080p Y plane 4 bytes off 16", shifted, qt[0], 8), *hostile):
        args = (blocks.contiguous(), q, prec)
        errs["fdct_exact"] = max(errs["fdct_exact"], bitwise(
            "fdct_exact", f"{label} {tuple(blocks.shape)}",
            fdct_exact(*args), fdct_exact_ref(*args)))
    for label, pix, mode, prec in (
            ("1080p RGB -> YCbCr", rgb, "to_ycc", 8),
            ("1080p YCbCr -> RGB", ycc, "to_rgb", 8),
            ("random 12-bit YCbCr -> RGB", rnd_px[:, :3].contiguous(),
             "to_rgb", 12),
            ("random YCCK -> RGB", rnd_px, "to_rgb", 8),
            ("random RGB -> YCbCr", rnd_px[:, :3].contiguous(), "to_ycc",
             12)):
        errs["color_exact"] = max(errs["color_exact"], bitwise(
            "color_exact", f"{label} {tuple(pix.shape)}",
            color_exact(pix, prec, mode), color_exact_ref(pix, prec, mode)))

    # Where a single image's time goes: the whole call (host clock) and
    # one stage of it.
    params0 = EncodeParams(exact=True,
                           **next(iter(exact["encode"].values()))["params"])
    enc_geom, padded, enc_qt = encode_inputs(ppm, params0, dev)
    for key, run, part, what in (
            ("exact_decode_ms",
             lambda: jpeg_tpu_torch.decode_jpeg(bench0, dev, exact=True),
             lambda: jpeg_tpu_torch.decode_coefficients(bench0),
             "host entropy decode (decode_coefficients)"),
            ("exact_decode_ms[lockstep-jax]",
             lambda: jpeg_tpu_torch.decode_jpeg(bench0, dev, exact=True,
                                                entropy="lockstep-jax"),
             lambda: jpeg_tpu_torch.decode_coefficients(
                 bench0, entropy="lockstep-jax", device=dev),
             f"device entropy decode on {dev} (decode_coefficients)"),
            ("exact_encode_ms",
             lambda: jpeg_tpu_torch.encode_jpeg(ppm, params0, dev),
             lambda: encode_frame(padded, enc_geom, enc_qt, True),
             f"dense stage on {dev} (encode_frame)")):
        med, runs = median_s(run, 2)
        med_p, _ = median_s(part, 2)
        log(f"time {key}={med * 1e3} (1080p, median of {len(runs)} runs, "
            f"host clock; {what} {med_p * 1e3} ms) [{card}]")

    y_in = y_blocks.contiguous()
    calls = {
        "idct_exact": (lambda: idct_exact(c_y, qt[0], 8),
                       lambda: idct_exact_ref(c_y, qt[0], 8)),
        "fdct_exact": (lambda: fdct_exact(y_in, qt[0], 8),
                       lambda: fdct_exact_ref(y_in, qt[0], 8)),
        "color_exact": (lambda: color_exact(ycc, 8, "to_rgb"),
                        lambda: color_exact_ref(ycc, 8, "to_rgb")),
    }
    # name -> (ms a call, device-only ms, plain ms)
    times = {name: (*kernel_ms(name, kern, 20, card), cuda_ms(plain, 2))
             for name, (kern, plain) in calls.items()}
    what = {"idct_exact": f"1080p Y plane, {c_y.shape[0]} blocks",
            "fdct_exact": f"1080p Y plane, {y_in.shape[0]} blocks",
            "color_exact": "1080p frame, YCbCr -> RGB"}
    # Separable 8x8 transforms: 2 passes of 64 eight-term sums (a multiply
    # and an add per term) per block; colour: ~10 operations per pixel.
    bounds = {
        "idct_exact": bound(nbytes(c_y, qt[0], idct_exact(c_y, qt[0], 8)),
                            c_y.shape[0] * 2 * 64 * 8 * 2, "float32"),
        "fdct_exact": bound(nbytes(y_in, qt[0], fdct_exact(y_in, qt[0], 8)),
                            y_in.shape[0] * 2 * 64 * 8 * 2, "float32"),
        "color_exact": bound(nbytes(ycc, color_exact(ycc, 8, "to_rgb")),
                             ycc.shape[0] * ycc.shape[1] * 10, "float64"),
    }
    for name, (k_ms, d_ms, p_ms) in times.items():
        log(f"time {name}_ms={k_ms} device_ms={d_ms} plain_ms={p_ms} per "
            f"{what[name]} [{card}]")
        log_bound(name, k_ms, bounds[name], card, d_ms)
    log(f"single: launches of the two lockstep-jax decodes {lj_launches}")
    return [{"name": name, "route": "cuda",
             "source": "jpeg_tpu_torch/csrc/dense_exact.cu",
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": errs[name], "ms": times[name][0],
             "device_ms": times[name][1], "plain_ms": times[name][2],
             **bounds[name]}
            for name, replaces in (
                ("idct_exact", "jpeg_tpu/ops/dct.py:70"),
                ("fdct_exact", "jpeg_tpu/ops/dct.py:81"),
                ("color_exact", "jpeg_tpu/ops/color.py:53"))]


# Small RST-less geometries: name -> (components, h, v, height, width,
# bits), three frames of seeded content each.
RSTLESS_SMALL = {"4:2:0": (3, 2, 2, 64, 96, 8), "4:2:2": (3, 2, 1, 48, 80, 8),
                 "4:4:4": (3, 1, 1, 40, 64, 8), "gray": (1, 1, 1, 56, 72, 8),
                 "gray 12-bit": (1, 1, 1, 48, 64, 12)}


def seeded_pnm(comps: int, height: int, width: int, bits: int,
               seed: int, noise: float = 0.05) -> bytes:
    """A PGM/PPM of smooth seeded content with gaussian noise of ``noise``
    full scale (16-bit samples, big-endian, above 8 bits)."""
    rng = np.random.default_rng(seed)
    maxval = (1 << bits) - 1
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    chans = [0.5 + 0.4 * np.sin(xx / (7.0 + 3 * c) + seed)
             * np.cos(yy / (5.0 + 2 * c)) for c in range(comps)]
    img = np.stack(chans, -1) + rng.normal(0, noise, (height, width, comps))
    samples = np.clip(np.round(img * maxval), 0, maxval)
    dt = ">u2" if maxval > 255 else np.uint8
    magic = b"P6" if comps == 3 else b"P5"
    return (magic + b"\n%d %d\n%d\n" % (width, height, maxval)
            + samples.astype(dt).tobytes())


def drop_dri(jpeg: bytes) -> bytes:
    """The frame without its DRI segment (FFDD 0004 nnnn) before SOS."""
    at = jpeg.find(b"\xff\xdd\x00\x04")
    if at < 0 or at > jpeg.find(b"\xff\xda"):
        raise AssertionError("no DRI segment before the scan")
    return jpeg[:at] + jpeg[at + 6:]


def rstless_modules():
    """(engine, kernel wrappers, plain versions) of the RST-less decode,
    imported when a phase runs: a ``--time-tree`` worker may import a
    checkout that lacks them."""
    from jpeg_tpu_torch.entropy import speculative as core
    from jpeg_tpu_torch.entropy import speculative_cuda as sc
    from jpeg_tpu_torch.entropy import speculative_torch as st
    return core, sc, st


def rstless_compare(label: str, plan: ScanPlan, tb: int, segs,
                    dev: torch.device, chunk_bytes: int, strip_bytes: int,
                    piece_bytes: int, damaged: bool = False) -> tuple:
    """Hold K8, K9 and K10 to their plain versions bit for bit on one
    batch; K9 and K10 run on the kernel's outputs of the stage before, K10
    also where K9 left a frame unresolved.  -> (the batch's resolve stats
    (rounds, recovery rows, mispredicts), {kernel: largest absolute
    difference from its plain version})."""
    core, sc, st = rstless_modules()
    words, nbits, rows = core.prepare_batch(segs, dev, chunk_bytes)
    if damaged:
        words, nbits = damage(words, nbits, 0)
    cb, sb, pb = chunk_bytes * 8, strip_bytes * 8, piece_bytes * 8
    k = sc.sync(plan, words, nbits, rows, cb, sb, pb)
    p = st.sync_ref(plan, words, nbits, rows, cb, sb, pb)
    torch.cuda.synchronize()
    errs = {"rstless_sync": max_err(k, p)}
    for name, a, b in zip(("links", "member", "marks"), k, p):
        if not torch.equal(a, b):
            raise AssertionError(f"rstless_sync {label}: {name} differs from "
                                 f"the plain version in "
                                 f"{int((a != b).sum())} entries")
    links, member, marks = k
    rounds = 1 + max(int(c) for c in np.diff(rows.row0))
    res_k = sc.resolve(plan, words, nbits, rows, links, member, marks, cb,
                       sb, pb, rounds)
    res_p = st.resolve_ref(plan, words, nbits, rows, links, member, marks,
                           cb, sb, pb, rounds)
    fs = res_k.frame.cpu().numpy()
    stats = (int(fs[:, st.S_ROUNDS].max()), int(fs[:, st.S_RECOVERY].sum()),
             int(fs[:, st.S_MISPREDICTS].sum()))
    for name, a, b in zip(res_k._fields, res_k, res_p):
        if not torch.equal(a, b):
            raise AssertionError(f"rstless_resolve {label}: {name} differs "
                                 f"from the plain version in "
                                 f"{int((a != b).sum())} entries")
    errs["rstless_resolve"] = max_err(res_k, res_p)
    ck, ok_k = sc.final(plan, words, nbits, rows, res_k.pieces, tb)
    cp, ok_p = st.final_ref(plan, words, nbits, rows, res_k.pieces, tb)
    torch.cuda.synchronize()
    # coefficients of the frames the engine accepts (resolved, every row
    # ok, every MCU decoded): the kernel writes each of their blocks, and
    # leaves a block no piece decodes, in a refused frame, as it was
    zero = torch.zeros(rows.F, dtype=torch.int64, device=dev)
    not_ok = zero.index_add(0, rows.frame, (ok_k == 0).to(torch.int64))
    blocks = zero.index_add(0, rows.frame,
                            res_k.row[st.R_NBLK].to(torch.int64))
    keep = ((res_k.frame[:, st.S_UNRESOLVED] == 0)
            & (res_k.frame[:, st.S_BAD] == 0) & (not_ok == 0)
            & (blocks >= plan.n_mcus * plan.blocks_per_mcu))
    ck, cp = (c.reshape(rows.F, tb, 64)[keep] for c in (ck, cp))
    errs["rstless_final"] = max_err((ck, ok_k), (cp, ok_p))
    if not (torch.equal(ck, cp) and torch.equal(ok_k, ok_p)):
        raise AssertionError(f"rstless_final {label}: {int((ck != cp).sum())}"
                             f" coefficients, {int((ok_k != ok_p).sum())} ok "
                             f"bits differ from the plain version")
    log(f"kernel-vs-plain rstless {label}: {rows.F} frames, {rows.R} rows "
        f"x {plan.blocks_per_mcu} variants, chunk {chunk_bytes} B strip "
        f"{strip_bytes} B piece {piece_bytes} B: sync links, membership and "
        f"marks equal; resolve rows, stats and pieces equal (rounds, "
        f"recovery rows, mispredicts {stats}; {int(fs[:, st.S_UNRESOLVED].sum())}"
        f" frames unresolved); final ok bits equal ({int((ok_k == 0).sum())}"
        f" rows not ok), coefficients equal in the {int(keep.sum())} of "
        f"{rows.F} frames the engine accepts")
    return stats, errs


def rstless_stream(dev: torch.device) -> tuple:
    """Phase 13's stream: bench.py's p_rl (bench.py:251-252), 1080p 4:2:0
    q75 without restart markers.  DeviceEncoder codes restart segments in
    parallel, so it needs a restart interval: one segment per frame, then
    the DRI segment dropped, is the ri=0 stream (the DC chain starts once,
    at the frame).  -> (encoder, pixels, frames, scan plan, blocks per
    frame, unstuffed segments)."""
    from jpeg_tpu_torch.models.device_decode import _rstless_scan

    n_mcus = -(-synth.HEIGHT // 16) * -(-synth.WIDTH // 16)  # 16x16 MCUs
    enc = DeviceEncoder.for_config(
        synth.HEIGHT, synth.WIDTH, 3,
        EncodeParams(h=2, v=2, quality=75, optimize=False,
                     restart_interval=n_mcus, exact=False), device=dev)
    px = bench_pixels(dev)
    frames = [drop_dri(f) for f in
              enc.encode_batch(px, optimize=False, chunk=CHUNK)]
    cs0, _, key = _rstless_scan(frames[0])
    plan = _cached_plan(cs0.geometry, cs0.scans[0].info, key)
    tb = sum(c.n_blocks for c in cs0.geometry.components)
    segs = [_rstless_scan(f)[1] for f in frames]
    return enc, px, frames, plan, tb, segs


def rstless_phase(card: str, dev: torch.device) -> list:
    """Phase 13 (RST-less decode: the speculative engine, K8-K10); -> the
    JSON entries of its three kernels."""
    mark("13")
    from jpeg_tpu_torch.models.device_decode import _rstless_scan

    core, sc, st = rstless_modules()
    enc, px, frames, plan, tb, segs = rstless_stream(dev)
    stream = b"".join(frames)
    ecs = [int(s.size) for s in segs]
    cb, sb, pb = core.CHUNK_BYTES, core.STRIP_BYTES, core.PIECE_BYTES
    rows8 = sum(-(-n // cb) for n in ecs[:CHUNK])
    log(f"rstless: {STREAM_FRAMES} frames of 1080p 4:2:0 q75 ri=0, ECS "
        f"{min(ecs)}..{max(ecs)} bytes a frame; chunk {cb} B, strip {sb} B, "
        f"piece {pb} B: {rows8} rows x {plan.blocks_per_mcu} variants = "
        f"{rows8 * plan.blocks_per_mcu} sync threads, "
        f"{rows8 * -(-cb // pb)} final-decode pieces per {CHUNK}-frame batch "
        f"on {torch.cuda.get_device_properties(dev).multi_processor_count} "
        f"SMs")

    # ---- the main path ------------------------------------------------
    c0 = dict(default_metrics.counters)
    sc.sync.launches = sc.resolve.launches = sc.final.launches = 0
    sc.sync.stage_launches = {"head": 0, "tail": 0}
    coeffs_to_pixels.launches = 0
    w0 = walk_counts()
    out = jpeg_tpu_torch.mjpeg.decode_stream_device(stream, dev, chunk=CHUNK)
    torch.cuda.synchronize()
    check_walked("rstless main path", w0, STREAM_FRAMES + 1)
    launches = {"rstless_sync": sc.sync.launches,
                "rstless_resolve": sc.resolve.launches,
                "rstless_final": sc.final.launches}
    stage_launches = dict(sc.sync.stage_launches)
    tail_launches = coeffs_to_pixels.launches
    delta = {k: default_metrics.counters.get(k, 0) - c0.get(k, 0)
             for k in ("speculative.fallbacks", "mjpeg.rstless_host_frames",
                       "speculative.resolve_rounds",
                       "speculative.recovery_rows", "speculative.mispredicts",
                       "speculative.batches", "speculative.native_prep_chunks",
                       "speculative.python_prep_chunks")}
    batches = STREAM_FRAMES // CHUNK
    want_launches = {"rstless_sync": batches, "rstless_final": batches,
                     "rstless_resolve": batches}
    if launches != want_launches or tail_launches != batches or \
            stage_launches != {"head": batches, "tail": batches}:
        raise AssertionError(f"rstless main path launches {launches}, "
                             f"K8's head and tail {stage_launches}, "
                             f"coeffs_to_pixels {tail_launches} (want "
                             f"{want_launches}, {batches} each)")
    if delta["speculative.fallbacks"] or delta["mjpeg.rstless_host_frames"]:
        raise AssertionError(f"rstless main path fell back: {delta}")
    if delta["speculative.native_prep_chunks"] != batches or \
            delta["speculative.python_prep_chunks"]:
        raise AssertionError(f"rstless main path: not every batch took the "
                             f"native prep: {delta}")
    want = (STREAM_FRAMES, synth.HEIGHT, synth.WIDTH, 3)
    if tuple(out.shape) != want or out.dtype != torch.uint8 or \
            out.device.type != dev.type:
        raise AssertionError(f"rstless output {tuple(out.shape)} {out.dtype}")
    log(f"rstless: decode_stream_device -> {want} uint8 on {dev}; launches "
        f"{launches} (K8's head and tail walks {stage_launches}), "
        f"coeffs_to_pixels {tail_launches}; per "
        f"{CHUNK}-frame batch: resolve rounds "
        f"{delta['speculative.resolve_rounds'] / batches}, recovery rows "
        f"{delta['speculative.recovery_rows'] / batches}, mispredicts "
        f"{delta['speculative.mispredicts'] / batches}; fallbacks 0, host "
        f"frames 0; native prep every batch")

    # ---- decoded blocks and pixels --------------------------------------
    prev = torch.from_numpy(enc.prev_idx).to(dev)
    qt = torch.from_numpy(np.stack([
        _rstless_scan(f)[0].qtables.astype(np.int32) for f in frames])).to(dev)
    for lo in range(0, STREAM_FRAMES, CHUNK):
        coeffs, n_use = core.speculative_core_batch(plan, tb,
                                                    segs[lo:lo + CHUNK], dev)
        if not torch.equal(raster_to_zz(coeffs.reshape(CHUNK, tb, 64), prev),
                           enc.dense(px[lo:lo + CHUNK])):
            raise AssertionError(f"rstless frames {lo}..: decoded blocks "
                                 f"differ from the encoder's")
        ref_px = coeffs_to_pixels(coeffs.reshape(CHUNK, tb, 64),
                                  qt[lo:lo + CHUNK], enc.geom)
        if not torch.equal(ref_px, out[lo:lo + CHUNK]):
            raise AssertionError(f"rstless frames {lo}..: pixels differ from "
                                 f"coeffs_to_pixels of the decoded blocks")
    log(f"rstless: {STREAM_FRAMES} frames' blocks equal to the encoder's, "
        f"pixels equal to coeffs_to_pixels of them")

    # ---- host syncs of one batch ----------------------------------------
    torch.cuda.synchronize()
    sites, others = [], []

    def on_warning(message, category, filename, lineno, file=None,
                   line=None):
        # the sync's innermost frame, and the port's frame that led there
        if "called a synchronizing CUDA operation" not in str(message):
            others.append(f"{Path(filename).name}:{lineno}: {message}")
        else:
            port = [f for f in traceback.extract_stack()
                    if "jpeg_tpu_torch" in f.filename]
            via = f" via {Path(port[-1].filename).name}:{port[-1].lineno}" \
                if port and port[-1].filename != filename else ""
            sites.append(f"{Path(filename).name}:{lineno}{via}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            core.speculative_core_batch(plan, tb, segs[:CHUNK], dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = len(sites)
    log(f"rstless: {syncs} host syncs in one {CHUNK}-frame batch of the "
        f"engine (uploads included), at {sites}; other warnings {others}")
    if syncs > RSTLESS_MAX_SYNCS:
        raise AssertionError(f"rstless: {syncs} host syncs in one batch, "
                             f"more than {RSTLESS_MAX_SYNCS} (three uploads "
                             f"and the one check read)")

    # ---- each kernel against its plain version ------------------------
    compare = [(f"1080p batch x{CHUNK}", plan, tb, segs[:CHUNK], cb, sb, pb,
                False)]
    for seed, (name, (nc, h, v, hh, ww, bits)) in enumerate(
            RSTLESS_SMALL.items()):
        # three frames of different content and coded size, coded with the
        # standard tables (a batch shares the first frame's plan)
        params = EncodeParams(h=h, v=v, quality=75, restart_interval=0,
                              optimize=False)
        small = [jpeg_tpu_torch.encode_jpeg(
            seeded_pnm(nc, hh, ww, bits, 10 * seed + i, 0.01 + 0.1 * i),
            params, dev) for i in range(3)]
        cs, _, k2 = _rstless_scan(small[0])
        p2 = _cached_plan(cs.geometry, cs.scans[0].info, k2)
        t2 = sum(c.n_blocks for c in cs.geometry.components)
        s2 = [_rstless_scan(f)[1] for f in small]
        # 16 B chunks and 4, 16 and 24 B pieces cut blocks (24 B: a short
        # last piece); a 4-byte strip forces re-decodes; the damaged copy
        # (noise, cut, all-zero words, flipped bits) holds rows that never
        # resynchronize
        for c_b, s_b, p_b, dmg in ((cb, sb, pb, False), (64, 16, 24, False),
                                   (16, 4, 4, False), (64, 16, 16, True)):
            compare.append((f"{name} x3 chunk {c_b} piece {p_b}"
                            + (" damaged" if dmg else ""), p2, t2, s2, c_b,
                            s_b, p_b, dmg))
    recovered = 0
    errs = {}
    for label, p2, t2, s2, c_b, s_b, p_b, dmg in compare:
        stats, e = rstless_compare(label, p2, t2, s2, dev, c_b, s_b, p_b,
                                   dmg)
        recovered += stats[1]
        for name, v in e.items():
            errs[name] = max(errs.get(name, 0), v)
    if recovered == 0:
        raise AssertionError("no comparison ran the re-decode kernel")

    # ---- times ----------------------------------------------------------
    words, nbits, rows = core.prepare_batch(segs[:CHUNK], dev)
    cbb, sbb, pbb = cb * 8, sb * 8, pb * 8
    links, member, marks, listed = sc._sync(plan, words, nbits, rows, cbb,
                                            sbb, pbb)
    survivors = int(listed[0])
    log(f"rstless: K8 survivors {survivors} of {rows.R * plan.blocks_per_mcu}"
        f" (row, variant) lanes walk past the strip in the {CHUNK}-frame "
        f"batch")
    rounds = 1 + int(np.diff(rows.row0).max())
    res = sc.resolve(plan, words, nbits, rows, links, member, marks, cbb, sbb,
                     pbb, rounds)
    coeffs, ok = sc.final(plan, words, nbits, rows, res.pieces, tb)
    calls = {
        "rstless_sync": (
            lambda: sc.sync(plan, words, nbits, rows, cbb, sbb, pbb),
            lambda: st.sync_ref(plan, words, nbits, rows, cbb, sbb, pbb)),
        "rstless_resolve": (
            lambda: sc.resolve(plan, words, nbits, rows, links, member, marks,
                               cbb, sbb, pbb, rounds),
            lambda: st.resolve_ref(plan, words, nbits, rows, links, member,
                                   marks, cbb, sbb, pbb, rounds)),
        "rstless_final": (
            lambda: sc.final(plan, words, nbits, rows, res.pieces, tb),
            lambda: st.final_ref(plan, words, nbits, rows, res.pieces, tb)),
    }
    ecs_bytes = int(((nbits.to(torch.int64) + 7) // 8).sum())
    bits = int(nbits.to(torch.int64).sum())
    bounds = {
        # the segment, the row layout and the code tables read once, the
        # links and marks written; every coded bit looked at once per
        # variant (the membership map and the survivor groups are this
        # design's scratch, not the function's; the design decodes fewer
        # bits than this counts: past the strip, only each row's distinct
        # decodes walk)
        "rstless_sync": bound(
            ecs_bytes + nbytes(nbits, rows.r0, rows.frame32, links, marks)
            + 4 * place_cuda._staged_ints(plan),
            bits * plan.blocks_per_mcu, "int32"),
        # links read, and the marks of the one variant each row settles
        # through (1 / bpm of them); the rows' outputs, the frames' stats
        # and the pieces written; one step a row
        "rstless_resolve": bound(
            nbytes(links, *res) + nbytes(marks) // plan.blocks_per_mcu,
            rows.R, "int32"),
        # the segment and the pieces read, coefficients and ok bits
        # written; every coded bit once
        "rstless_final": bound(ecs_bytes + nbytes(res.pieces, coeffs, ok),
                               bits, "int32"),
    }
    times = {}
    for name, (kern, plain) in calls.items():
        times[name] = (*kernel_ms(name, kern, 10, card), cuda_ms(plain, 1))
        log(f"time {name}_ms={times[name][0]} device_ms={times[name][1]} "
            f"plain_ms={times[name][2]} per {CHUNK}-frame 1080p ri=0 batch "
            f"({rows.R} rows) [{card}]")
        log_bound(name, times[name][0], bounds[name], card, times[name][1])

    mpix = STREAM_FRAMES * synth.WIDTH * synth.HEIGHT / 1e6
    med, runs = median_s(lambda: jpeg_tpu_torch.mjpeg.decode_stream_device(
        stream, dev, chunk=CHUNK), E2E_RUNS)
    log(f"time rstless_e2e_stream_Mpix_s={mpix / med} (median of {len(runs)} "
        f"runs of {STREAM_FRAMES} ri=0 frames from bytes, chunk {CHUNK}; run "
        f"ms {[round(r * 1e3, 3) for r in runs]}) [{card}]")
    prepared = [(core.prepare_batch(segs[i:i + CHUNK], dev), qt[i:i + CHUNK])
                for i in range(0, STREAM_FRAMES, CHUNK)]

    def resident():
        for (w, n, r), q in prepared:
            lk, mb, mk = sc.sync(plan, w, n, r, cbb, sbb, pbb)
            rr = sc.resolve(plan, w, n, r, lk, mb, mk, cbb, sbb, pbb, rounds)
            c, _ = sc.final(plan, w, n, r, rr.pieces, tb)
            coeffs_to_pixels(c.reshape(-1, tb, 64), q, enc.geom)

    resident()
    med, runs = median_s(resident, E2E_RUNS)
    log(f"time rstless_device_resident_Mpix_s={mpix / med} (median of "
        f"{len(runs)} runs of {STREAM_FRAMES} frames whose words are on the "
        f"card: sync, resolve, final, dense tail; host clock) [{card}]")
    by_kernel = profile_window(
        lambda: jpeg_tpu_torch.mjpeg.decode_stream_device(stream, dev,
                                                          chunk=CHUNK),
        "device_decode.", card, f"{STREAM_FRAMES}-frame RST-less stream "
        "decode", top=12)
    # K8's head and tail walks, K9, K10's piece walk and DC pass apart
    for stage, kernel in (("K8 head walk", "head_kernel"),
                          ("K8 tail walk", "tail_kernel"),
                          ("K9 resolve", "resolve_kernel"),
                          ("K10 piece walk", "final_kernel"),
                          ("K10 DC pass", "dc_kernel")):
        n, us = next(((n, us) for name, (n, us) in by_kernel.items()
                      if f"::{kernel}(" in name or f"::{kernel}<" in name),
                     (0, 0.0))
        log(f"profile: {stage} device {us / 1e3} ms x{n} in the "
            f"{STREAM_FRAMES}-frame window [{card}]")
    replaces = {"rstless_sync": "jpeg_tpu/entropy/speculative.py:545",
                "rstless_resolve": "jpeg_tpu/entropy/speculative.py:749",
                "rstless_final": "jpeg_tpu/entropy/speculative.py:1249"}
    return [{"name": name, "route": "cuda",
             "source": "jpeg_tpu_torch/csrc/decode_rstless.cu",
             "replaces": replaces[name], "launches": launches[name],
             "max_abs_err": errs[name], "ms": times[name][0],
             "device_ms": times[name][1], "plain_ms": times[name][2],
             **bounds[name]}
            for name in calls]


def rstless_prep_phase(card: str, dev: torch.device) -> None:
    """Phase 19 (the RST-less engine's two host preps): an 8-frame 1080p
    chunk of phase 13's stream through the native prep
    (``prepare_batch_native``, ``jt_walk_ecs_rows`` a frame) and the Python
    prep (``_rstless_scan`` a frame, ``prepare_batch``) on the card:
    words equal over ``pack_words``' width and zero past it, bit counts
    and rows equal, the engine's coefficients equal, and
    ``decode_stream_rstless`` with the stream's decoder gives equal
    pixels with and without the native library, each chunk counted by
    its prep; each prep timed, host clock."""
    mark("19")
    from jpeg_tpu_torch import native
    from jpeg_tpu_torch.models.device_decode import (
        _rstless_scan,
        decode_stream_rstless,
    )

    core, _, _ = rstless_modules()
    _, _, frames, plan, tb, segs = rstless_stream(dev)
    chunk = frames[:CHUNK]
    dec = DeviceDecoder.for_stream(chunk[0], dev)
    if not native.available():
        raise AssertionError(f"native library: {native.load_error()}")
    got = core.prepare_batch_native(chunk, dec.scan_start, dev)
    if got is None:
        raise AssertionError("the native prep refused the RST-less chunk")
    want = core.prepare_batch(segs[:CHUNK], dev)
    wn = want[0].shape[1]
    if not (torch.equal(got[0][:, :wn], want[0])
            and not bool(got[0][:, wn:].any())
            and torch.equal(got[1], want[1])
            and np.array_equal(got[2].row0, want[2].row0)
            and torch.equal(got[2].frame, want[2].frame)):
        raise AssertionError("rstless native prep: words, bit counts or rows"
                             " differ from the Python prep's")
    c_native = core.speculative_core(plan, tb, *got)
    c_python = core.speculative_core(plan, tb, *want)
    if c_native is None or c_python is None or \
            not torch.equal(c_native[0], c_python[0]):
        raise AssertionError("rstless native prep: coefficients differ from "
                             "the Python prep's (or a batch was refused)")
    counts = ("speculative.native_prep_chunks",
              "speculative.python_prep_chunks")
    c0 = [default_metrics.counters.get(k, 0) for k in counts]
    px_native = decode_stream_rstless(chunk, dev, chunk=CHUNK, dec=dec)
    c1 = [default_metrics.counters.get(k, 0) for k in counts]
    available = native.available
    native.available = lambda: False
    try:
        px_python = decode_stream_rstless(chunk, dev, chunk=CHUNK, dec=dec)
    finally:
        native.available = available
    c2 = [default_metrics.counters.get(k, 0) for k in counts]
    torch.cuda.synchronize()
    if [b - a for a, b in zip(c0, c1)] != [1, 0] or \
            [b - a for a, b in zip(c1, c2)] != [0, 1]:
        raise AssertionError(f"rstless preps counted {c0} -> {c1} -> {c2} "
                             f"(native, python): want one chunk each")
    if not torch.equal(px_native, px_python):
        raise AssertionError("rstless native prep: pixels differ from the "
                             "Python prep's")
    native_s, native_runs = median_s(
        lambda: core.prepare_batch_native(chunk, dec.scan_start, dev),
        E2E_RUNS)
    python_s, python_runs = median_s(
        lambda: core.prepare_batch([_rstless_scan(f, dec.geom,
                                                  dec.htable_key)[1]
                                    for f in chunk], dev), E2E_RUNS)
    log(f"rstless prep: {CHUNK}-frame 1080p chunk, words [{CHUNK}, "
        f"{got[0].shape[1]}] native against [{CHUNK}, {wn}] Python, equal "
        f"over {wn} and zero past it; bit counts, rows, coefficients and "
        f"pixels equal")
    log(f"time rstless_host_prep_ms[native]={native_s * 1e3 / CHUNK} "
        f"rstless_host_prep_ms[python]={python_s * 1e3 / CHUNK} a frame "
        f"(median of {E2E_RUNS}, parse, unstuff, pack and upload, host "
        f"clock; run ms native {[round(r * 1e3, 3) for r in native_runs]} "
        f"python {[round(r * 1e3, 3) for r in python_runs]}) [{card}]")


def encode_inputs(ppm: bytes, params: EncodeParams,
                  dev: torch.device) -> tuple:
    """What ``encode_jpeg(ppm, params, dev)`` hands its dense stage: (the
    geometry, the MCU-padded float32 frame on ``dev``, the [4, 64] int32
    tables on the host)."""
    geom = geometry_for_image(read_pnm(ppm), params)
    img = read_pnm(ppm, pad_to=(8 * geom.max_v, 8 * geom.max_h))
    qt = np.ones((4, 64), np.int32)
    qt[0] = scale_qtable(STD_LUMINANCE_QUANT, params.quality)
    qt[1] = scale_qtable(STD_CHROMINANCE_QUANT, params.quality)
    return geom, torch.from_numpy(img.data).to(dev), qt


def plane_major(frame: bytes, dev: torch.device) -> tuple:
    """A frame's host-decoded coefficients as K11 takes them: (the
    geometry, int32 [total_blocks, 64] plane-major on ``dev``, its [4, 64]
    tables on ``dev``)."""
    cs, planes = jpeg_tpu_torch.decode_coefficients(frame)
    geom = cs.geometry
    flat = np.concatenate([planes[c.cid] for c in geom.components])
    return (geom, torch.from_numpy(flat).to(dev),
            torch.from_numpy(cs.qtables.astype(np.int32)).to(dev))


def fast_tol(ref: torch.Tensor) -> float:
    """K11's float tolerance against its plain version: the two sum their
    float32 IDCTs in their own order (and nvcc contracts the kernel's
    into FMAs), ~1e-4 of the samples' magnitude apart."""
    return 1e-3 + 1e-5 * float(ref.abs().max())


def frame_pixels(frame: torch.Tensor, geom: FrameGeometry) -> torch.Tensor:
    """``DecodedImage.pixels()`` of a float frame, on its device: the
    [height, width] window of its first 3 (or 1) channels, rounded half
    away from zero and clipped."""
    nc = 3 if geom.nf >= 3 else 1
    win = frame[:geom.height, :geom.width, :nc]
    return roundf(win).clamp(0, (1 << geom.precision) - 1).to(torch.int32)


def check_fast_decode(label: str, coeffs: torch.Tensor, qt: torch.Tensor,
                      geom: FrameGeometry, share: float) -> float:
    """``decode_frame_fast`` against ``decode_frame_fast_ref`` on the same
    card tensors: the floats within ``fast_tol``, and their pixels within
    +-1 with at most ``share`` of the samples differing; -> max |diff|."""
    got = decode_frame_fast(coeffs, qt, geom)
    want = decode_frame_fast_ref(coeffs, qt, geom)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != torch.float32:
        raise AssertionError(f"decode_frame_fast, {label}: "
                             f"{tuple(got.shape)} {got.dtype} vs plain "
                             f"{tuple(want.shape)} {want.dtype}")
    err, tol = float((got - want).abs().max()), fast_tol(want)
    diff = (frame_pixels(got, geom) - frame_pixels(want, geom)).abs()
    px_err, n = int(diff.max()), int((diff != 0).sum())
    if not err <= tol or px_err > 1 or n > share * diff.numel():
        raise AssertionError(f"decode_frame_fast, {label}: max |diff| {err}"
                             f" (allowed {tol}); pixels max |diff| {px_err},"
                             f" {n} of {diff.numel()} differ (allowed "
                             f"{share})")
    log(f"kernel-vs-plain decode_frame_fast {label}: {tuple(got.shape)}, "
        f"max |diff| {err} (allowed {tol}); pixels max |diff| {px_err}, {n} "
        f"of {diff.numel()} differ (allowed {share})")
    return err


def fast_phase(card: str, dev: torch.device, streams: dict) -> list:
    """Phase 14 (the fast mode's dense stages, K11 ``decode_frame_fast``
    and K12 ``encode_frame_fast``); -> their JSON entries."""
    from jpeg_tpu_torch.models.dense_fast import encode_tiles, kernel_resources

    mark("14")
    bench0 = streams["bench"][0]
    # -- K11 against its plain version: bench frame 0, every frame of the
    # small corpus streams and the crafted frames, each also with seeded
    # +-40 noise on its coefficients
    cases = [("bench frame 0", bench0, TAIL_DIFF_SHARE["chunk"])]
    for name in STREAMS[1:]:
        cases += [(f"{name} frame {i}", f, TAIL_DIFF_SHARE["small"])
                  for i, f in enumerate(streams[name])]
    cases += [(name, synth.crafted(name), TAIL_DIFF_SHARE["small"])
              for name in synth.CRAFTED]
    rng = np.random.default_rng(41)
    err11 = 0.0
    for label, frame, share in cases:
        geom, coeffs, qt = plane_major(frame, dev)
        noise = torch.from_numpy(rng.integers(-40, 41, tuple(coeffs.shape))
                                 .astype(np.int32)).to(dev)
        for lab, c in ((label, coeffs), (f"{label} + noise", coeffs + noise)):
            err11 = max(err11, check_fast_decode(lab, c, qt, geom, share))
    # seeded coefficients (DC up to +-60, AC up to +-8), tables 1..24
    comps, height, width = FAST_GEOMETRY
    geom = with_block_grid(FrameGeometry(8, height, width, tuple(
        Component(cid=i, h=h, v=v, tq=tq) for i, h, v, tq in comps)))
    tb = sum(c.n_blocks for c in geom.components)
    c = rng.integers(-8, 9, (tb, 64)).astype(np.int32)
    c[:, 0] = rng.integers(-60, 61, tb)
    err11 = max(err11, check_fast_decode(
        f"YCCK 15x15 sampling {height}x{width}, seeded",
        torch.from_numpy(c).to(dev),
        torch.from_numpy(rng.integers(1, 25, (4, 64)).astype(np.int32))
        .to(dev), geom, TAIL_DIFF_SHARE["small"]))

    # -- K12 against its plain version: bench frame 0 and seeded noise in
    # the small shapes (gray, 12-bit 4:2:2, 4:4:4, padded 4:2:0, h=1 v=2)
    ppm = synth.make_frame_ppm(0)
    g_e, f_e, qt_host = encode_inputs(ppm, BENCH_PARAMS, dev)
    q_e = torch.from_numpy(qt_host).to(dev)
    err12 = check_dense("bench frame 0",
                        encode_frame_fast(f_e, q_e, g_e)
                        - encode_frame_fast_ref(f_e, q_e, g_e),
                        DENSE_DIFF_SHARE["chunk"], "encode_frame_fast")
    for comps, h, v, height, width, bits in DENSE_SHAPES:
        px = rng.integers(0, 1 << bits, (height, width, comps))
        g, f, q = encode_inputs(
            write_pnm(px.astype(np.float32), width, height, bits),
            EncodeParams(h=h, v=v, quality=80, exact=False), dev)
        q = torch.from_numpy(q).to(dev)
        err12 = max(err12, check_dense(
            f"{comps} comps {height}x{width} {bits}-bit h={h} v={v} noise "
            f"(box cell {encode_tiles(g).cell})",
            encode_frame_fast(f, q, g) - encode_frame_fast_ref(f, q, g),
            DENSE_DIFF_SHARE["noise"], "encode_frame_fast"))
    comps, height, width = FAST_ENCODE_GEOMETRY
    general12 = with_block_grid(FrameGeometry(8, height, width, tuple(
        Component(cid=i, h=h, v=v, tq=tq) for i, h, v, tq in comps)))
    f = torch.from_numpy(rng.uniform(0, 255, (general12.size_y,
                                              general12.size_x, 3))
                         .astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.integers(1, 60, (4, 64)).astype(np.int32)
                         ).to(dev)
    if encode_tiles(general12).cell != (0, 0):
        raise AssertionError("FAST_ENCODE_GEOMETRY has a box cell")
    err12 = max(err12, check_dense(
        f"{[c[1:3] for c in comps]} sampling {height}x{width} noise "
        "(the general code)",
        encode_frame_fast(f, q, general12)
        - encode_frame_fast_ref(f, q, general12),
        DENSE_DIFF_SHARE["noise"], "encode_frame_fast"))
    g0, c0, q0 = plane_major(bench0, dev)
    check_no_sync("decode_frame_fast", lambda: decode_frame_fast(c0, q0, g0))
    check_no_sync("encode_frame_fast",
                  lambda: encode_frame_fast(f_e, q_e, g_e))
    # The bench frame's inputs 4 bytes past a 16-byte boundary: each kernel
    # fills its stages with 4-byte copies in place of its bulk copies, to
    # the same output as the aligned call's.
    for name, run, base in (
            ("decode_frame_fast", lambda x: decode_frame_fast(x, q0, g0), c0),
            ("encode_frame_fast", lambda x: encode_frame_fast(x, q_e, g_e),
             f_e)):
        buf = torch.empty(base.numel() + 1, dtype=base.dtype, device=dev)
        off = buf[1:].view(base.shape)
        off.copy_(base)
        if off.data_ptr() % 16 == 0 or not torch.equal(run(off), run(base)):
            raise AssertionError(f"{name}: bench frame 0's input 4 bytes "
                                 "off a 16-byte boundary gives another "
                                 "output")
        log(f"{name}: bench frame 0's input at an address "
            f"{off.data_ptr() % 16} mod 16 gives the aligned call's output")
        del buf, off
    # Registers a thread and CTAs an SM of the instances the bench frame
    # runs (the shift path, the 2 x 2 cell) and of the general code's (the
    # crafted non-dividing frame, FAST_ENCODE_GEOMETRY).
    resources = {
        "decode_frame_fast": kernel_resources(g0, "decode"),
        "encode_frame_fast": kernel_resources(g_e, "encode")}
    for name, g, kind in (
            ("decode_frame_fast", g0, "decode"),
            ("decode_frame_fast", plane_major(synth.crafted("nondividing"),
                                              dev)[0], "decode"),
            ("encode_frame_fast", g_e, "encode"),
            ("encode_frame_fast", general12, "encode")):
        log(f"resources {name} {g.size_y}x{g.size_x} "
            f"{[(c.h, c.v) for c in g.components]}: "
            f"{kernel_resources(g, kind)} [{card}]")

    # -- the paths that reach the kernels, each launch counted
    decode_frame_fast.launches = 0
    img = jpeg_tpu_torch.decode_jpeg(bench0, dev, exact=False)
    one = decode_frame_fast.launches
    cpu = jpeg_tpu_torch.decode_jpeg(bench0, "cpu", exact=False)
    diff = int(np.abs(img.pixels() - cpu.pixels()).max())
    if one != 1 or diff > 1:
        raise AssertionError(f"decode_jpeg(exact=False): {one} K11 "
                             f"launches, pixels {diff} from the CPU run's")
    log(f"fast: decode_jpeg(bench frame 0, {dev}, exact=False) 1 K11 "
        f"launch, pixels max |diff| {diff} against its CPU run")
    for name in synth.CRAFTED:
        frame = synth.crafted(name)
        decode_frame_fast.launches = 0
        got = jpeg_tpu_torch.decode_jpeg(frame, dev, exact=False)
        one = decode_frame_fast.launches
        want = jpeg_tpu_torch.decode_jpeg(frame, "cpu", exact=False)
        diff = int(np.abs(got.pixels() - want.pixels()).max())
        if one != 1 or diff > 1 or got.frame.shape != want.frame.shape:
            raise AssertionError(f"{name}: decode_jpeg(exact=False) on "
                                 f"{dev}: {one} K11 launches, pixels "
                                 f"{diff} from the CPU run's")
        log(f"fast: {name} {got.frame.shape} decodes on {dev}, 1 K11 "
            f"launch, pixels max |diff| {diff} against its CPU run")
    stream = b"".join(streams["bench"][i % len(streams["bench"])]
                      for i in range(STREAM_FRAMES))
    decode_frame_fast.launches = 0
    res = jpeg_tpu_torch.mjpeg.decode_stream(stream, dev)
    stream_launches = decode_frame_fast.launches
    if stream_launches != STREAM_FRAMES or res.ok_count != STREAM_FRAMES \
            or not np.array_equal(res.frames[0].frame, img.frame):
        raise AssertionError(f"mjpeg.decode_stream: {res.ok_count} frames, "
                             f"{stream_launches} K11 launches (want "
                             f"{STREAM_FRAMES}), or frame 0 differs from "
                             "its decode_jpeg")
    log(f"fast: mjpeg.decode_stream of {STREAM_FRAMES} 1080p frames on "
        f"{dev}: {stream_launches} K11 launches, frame 0 equal to its "
        "decode_jpeg")
    encode_frame_fast.launches = 0
    data = jpeg_tpu_torch.encode_jpeg(ppm, BENCH_PARAMS, dev)
    enc_launches = encode_frame_fast.launches
    data_cpu = jpeg_tpu_torch.encode_jpeg(ppm, BENCH_PARAMS, "cpu")
    planes = [jpeg_tpu_torch.decode_coefficients(d)[1]
              for d in (data, data_cpu)]
    cdiff = torch.from_numpy(np.concatenate(
        [planes[0][c.cid] - planes[1][c.cid] for c in g_e.components]))
    check_dense("encode_jpeg(bench frame 0) bytes against the CPU encode's",
                cdiff, DENSE_DIFF_SHARE["chunk"], "encode_frame_fast")
    # Where a quantized value differs by 1, its block's pixels differ by
    # up to q times the basis function; elsewhere by at most 1.
    blocks = int((cdiff != 0).any(dim=1).sum())
    pd = np.abs(jpeg_tpu_torch.decode_jpeg(data, "cpu", exact=False)
                .pixels() - jpeg_tpu_torch.decode_jpeg(
                    data_cpu, "cpu", exact=False).pixels())
    far, allowed = int((pd > 1).sum()), blocks * 64 * 4 * 3
    if enc_launches != 1 or far > allowed:
        raise AssertionError(f"encode_jpeg(exact=False): {enc_launches} K12 "
                             f"launches; {far} samples of its decode more "
                             f"than 1 from the CPU encode's (allowed "
                             f"{allowed}: {blocks} blocks differ)")
    log(f"fast: encode_jpeg(bench frame 0, {dev}, exact=False) 1 K12 launch "
        f"({len(data)} bytes, CPU {len(data_cpu)}); decoded, {far} samples "
        f"more than 1 apart (max {int(pd.max())}), within the {blocks} "
        "blocks whose coefficients differ")
    encode_frame_fast.launches = 0
    DeviceEncoder.tables_for_stream(ppm, BENCH_PARAMS, dev)
    if encode_frame_fast.launches != 1:
        raise AssertionError(f"tables_for_stream: "
                             f"{encode_frame_fast.launches} K12 launches")
    log(f"fast: DeviceEncoder.tables_for_stream on {dev}, 1 K12 launch")

    # -- times: each kernel (a call and device only) against the plain
    # eager chain on the card, the chain's device launches, and the
    # single-image calls with their parts
    out11 = decode_frame_fast(c0, q0, g0)
    out12 = encode_frame_fast(f_e, q_e, g_e)
    calls = {
        "decode_frame_fast": (lambda: decode_frame_fast(c0, q0, g0),
                              lambda: decode_frame_fast_ref(c0, q0, g0),
                              bound(nbytes(c0, q0, out11),
                                    c0.shape[0] * 2 * 64 * 8 * 2,
                                    "float32")),
        "encode_frame_fast": (lambda: encode_frame_fast(f_e, q_e, g_e),
                              lambda: encode_frame_fast_ref(f_e, q_e, g_e),
                              bound(nbytes(f_e, q_e, out12),
                                    out12.shape[0] * 2 * 64 * 8 * 2,
                                    "float32")),
    }
    times = {}
    for name, (kern, plain, b) in calls.items():
        k_ms, d_ms = kernel_ms(name, kern, 20, card)
        p_ms = cuda_ms(plain, 5)
        chain = profile_window(plain, "device_", card,
                               f"one plain {name} chain")
        log(f"time {name}_ms={k_ms} device_ms={d_ms} plain_ms={p_ms} "
            f"(the eager chain: {sum(n for n, _ in chain.values())} device "
            f"launches, as the profiler saw them) per 1080p bench frame 0 "
            f"[{card}]")
        log_bound(name, k_ms, b, card, d_ms)
        times[name] = (k_ms, d_ms, p_ms)
    enc_planes = dict(zip([c.cid for c in g_e.components], np.split(
        out12.cpu().numpy(),
        np.cumsum([c.n_blocks for c in g_e.components])[:-1])))
    f_host = f_e.cpu()
    for key, run, parts in (
            ("fast_decode_ms",
             lambda: jpeg_tpu_torch.decode_jpeg(bench0, dev, exact=False), {
                 "host entropy (decode_coefficients)":
                     lambda: jpeg_tpu_torch.decode_coefficients(bench0),
                 "dense stage (one upload, K11)":
                     lambda: decode_frame(img.coefficients, g0,
                                          img.codestream.qtables
                                          .astype(np.int32), False,
                                          device=dev),
                 "D2H copy of the float frame": lambda: out11.cpu()}),
            ("fast_encode_ms",
             lambda: jpeg_tpu_torch.encode_jpeg(ppm, BENCH_PARAMS, dev), {
                 "dense stage (upload, K12, planes to the host)":
                     lambda: {k: p.cpu() for k, p in encode_frame(
                         f_host.to(dev), g_e, qt_host, False).items()},
                 "host entropy (encode_jpeg_from_planes)":
                     lambda: encode_jpeg_from_planes(
                         enc_planes, g_e, qt_host.astype(np.uint16),
                         BENCH_PARAMS, dev)})):
        med, runs = median_s(run, 2)
        split = {what: median_s(fn, 2)[0] * 1e3 for what, fn in parts.items()}
        log(f"time {key}={med * 1e3} (1080p bench frame 0, median of "
            f"{len(runs)} runs, host clock; parts, ms: {split}) [{card}]")
    return [{"name": name, "route": "cuda",
             "source": "jpeg_tpu_torch/csrc/dense_fast.cu",
             "replaces": replaces, "launches": launches,
             "max_abs_err": err, "ms": times[name][0],
             "device_ms": times[name][1], "plain_ms": times[name][2],
             "registers": resources[name]["registers"],
             "ctas_per_sm": resources[name]["ctas_per_sm"],
             **calls[name][2]}
            for name, replaces, launches, err in (
                ("decode_frame_fast", "jpeg_tpu/api.py:32", stream_launches,
                 err11),
                ("encode_frame_fast", "jpeg_tpu/encoder.py:155",
                 enc_launches, err12))]


@contextlib.contextmanager
def python_prep():
    """``DeviceDecoder.prepare`` takes the Python prep, and
    ``DeviceEncoder._finalize_flat`` the NumPy host tail, while the block
    runs (the native library reads as not available)."""
    from jpeg_tpu_torch import native

    saved = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = saved


def prep_counts() -> tuple:
    c = default_metrics.counters
    return (c.get("device_decode.native_prep_chunks", 0),
            c.get("device_decode.python_prep_chunks", 0))


ENTRY_COUNTERS = ("mjpeg.native_splits", "mjpeg.python_splits",
                  "device_decode.native_for_stream",
                  "device_decode.python_for_stream")


def entry_counts() -> tuple:
    """The stream entry's walk counters, ``ENTRY_COUNTERS``' order."""
    return tuple(default_metrics.counters.get(k, 0) for k in ENTRY_COUNTERS)


def walk_counts() -> tuple:
    """The prep's run walk counters, ``WALK_COUNTERS``' order."""
    return tuple(default_metrics.counters.get(k, 0) for k in WALK_COUNTERS)


def check_walked(label: str, w0: tuple, frames: int) -> None:
    """Since ``w0`` (``walk_counts()``) the run walk packed ``frames``
    frames and refused none."""
    got = tuple(b - a for a, b in zip(w0, walk_counts()))
    if got != (frames, 0):
        raise AssertionError(f"{label}: the prep's run walk packed and "
                             f"refused {got} frames, want ({frames}, 0)")


def cli_run(args: list) -> subprocess.Popen:
    """``python -m jpeg_tpu_torch.cli`` with ``args``, started from the
    repository root (the checkout's package) in the background."""
    return subprocess.Popen(
        [sys.executable, "-m", "jpeg_tpu_torch.cli", *args],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def native_phase(card: str, dev: torch.device, streams: dict) -> None:
    """Phase 15: the native host layer (``jpeg_tpu_torch/native``) and the
    CLI on the card."""
    mark("15")
    from jpeg_tpu_torch import native

    lib = native.load_library()  # a failed build raises here
    if not native.available():
        raise AssertionError("native.available() is False after a build")
    threads = min(os.cpu_count() or 1, 16)
    log(f"native: {lib.path.name} built in {lib.build_seconds:.2f} s "
        f"(g++ {' '.join(native.CXX_FLAGS)}); {threads} host threads "
        f"(cpu_count {os.cpu_count()}) [{card}]")

    # -- the native prep against the Python prep on the ri=4 bench stream
    bench = streams["bench"]
    frames = [bench[i % len(bench)] for i in range(STREAM_FRAMES)]
    stream = b"".join(frames)
    chunks = [frames[i:i + CHUNK] for i in range(0, STREAM_FRAMES, CHUNK)]
    dec = DeviceDecoder.for_stream(bench[0], dev)
    dec.prep_mode = "rows"  # zeros past each lane, as the Python prep's
    routes = {}
    for label in ("python", "native"):
        with python_prep() if label == "python" else \
                contextlib.nullcontext():
            n0 = prep_counts()
            before = dict(place_cuda.ROUTE_LAUNCHES)
            prepared = [dec.prepare(c) for c in chunks]
            for words, nbits, _ in prepared:
                dec.decode_prepared(words, nbits, CHUNK)
            torch.cuda.synchronize()
            routes[label] = {k: v - before[k]
                             for k, v in place_cuda.ROUTE_LAUNCHES.items()}
            got = tuple(b - a for a, b in zip(n0, prep_counts()))
        want = (len(chunks), 0) if label == "native" else (0, len(chunks))
        if got != want:
            raise AssertionError(f"{label} prep: (native, python) chunk "
                                 f"counts {got}, want {want}")
        if label == "python":
            py = prepared
    for i, ((w, n, q), (w_p, n_p, q_p)) in enumerate(zip(prepared, py)):
        width = w_p.shape[1]
        if w.shape[0] != w_p.shape[0] or w.shape[1] < width or \
                not torch.equal(w[:, :width], w_p) or \
                bool(w[:, width:].any()) or not torch.equal(n, n_p) or \
                n.dtype != torch.int32 or not torch.equal(q, q_p):
            raise AssertionError(f"chunk {i}: the native prep's words "
                                 f"{tuple(w.shape)}, bit counts or tables "
                                 f"differ from the Python prep's "
                                 f"{tuple(w_p.shape)}")
    if routes["native"] != routes["python"]:
        raise AssertionError(f"word routes differ: native {routes['native']}"
                             f", python {routes['python']}")
    log(f"native: prep of {len(chunks)} chunks equal to the Python prep "
        f"(words {tuple(prepared[0][0].shape)} a chunk, bit counts, "
        f"tables); word routes native {routes['native']}, python "
        f"{routes['python']}")

    # the main path: the stream decode, every chunk on the native prep
    default_metrics.counters["device_decode.native_prep_chunks"] = 0
    default_metrics.counters["device_decode.python_prep_chunks"] = 0
    decode_segments.launches = coeffs_to_pixels.launches = 0
    e0, w0 = entry_counts(), walk_counts()
    px = jpeg_tpu_torch.mjpeg.decode_stream_device(stream, dev, chunk=CHUNK)
    torch.cuda.synchronize()
    # the sample frame's walk in for_stream, then one a frame
    check_walked("native stream decode", w0, STREAM_FRAMES + 1)
    counts = prep_counts()
    launches = (decode_segments.launches, coeffs_to_pixels.launches)
    if counts != (len(chunks), 0) or launches != (len(chunks), len(chunks)):
        raise AssertionError(f"native stream decode: (native, python) prep "
                             f"chunks {counts}, decode_segments and "
                             f"coeffs_to_pixels launches {launches}")
    entry = tuple(b - a for a, b in zip(e0, entry_counts()))
    if entry != (1, 0, 1, 0):
        raise AssertionError(f"native stream decode: the stream entry's "
                             f"walks {dict(zip(ENTRY_COUNTERS, entry))}, "
                             f"want one native split and one native "
                             f"for_stream")
    with python_prep():
        px_py = jpeg_tpu_torch.mjpeg.decode_stream_device(stream, dev,
                                                          chunk=CHUNK)
    if not torch.equal(px, px_py):
        raise AssertionError("native prep: pixels differ from the Python "
                             "prep's")
    log(f"native: decode_stream_device of {STREAM_FRAMES} frames, "
        f"(native, python) prep chunks {counts}, launches decode_segments "
        f"{launches[0]}, coeffs_to_pixels {launches[1]}, stream entry "
        f"{dict(zip(ENTRY_COUNTERS, entry))}; pixels equal to the Python "
        f"prep's")

    # -- times: each prep, and the stream rate under each, in turns
    mpix = STREAM_FRAMES * 1920 * 1080 / 1e6
    preps = {"native": [], "python": []}
    rates = {"native": [], "python": []}
    for turn in range(E2E_RUNS + 1):  # turn 0 warms up
        for label in (("native", "python") if turn % 2 else
                      ("python", "native")):
            with python_prep() if label == "python" else \
                    contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for c in chunks:
                    dec.prepare(c)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                jpeg_tpu_torch.mjpeg.decode_stream_device(stream, dev,
                                                          chunk=CHUNK)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            if turn:
                preps[label].append((t1 - t0) * 1e3)
                rates[label].append(mpix / (t2 - t1))
    for label in ("native", "python"):
        p, r = sorted(preps[label]), sorted(rates[label])
        log(f"time host_prep_ms[{label}]={p[len(p) // 2]} (median of "
            f"{len(p)} runs: parse, unstuff, pack and upload of "
            f"{STREAM_FRAMES} frames, host clock; run ms {p}; "
            f"{threads if label == 'native' else 1} host threads) [{card}]")
        log(f"time e2e_stream_Mpix_s[{label} prep]={r[len(r) // 2]} "
            f"(median of {len(r)} runs of {STREAM_FRAMES} ri=4 frames from "
            f"bytes, host clock; runs {r}) [{card}]")

    # -- the encode host tail: every chunk native, bytes equal to the
    # NumPy tail's, and both timed on the 16 bench frames
    enc = DeviceEncoder.for_config(synth.HEIGHT, synth.WIDTH, 3,
                                   BENCH_PARAMS, device=dev)
    px16 = bench_pixels(dev)
    keys = ("device_encode.native_finalize_chunks",
            "device_encode.python_finalize_chunks")
    tails = {}
    for label in ("native", "python"):
        with python_prep() if label == "python" else \
                contextlib.nullcontext():
            n0 = [default_metrics.counters[k] for k in keys]
            out = enc.encode_batch(px16, chunk=CHUNK)
            got = tuple(default_metrics.counters[k] - n
                        for k, n in zip(keys, n0))
            med, runs = median_s(lambda: enc.encode_batch(px16, chunk=CHUNK),
                                 E2E_RUNS)
        want = (len(chunks), 0) if label == "native" else (0, len(chunks))
        if got != want:
            raise AssertionError(f"{label} encode tail: (native, python) "
                                 f"chunk counts {got}, want {want}")
        tails[label] = out
        log(f"time encode_batch_ms[{label} tail]={med * 1e3} (median of "
            f"{len(runs)} runs of {STREAM_FRAMES} 1080p frames, chunk "
            f"{CHUNK}, host clock; run ms "
            f"{[round(r * 1e3, 3) for r in runs]}) [{card}]")
    if tails["native"] != tails["python"]:
        raise AssertionError("the native encode tail's bytes differ from "
                             "the NumPy tail's")
    log(f"native: encode_batch of {STREAM_FRAMES} frames, every chunk "
        f"through the native tail, byte-identical to the NumPy tail "
        f"({sum(map(len, tails['native']))} bytes)")

    # -- single images with native host entropy
    exact = json.loads((CORPUS / "exact.json").read_text())
    bench0 = bench[0]
    img = jpeg_tpu_torch.decode_jpeg(bench0, dev, exact=True,
                                     entropy="native")
    if hashlib.sha256(img.to_pnm()).hexdigest() != exact["pnm"]["bench"][0]:
        raise AssertionError("decode_jpeg(entropy='native') of bench frame "
                             "0 differs from jpeg_tpu's digest")
    log(f"native: decode_jpeg(bench frame 0, {dev}, exact=True, "
        f"entropy='native').to_pnm() equals jpeg_tpu's digest")
    ppm = synth.make_frame_ppm(0)
    for name, rec in exact["encode"].items():
        params = EncodeParams(exact=True, entropy_backend="native",
                              **rec["params"])
        data = jpeg_tpu_torch.encode_jpeg(ppm, params, dev)
        numpy_data = jpeg_tpu_torch.encode_jpeg(
            ppm, EncodeParams(exact=True, **rec["params"]), dev)
        if data != numpy_data or \
                hashlib.sha256(data).hexdigest() != rec["sha256"]:
            raise AssertionError(f"native encode {name}: differs from the "
                                 "numpy backend or jpeg_tpu's digest")
        log(f"native: encode_jpeg({name}, {dev}, entropy_backend='native') "
            f"byte-identical to the numpy backend and jpeg_tpu's digest "
            f"({len(data)} bytes)")
    params0 = EncodeParams(exact=True, entropy_backend="native",
                           **next(iter(exact["encode"].values()))["params"])
    geom, padded, qt = encode_inputs(ppm, params0, dev)
    planes = {cid: p.cpu().numpy()
              for cid, p in encode_frame(padded, geom, qt, True).items()}
    for key, run, part, what in (
            ("exact_decode_ms[native]",
             lambda: jpeg_tpu_torch.decode_jpeg(bench0, dev, exact=True,
                                                entropy="native"),
             lambda: jpeg_tpu_torch.decode_coefficients(bench0,
                                                        entropy="native"),
             "native host entropy (decode_coefficients)"),
            ("fast_decode_ms[native]",
             lambda: jpeg_tpu_torch.decode_jpeg(bench0, dev, exact=False,
                                                entropy="native"),
             lambda: jpeg_tpu_torch.decode_coefficients(bench0,
                                                        entropy="native"),
             "native host entropy (decode_coefficients)"),
            ("exact_encode_ms[native]",
             lambda: jpeg_tpu_torch.encode_jpeg(ppm, params0, dev),
             lambda: encode_jpeg_from_planes(planes, geom,
                                             qt.astype(np.uint16), params0,
                                             dev),
             "native host entropy and markers (encode_jpeg_from_planes)")):
        med, runs = median_s(run, 3)
        med_p, _ = median_s(part, 3)
        log(f"time {key}={med * 1e3} (1080p bench frame 0, median of "
            f"{len(runs)} runs, host clock; {what} {med_p * 1e3} ms; "
            f"{threads} host threads) [{card}]")

    # -- the CLI, as subprocesses on the card (all three at once)
    rec_name, rec = next(iter(exact["encode"].items()))
    p = rec["params"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "bench0.jpg").write_bytes(bench0)
        (tmp / "bench0.ppm").write_bytes(ppm)
        (tmp / "stream.mjpeg").write_bytes(stream)
        t0 = time.perf_counter()
        procs = {
            "decode": cli_run(["decode", str(tmp / "bench0.jpg"),
                               str(tmp / "out.ppm")]),
            "encode": cli_run(["encode", "-h", str(p["h"]), "-v",
                               str(p["v"]), "-q", str(p["quality"]), "-o",
                               str(int(p["optimize"])), "-r",
                               str(p["restart_interval"]),
                               "--entropy-backend", "native",
                               str(tmp / "bench0.ppm"),
                               str(tmp / "out.jpg")]),
            "mjpeg": cli_run(["mjpeg", str(tmp / "stream.mjpeg"),
                              str(tmp / "frames"), "--chunk", str(CHUNK)]),
        }
        for name, proc in procs.items():
            out = proc.communicate(timeout=300)[0]
            if proc.returncode != 0:
                raise AssertionError(f"cli {name} exited {proc.returncode}:"
                                     f"\n{out}")
        seconds = time.perf_counter() - t0
        if hashlib.sha256((tmp / "out.ppm").read_bytes()).hexdigest() != \
                exact["pnm"]["bench"][0]:
            raise AssertionError("cli decode: output differs from jpeg_tpu's "
                                 "digest")
        if hashlib.sha256((tmp / "out.jpg").read_bytes()).hexdigest() != \
                rec["sha256"]:
            raise AssertionError(f"cli encode {rec_name}: output differs "
                                 "from jpeg_tpu's digest")
        host_px = px.cpu().numpy()
        for i in range(STREAM_FRAMES):
            want = write_pnm(host_px[i].astype(np.float32), 1920, 1080, 8,
                             components=3)
            if (tmp / "frames" / f"frame_{i:05d}.ppm").read_bytes() != want:
                raise AssertionError(f"cli mjpeg: frame {i} differs from "
                                     "decode_stream_device's")
    log(f"native: cli decode (jpeg_tpu digest), encode {rec_name} "
        f"(jpeg_tpu digest) and mjpeg ({STREAM_FRAMES} frames equal to "
        f"decode_stream_device's) exited 0 on {dev}, {seconds:.1f} s "
        f"together [{card}]")


# Phase 16: the multi-device layer.  The batch of BatchConfig paths
# (bench.py's 1080p 4:2:0), its size and seed; the ri=9 frame's lane count
# (907) does not divide over two ranks, so its decode pads a lane.
PARALLEL_BATCH = 8
PARALLEL_SEED = 16
PAD_PARAMS = EncodeParams(h=2, v=2, quality=75, optimize=False,
                          restart_interval=9, exact=False)
# Wall limit of the two-rank run (its ranks are stopped past it).
PARALLEL_TIMEOUT_S = 240.0
# Runs of each path: a cold one (first launches, NCCL set-up) and a warm.
PARALLEL_RUNS = 2


def launch_deltas(before: dict) -> dict:
    """The kernel launches since ``before`` (``parallel_launches()``)."""
    return {k: n for k, n in ((k, c - before[k]) for k, c in
                              parallel_launches().items()) if n}


def parallel_launches() -> dict:
    from jpeg_tpu_torch.parallel.demo import kernel_wrappers

    return {k: f.launches for k, f in kernel_wrappers().items()}


def parallel_phase(card: str, dev: torch.device, streams: dict) -> dict:
    """Phase 16 (multi-device, ``jpeg_tpu_torch.parallel``): (a) every
    sharded path in this process over an NCCL group of one rank, against
    its single-device path bit for bit (and the batch paths against their
    plain versions); (b) the same paths in two spawned ranks on this one
    card over gloo, their gathered outputs (sha256) against (a)'s.  ->
    {kernel: {path: launches}} of both runs."""
    from torch.distributed.device_mesh import DeviceMesh

    from jpeg_tpu_torch.models import batch as mb
    from jpeg_tpu_torch.parallel import demo, distributed
    from jpeg_tpu_torch.parallel import sharding as sh

    mark("16")
    t_phase = time.perf_counter()
    bench = streams["bench"]
    frames4 = [bench[i % len(bench)] for i in range(STREAM_FRAMES)]
    px = bench_pixels(dev)
    enc7 = DeviceEncoder.for_config(synth.HEIGHT, synth.WIDTH, 3,
                                    GENERAL_PARAMS, device=dev)
    frames7 = enc7.encode_batch(px, optimize=False, chunk=CHUNK)
    pad = DeviceEncoder.for_config(synth.HEIGHT, synth.WIDTH, 3, PAD_PARAMS,
                                   device=dev).encode_batch(px[:1])[0]
    one_frames = {"bench0": bench[0], "ri7_0": frames7[0], "ri9_0": pad}
    lanes = {k: len(parse_codestream(f).scans[0].ecs_ranges)
             for k, f in one_frames.items()}
    if lanes["ri9_0"] % 2 == 0:
        raise AssertionError(f"the padding frame has {lanes['ri9_0']} lanes")
    cfg = mb.BatchConfig(synth.HEIGHT, synth.WIDTH, 2, 2)
    y, cb, cr, ql, qc = demo.batch_inputs(cfg, PARALLEL_BATCH, PARALLEL_SEED)
    batch = [torch.from_numpy(a).to(dev) for a in (y, cb, cr, ql, qc)]
    launches = {}  # kernel -> {path: launches}
    digests = {}  # (path, output) -> sha256 of (a)'s output

    def record(path, got, run):
        for k, n in got.items():
            launches.setdefault(k, {})[f"{run} {path}"] = n

    # -- (a) one rank, NCCL
    t_a = time.perf_counter()
    rank, world = distributed.initialize(f"localhost:{demo.free_port()}", 1,
                                         0, device="cuda")
    backend = torch.distributed.get_backend()
    if (rank, world, backend) != (0, 1, "nccl"):
        raise AssertionError(f"(a): group {rank}/{world} on {backend}")
    mesh = sh.make_mesh(1, 1, "cuda")
    mesh_f = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("frame",))
    log(f"parallel (a): {backend} group of {world}, mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
        f"{sh.local_device(mesh)} [{card}]")

    def path_a(name, run, check):
        secs = []
        for _ in range(PARALLEL_RUNS):  # the first is a warm-up, the last kept
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = parallel_launches()
            t0 = time.perf_counter()
            outs = run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            got = launch_deltas(before)
        record(name, got, "(a)")
        peak = torch.cuda.max_memory_allocated() / 2**20
        note = check(outs)
        for k, t in outs.items():
            digests[(name, k)] = demo._digest(t)
        log(f"parallel (a) {name}: wall ms {[round(t * 1e3, 3) for t in secs]}"
            f" (cold, warm), peak {peak:.1f} MiB, launches {got or '-'}; "
            f"{note} [{card}]")

    def equal(what, got, ref):
        if not torch.equal(got, ref):
            raise AssertionError(f"parallel (a) {what}: the sharded path "
                                 "differs from the single-device one")

    for name, frames, ri, place_ri in (("stream ri=4", frames4, 4, 4),
                                       ("stream ri=7", frames7, 7, 0)):
        dec = DeviceDecoder.for_stream(frames[0], dev)
        if dec.ri != ri:
            raise AssertionError(f"{name}: restart interval {dec.ri}")
        words, nbits, qt = dec.prepare(frames)

        def run(dec=dec, words=words, nbits=nbits, qt=qt,
                frames=frames, place_ri=place_ri):
            fn = sh.make_sharded_stream_decoder(dec, mesh, len(frames),
                                                place_ri=place_ri)
            got, counts = fn(words, nbits, qt)
            return {"px": sh.gather_full(got),
                    "counts": sh.gather_full(counts)}

        def check(o, dec=dec, frames=frames):
            equal(name, o["px"], dec.decode_batch(frames, chunk=CHUNK))
            if int(o["counts"].sum()) != dec.plan.n_mcus * len(frames):
                raise AssertionError(f"{name}: MCU counts short")
            return f"{len(frames)} frames equal to decode_batch"

        path_a(name, run, check)

    for label, frame in one_frames.items():
        def run(frame=frame):
            _, planes = sh.decode_frame_sharded(frame, mesh_f)
            return {f"c{c}": torch.from_numpy(p) for c, p in planes.items()}

        def check(o, frame=frame, label=label):
            _, ref = jpeg_tpu_torch.decode_coefficients(
                frame, entropy="lockstep-jax", device="cuda")
            for c, p in ref.items():
                equal(f"frame {label} c{c}", o[f"c{c}"], torch.from_numpy(p))
            return (f"{lanes[label]} lanes, planes equal to "
                    "decode_coefficients(lockstep-jax)")

        path_a(f"frame {label}", run, check)

    enc4 = DeviceEncoder.for_config(synth.HEIGHT, synth.WIDTH, 3,
                                    BENCH_PARAMS, device=dev)

    def run_enc():
        fn = sh.make_sharded_stream_encoder(enc4, mesh, STREAM_FRAMES,
                                            with_hist=True)
        words, seg_bits, n_words, missing, hist = fn(px)
        nw = int(n_words.to_local()[0])
        if int(missing.to_local()[0]):
            raise AssertionError("stream encode: a symbol has no code")
        jpegs = enc4._finalize_flat(words[:nw].cpu().numpy().view(np.uint32),
                                    seg_bits.to_local().cpu().numpy(),
                                    STREAM_FRAMES)
        half = STREAM_FRAMES // 2  # (b)'s ranks' bytes, one digest each
        return {"hist": sh.gather_full(hist),
                "seg_bits": sh.gather_full(seg_bits),
                **{f"jpegs.r{r}": torch.frombuffer(
                    bytearray(b"".join(part)), dtype=torch.uint8)
                   for r, part in enumerate((jpegs[:half], jpegs[half:]))}}

    def check_enc(o):
        ref = b"".join(enc4.encode_batch(px, chunk=CHUNK))
        if bytes(torch.cat([o["jpegs.r0"], o["jpegs.r1"]]).numpy()) != ref:
            raise AssertionError("stream encode: bytes differ from "
                                 "encode_batch")
        equal("stream encode hist", o["hist"],
              enc4.histogram(enc4.dense(px)))
        return f"{STREAM_FRAMES} frames equal to encode_batch, hist equal"

    path_a("stream encode", run_enc, check_enc)

    def run_dec(exact=False, b=PARALLEL_BATCH):
        fn = sh.make_sharded_decoder(cfg, mesh, exact=exact)
        ys, cbs, crs = sh.shard_batch(mesh, *(t[:b] for t in batch[:3]))
        qls, qcs = sh.replicate(mesh, *batch[3:])
        return {"px": sh.gather_full(fn(ys, cbs, crs, qls, qcs))}

    def check_dec(o, exact=False, b=PARALLEL_BATCH):
        args = [t[:b] for t in batch[:3]] + batch[3:]
        ref = mb.decode_batch_ycc(cfg, *args, exact=exact)
        equal("batch decode", o["px"], ref)
        plain = mb.decode_batch_ycc_ref(cfg, *args, exact=exact)
        err = float((ref - plain).abs().max())
        tol = 0.0 if exact else fast_tol(plain)
        if err > tol:
            raise AssertionError(f"batch decode: kernels vs plain {err} > "
                                 f"{tol}")
        return (f"equal to decode_batch_ycc; vs plain max |diff| {err} "
                f"(allowed {tol})")

    path_a("batch decode", run_dec, check_dec)
    path_a("batch decode exact", lambda: run_dec(True, 2),
           lambda o: check_dec(o, True, 2))

    def run_rt():
        fn = sh.make_sharded_roundtrip(cfg, mesh)
        ys, cbs, crs = sh.shard_batch(mesh, *batch[:3])
        qls, qcs = sh.replicate(mesh, *batch[3:])
        return dict(zip(("y2", "cb2", "cr2", "hist"),
                        (sh.gather_full(t) for t in fn(ys, cbs, crs, qls,
                                                       qcs))))

    def check_rt(o):
        ref = mb.roundtrip_step_ycc(cfg, *batch)
        for k, r in zip(("y2", "cb2", "cr2", "hist"), ref):
            equal(f"roundtrip {k}", o[k], r)
        if int(o["hist"].sum()) != PARALLEL_BATCH * cfg.n_luma_blocks:
            raise AssertionError("roundtrip: histogram does not sum to the "
                                 "luma blocks")
        # K12 against its plain version on the kernels' own RGB
        rgb = mb.decode_batch_ycc(cfg, *batch)
        err = 0
        for g, p in zip(mb.encode_batch_ycc(cfg, rgb, *batch[3:]),
                        mb.encode_batch_ycc_ref(cfg, rgb, *batch[3:])):
            err = max(err, check_dense("roundtrip re-encode", g - p,
                                       DENSE_DIFF_SHARE["noise"],
                                       "encode_batch_ycc"))
        ex = mb.encode_batch_ycc(cfg, rgb[:2], *batch[3:], exact=True)
        for g, p in zip(ex, mb.encode_batch_ycc_ref(cfg, rgb[:2], *batch[3:],
                                                    exact=True)):
            equal("encode_batch_ycc exact vs plain", g, p)
        return ("equal to roundtrip_step_ycc, histogram sums to the luma "
                f"blocks; re-encode vs plain max |diff| {err}; exact "
                "encode equal to plain")

    path_a("roundtrip", run_rt, check_rt)
    torch.distributed.destroy_process_group()
    sec_a = time.perf_counter() - t_a

    # -- (b) two ranks on this one card, gloo
    t_b = time.perf_counter()
    work = CORPUS.parents[2] / "build"
    work.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=str(work)) as tmp:
        tmp = Path(tmp)
        demo.frames_file(tmp / "ri4.npz", frames4)
        demo.frames_file(tmp / "ri7.npz", frames7)
        demo.frames_file(tmp / "one.npz", list(one_frames.values()))
        np.save(tmp / "pixels.npy", px.cpu().numpy())
        cfg_l = [cfg.height, cfg.width, cfg.h, cfg.v]
        params = {k: getattr(BENCH_PARAMS, k) for k in (
            "h", "v", "quality", "optimize", "restart_interval", "exact")}
        paths = [
            {"name": "stream ri=4", "kind": "stream_decode",
             "frames": "ri4.npz", "place_ri": 4, "mesh": [2, 1]},
            {"name": "stream ri=7", "kind": "stream_decode",
             "frames": "ri7.npz", "place_ri": 0, "mesh": [2, 1]},
            {"name": "frame", "kind": "frame_decode", "frames": "one.npz",
             "mesh": "frame"},
            {"name": "stream encode", "kind": "stream_encode",
             "pixels": "pixels.npy", "params": params,
             "with_hist": True, "mesh": [2, 1]},
            {"name": "batch decode", "kind": "batch_decode", "cfg": cfg_l,
             "batch": PARALLEL_BATCH, "seed": PARALLEL_SEED, "mesh": [1, 2]},
            {"name": "roundtrip", "kind": "roundtrip", "cfg": cfg_l,
             "batch": PARALLEL_BATCH, "seed": PARALLEL_SEED, "mesh": [1, 2]},
            {"name": "global batch", "kind": "global_batch",
             "frames": "ri4.npz", "mesh": "frame"},
        ]
        spec = tmp / "spec.json"
        spec.write_text(json.dumps({"paths": paths, "digest": True,
                                    "repeat": PARALLEL_RUNS}))
        demo.spawn(2, "jpeg_tpu_torch.parallel.demo:check_rank", str(spec),
                   "cuda", backend="gloo", timeout_s=PARALLEL_TIMEOUT_S)
        outs = {p["name"]: [dict(np.load(tmp / f"{p['name']}.r{r}.npz"))
                            for r in range(2)] for p in paths}
    sec_b = time.perf_counter() - t_b
    # what (b)'s gathered outputs must equal, by (path, output)
    want = {("stream ri=4", "px"): digests[("stream ri=4", "px")],
            ("stream ri=4", "counts"): digests[("stream ri=4", "counts")],
            ("stream ri=7", "px"): digests[("stream ri=7", "px")],
            ("stream ri=7", "counts"): digests[("stream ri=7", "counts")],
            ("stream encode", "hist"): digests[("stream encode", "hist")],
            ("stream encode", "seg_bits"):
                digests[("stream encode", "seg_bits")],
            ("batch decode", "px"): digests[("batch decode", "px")],
            ("global batch", "full"): digests[("stream ri=4", "px")]}
    for k in ("y2", "cb2", "cr2", "hist"):
        want[("roundtrip", k)] = digests[("roundtrip", k)]
    for i, label in enumerate(one_frames):
        for (path, k), d in digests.items():
            if path == f"frame {label}":
                want[("frame", f"f{i}_{k}")] = d
    for (path, k), d in want.items():
        for r, o in enumerate(outs[path]):
            if str(o[k]) != d:
                raise AssertionError(f"parallel (b) {path} {k} on rank {r} "
                                     "differs from (a)")
    for r, o in enumerate(outs["stream encode"]):
        if str(o["jpegs"]) != digests[("stream encode", f"jpegs.r{r}")]:
            raise AssertionError(f"parallel (b) stream encode: rank {r}'s "
                                 "bytes differ from encode_batch's")
    for p in paths:
        rows = outs[p["name"]]
        for k, n in json.loads(str(rows[0]["launches"])).items():
            launches.setdefault(k, {})[f"(b) {p['name']}"] = n
        walls = [[round(float(t) * 1e3, 3) for t in o["seconds"]]
                 for o in rows]
        log(f"parallel (b) {p['name']} mesh {p['mesh']}: wall ms a rank "
            f"(cold, warm) {walls}, peak "
            f"MiB {[round(float(o['peak_MiB']), 1) for o in rows]}, "
            f"launches a rank "
            f"{[json.loads(str(o['launches'])) for o in rows]} [{card}]")
    log(f"parallel (b): 2 ranks over gloo on one card, every gathered "
        f"output equal to (a)'s; both ranks share one card, so these times "
        f"show the collectives' cost, not scaling [{card}]")
    log(f"parallel: launches {json.dumps(launches)}")
    log(f"time parallel_phase_s={time.perf_counter() - t_phase} ((a) "
        f"{sec_a:.1f} s, (b) {sec_b:.1f} s with its spawn) [{card}]")
    return launches


def decoder(frame: bytes, dev: torch.device, mode: str) -> DeviceDecoder:
    """A fresh ``DeviceDecoder`` of ``frame``'s stream in the prep
    ``mode``."""
    dec = DeviceDecoder.for_stream(frame, dev)
    dec.prep_mode = mode
    return dec


def stream_decode(data: bytes, dev: torch.device, mode: str):
    """``mjpeg.decode_stream_device`` of a stream with restart markers,
    in the prep ``mode``: a fresh decoder of its first frame decodes the
    whole stream."""
    parts = jpeg_tpu_torch.mjpeg.split_stream(data)
    return decoder(parts[0], dev, mode).decode_batch(parts, chunk=CHUNK)


def flat_inputs(dec: DeviceDecoder, chunk: list, dev: torch.device) -> tuple:
    """(flat words [blen] int32, starts [S] int32 on ``dev``, lens [S]) of
    a chunk, from the decoder's flat host prep."""
    packed = dec._pack_flat(chunk)
    if packed is None:
        raise AssertionError("the flat prep refused a chunk")
    buf, starts, lens, _ = packed
    return (torch.from_numpy(buf.view(np.int32)).to(dev),
            torch.from_numpy(starts).to(dev), lens)


def flat_read_words(starts: torch.Tensor, wn: int, blen: int) -> int:
    """Distinct buffer words the rebuild reads: the union of each row's
    ``[start, start + wn)`` within the buffer (starts ascend)."""
    st = starts.cpu().numpy().astype(np.int64)
    if (np.diff(st) < 0).any():
        raise AssertionError("flat starts do not ascend")
    ends = np.minimum(st + wn, blen)
    return int((np.minimum(ends, np.r_[st[1:], blen]) - st).clip(0).sum())


def flat_phase(card: str, dev: torch.device, streams: dict,
               main_launches: int) -> dict:
    """Phase 17: the flat prep mode and K13 ``rows_from_flat``; -> the
    kernel's JSON entry, with ``main_launches``, K13's launches in phase
    5's main-path run (flat prep, the card's default)."""
    from jpeg_tpu_torch.models.flat_rows import rows_from_flat_ref

    mark("17")
    t_phase = time.perf_counter()
    bench = streams["bench"]
    frames4 = [bench[i % len(bench)] for i in range(STREAM_FRAMES)]
    enc7 = DeviceEncoder.for_config(synth.HEIGHT, synth.WIDTH, 3,
                                    GENERAL_PARAMS, device=dev)
    frames7 = enc7.encode_batch(bench_pixels(dev), optimize=False,
                                chunk=CHUNK)
    cases = {"ri=4": frames4, "ri=7": frames7}
    damaged = {"ri=4 damaged": [damage_frame(f, 37 + i)
                                for i, f in enumerate(frames4[:CHUNK])],
               "ri=7 damaged": [damage_frame(f, 37 + i)
                                for i, f in enumerate(frames7[:CHUNK])],
               "ri=4 cut": [cut_frame(f, 5 + i)
                            for i, f in enumerate(frames4[:CHUNK])],
               "ri=7 cut": [cut_frame(f, 5 + i)
                            for i, f in enumerate(frames7[:CHUNK])]}

    # -- K13 against its plain version, bit for bit
    err, checked = 0, []
    for label, frames in {**cases, **damaged}.items():
        dec = DeviceDecoder.for_stream(frames[0], dev)
        for lo in range(0, len(frames), CHUNK):
            buf, starts, _ = flat_inputs(dec, frames[lo:lo + CHUNK], dev)
            got = rows_from_flat(buf, starts, dec.wn)
            want = rows_from_flat_ref(buf, starts, dec.wn)
            err = max(err, int((got.long() - want.long()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"rows_from_flat {label} chunk {lo}: "
                                     "differs from rows_from_flat_ref")
            checked.append(f"{label}@{lo} {tuple(got.shape)}")
    rng = np.random.default_rng(17)  # rows that clip at both ends
    buf = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 1000,
                                        dtype=np.int64).astype(np.int32))
    starts = np.sort(rng.integers(0, 990, 300)).astype(np.int32)
    starts[0], starts[-3:] = -7, (995, 999, 1200)
    buf, starts = buf.to(dev), torch.from_numpy(starts).to(dev)
    got = rows_from_flat(buf, starts, 48)
    want = rows_from_flat_ref(buf, starts, 48)
    err = max(err, int((got.long() - want.long()).abs().max()))
    if not torch.equal(got, want):
        raise AssertionError("rows_from_flat: clipped rows differ from "
                             "rows_from_flat_ref")
    log(f"kernel-vs-plain rows_from_flat: max abs err {err}, equal bit "
        f"for bit on {len(checked)} chunks ({', '.join(checked)}) and on rows that "
        f"clip at both ends")

    # -- flat decode == rows decode on the card (each batch a fresh
    # decoder's first, whose rows are frame-major: a kept decoder's second
    # batch would take the learned lane order, phase 18; ``prepare`` is
    # frame-major unless asked)
    routes = {}
    for label, frames in {**cases, **damaged}.items():
        outs = {}
        for mode in ("rows", "flat"):
            before = dict(place_cuda.ROUTE_LAUNCHES)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)  # damage
                coeffs = decoder(frames[0], dev, mode).decode_coeffs_batch(
                    frames, chunk=CHUNK)
                dec = decoder(frames[0], dev, mode)
                px = dec.decode_batch(frames, chunk=CHUNK)
            counts = torch.cat([
                dec.decode_prepared(*dec.prepare(frames[i:i + CHUNK])[:2],
                                    len(frames[i:i + CHUNK]))[1]
                for i in range(0, len(frames), CHUNK)])
            torch.cuda.synchronize()
            routes[(label, mode)] = {
                k: v - before[k] for k, v in place_cuda.ROUTE_LAUNCHES.items()}
            outs[mode] = (coeffs, counts, px)
        for name, a, b in zip(("coefficients", "MCU counts", "pixels"),
                              outs["rows"], outs["flat"]):
            if not torch.equal(a, b):
                raise AssertionError(f"flat {label}: {name} differ from the "
                                     "rows decode")
        if routes[(label, "rows")] != routes[(label, "flat")]:
            raise AssertionError(f"flat {label}: word routes "
                                 f"{routes[(label, 'flat')]}, rows "
                                 f"{routes[(label, 'rows')]}")
        c = outs["flat"][1]
        log(f"flat {label}: {len(frames)} frames, coefficients "
            f"{tuple(outs['flat'][0].shape)}, lane MCU counts (sum "
            f"{int(c.sum())}) and pixels equal to the rows decode; word "
            f"routes {routes[(label, 'flat')]}")
    if routes[("ri=4", "flat")]["staged"] == 0:
        raise AssertionError("flat ri=4 chunks did not take the staged route")

    # -- the flat main path: counts from 0, one stream decode
    stream4 = b"".join(frames4)
    chunks = STREAM_FRAMES // CHUNK
    default_metrics.counters["device_decode.flat_prep_chunks"] = 0
    default_metrics.counters["device_decode.rows_prep_chunks"] = 0
    rows_from_flat.launches = 0
    decode_segments.launches = coeffs_to_pixels.launches = 0
    w0 = walk_counts()
    px_flat = jpeg_tpu_torch.mjpeg.decode_stream_device(stream4, dev,
                                                        chunk=CHUNK)
    torch.cuda.synchronize()
    check_walked("flat stream decode", w0, STREAM_FRAMES + 1)
    launches = rows_from_flat.launches
    got = (launches, decode_segments.launches, coeffs_to_pixels.launches,
           default_metrics.counters["device_decode.flat_prep_chunks"],
           default_metrics.counters["device_decode.rows_prep_chunks"])
    if got != (chunks, chunks, chunks, chunks, 0):
        raise AssertionError(f"flat stream decode: (rows_from_flat, "
                             f"decode_segments, coeffs_to_pixels) launches, "
                             f"(flat, rows) chunks {got}")
    px_rows = stream_decode(stream4, dev, "rows")
    if not torch.equal(px_flat, px_rows):
        raise AssertionError("flat stream decode: pixels differ from rows")
    log(f"flat: decode_stream_device of {STREAM_FRAMES} ri=4 frames (flat "
        f"prep, the card's default): launches rows_from_flat {launches}, "
        f"decode_segments {got[1]}, coeffs_to_pixels {got[2]}, flat chunks "
        f"{got[3]}; pixels equal to a rows decoder's")

    # -- K13's times and bound on the bench chunk
    dec = DeviceDecoder.for_stream(bench[0], dev)
    chunk = frames4[:CHUNK]
    buf, starts, lens = flat_inputs(dec, chunk, dev)
    S, wn, blen = starts.numel(), dec.wn, buf.numel()
    k_ms, kd_ms = kernel_ms("rows_from_flat",
                            lambda: rows_from_flat(buf, starts, wn), 20, card)
    p_ms = cuda_ms(lambda: rows_from_flat_ref(buf, starts, wn), 5)
    read = flat_read_words(starts, wn, blen)
    k_bound = bound(4 * read + 4 * S * wn + nbytes(starts), 0, "int32")
    log(f"time rows_from_flat_ms={k_ms} device_ms={kd_ms} plain_ms={p_ms} "
        f"per {CHUNK}-frame 1080p chunk ({S} rows of {wn} words from "
        f"{blen} buffer words, {read} of them read) [{card}]")
    log_bound("rows_from_flat", k_ms, k_bound, card, kd_ms)

    # -- upload bytes, host prep and stream rates in each mode, in turns
    dec.prep_mode = "rows"
    rows_w, rows_n, _ = dec.prepare(chunk)
    up = {"rows": nbytes(rows_w, rows_n),
          "flat": 4 * blen + nbytes(starts) + 4 * S}
    log(f"flat: upload bytes per {CHUNK}-frame ri=4 chunk: rows {up['rows']}"
        f" ([{S}, {rows_w.shape[1]}] words + bit counts), flat {up['flat']} "
        f"({blen} buffer words + starts + bit counts; "
        f"{int(lens.astype(np.int64).sum())} segment bytes) [{card}]")
    mpix = STREAM_FRAMES * synth.WIDTH * synth.HEIGHT / 1e6
    streams_b = {"ri=4": stream4, "ri=7": b"".join(frames7)}
    preps = {m: [] for m in ("rows", "flat")}
    rates = {(k, m): [] for k in streams_b for m in ("rows", "flat")}
    pdec = DeviceDecoder.for_stream(bench[0], dev)
    for turn in range(E2E_RUNS + 1):  # turn 0 warms up
        for mode in (("rows", "flat") if turn % 2 else ("flat", "rows")):
            pdec.prep_mode = mode
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(0, STREAM_FRAMES, CHUNK):
                pdec.prepare(frames4[i:i + CHUNK])
            torch.cuda.synchronize()
            if turn:
                preps[mode].append((time.perf_counter() - t0) * 1e3)
            for key, data in streams_b.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stream_decode(data, dev, mode)
                torch.cuda.synchronize()
                if turn:
                    rates[(key, mode)].append(
                        mpix / (time.perf_counter() - t0))
    for mode in ("rows", "flat"):
        p = sorted(preps[mode])
        log(f"time host_prep_ms[{mode}]={p[len(p) // 2]} (median of {len(p)}"
            f" runs: native {mode} prep and upload of {STREAM_FRAMES} ri=4 "
            f"frames, host clock; run ms {p}) [{card}]")
        for key in streams_b:
            r = sorted(rates[(key, mode)])
            log(f"time e2e_stream_Mpix_s[{key} {mode}]={r[len(r) // 2]} "
                f"(median of {len(r)} runs of {STREAM_FRAMES} frames from "
                f"bytes, host clock; runs {r}) [{card}]")

    # -- the upload rate at which rows would beat flat
    even = (up["rows"] - up["flat"]) / (kd_ms / 1e3)
    even_call = (up["rows"] - up["flat"]) / (k_ms / 1e3)
    log(f"flat: break-even upload rate {even} B/s ({up['rows'] - up['flat']}"
        f" more bytes for rows over K13's device-only {kd_ms} ms; "
        f"{even_call} B/s over its whole call, {k_ms} ms): rows would beat "
        f"flat only over a faster link [{card}]")
    log(f"time flat_phase_s={time.perf_counter() - t_phase} [{card}]")
    return {"name": "rows_from_flat", "route": "cuda",
            "source": "jpeg_tpu_torch/csrc/flat_rows.cu",
            "replaces": "jpeg_tpu/models/device_decode.py:272",
            "launches": main_launches, "max_abs_err": err, "ms": k_ms,
            "device_ms": kd_ms, "plain_ms": p_ms, **k_bound}


def lane_order_case(label: str, plan: ScanPlan, words: torch.Tensor,
                    nbits: torch.Tensor, perm, frames: int, spf: int,
                    tb: int) -> tuple:
    """K2 with the lane order ``perm`` (or none) and its steps against its
    plain version on the same card inputs, on both word routes: the
    coefficients, frame-major MCU counts and steps integer for integer.
    -> (max |diff|, the plain version's (coeffs, counts, nsteps))."""
    args = (plan, words, nbits, frames, spf, tb)
    ref = decode_segments_general_ref(*args, perm=perm, want_nsteps=True)
    err = 0
    for budget in (place_cuda.STAGE_BYTES, 0):
        saved, place_cuda.STAGE_BYTES = place_cuda.STAGE_BYTES, budget
        try:
            got = decode_segments_general(*args, perm=perm, want_nsteps=True)
        finally:
            place_cuda.STAGE_BYTES = saved
        torch.cuda.synchronize()
        err = max(err, max_err(got, ref))
        for name, a, b in zip(("coefficients", "MCU counts", "steps"), got,
                              ref):
            if a.dtype != torch.int32 or not torch.equal(a, b):
                raise AssertionError(
                    f"lane order {label}: decode_segments_general's {name} "
                    f"(stage budget {budget} bytes) differ from the plain "
                    f"version's (max |diff| {max_err([a], [b])})")
    return err, ref


def phased_phase(card: str, dev: torch.device, streams: dict) -> dict:
    """Phase 18: jpeg_tpu's learned lane order on the card (a kept
    ``DeviceDecoder`` in "rows" prep, K2 ``decode_segments_general`` with
    a ``perm``); -> the lane-order kernel's JSON entry, its launches those
    of the ri=7 stream's sorted batch."""
    mark("18")
    t_phase = time.perf_counter()
    bench = streams["bench"]
    frames4 = [bench[i % len(bench)] for i in range(STREAM_FRAMES)]
    enc7 = DeviceEncoder.for_config(synth.HEIGHT, synth.WIDTH, 3,
                                    GENERAL_PARAMS, device=dev)
    px7 = bench_pixels(dev)
    frames7 = enc7.encode_batch(px7, optimize=False, chunk=CHUNK)

    # -- K2 with a lane order against its plain version, on the 8-frame
    # ri=7 chunk in the order its learning batch gives it
    chunk = frames7[:CHUNK]
    dec = decoder(chunk[0], dev, "rows")
    dec.decode_coeffs_batch(chunk, chunk=CHUNK)  # the learning batch
    prepared = dec.prepare(chunk, lane_order=True)
    frame_major = dec.prepare(chunk)
    if dec.lane_steps is None or prepared.kind != "mats" or \
            frame_major.kind != "mat":
        raise AssertionError(f"ri=7 chunk: prep kinds {prepared.kind}, "
                             f"{frame_major.kind} after a learning batch")
    words, nbits, _ = prepared
    perm = prepared.perm
    spf, tb = dec.segs_per_frame, dec.total_blocks
    bad_w, bad_n = damage(words, nbits, 18)
    err, refs = 0, {}
    for label, plan, w, n, p in (
            ("sorted intact", dec.plan, words, nbits, perm),
            ("sorted damaged", dec.plan, bad_w, bad_n, perm),
            ("sorted damaged, hostile tables", hostile_plan(chunk[0]), bad_w,
             bad_n, perm),
            ("frame-major intact", dec.plan, *frame_major[:2], None)):
        e, refs[label] = lane_order_case(label, plan, w, n, p, CHUNK, spf, tb)
        err = max(err, e)
        short = refs[label][1].cpu() - lane_mcus(dec, CHUNK)
        if ("intact" in label) == bool((short != 0).any()):
            raise AssertionError(f"lane order {label}: lanes short of their "
                                 f"MCUs: {int((short < 0).sum())}")
        log(f"kernel-vs-plain decode_segments_general {label} ri=7 chunk "
            f"x{CHUNK}: {words.shape[0]} lanes ({int((short < 0).sum())} "
            f"died short of their MCUs), coefficients, frame-major MCU "
            f"counts and steps equal on both word routes (longest lane "
            f"{int(refs[label][2].max())} steps)")
    for a, b in zip(refs["sorted intact"], refs["frame-major intact"]):
        if not torch.equal(a, b):
            raise AssertionError("ri=7 chunk: the sorted decode differs from "
                                 "the frame-major one")
    # The count walk's layout with the lane order (its per-frame tickets
    # from a warp's lanes of one frame at a time), against the plain scan.
    for tag, (w, n) in (("intact", (words, nbits)),
                        ("damaged", (bad_w, bad_n))):
        got = place_cuda._general_layout(dec.plan, w, n, CHUNK, spf, tb, perm)
        counts, key, _, _ = scan_lanes(dec.plan, w, n)
        partial = place_cuda._to_frame_major(
            place_cuda.partial_lanes(counts, key), perm)
        counts = place_cuda._to_frame_major(counts, perm)
        want = (counts, partial, *place_cuda.lane_layout(counts, CHUNK, spf),
                place_cuda.contested_rows(counts, partial, CHUNK, spf,
                                          dec.plan.n_mcus))
        torch.cuda.synchronize()
        for name, a, b in zip(("counts", "partial", "lane_off",
                               "lane_first", "contested"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"lane order {tag}: the count walk's "
                                     f"{name} differs from the plain scan's")
        log(f"lane order {tag}: the count walk's counts, partial flags and "
            f"layout equal to the plain scan's ({int(want[4].sum())} "
            "contested MCUs)")

    # -- a kept decoder: its first batch learns, its second runs sorted
    def kept(label: str, frames: list) -> tuple:
        d = decoder(frames[0], dev, "rows")
        d.place_ri = 0  # K2, also where the region kernel takes the shape
        first = d.decode_batch(frames, chunk=CHUNK)
        torch.cuda.synchronize()
        if d.lane_steps is None:
            raise AssertionError(f"{label}: the first batch learned nothing")
        keys = ("mats_chunks", "learn_chunks", "phase_inflate")
        for k in keys:
            default_metrics.counters[f"device_decode.{k}"] = 0
        decode_segments_general.launches = 0
        decode_segments_general.lane_order_launches = 0
        decode_segments.launches = coeffs_to_pixels.launches = 0
        second = d.decode_batch(frames, chunk=CHUNK)
        torch.cuda.synchronize()
        got = {k: default_metrics.counters[f"device_decode.{k}"]
               for k in keys}
        got.update(k2=decode_segments_general.launches,
                   k2_lane_order=decode_segments_general.lane_order_launches,
                   k1=decode_segments.launches,
                   k3=coeffs_to_pixels.launches)
        chunks = -(-len(frames) // CHUNK)
        want = {"mats_chunks": chunks, "learn_chunks": 0, "phase_inflate": 0,
                "k2": chunks, "k2_lane_order": chunks, "k1": 0, "k3": chunks}
        if got != want:
            raise AssertionError(f"{label}: second batch {got}, want {want}")
        if not torch.equal(first, second):
            raise AssertionError(f"{label}: the sorted batch's pixels differ "
                                 "from the learning batch's")
        log(f"phased {label}: a kept DeviceDecoder (rows prep), first batch "
            f"learned {d.segs_per_frame} segment bounds (max_steps "
            f"{d.max_steps}, longest prediction {int(d.lane_steps.max())}), "
            f"second batch {got}: pixels equal to the first's")
        return d, got["k2_lane_order"]

    dec7, launches = kept(f"ri=7 x{STREAM_FRAMES}", frames7)
    coeffs = dec7.decode_coeffs_batch(frames7, chunk=CHUNK)
    blocks = torch.cat([enc7.dense(px7[i:i + CHUNK])
                        for i in range(0, STREAM_FRAMES, CHUNK)])
    prev = torch.from_numpy(enc7.prev_idx).to(dev)
    if not torch.equal(raster_to_zz(coeffs, prev), blocks):
        raise AssertionError("ri=7 sorted decode: blocks differ from the "
                             "encoder's")
    log("phased ri=7: a third, sorted decode_coeffs_batch gives the "
        "encoder's blocks")
    _, launches4 = kept(f"ri=4 place_ri=0 x{STREAM_FRAMES}", frames4)

    # -- times: K2 sorted against frame-major on the same chunk, in turns
    fm_args = (dec.plan, *frame_major[:2], CHUNK, spf, tb)
    so_args = (dec.plan, words, nbits, CHUNK, spf, tb)
    # The decoder's own order, checked above: timed as the decoder
    # launches it, with no host read of its values (a graph captures it).
    runs = {"frame-major": lambda: decode_segments_general(*fm_args),
            "sorted": lambda: decode_segments_general(
                *so_args, perm=perm, want_nsteps=True, perm_checked=True)}
    walks = {"frame-major": lambda: place_cuda._general_layout(*fm_args),
             "sorted": lambda: place_cuda._general_layout(
                 *so_args, perm=perm, perm_checked=True)}
    times = {k: [] for k in runs}
    walk_times = {k: [] for k in runs}
    for order in ("frame-major", "sorted", "sorted", "frame-major"):
        times[order].append(kernel_ms(f"decode_segments_general {order}",
                                      runs[order], 20, card))
        walk_times[order].append(kernel_ms(f"count walk {order}",
                                           walks[order], 20, card))
    for order in runs:
        ms = [t[0] for t in times[order]]
        dms = [t[1] for t in times[order]]
        wdms = [t[1] for t in walk_times[order]]
        log(f"time decode_segments_general_ms[{order}]={ms} device_ms={dms} "
            f"count walk with its layouts device_ms={wdms} (share of the "
            f"call's device time {[w / d for w, d in zip(wdms, dms)]}) per "
            f"{CHUNK}-frame ri=7 1080p chunk, in turns [{card}]")
    k_ms = float(np.mean([t[0] for t in times["sorted"]]))
    kd_ms = float(np.mean([t[1] for t in times["sorted"]]))
    p_ms = cuda_ms(lambda: decode_segments_general_ref(
        *so_args, perm=perm, want_nsteps=True), 2)
    out = decode_segments_general(*so_args, perm=perm, want_nsteps=True)
    nb64 = nbits.to(torch.int64)
    b = bound(int(((nb64 + 7) // 8).sum()) + nbytes(nbits, perm, *out)
              + 4 * place_cuda._staged_ints(dec.plan), int(nb64.sum()),
              "int32")
    log(f"time decode_segments_general_lane_order_ms={k_ms} device_ms={kd_ms}"
        f" plain_ms={p_ms} (plain: the eager scan and placement with the "
        f"lane order) [{card}]")
    log_bound("decode_segments_general (lane order)", k_ms, b, card, kd_ms)

    foreign_perm_phase(card, dec7, frames7)
    redo_phase(card, dec7, frames7)
    profile_window(lambda: dec7.decode_batch(frames7, chunk=CHUNK),
                   "device_decode.", card,
                   f"{STREAM_FRAMES}-frame ri=7 decode, a kept decoder, "
                   f"rows sorted")
    log(f"phased: lane-order launches ri=7 {launches}, ri=4 place_ri=0 "
        f"{launches4}")
    log(f"time phased_phase_s={time.perf_counter() - t_phase} [{card}]")
    return {"name": "decode_segments_general (lane order)", "route": "cuda",
            "source": "jpeg_tpu_torch/csrc/decode_segments.cu",
            "replaces": "jpeg_tpu/entropy/lockstep_jax.py:499",
            "launches": launches, "max_abs_err": err, "ms": k_ms,
            "device_ms": kd_ms, "plain_ms": p_ms, **b}


def foreign_perm_phase(card: str, dec, frames: list) -> None:
    """A lane order from a caller is checked on the card, the decoder's
    own is not: a repeated lane and one out of range raise ValueError
    through ``DeviceDecoder.decode_prepared`` and
    ``decode_segments_general``; a valid foreign order (a copy of the
    decoder's) decodes as the decoder's own does; and a sorted batch of
    the kept decoder makes no host sync in ``place_cuda.py`` and one host
    read (``device_decode.readback``)."""
    prepared = dec.prepare(frames[:CHUNK], lane_order=True)
    if prepared.kind != "mats":
        raise AssertionError(f"foreign perm: a {prepared.kind} chunk")
    words, nbits, _ = prepared
    own = prepared.perm
    S, spf, tb = own.numel(), dec.segs_per_frame, dec.total_blocks
    repeated, outside = own.clone(), own.clone()
    repeated[1] = repeated[0]
    outside[-1] = S
    entries = {
        "decode_prepared": lambda p: dec.decode_prepared(
            words, nbits, CHUNK, perm=p),
        "decode_segments_general": lambda p: decode_segments_general(
            dec.plan, words, nbits, CHUNK, spf, tb, perm=p)}
    for entry, run in entries.items():
        for label, bad in (("a repeated lane", repeated),
                           ("a lane out of range", outside)):
            try:
                run(bad)
            except ValueError as e:
                log(f"foreign perm: {entry} with {label} raises ValueError "
                    f"({e})")
            else:
                raise AssertionError(f"foreign perm: {entry} took an order "
                                     f"with {label}")
        want = run(own)
        got = run(own.clone())
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"foreign perm: {entry} with a copy of the "
                                 "decoder's order decodes otherwise")
    sites = []

    def on_warning(message, category, filename, lineno, file=None,
                   line=None):
        if "called a synchronizing CUDA operation" in str(message):
            stack = traceback.extract_stack()
            sites.append((any(f.filename.endswith("place_cuda.py")
                              for f in stack), f"{Path(filename).name}:"
                          f"{lineno}"))

    reads = default_metrics.stages["device_decode.readback"].calls
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            dec.decode_batch(frames, chunk=CHUNK)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    reads = default_metrics.stages["device_decode.readback"].calls - reads
    in_check = [site for inside, site in sites if inside]
    log(f"foreign perm: a sorted {len(frames)}-frame batch of the kept "
        f"decoder: {len(sites)} host syncs (uploads included) at "
        f"{[site for _, site in sites]}, {reads} host read(s), none in "
        f"place_cuda.py: {not in_check} [{card}]")
    if in_check or reads != 1:
        raise AssertionError(f"foreign perm: the decoder's own order made "
                             f"syncs in place_cuda.py at {in_check}, "
                             f"{reads} host reads")


def redo_phase(card: str, dec, frames: list) -> None:
    """What a misprediction costs a kept, learned decoder: bounds of 8
    steps a segment (jpeg_tpu's own test of it) starve every "mats"
    chunk, which is then redone frame-major, learning again (the redo
    that keeps jpeg_tpu's result on damaged chunks).  Timed against the
    sorted batch, in turns, host clock; the learned state is put back
    after each run.  Fails unless every chunk of a mispredicted batch,
    and none of a sorted one, is redone, and unless both give the same
    pixels."""
    chunks = -(-len(frames) // CHUNK)
    ref = dec.decode_batch(frames, chunk=CHUNK)
    keep = (dec.lane_steps, dec.sort_order, dec.max_steps)
    ms = {"sorted": [], "mispredicted": []}
    for turn in range(E2E_RUNS + 1):  # turn 0 warms up
        for order in (("sorted", "mispredicted") if turn % 2
                      else ("mispredicted", "sorted")):
            if order == "mispredicted":
                dec.lane_steps = np.full(dec.segs_per_frame, 8, np.int64)
                dec.sort_order = np.arange(dec.segs_per_frame)
            default_metrics.counters["device_decode.phase_inflate"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            px = dec.decode_batch(frames, chunk=CHUNK)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            redone = default_metrics.counters["device_decode.phase_inflate"]
            dec.lane_steps, dec.sort_order, dec.max_steps = keep
            want = chunks if order == "mispredicted" else 0
            if redone != want:
                raise AssertionError(f"redo: {order} batch redid {redone} "
                                     f"chunks, want {want}")
            if not torch.equal(px, ref):
                raise AssertionError(f"redo: the {order} batch's pixels "
                                     "differ from the sorted batch's")
            if turn:
                ms[order].append(dt)
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    log(f"time redo_batch_ms[ri=7 rows sorted]={med['sorted']} "
        f"[mispredicted, {chunks} chunks redone]={med['mispredicted']} "
        f"(medians of {E2E_RUNS} runs of {len(frames)} frames from bytes, "
        f"a kept decoder, host clock; redo cost "
        f"{med['mispredicted'] - med['sorted']} ms a batch; runs {ms}) "
        f"[{card}]")


def digest(out) -> str:
    """sha256 of a tensor or a tuple of tensors, on the host."""
    h = hashlib.sha256()
    for t in (out if isinstance(out, tuple) else (out,)):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def scan_digest(out) -> str:
    """``digest`` of encode_scan's stream (its words up to the word count,
    where the checkout returns one), segment bases, bits and missing."""
    words = out[0][:int(out[4])] if len(out) > 4 else out[0]
    return digest((words, *out[1:4]))


def jpegs_digest(frames) -> str:
    """sha256 of a list of JPEG byte strings."""
    return hashlib.sha256(b"".join(frames)).hexdigest()


def time_tree(tree: str) -> dict:
    """``--time-tree`` (a worker of ``--compare``): the segment decode
    kernels, the dense decode tail, the device-resident decode, the encode
    kernels and the end-to-end encode of the checkout
    at ``tree``, whose package this process imported, on this card -> the
    JSON record of their times, peak device memory and output digests."""
    here = Path(jpeg_tpu_torch.__file__).resolve()
    if not here.is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {here}, not the package of {tree}")
    card = card_label()
    set_precision()
    dev = torch.device("cuda")
    bench = frames_of("bench")
    chunk4 = [bench[i % len(bench)] for i in range(CHUNK)]
    dec4 = DeviceDecoder.for_stream(chunk4[0], dev)
    w4, n4, q4 = dec4.prepare(chunk4)
    c4, _ = dec4.decode_prepared(w4, n4, CHUNK)
    # The 16 bench frames prepared in chunks: the device-resident decode.
    prep16 = [dec4.prepare([bench[j % len(bench)]
                            for j in range(i, i + CHUNK)])
              for i in range(0, STREAM_FRAMES, CHUNK)]

    def resident():
        return tuple(coeffs_to_pixels(dec4.decode_prepared(w, n, CHUNK)[0],
                                      q, dec4.geom) for w, n, q in prep16)
    enc = DeviceEncoder.for_config(synth.HEIGHT, synth.WIDTH, 3,
                                   GENERAL_PARAMS, device=dev)
    px = bench_pixels(dev)[:CHUNK]
    chunk7 = enc.encode_batch(px, optimize=False, chunk=CHUNK)
    dec7 = DeviceDecoder.for_stream(chunk7[0], dev)
    w7, n7, _ = dec7.prepare(chunk7)
    g7 = (CHUNK, dec7.segs_per_frame, dec7.total_blocks)
    bad7 = damage(w7, n7, 0)
    a4 = (dec4.plan, w4, n4, CHUNK, dec4.segs_per_frame, dec4.ri,
          dec4.total_blocks)
    # The encode kernels on the bench pixels; encode_scan on the plain
    # dense stage's blocks, the same input in every checkout.
    enc4 = DeviceEncoder.for_config(synth.HEIGHT, synth.WIDTH, 3,
                                    BENCH_PARAMS, device=dev)
    # One segment per frame: one warp per frame in the redesigned kernel.
    enc1 = DeviceEncoder.for_config(
        synth.HEIGHT, synth.WIDTH, 3,
        EncodeParams(h=2, v=2, quality=75, optimize=False,
                     restart_interval=enc4.geom.n_mcus, exact=False),
        device=dev)
    dense = {}
    for e in (enc4, enc, enc1):
        qt = torch.from_numpy(e.qtables).to(dev)
        prev = torch.from_numpy(e.prev_idx).to(dev)
        dense[e.ri] = (px, qt, prev, e.geom)
    sargs = {e.ri: (pixels_to_zz_ref(*dense[e.ri]), *e.chunk_tables(CHUNK),
                    torch.from_numpy(e.ehufco).to(dev),
                    torch.from_numpy(e.ehufsi).to(dev),
                    CHUNK * e.n_segments) for e in (enc4, enc, enc1)}
    px16 = bench_pixels(dev)
    # K7 on the plain dense stage's blocks of the 8 bench frames; K4's
    # FDCT on the 1080p Y plane of the exact encode (bench frame 0)
    _, _, dc4, ac4 = enc4.chunk_tables(CHUNK)
    hargs = (sargs[4][0], dc4, ac4, len(enc4.table_keys))
    ycc = color_exact_ref(torch.from_numpy(synth.make_frame(0)).to(dev)
                          .to(torch.float32), 8, "to_ycc")
    fargs = (plane_to_blocks(ycc[..., 0], 135, 240).reshape(-1, 64)
             .contiguous(), torch.from_numpy(enc4.qtables[0]).to(dev), 8)
    # K4's IDCT on the 1080p Y plane of the exact decode (bench frame 0)
    cs0, planes0 = jpeg_tpu_torch.decode_coefficients(bench[0])
    y0 = cs0.geometry.components[0]
    iargs = (torch.from_numpy(planes0[y0.cid]).to(dev),
             torch.from_numpy(cs0.qtables[y0.tq].astype(np.int32)).to(dev),
             8)
    # name -> (one call, its digest, timing: "routed" (each word route,
    # CUDA events), "device" (CUDA events) or "host" (host clock))
    cases = {
        "decode_segments ri=4": (lambda: decode_segments(*a4), digest,
                                 "routed"),
        "dense_tail ri=4": (lambda: coeffs_to_pixels(c4, q4, dec4.geom),
                            digest, "device"),
        f"device_resident ri=4 x{STREAM_FRAMES}": (resident, digest,
                                                   "device"),
        "decode_segments_general ri=7": (
            lambda: decode_segments_general(dec7.plan, w7, n7, *g7), digest,
            "routed"),
        "decode_segments_general ri=7 damaged": (
            lambda: decode_segments_general(dec7.plan, *bad7, *g7), digest,
            "routed"),
        "pixels_to_zz ri=4": (lambda: pixels_to_zz(*dense[4]), digest,
                              "device"),
        "encode_scan ri=4": (lambda: encode_scan(*sargs[4]), scan_digest,
                             "device"),
        "encode_scan ri=7": (lambda: encode_scan(*sargs[7]), scan_digest,
                             "device"),
        f"encode_scan ri={enc1.ri}": (lambda: encode_scan(*sargs[enc1.ri]),
                                      scan_digest, "device"),
        "block_histogram ri=4": (lambda: block_histogram(*hargs), digest,
                                 "device"),
        "fdct_exact 1080p Y": (lambda: fdct_exact(*fargs), digest, "device"),
        "idct_exact 1080p Y": (lambda: idct_exact(*iargs), digest, "device"),
        "encode_batch ri=4 x16": (
            lambda: enc4.encode_batch(px16, optimize=False, chunk=CHUNK),
            jpegs_digest, "host"),
        "encode_batch ri=4 x16 optimize": (
            lambda: enc4.encode_batch(px16, optimize=True, chunk=CHUNK),
            jpegs_digest, "host"),
    }
    if importlib.util.find_spec("jpeg_tpu_torch.entropy.speculative"):
        # The RST-less stream (phase 13's), where the checkout has the
        # engine; a checkout before it decodes such frames on the host.
        rl = b"".join(drop_dri(f) for f in enc1.encode_batch(
            px16, optimize=False, chunk=CHUNK))
        cases[f"rstless ri=0 x{STREAM_FRAMES}"] = (
            lambda: jpeg_tpu_torch.mjpeg.decode_stream_device(rl, dev,
                                                              chunk=CHUNK),
            digest, "host")
    if importlib.util.find_spec("jpeg_tpu_torch.models.dense_fast"):
        # K11 and K12 on bench frame 0, where the checkout has them (an
        # older one runs the eager chain, whose floats differ).
        g0, c0, q0 = plane_major(bench[0], dev)
        g_e, f_e, q_e = encode_inputs(synth.make_frame_ppm(0), BENCH_PARAMS,
                                      dev)
        q_e = torch.from_numpy(q_e).to(dev)
        cases["decode_frame_fast 1080p"] = (
            lambda: decode_frame_fast(c0, q0, g0), digest, "device")
        cases["encode_frame_fast 1080p"] = (
            lambda: encode_frame_fast(f_e, q_e, g_e), digest, "device")
    # (label, shared-memory budget of the staged words; None: as it is)
    routes = [("default", None)]
    if hasattr(place_cuda, "STAGE_BYTES"):
        routes.append(("lookahead", 0))
    out = {"tree": tree, "card": card, "torch": torch.__version__,
           "cases": {}}
    for name, (call, dig, timing) in cases.items():
        rec = {"sha256": dig(call()), "ms": {}, "device_ms": {},
               "host_ms": {}}
        # Device memory allocated at the peak of one call, in MiB, and
        # what was held when it started (inputs, cached buffers).
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec["held_MiB"] = torch.cuda.memory_allocated() / 2**20
        call()
        torch.cuda.synchronize()
        rec["peak_MiB"] = torch.cuda.max_memory_allocated() / 2**20
        for label, budget in routes if timing == "routed" else routes[:1]:
            saved = getattr(place_cuda, "STAGE_BYTES", None)
            if budget is not None:
                place_cuda.STAGE_BYTES = budget
            try:
                if dig(call()) != rec["sha256"]:
                    raise AssertionError(f"{tree} {name}: the {label} "
                                         "route's output differs")
                rec["ms"][label] = [
                    median_s(call, 5)[0] * 1e3 if timing == "host"
                    else cuda_ms(call, 20) for _ in range(3)]
                if timing != "host":  # device-only: a graph of 20 calls
                    rec["device_ms"][label] = [device_ms(call, 20)
                                               for _ in range(3)]
                    rec["host_ms"][label] = [enqueue_ms(call, 20)
                                             for _ in range(3)]
            finally:
                if budget is not None:
                    place_cuda.STAGE_BYTES = saved
        log(f"compare {tree} {name}: ms {rec['ms']}, device-only ms "
            f"{rec['device_ms']}, host ms a call to enqueue "
            f"{rec['host_ms']}, peak "
            f"{rec['peak_MiB']} MiB (held {rec['held_MiB']}) [{card}]")
        by_kernel = profile_window(call, "device_", card,
                                   f"one {name} call of {tree}", top=16)
        # device launches of one call, by kernel (as the profiler saw them)
        rec["launches"] = {k[:80]: n for k, (n, _) in by_kernel.items()}
        out["cases"][name] = rec
    return out


def compare_trees(trees: list) -> None:
    """``--compare``: ``time_tree`` for each checkout in turn, each in a
    process of its own; every checkout's outputs must be equal."""
    if not torch.cuda.is_available() or not trees:
        raise SystemExit("chip_smoke --compare: needs a CUDA card and "
                         "at least one checkout")
    digests = {}
    for tree in trees:
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--time-tree",
             tree], capture_output=True, text=True,
            timeout=900)
        sys.stdout.write(res.stdout)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            raise SystemExit(f"chip_smoke --time-tree {tree} failed "
                             f"({res.returncode})")
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        for name, case in rec["cases"].items():
            if digests.setdefault(name, case["sha256"]) != case["sha256"]:
                raise AssertionError(f"{name}: the output of {tree} "
                                     f"differs from an earlier run's")
    log(f"compare: the outputs of {len(trees)} runs are equal")


def main() -> None:
    argv = sys.argv[1:]
    if argv[:1] == ["--compare"]:
        compare_trees(argv[1:])
        return
    if argv[:1] == ["--time-tree"] and len(argv) == 2:
        print(json.dumps(time_tree(argv[1])), flush=True)
        return
    if argv:
        raise SystemExit(f"chip_smoke: unknown arguments {argv}")
    t_start = T0[0] = time.perf_counter()
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
    mark("3")
    streams = {name: frames_of(name) for name in STREAMS + GENERAL}
    decs = {name: DeviceDecoder.for_stream(fr[0], "cuda")
            for name, fr in streams.items()}
    bench = streams["bench"]
    # The bench chunk holds both bench frames; each general stream goes in
    # a 3-frame chunk (all of its frames), so the prefix sums restart.
    cases = [(name, decs[name], streams[name], seed)
             for seed, name in enumerate(STREAMS) if name != "bench"]
    cases.append((f"bench chunk x{CHUNK}", decs["bench"],
                  [bench[i % len(bench)] for i in range(CHUNK)], 5))
    for seed, name in enumerate(GENERAL, 6):
        fr = streams[name]
        cases.append((f"{name} x3", decs[name],
                      [fr[i % len(fr)] for i in range(3)], seed))
    errs = compare_all(cases)
    max_err = errs["decode_segments"]
    tail_err = dense_tail_phase(card, torch.device("cuda"), streams, decs)

    # ---- 4. against JAX (committed digests) ----------------------------
    mark("4")
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
    mark("5")
    stream_frames = [bench[i % len(bench)] for i in range(STREAM_FRAMES)]
    stream = b"".join(stream_frames)
    chunks = STREAM_FRAMES // CHUNK
    decode_segments.launches = coeffs_to_pixels.launches = 0
    rows_from_flat.launches = 0
    for mode in ("rows", "flat"):
        default_metrics.counters[f"device_decode.{mode}_prep_chunks"] = 0
    px = jpeg_tpu_torch.mjpeg.decode_stream_device(stream, "cuda",
                                                   chunk=CHUNK)
    torch.cuda.synchronize()
    launches = decode_segments.launches
    tail_launches = coeffs_to_pixels.launches
    flat_launches = rows_from_flat.launches
    preps = {mode: default_metrics.counters[
        f"device_decode.{mode}_prep_chunks"] for mode in ("rows", "flat")}
    if launches <= 0 or tail_launches != chunks:
        raise AssertionError(f"main path launched decode_segments "
                             f"{launches} times, coeffs_to_pixels "
                             f"{tail_launches} (want {chunks})")
    # The decoder's default prep on the card is flat: every chunk through
    # K13, once each.
    prep = decs["bench"].prep_mode
    if prep != "flat" or flat_launches != chunks or \
            preps != {"rows": 0, "flat": chunks}:
        raise AssertionError(f"main path: default prep {prep}, launched "
                             f"rows_from_flat {flat_launches} times, (rows, "
                             f"flat) prep chunks {preps} (want {chunks} "
                             f"flat)")
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
        f"decode_segments launches {launches}, coeffs_to_pixels launches "
        f"{tail_launches}, rows_from_flat launches {flat_launches} "
        f"({prep} prep, {preps['flat']} flat chunks), frame 0 vs CPU max "
        f"diff {diff}")

    # ---- 6. times ---------------------------------------------------------
    mark("6")
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
    log(f"time e2e_stream_Mpix_s[{prep}]={mpix / med} (median of "
        f"{len(runs)} runs of {STREAM_FRAMES} frames from bytes; run ms "
        f"{[round(r * 1e3, 3) for r in runs]}) [{card}]")

    dec = decs["bench"]
    prep_s = []
    for _ in range(E2E_RUNS):
        t0 = time.perf_counter()
        prepared = [dec.prepare(stream_frames[i:i + CHUNK])
                    for i in range(0, STREAM_FRAMES, CHUNK)]
        torch.cuda.synchronize()
        prep_s.append(time.perf_counter() - t0)
    prep_s = sorted(prep_s)
    log(f"time host_prep_ms[{prep}]={prep_s[len(prep_s) // 2] * 1e3} "
        f"(median of {len(prep_s)} runs: native {dec.prep_mode} prep and "
        f"upload of {STREAM_FRAMES} frames, host clock; run ms "
        f"{[round(r * 1e3, 3) for r in prep_s]}) [{card}]")

    def resident():
        for words, nbits, qt in prepared:
            c, _ = dec.decode_prepared(words, nbits, CHUNK)
            coeffs_to_pixels(c, qt, dec.geom)

    resident()
    reps = 10
    ms = cuda_ms(resident, reps)
    log(f"time device_resident_Mpix_s[{prep}]={mpix / (ms / 1e3)} "
        f"({ms} ms per {STREAM_FRAMES} frames, mean of {reps}) [{card}]")

    words, nbits, qt = prepared[0]
    args = (dec.plan, words, nbits, CHUNK, dec.segs_per_frame, dec.ri,
            dec.total_blocks)
    k_ms, kd_ms = kernel_ms("decode_segments",
                            lambda: decode_segments(*args), 20, card)
    p_ms = cuda_ms(lambda: decode_segments_ref(*args), 2)
    log(f"time decode_segments_ms={k_ms} device_ms={kd_ms} "
        f"decode_segments_ref_ms={p_ms} "
        f"per {CHUNK}-frame 1080p chunk ({words.shape[0]} lanes) [{card}]")
    region_bound = segment_bound(dec.plan, nbits, *decode_segments(*args))
    log_bound("decode_segments", k_ms, region_bound, card, kd_ms)
    coeffs, _ = dec.decode_prepared(words, nbits, CHUNK)
    d_ms, dd_ms = kernel_ms(
        "coeffs_to_pixels", lambda: coeffs_to_pixels(coeffs, qt, dec.geom),
        20, card)
    dp_ms = cuda_ms(lambda: coeffs_to_pixels_ref(coeffs, qt, dec.geom), 3)
    log(f"time dense_tail_ms={d_ms} device_ms={dd_ms} plain_ms={dp_ms} per "
        f"{CHUNK}-frame "
        f"1080p chunk (coeffs_to_pixels kernel; plain version) [{card}]")
    # K3, the dense decode tail: coefficients and the chunk's one set of
    # tables (frame stride 0) in, pixels out; a separable IDCT per block,
    # as K4 counts.
    tail_px = coeffs_to_pixels(coeffs, qt, dec.geom)
    tail_bound = bound(nbytes(coeffs, qt[:1], tail_px),
                       coeffs.shape[0] * coeffs.shape[1] * 2 * 64 * 8 * 2,
                       "float32")
    log_bound("dense_tail", d_ms, tail_bound, card, dd_ms)

    # Card busy share of one stream decode.  The decoder's spans (prepare
    # / dispatch) are recorded as host events.
    profile_window(
        lambda: jpeg_tpu_torch.mjpeg.decode_stream_device(stream, "cuda",
                                                          chunk=CHUNK),
        "device_decode.", card,
        f"{STREAM_FRAMES}-frame stream decode, {prep} prep")

    entries = [{
        "name": "decode_segments",
        "route": "cuda",
        "source": "jpeg_tpu_torch/csrc/decode_segments.cu",
        "replaces": "jpeg_tpu/entropy/place_pallas.py:121",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "device_ms": kd_ms,
        "plain_ms": p_ms,
        **region_bound,
    }, {
        "name": "coeffs_to_pixels",
        "route": "cuda",
        "source": "jpeg_tpu_torch/csrc/decode_dense.cu",
        "replaces": "jpeg_tpu/models/device_decode.py:149",
        "launches": tail_launches,
        "max_abs_err": tail_err,
        "ms": d_ms,
        "device_ms": dd_ms,
        "plain_ms": dp_ms,
        **tail_bound,
    }]
    dev = torch.device("cuda")
    encode_streams = {name: streams[name] for name in STREAMS}
    entries += encode_phases(card, encode_streams, decs, dev)
    general, ri7 = general_phase(card, dev, errs["decode_segments_general"],
                                 k_ms)
    entries += general
    entries += single_image_phase(card, dev, streams, ri7)
    entries += rstless_phase(card, dev)
    rstless_prep_phase(card, dev)
    entries += fast_phase(card, dev, streams)
    native_phase(card, dev, streams)
    sharded = parallel_phase(card, dev, streams)
    entries.append(flat_phase(card, dev, streams, flat_launches))
    entries.append(phased_phase(card, dev, streams))
    entries.append(frame_tables_phase(card, dev))
    ecs_walk_phase(card)
    for e in entries:
        e["sharded_launches"] = sharded.get(e["name"], {})
    log(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
