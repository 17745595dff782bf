"""Synthetic test inputs, made from a seed with numpy.

``make_frame_ppm`` is a copy of ``bench.make_frame_ppm`` (the repository's
benchmark frames: smooth gradients plus seeded Gaussian noise), so the
port's chip check encodes the same content the JAX package's benchmark
does without importing ``bench`` (which imports JAX).  ``symbol_blocks``
is a chunk of quantized blocks that holds every kind of Huffman symbol,
for holding the entropy kernels against their plain versions;
``tie_frame`` is a grayscale frame whose quantization meets exact
rounding ties, for holding the dense encode stage to round-half-away.
``hostile_hist`` and ``hostile_fdct`` are the edge cases of the symbol
histogram and of the exact FDCT + quantizer, by name (``HIST_CASES``,
``FDCT_CASES``), for the CPU tests and the chip check alike.
``crafted_frame`` is a frame no encoder emits (a sampling ratio that does
not divide, YCCK, component ids out of order), built from seeded planes
with the port's own emitter, byte for byte the single-image tests' frames.
"""

from __future__ import annotations

import numpy as np

from ..ops.dct import dct_lut_f32

WIDTH, HEIGHT = 1920, 1080


def make_frame_ppm(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float32)
    img = np.stack(
        [
            0.5 + 0.5 * np.sin(xx / 37.0 + seed) * np.cos(yy / 23.0),
            (xx + yy) / (WIDTH + HEIGHT),
            0.5 + 0.5 * np.cos(xx / 61.0 - yy / 41.0),
        ],
        axis=-1,
    )
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    samples = np.clip(np.round(img * 255), 0, 255).astype(np.uint8)
    return b"P6\n%d %d\n255\n" % (WIDTH, HEIGHT) + samples.tobytes()


def small_ppm(width: int, height: int, seed: int = 0) -> bytes:
    """A small seeded P6 image: smooth gradients and texture (the same
    samples as the tests' ``refbin.make_ppm`` at maxval 255)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    img = np.stack([0.5 + 0.5 * np.sin(xx / 17.0) * np.cos(yy / 23.0),
                    (xx + yy) / (width + height),
                    0.5 + 0.5 * np.cos(xx / 31.0 + yy / 13.0)], axis=-1)
    img = img + rng.normal(0, 0.02, img.shape)
    samples = np.clip(np.round(img * 255), 0, 255).astype(np.uint8)
    return b"P6\n%d %d\n255\n" % (width, height) + samples.tobytes()


def make_frame(seed: int) -> np.ndarray:
    """``make_frame_ppm(seed)``'s samples as [HEIGHT, WIDTH, 3] uint8."""
    data = make_frame_ppm(seed)
    return np.frombuffer(data[-HEIGHT * WIDTH * 3:], np.uint8).reshape(
        HEIGHT, WIDTH, 3).copy()


def symbol_blocks(n_blocks: int, seed: int = 11) -> np.ndarray:
    """[n_blocks, 64] int32 zig-zag blocks (DC differential), n_blocks >= 8.

    Seeded sparse blocks, in which rows 3-7 are made by hand: 63 nonzeros
    (no EOB), a lone nonzero at position 63 (three ZRLs, no EOB), DC
    category 15 with AC category 14 after 38 zeros (two ZRLs), a negative
    DC of category 14 with AC category 14 after a 16-zero run (one ZRL),
    and an all-zero block (DC category 0, EOB).  Categories 14 and 15 need
    12-bit tables that code them.
    """
    rng = np.random.default_rng(seed)
    zz = np.zeros((n_blocks, 64), np.int32)
    sparse = rng.random((n_blocks, 64)) < 0.15
    zz[sparse] = rng.integers(-60, 61, int(sparse.sum()))
    zz[:, 0] = rng.integers(-300, 301, n_blocks)
    zz[3] = rng.integers(1, 9, 64) * rng.choice([-1, 1], 64)
    zz[4] = 0
    zz[4, 63] = -5
    zz[5] = 0
    zz[5, 0] = 20000
    zz[5, 40] = -10000
    zz[6] = 0
    zz[6, 0] = -16383
    zz[6, 17] = 12000
    zz[7] = 0
    return zz


def worst_blocks(n_blocks: int, dc_cat: int, ac_cat: int,
                 seed: int = 13) -> np.ndarray:
    """[n_blocks, 64] int32 zig-zag blocks that take the most bits: every
    nonzero of DC category ``dc_cat`` or AC category ``ac_cat`` (16 is the
    cap of the category function), position 63 always nonzero (no EOB).
    Block i % 3 == 0 has all 64 coefficients nonzero; the others hold one
    run of 16-47 zeros (one or two ZRLs), at position 1 (i % 3 == 1) or
    further in (i % 3 == 2).
    """
    rng = np.random.default_rng(seed)

    def values(shape, cat):
        mag = rng.integers(1 << (cat - 1), 1 << cat, shape)
        return mag * rng.choice([-1, 1], shape)

    zz = values((n_blocks, 64), ac_cat)
    zz[:, 0] = values(n_blocks, dc_cat)
    for i in range(n_blocks):
        if i % 3:
            run = int(rng.integers(16, 48))
            start = 1 if i % 3 == 1 else int(rng.integers(2, 63 - run))
            zz[i, start:start + run] = 0
    return zz.astype(np.int32)


def tie_frame(fdct: np.ndarray, qtable: np.ndarray, shift: int = 128):
    """A grayscale frame whose quantized AC coefficients meet exact ties.

    ``fdct`` is the [64, 64] float32 FDCT operator (``ops.dct._kron_mats()
    [1]``), ``qtable`` the [64] raster-order quantization table.  Every
    8x8 block is flat at ``shift`` (0 after the level shift) but for one
    sample ``shift + t``, so its coefficient k is the one float32 product
    ``t * fdct[i, k]`` in any summation order.  The blocks are every
    (t, i), 0 < |t| < shift, for which some AC quotient ``c / qtable[k]``
    is, in float32, exactly an even integer + 0.5: rounding half away from
    zero and half to even disagree there.

    -> (frame [8, 8 * n, 1] uint8, want [n, 64] int32: the raster-order
    quantized blocks, rounded half away from zero).
    """
    m = np.asarray(fdct, np.float32)
    q = np.asarray(qtable, np.float32).reshape(64)
    ts = np.arange(1 - shift, shift, dtype=np.float32)
    ts = ts[ts != 0]
    r = ts[:, None, None] * m[None] / q  # [t, i, k], float32 throughout
    mag = np.abs(r.astype(np.float64))
    tie = (mag - np.floor(mag) == 0.5) & (np.floor(mag) % 2 == 0)
    tie[:, :, 0] = False
    ti, ii = np.nonzero(tie.any(axis=2))
    n = ti.size
    blocks = np.full((n, 64), shift, np.int64)
    blocks[np.arange(n), ii] += ts[ti].astype(np.int64)
    frame = blocks.reshape(n, 8, 8).transpose(1, 0, 2).reshape(8, 8 * n, 1)
    rr = r[ti, ii].astype(np.float64)
    want = (np.sign(rr) * np.floor(np.abs(rr) + 0.5)).astype(np.int32)
    return frame.astype(np.uint8), want


HIST_CASES = ("int_extremes", "no_eob", "zero_runs", "tables8")


def hostile_hist(case: str, n_blocks: int = 1000, seed: int = 17):
    """(zz [n_blocks, 64] int32, dc_tab, ac_tab [n_blocks] int32, T): the
    symbol histogram's edge cases on seeded sparse blocks.

    ``int_extremes``: INT_MIN (category 0: its absolute value wraps) and
    +-32767 coefficients, DC included; ``no_eob``: all 63 ACs nonzero;
    ``zero_runs``: runs of exactly 16, 31 and 47 zeros before a nonzero,
    every other block's at position 63; ``tables8``: table ids 0..7 (T =
    8; the others 0..1, T = 2).  The default ``n_blocks`` is not a
    multiple of 32, so a kernel's last group of blocks is short.
    """
    if case not in HIST_CASES:
        raise ValueError(f"unknown histogram case {case!r}")
    rng = np.random.default_rng(seed)
    n = n_blocks
    zz = np.zeros((n, 64), np.int32)
    sparse = rng.random((n, 64)) < 0.2
    zz[sparse] = rng.integers(-60, 61, int(sparse.sum()))
    zz[:, 0] = rng.integers(-300, 301, n)
    if case == "int_extremes":
        pick = rng.random((n, 64)) < 0.3
        extremes = np.array([np.iinfo(np.int32).min, 32767, -32767],
                            np.int32)
        zz[pick] = rng.choice(extremes, int(pick.sum()))
    elif case == "no_eob":
        zz[:, 1:] = rng.integers(1, 200, (n, 63)) * rng.choice([-1, 1],
                                                               (n, 63))
    elif case == "zero_runs":
        for i in range(n):
            run = (16, 31, 47)[i % 3]
            end = 63 if i % 2 == 0 else int(rng.integers(run + 1, 63))
            zz[i, end - run:end] = 0
            zz[i, end] = rng.integers(1, 100) * rng.choice([-1, 1])
            if end - run - 1 >= 1:  # the run starts right after a nonzero
                zz[i, end - run - 1] = rng.integers(1, 100)
    T = 8 if case == "tables8" else 2
    dc_tab = rng.integers(0, T, n).astype(np.int32)
    ac_tab = rng.integers(0, T, n).astype(np.int32)
    return zz, dc_tab, ac_tab, T


FDCT_CASES = ("12bit", "ties_8bit", "ties_12bit", "q1", "q255")


def hostile_fdct(case: str, seed: int = 19):
    """(samples [n, 64] float32 raster blocks, qtable [64] int32,
    precision): the exact FDCT + quantizer's edge cases.

    ``12bit``: random 12-bit samples, a random table; ``ties_8bit`` and
    ``ties_12bit``: under a table of powers of two (1..32), blocks flat
    at the level shift but for one sample ``shift + t``, each chosen so
    that some quotient ``c / Q`` is, in float32, exactly an integer + 0.5
    (``roundf`` rounds it away from zero); ``q1`` and ``q255``: random 8-bit samples under a table of all
    1 and of all 255.  With one nonzero sample at row y, column x, the
    exact FDCT's coefficient (v, u) is the float32 product ``(t *
    A[x][u]) * A[y][v]`` of the cosine LUT ``A`` (``ops.dct.dct_lut_f32``)
    in any order of the zero terms, so the ties are found here without
    the transform.
    """
    if case not in FDCT_CASES:
        raise ValueError(f"unknown FDCT case {case!r}")
    rng = np.random.default_rng(seed)
    if case in ("12bit", "q1", "q255"):
        bits = 12 if case == "12bit" else 8
        samples = rng.integers(0, 1 << bits, (512, 64)).astype(np.float32)
        q = {"12bit": rng.integers(1, 256, 64), "q1": np.ones(64),
             "q255": np.full(64, 255)}[case]
        return samples, q.astype(np.int32), bits
    bits = 8 if case == "ties_8bit" else 12
    shift = 1 << (bits - 1)
    # powers of two keep some quotients exact: t = 4 makes the DC
    # (4 A[0][0]) A[0][0] = 0.5 in float32, a tie under Q = 1
    q = (1 << rng.integers(0, 6, 64)).astype(np.int32)
    a = dct_lut_f32()  # A[x][u]
    ts = np.arange(1 - shift, shift, dtype=np.float32)
    ts = ts[ts != 0]
    qf = q.reshape(8, 8).astype(np.float32)
    tie = []
    for lo in range(0, ts.size, 256):
        # c[t, y, x, v, u] = (t * A[x][u]) * A[y][v], float32 throughout
        row = ts[lo:lo + 256, None, None] * a[None]  # [t, x, u]
        c = row[:, None, :, None, :] * a[None, :, None, :, None]
        mag = np.abs((c / qf).astype(np.float64))
        tie.append((mag - np.floor(mag) == 0.5).reshape(-1, 64, 64)
                   .any(axis=2))
    ti, pos = np.nonzero(np.concatenate(tie))
    samples = np.full((ti.size, 64), shift, np.float32)
    samples[np.arange(ti.size), pos] += ts[ti]
    return samples, q, bits


def crafted_frame(components, tables, seed: int) -> bytes:
    """A 40 x 24 baseline frame of ``components`` (``geometry.Component``,
    SOF order) from seeded planes (DC in [-150, 150), five low AC in
    [-20, 20)), every table 3, the default Huffman tables ``tables`` per
    scan component; the JAX package's tests build the same bytes with its
    own emitter (``tests/test_torch_api.py::_crafted``)."""
    from ..constants import DEFAULT_HTABLES
    from ..entropy.encode import pack_scan, symbolize_scan
    from ..format import emit
    from ..geometry import FrameGeometry, ScanInfo, with_block_grid
    from ..tables import HuffSpec, derive_table

    geom = with_block_grid(FrameGeometry(precision=8, height=24, width=40,
                                         components=tuple(components)))
    rng = np.random.default_rng(seed)
    planes = {}
    for c in geom.components:
        p = np.zeros((c.n_blocks, 64), np.int32)
        p[:, 0] = rng.integers(-150, 150, c.n_blocks)
        for k in (1, 2, 8, 9, 16):
            p[:, k] = rng.integers(-20, 20, c.n_blocks)
        planes[c.cid] = p
    qt = np.full((4, 64), 3, np.uint16)
    specs = {k: HuffSpec.from_pair(v) for k, v in DEFAULT_HTABLES.items()}
    info = ScanInfo(component_ids=tuple(c.cid for c in components),
                    td=tuple(tables), ta=tuple(tables))
    segs = pack_scan(symbolize_scan(planes, geom, info),
                     {k: derive_table(s) for k, s in specs.items()})
    out = bytearray(emit.emit_soi())
    out += emit.emit_dqt(qt[0], 0) + emit.emit_dqt(qt[1], 1)
    out += emit.emit_sof0(geom)
    for key in ((0, 0), (1, 0), (0, 1), (1, 1)):
        out += emit.emit_dht(specs[key], *key)
    out += emit.emit_sos(info) + emit.emit_scan_body(segs) + emit.emit_eoi()
    return bytes(out)


def _component(cid: int, h: int, v: int, t: int):
    from ..geometry import Component

    return Component(cid=cid, h=h, v=v, tq=t, td=t, ta=t)


# The crafted frames of the single-image tests, by name: (components as
# (id, h, v, table), SOF order; seed).  "nondividing": h = 3, 2, 1, so the
# middle component's upsampled plane leaves a margin of 0.0; "ycck": four
# components; "cid312": the SOF lists ids 3, 1, 2, the full-size one
# first, so plane and channel orders differ.
CRAFTED = {
    "nondividing": (((1, 3, 1, 0), (2, 2, 1, 1), (3, 1, 1, 1)), 7),
    "ycck": (((1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1), (4, 1, 1, 0)), 8),
    "cid312": (((3, 2, 2, 0), (1, 1, 1, 1), (2, 1, 2, 1)), 9),
}


def crafted(name: str) -> bytes:
    """``crafted_frame`` of ``CRAFTED[name]``."""
    comps, seed = CRAFTED[name]
    return crafted_frame([_component(*c) for c in comps],
                         [c[3] for c in comps], seed)
