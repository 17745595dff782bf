"""PyTorch port: dense decode tail vs jpeg_tpu (CPU).

The port's ``coeffs_to_pixels`` -- on the CPU the plain version
``decode_dense.coeffs_to_pixels_ref`` (dequant -> Kronecker IDCT matmul ->
upsample -> colour -> round/clip) -- against the JAX package's
``device_decode._dense_only`` on the same coefficients: within +-1 per
u8/u16 sample, because the float32 matmul sums in another order.  The
elementwise ops it is built from are pinned one by one.

The CUDA kernel ``csrc/decode_dense.cu`` cannot run here, so a numpy
model of it (``kernel_model``: its tile walk, the runs it copies into a
tile's stage, its slot and sample arithmetic and its separable ``fmaf``
IDCT) is held to the plain version: every pixel written once, within
+-1; and the runs (``tile_runs``) are held to cover every block of every
tile once, each a 16-byte aligned copy.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jpeg_tpu
from jpeg_tpu import mjpeg as jmjpeg
from jpeg_tpu import geometry as jgeometry
from jpeg_tpu.format.parse import parse_codestream as jax_parse
from jpeg_tpu.models.device_decode import _dense_only
from jpeg_tpu.ops import color as jcolor
from jpeg_tpu.ops import dct as jdct
from jpeg_tpu.ops.resample import upsample_nn as j_upsample
from jpeg_tpu.utils.floatops import roundf as j_roundf

import jpeg_tpu_torch as jt
from jpeg_tpu_torch import geometry as pgeometry
from jpeg_tpu_torch.device import set_precision
from jpeg_tpu_torch.format.parse import parse_codestream
from jpeg_tpu_torch.models.decode_dense import (
    RUN_MAX,
    coeffs_to_pixels,
    coeffs_to_pixels_ref,
    tile_plan,
    tile_runs,
)
from jpeg_tpu_torch.ops import color, dct
from jpeg_tpu_torch.ops.resample import upsample_nn
from jpeg_tpu_torch.utils.floatops import roundf

CORPUS = Path(__file__).resolve().parent / "data" / "torch_port"
REPO = Path(__file__).resolve().parent.parent
# Every small single-scan corpus stream (tools/make_torch_fixtures.py).
SINGLE_SCAN = ("yuv420_ri2", "yuv444_ri3", "gray_ri4", "p12_422_ri2",
               "ineligible_420_ri3", "short_422_ri5", "short_p12_420_ri5",
               "row_420_ri3", "short_gray_ri4", "rstless_420",
               "mixed_420_ri2")
# The two float32 IDCTs (the plain version's [64, 64] matmul, JAX's, the
# kernel's separable fmaf chains) sum in different orders, so a sample
# moves by 1 where its value sits on a rounding boundary, and nowhere by
# more.  On these small frames that is well under 1% of the samples.
SHARE = 0.01


def _coeffs(frames):
    """[F, total_blocks, 64] int32 from jpeg_tpu.decode_coefficients."""
    out = []
    for f in frames:
        cs, planes = jpeg_tpu.decode_coefficients(f)
        out.append(np.concatenate([
            np.asarray(planes[c.cid], np.int32).reshape(-1, 64)
            for c in cs.geometry.components]))
    return np.stack(out)


@pytest.mark.parametrize("name,noise", [
    ("yuv420_ri2", False),
    ("yuv420_ri2", True),  # large coefficients: clipping at both ends
    ("yuv444_ri3", False),
    ("gray_ri4", False),
    ("p12_422_ri2", False),  # 12-bit: uint16 samples
])
def test_dense_tail_matches_jax(name, noise):
    set_precision()
    frames = jmjpeg.split_stream((CORPUS / f"{name}.mjpeg").read_bytes())
    coeffs = _coeffs(frames)
    if noise:
        rng = np.random.default_rng(5)
        coeffs = coeffs + rng.integers(-40, 41, coeffs.shape, dtype=np.int32)
    jcs = jax_parse(frames[0])
    pcs = parse_codestream(frames[0])
    qt = pcs.qtables.astype(np.int32)
    ref = np.asarray(_dense_only(jcs.geometry, jnp.asarray(coeffs),
                                 jnp.asarray(qt)))
    got = coeffs_to_pixels(
        torch.from_numpy(coeffs),
        torch.from_numpy(qt).expand(len(frames), 4, 64), pcs.geometry)
    assert got.is_contiguous()
    assert got.dtype == (torch.uint8 if pcs.geometry.precision <= 8
                         else torch.uint16)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.99
    if noise:
        assert (got == 0).any() and (got == 255).any()


def test_dense_ops_match_jax():
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((3, 16, 24)) * 300).astype(np.float32)
    x[0, 0, :4] = [2.5, -2.5, 0.5, -0.5]  # ties round away from zero
    np.testing.assert_array_equal(roundf(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_roundf(jnp.asarray(x))))
    np.testing.assert_array_equal(
        upsample_nn(torch.from_numpy(x), 2, 3).numpy(),
        np.asarray(j_upsample(jnp.asarray(x), 2, 3)))
    np.testing.assert_array_equal(dct.dct_lut_f32(), jdct.dct_lut_f32())
    flat = (rng.standard_normal((50, 64)) * 100).astype(np.float32)
    # outputs reach ~1e3; float32 sums in another order differ by ~1e-4
    np.testing.assert_allclose(
        dct.idct8x8_kron(torch.from_numpy(flat)).numpy(),
        np.asarray(jdct.idct8x8_kron(jnp.asarray(flat))),
        rtol=0, atol=1e-3)


@pytest.mark.parametrize("nc", [1, 3, 4])
def test_color_matches_jax(nc):
    rng = np.random.default_rng(nc)
    px = rng.uniform(0, 255, (2, 8, 8, nc)).astype(np.float32)
    got = color.to_rgb(torch.from_numpy(px), 8).numpy()
    ref = np.asarray(jcolor.to_rgb(jnp.asarray(px), 8, exact=False))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)  # same float32 op order
    if nc == 3:
        planes = [torch.from_numpy(px[..., i]) for i in range(3)]
        r, g, b = color.ycc_to_rgb_planar(*planes, 8)
        np.testing.assert_array_equal(torch.stack([r, g, b], -1).numpy(),
                                      ref)


def _frame_tables(frames):
    """[F, 4, 64] int32: each frame's own quantization tables."""
    return np.stack([parse_codestream(f).qtables.astype(np.int32)
                     for f in frames])


def _jax_per_frame(jgeom, coeffs, qts):
    """jpeg_tpu's ``_dense_only`` run frame by frame with that frame's
    [4, 64] tables -> [F, H, W, C]."""
    return np.stack([
        np.asarray(_dense_only(jgeom, jnp.asarray(coeffs[i:i + 1]),
                               jnp.asarray(qts[i])))[0]
        for i in range(coeffs.shape[0])])


def _within_one(got, want, share=SHARE):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1
    assert (diff != 0).mean() <= share


@pytest.mark.parametrize("name", SINGLE_SCAN)
def test_plain_tail_per_frame_tables_match_jax(name):
    set_precision()
    frames = jmjpeg.split_stream((CORPUS / f"{name}.mjpeg").read_bytes())
    coeffs = _coeffs(frames)
    qts = _frame_tables(frames)
    geom = parse_codestream(frames[0]).geometry
    got = coeffs_to_pixels_ref(torch.from_numpy(coeffs),
                               torch.from_numpy(qts), geom).numpy()
    _within_one(got, _jax_per_frame(jax_parse(frames[0]).geometry, coeffs,
                                    qts))


def _crafted(kind):
    """(port geometry, jpeg_tpu geometry) of a YCCK frame or a frame whose
    luma is sampled h=1 v=2 (chroma upsampled 1 x 2), with padding on both
    edges."""
    if kind == "ycck":
        comps = [(i, 1, 1, int(i in (2, 3))) for i in (1, 2, 3, 4)]
    else:  # "h1v2"
        comps = [(1, 1, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    out = []
    for mod in (pgeometry, jgeometry):
        out.append(mod.with_block_grid(mod.FrameGeometry(8, 37, 45, tuple(
            mod.Component(cid=i, h=h, v=v, tq=tq) for i, h, v, tq in comps))))
    return out


def _seeded_coeffs(geom, frames, seed):
    """Seeded coefficients (DC up to +-60, AC up to +-8) and per-frame
    tables (entries 1..24) for ``geom``."""
    rng = np.random.default_rng(seed)
    tb = sum(c.n_blocks for c in geom.components)
    coeffs = rng.integers(-8, 9, (frames, tb, 64)).astype(np.int32)
    coeffs[:, :, 0] = rng.integers(-60, 61, (frames, tb))
    qts = rng.integers(1, 25, (frames, 4, 64)).astype(np.int32)
    return coeffs, qts


@pytest.mark.parametrize("kind", ["ycck", "h1v2"])
def test_plain_tail_crafted_geometries_match_jax(kind):
    set_precision()
    geom, jgeom = _crafted(kind)
    coeffs, qts = _seeded_coeffs(geom, 2, 3)
    got = coeffs_to_pixels_ref(torch.from_numpy(coeffs),
                               torch.from_numpy(qts), geom).numpy()
    assert got.shape == (2, 37, 45, 3)
    _within_one(got, _jax_per_frame(jgeom, coeffs, qts))
    assert (got == 0).any() and (got == 255).any()


def _roundf(v):
    t = np.trunc(v)
    return np.where(np.abs(v - t) >= 0.5, t + np.where(v >= 0, 1, -1), t)


def _fma(a, b, c):
    """fmaf on float32 values: the exact product plus c, rounded once (in
    float64, then to float32; the double rounding is rare enough for a
    model)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def kernel_model(coeffs, qtables, geom):
    """numpy model of csrc/decode_dense.cu on [F, TB, 64] int32 coeffs and
    [F, 4, 64] int32 tables: the kernel's tile walk, its slot and sample
    index arithmetic, and its numerics.  -> ([F, H, W, C] pixels, how many
    times each output sample was written)."""
    plan = tile_plan(geom)
    f = coeffs.shape[0]
    lut = dct.dct_lut_f32()
    nf, prec = geom.nf, geom.precision
    nc = 3 if nf >= 3 else 1
    shift = np.float32(1 << (prec - 1))
    denom = np.float32(1 << prec)
    cp = plan.comps
    out = np.zeros((f, geom.height, geom.width, nc), np.int64)
    writes = np.zeros(out.shape, np.int64)
    for t in range(geom.m_y * plan.tiles_x):
        my, tx = divmod(t, plan.tiles_x)
        n = min(plan.mcus, geom.m_x - tx * plan.mcus)
        # A. the tile's runs into its stage slots; B. each slot dequantized
        # with its component's table (the kernel's search over slots)
        blks = np.full(n * plan.bpm, -1)
        for _, first, count, slot in tile_runs(plan, geom.m_x, my, tx):
            blks[slot:slot + count] = np.arange(first, first + count)
        assert (blks >= 0).all()
        tqs = []
        for b in range(n * plan.bpm):
            j = 0
            while j + 1 < nf and b >= n * cp[j + 1][7]:
                j += 1
            tqs.append(cp[j][6])
        prod = (coeffs[:, blks].astype(np.uint32)
                * qtables[:, tqs].astype(np.uint32))
        x = prod.astype(np.int32).astype(np.float32).reshape(f, -1, 8, 8)
        # B. rows, C. columns: fmaf chains over ascending taps
        rows = np.zeros_like(x)
        for xx in range(8):
            acc = np.zeros(x.shape[:-1], np.float32)
            for v in range(8):
                acc = _fma(x[..., v], lut[xx, v], acc)
            rows[..., xx] = acc
        smp = np.zeros_like(x)
        for y in range(8):
            acc = np.zeros(rows.shape[:-2] + (8,), np.float32)
            for u in range(8):
                acc = _fma(lut[y, u], rows[..., u, :], acc)
            smp[..., y, :] = acc + shift
        # D. pixels inside the frame, by index
        y0, x0 = my * plan.mcu_h, tx * plan.mcus * plan.mcu_w
        nrow = min(plan.mcu_h, geom.height - y0)
        ncol = min(n * plan.mcu_w, geom.width - x0)
        py, px = np.meshgrid(np.arange(nrow), np.arange(ncol), indexing="ij")
        s = []
        for j in range(nf):
            c = cp[j]
            sy, sx = py // c[2], px // c[3]
            slot = n * c[7] + (sy >> 3) * (n * c[0]) + (sx >> 3)
            s.append(smp[:, slot, sy & 7, sx & 7])
        if nf == 1:
            chans = [s[0]]
        else:
            cb, cr = s[1] - shift, s[2] - shift
            chans = [s[0] + np.float32(1.402) * cr,
                     s[0] - np.float32(0.34414) * cb
                     - np.float32(0.71414) * cr,
                     s[0] + np.float32(1.772) * cb]
            if nf == 4:
                chans = [s[3] - (ch * s[3]) / denom for ch in chans]
        px_out = np.stack([np.clip(_roundf(ch), 0, (1 << prec) - 1)
                           for ch in chans], axis=-1)
        out[:, y0:y0 + nrow, x0:x0 + ncol] = px_out
        writes[:, y0:y0 + nrow, x0:x0 + ncol] += 1
    return out.astype(np.uint8 if prec <= 8 else np.uint16), writes


# (components as (id, h, v, tq), height, width): 4:2:0, 4:2:2, 4:4:4, luma
# h=1 v=2, gray and YCCK, each with a short last tile in its MCU rows
# (4:2:0: 13 MCUs a row in tiles of 10) and padding on both edges
RUN_GEOMETRIES = {
    "420": (((1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)), 40, 200),
    "422": (((1, 2, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)), 20, 300),
    "444": (((1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)), 17, 190),
    "h1v2": (((1, 1, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)), 37, 130),
    "gray": (((1, 1, 1, 0),), 9, 530),
    "ycck": (((1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1), (4, 1, 1, 0)), 16,
             180),
}


@pytest.mark.parametrize("name", list(RUN_GEOMETRIES))
def test_tile_runs_cover_every_block_once(name):
    """The runs of each tile fill its stage slots [0, n * bpm) once, each
    slot from a block of the component the kernel's slot search gives it;
    over the frame's tiles every block of every plane is copied once; and
    every run starts and ends on a 16-byte boundary of the frame's
    coefficients and of the stage, as the bulk copies need."""
    comps, height, width = RUN_GEOMETRIES[name]
    geom = pgeometry.with_block_grid(pgeometry.FrameGeometry(
        8, height, width, tuple(pgeometry.Component(cid=i, h=h, v=v, tq=tq)
                                for i, h, v, tq in comps)))
    plan = tile_plan(geom)
    tb = sum(c.n_blocks for c in geom.components)
    starts = np.cumsum([0] + [c.n_blocks for c in geom.components])
    assert plan.runs.shape[0] == sum(c.v for c in geom.components) <= RUN_MAX
    copied = np.zeros(tb, np.int64)
    ragged = False
    for my in range(geom.m_y):
        for tx in range(plan.tiles_x):
            n = min(plan.mcus, geom.m_x - tx * plan.mcus)
            ragged |= n < plan.mcus
            slots = np.zeros(n * plan.bpm, np.int64)
            for j, first, count, slot in tile_runs(plan, geom.m_x, my, tx):
                assert starts[j] <= first and first + count <= starts[j + 1]
                copied[first:first + count] += 1
                slots[slot:slot + count] += 1
                c = plan.comps[j]
                assert n * c[7] <= slot and slot + count <= n * (c[7]
                                                                + c[0] * c[1])
                for off in (first * 256, count * 256, slot * 256):
                    assert off % 16 == 0
            assert (slots == 1).all()
    assert (copied == 1).all()
    assert ragged == (geom.m_x % plan.mcus != 0) and ragged


MODEL_CASES = [(name, False) for name in SINGLE_SCAN[:4]] + [
    ("short_gray_ri4", False), ("short_422_ri5", True), ("yuv420_ri2", True),
    ("ycck", True), ("h1v2", True)]


@pytest.mark.parametrize("name,noise", MODEL_CASES)
def test_kernel_model_matches_plain(name, noise):
    """The kernel's tiling writes every output sample exactly once and its
    arithmetic lands within +-1 of the plain version (seeded noise +-40
    on the coefficients clips both ends)."""
    set_precision()
    if name in ("ycck", "h1v2"):
        geom = _crafted(name)[0]
        coeffs, qts = _seeded_coeffs(geom, 2, 11)
    else:
        frames = jmjpeg.split_stream((CORPUS / f"{name}.mjpeg").read_bytes())
        geom = parse_codestream(frames[0]).geometry
        coeffs, qts = _coeffs(frames), _frame_tables(frames)
    if noise:
        rng = np.random.default_rng(7)
        coeffs = coeffs + rng.integers(-40, 41, coeffs.shape, dtype=np.int32)
    want = coeffs_to_pixels_ref(torch.from_numpy(coeffs),
                                torch.from_numpy(qts), geom).numpy()
    got, writes = kernel_model(coeffs, qts, geom)
    assert (writes == 1).all()
    _within_one(got, want)
    if noise:
        top = (1 << geom.precision) - 1
        assert (got == 0).any() and (got == top).any()


def test_kernel_model_wraps_the_int32_product():
    """A damaged stream's huge coefficient times its quantizer wraps as
    torch's int32 multiply does, in both versions."""
    geom = parse_codestream(jmjpeg.split_stream(
        (CORPUS / "gray_ri4.mjpeg").read_bytes())[0]).geometry
    tb = sum(c.n_blocks for c in geom.components)
    coeffs = np.zeros((1, tb, 64), np.int32)
    coeffs[0, :, 0] = np.int32(2**30 + 5)
    qts = np.full((1, 4, 64), 4, np.int32)  # 4 * (2^30 + 5) wraps to 20
    want = coeffs_to_pixels_ref(torch.from_numpy(coeffs),
                                torch.from_numpy(qts), geom).numpy()
    got, _ = kernel_model(coeffs, qts, geom)
    np.testing.assert_array_equal(got, want)
    assert (want == 128 + 3).all()  # 20 / 8 = 2.5 rounds away from zero


@pytest.mark.parametrize("case", ["nondividing", "two_components"])
def test_dense_tail_refuses_uncovered_geometries(case):
    """Where a component's upsampled plane does not cover the frame, or
    the frame has two components, both versions raise before any work."""
    if case == "nondividing":  # h = 3, 2, 1: the middle plane falls short
        comps = ((1, 3, 1, 0), (2, 2, 1, 1), (3, 1, 1, 1))
    else:
        comps = ((1, 1, 1, 0), (2, 1, 1, 1))
    geom = pgeometry.with_block_grid(pgeometry.FrameGeometry(8, 16, 48, tuple(
        pgeometry.Component(cid=i, h=h, v=v, tq=tq) for i, h, v, tq in comps)))
    tb = sum(c.n_blocks for c in geom.components)
    coeffs = torch.zeros(1, tb, 64, dtype=torch.int32)
    qts = torch.ones(1, 4, 64, dtype=torch.int32)
    for fn, dev in ((coeffs_to_pixels_ref, "cpu"), (coeffs_to_pixels, "cpu"),
                    (coeffs_to_pixels, "meta")):
        with pytest.raises(jt.UnsupportedError):
            fn(coeffs.to(dev), qts.to(dev), geom)
    assert coeffs_to_pixels.launches == 0


def test_dense_wrapper_refuses_other_devices():
    frames = jmjpeg.split_stream((CORPUS / "yuv420_ri2.mjpeg").read_bytes())
    geom = parse_codestream(frames[0]).geometry
    coeffs = torch.from_numpy(_coeffs(frames[:1]))
    qts = torch.from_numpy(_frame_tables(frames[:1]))
    with pytest.raises(ValueError, match="device"):
        coeffs_to_pixels(coeffs.to("meta"), qts.to("meta"), geom)
    # The CPU path takes one set of tables expanded over the frames too.
    one = coeffs_to_pixels(coeffs, qts, geom)
    shared = coeffs_to_pixels(coeffs.expand(3, -1, -1),
                              qts[0].expand(3, 4, 64), geom)
    for i in range(3):
        np.testing.assert_array_equal(shared[i].numpy(), one[0].numpy())
    assert coeffs_to_pixels.launches == 0


def test_decode_dense_imports_and_runs_without_nvcc():
    """No nvcc and no CUDA toolkit: the module imports and its CPU path
    runs without building or loading the kernel library."""
    code = (
        "import torch\n"
        "from jpeg_tpu_torch import kernels\n"
        "from jpeg_tpu_torch.models import decode_dense\n"
        "from jpeg_tpu_torch.geometry import Component, FrameGeometry, "
        "with_block_grid\n"
        "g = with_block_grid(FrameGeometry(8, 8, 8, (Component(1, 1, 1, "
        "0),)))\n"
        "px = decode_dense.coeffs_to_pixels(torch.zeros(1, 1, 64, "
        "dtype=torch.int32), torch.ones(1, 4, 64, dtype=torch.int32), g)\n"
        "assert px.shape == (1, 8, 8, 1) and bool((px == 128).all())\n"
        "info = kernels.load_library.cache_info()\n"
        "assert info.hits + info.misses == 0, info\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME=str(REPO / "no-cuda-here"))
    env.pop("CUDA_PATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "ok"
