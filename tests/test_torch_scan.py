"""PyTorch port: restart-segment decode vs the JAX region path (CPU).

``decode_segments_ref`` -- the plain version the CUDA kernel is held
against on the card -- must equal, integer for integer, the JAX scan
(``_scan_lanes``) followed by the Pallas region placement
(``place_emissions_region``, interpret mode), run as
``tests/test_place_pallas.py`` runs them.  Coefficients, per-lane MCU
counts, the emission keys and the per-lane step counts all agree.  A
stream with damaged segment bytes and a hand-built two-frame stream
cover every way a lane can die.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_tpu.encoder import EncodeParams, encode_jpeg
from jpeg_tpu.entropy.lockstep_jax import (
    _cached_plan,
    _scan_lanes,
    _segments_to_words,
)
from jpeg_tpu.entropy.place_pallas import place_emissions_region
from jpeg_tpu.format.parse import parse_codestream, unstuff
from jpeg_tpu.tables import HuffSpec, derive_table

from jpeg_tpu_torch.entropy import lockstep_torch, place_cuda
from jpeg_tpu_torch.format.parse import parse_codestream as port_parse
from refbin import make_pgm, make_ppm

# name -> (h, v, ri, (w, h), gray, maxval, optimize)
STREAMS = {
    "yuv420": (2, 2, 2, (64, 48), False, 255, False),
    "yuv444": (1, 1, 3, (48, 48), False, 255, False),  # odd region pad
    "gray": (1, 1, 4, (48, 48), True, 255, False),  # Ns=1 scan
    "p12_422": (2, 1, 2, (64, 32), False, 4095, True),
    "corrupt420": (2, 2, 2, (64, 48), False, 255, False),
}


def _encode(name):
    h, v, ri, (w, ht), gray, maxval, opt = STREAMS[name]
    params = EncodeParams(h=h, v=v, quality=80, restart_interval=ri,
                          optimize=opt, exact=False)
    src = (make_pgm if gray else make_ppm)(w, ht, seed=5 * ri + h,
                                           maxval=maxval)
    return encode_jpeg(src, params)


def _plans(jpeg, spec_items=None):
    """(JAX plan, port plan, JAX scan, total_blocks) for one frame."""
    cs, pcs = parse_codestream(jpeg), port_parse(jpeg)
    scan, pscan = cs.scans[0], pcs.scans[0]
    plan = _cached_plan(cs.geometry, scan.info,
                        spec_items or tuple(sorted(scan.htables.items())))
    pplan = lockstep_torch._cached_plan(
        pcs.geometry, pscan.info,
        spec_items or tuple(sorted(pscan.htables.items())))
    total_blocks = sum(c.n_blocks for c in cs.geometry.components)
    return plan, pplan, scan, total_blocks


def _compare(plan, pplan, segs, frames, ri, total_blocks):
    """Port plain path vs JAX scan + Pallas placement; -> mcu_counts."""
    words, nbits = _segments_to_words(segs)
    spf = len(segs) // frames
    assert place_cuda.placement_eligible(pplan, ri, spf)
    w_t = torch.from_numpy(words.view(np.int32))
    nb_t = torch.from_numpy(nbits.astype(np.int32))
    coeffs, counts = place_cuda.decode_segments(
        pplan, w_t, nb_t, frames, spf, ri, total_blocks)
    _, key, val, nsteps = lockstep_torch.scan_lanes(pplan, w_t, nb_t)

    # The JAX scan needs a static step bound; give it the port's exact
    # count rounded up, and require that no lane starved.
    steps = (key.shape[0] // 128 + 1) * 128
    jcounts, (jkey, jval), starved, jnsteps = _scan_lanes(
        plan, jnp.asarray(words), jnp.asarray(nbits, jnp.int32), steps)
    assert not bool(starved)
    ref = np.asarray(place_emissions_region(
        plan, jkey, jval, jnsteps, frames, spf, ri, interpret=True))

    np.testing.assert_array_equal(coeffs.numpy(), ref)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(nsteps.numpy(), np.asarray(jnsteps))
    jkey, jval = np.asarray(jkey), np.asarray(jval)
    n = key.shape[0]
    assert not jkey[n:].any()
    np.testing.assert_array_equal(key.numpy(), jkey[:n])
    live = jkey[:n] > 0
    np.testing.assert_array_equal(val.numpy()[live], jval[:n][live])
    return counts.numpy(), coeffs.numpy()


@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_segments_ref_matches_jax_region_path(name):
    jpeg = _encode(name)
    plan, pplan, scan, total_blocks = _plans(jpeg)
    segs = [unstuff(jpeg[s:e]) for s, e in scan.ecs_ranges]
    if name.startswith("corrupt"):
        # Seeded damage: flipped bytes in most segments, two segments of
        # pure noise, one cut short.
        rng = np.random.default_rng(1234)
        segs = [s.copy() for s in segs]
        for i, s in enumerate(segs):
            if i in (1, 4):
                segs[i] = rng.integers(0, 256, s.size, dtype=np.uint8)
            elif i == 2:
                segs[i] = s[: s.size // 2]
            elif s.size and i != 3:
                at = rng.integers(0, s.size, max(1, s.size // 8))
                s[at] ^= rng.integers(1, 256, at.size, dtype=np.uint8)
    counts, _ = _compare(plan, pplan, segs, 1, scan.ri, total_blocks)
    if name.startswith("corrupt"):
        assert (counts < scan.ri).sum() >= 3  # the damage killed lanes
    else:
        assert (counts == scan.ri).all()


# Incomplete custom codes, so some bit patterns match no code, and a DC
# table holding categories 17 and 20 (invalid: they kill the lane).
DC_SPEC = HuffSpec(counts=(0, 3, 1, 1, 1) + (0,) * 11,
                   values=(0, 1, 2, 5, 17, 20))
AC_SPEC = HuffSpec(counts=(0, 2, 2, 1) + (0,) * 12,
                   values=(0x00, 0x01, 0xF0, 0x11, 0x02))


def _bits(table, value, extra=""):
    code = int(table.ehufco[value])
    size = int(table.ehufsi[value])
    assert size > 0
    return format(code, f"0{size}b") + extra


def _to_bytes(bits, pad="1"):
    bits += pad * (-len(bits) % 8)
    return np.frombuffer(int(bits, 2).to_bytes(len(bits) // 8, "big"),
                         np.uint8) if bits else np.zeros(0, np.uint8)


def test_crafted_lane_deaths_match_jax():
    """Two 64x48 4:2:0 frames (ri=2: 6 lanes each) of hand-built segments,
    one per way a lane ends: a full segment, a DC category past 16, an
    AC code that matches nothing (mid-block: ACs kept, DC 0), an AC run
    past 63, a DC past the frame's MCUs (interleaved NULL block), a
    symbol overrunning the segment, and an empty segment."""
    dc, ac = derive_table(DC_SPEC), derive_table(AC_SPEC)
    spec_items = tuple(sorted({(0, 0): DC_SPEC, (0, 1): DC_SPEC,
                               (1, 0): AC_SPEC, (1, 1): AC_SPEC}.items()))
    plan, pplan, scan, total_blocks = _plans(_encode("yuv420"), spec_items)
    ri, bpm = 2, plan.blocks_per_mcu
    assert scan.ri == ri and pplan.n_mcus == 12

    full = (_bits(dc, 2, "11") + _bits(ac, 0x01, "0") + _bits(ac, 0x11, "1")
            + _bits(ac, 0x00))
    empty = _bits(dc, 0) + _bits(ac, 0x00)
    lanes = [
        full * (ri * bpm),
        full + _bits(dc, 17) + "0" * 24,
        full * 3 + _bits(dc, 1, "1") + _bits(ac, 0x02, "01") + "1101" * 8,
        full + _bits(dc, 0) + _bits(ac, 0xF0) * 4 + _bits(ac, 0x00) * 8,
        empty * (pplan.n_mcus * bpm) + _bits(dc, 0) + _bits(ac, 0x00) * 4,
        full * 5 + _bits(dc, 5, "10"),
        "",
    ]
    lanes += [full * (ri * bpm)] * (12 - len(lanes))  # frame 2: intact
    segs = [_to_bytes(b) for b in lanes]
    segs[5] = _to_bytes(lanes[5][:-2])  # the DC's extra bits are missing
    counts, coeffs = _compare(plan, pplan, segs, 2, ri, total_blocks)
    assert list(counts) == [ri, 0, 0, 0, pplan.n_mcus, 0, 0] + [ri] * 5
    # the block a lane died in keeps its ACs, with DC 0
    tb = total_blocks
    mid = (coeffs[:tb, 0] == 0) & (coeffs[:tb, 1:] != 0).any(axis=1)
    assert mid.sum() == 1
