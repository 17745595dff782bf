"""PyTorch port: jpeg_tpu's learned lane order (its phased scan), CPU.

jpeg_tpu's ``DeviceDecoder`` learns each restart segment's symbol count
from the first batch of a stream ("mat" chunks, ``_decode_device_learn``)
and writes later batches' lane rows longest first ("mats" chunks, the
native ``jt_prep_ecs_rows``), which its phased scan narrows over
(``_scan_lanes_phased`` + ``_place_emissions(perm=...)``).  The port keeps
the learning, the order, the schedule and the starvation rule, and
decodes a "mats" chunk with the general kernel's lane order (its plain
version here).  Held against jpeg_tpu run on the CPU in "rows" prep, on
a general-shape 4:2:0 stream and on an eligible one on the general
kernel (jpeg_tpu under ``JPEG_TPU_PREP=rows`` and
``JPEG_TPU_PLACE=scatter``, the port's decoder with ``prep_mode`` "rows"
and ``place_ri`` 0):

* the copies of ``_max_steps_for`` and ``_grow_steps`` equal the
  originals over a seeded grid;
* after the same batches the two decoders hold equal ``max_steps``,
  ``lane_steps`` and ``sort_order`` and give equal ``_phases_for``, also
  with half the bounds inflated (jpeg_tpu's own trick) so that the
  schedule narrows;
* the "mats" prep (rows, ``perm``, sorted bit counts) is byte-equal;
* the sorted decode's coefficients, frame-major MCU counts and steps
  equal jpeg_tpu's phased program on a chunk of intact, damaged and cut
  frames, on the learned and on the narrowed schedule;
* the starvation rule (a lane starves when it begins more steps than its
  phase budget) equals ``_scan_lanes_phased``'s at the exact boundary;
* a misprediction starves, redoes the chunk frame-major, counts
  ``phase_inflate`` and learns as jpeg_tpu does, to the classic decode;
* ``prepare`` without ``lane_order``, the flat prep and the region
  placement never sort, and ``place_ri = 0`` takes the general kernel on
  a stream that the region kernel takes;
* a kept decoder's public ``prepare`` stays frame-major after learning,
  so ``decode_prepared``, a slice of its rows by frame and
  ``make_sharded_stream_decoder`` decode it as a fresh decoder does;
* the general kernel's plain version with an identity lane order equals
  it with none, any lane order gives the same layout, and one that is not
  a permutation raises;
* a kept decoder on ri=7, which does not tile the MCU rows, counts the
  frames of its "mats" chunks in ``device_decode.lane_order_frames``; a
  forced redo opens ``device_decode.inflate`` once and counts none of its
  chunk's frames;
* the CUDA launch's check of a caller's lane order (its host half) raises
  as the plain version does, and the decoder trusts only its own order.

jpeg_tpu's jitted programs compile on the CPU (~10-25 s each), so the
cases share a few schedules: a module cache keeps each stream's decoders
after their learning batch, and tests work on copies.
"""

import copy
import os
from contextlib import contextmanager
from functools import partial
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu.encoder import EncodeParams as JParams
from jpeg_tpu.encoder import encode_jpeg as jax_encode
from jpeg_tpu.entropy import lockstep_jax as jlj
from jpeg_tpu.models.device_decode import DeviceDecoder as JaxDecoder
from jpeg_tpu.utils.metrics import default_metrics as jax_metrics

from jpeg_tpu_torch.entropy import place_cuda, steps
from jpeg_tpu_torch.models import device_decode as dd
from jpeg_tpu_torch.models.device_decode import DeviceDecoder
from jpeg_tpu_torch.utils.metrics import default_metrics
from refbin import make_ppm
from test_torch_flat import cut
from test_torch_native import _damaged

# name -> (width, height, restart interval, jpeg_tpu's JPEG_TPU_PLACE);
# 4:2:0 q75, both on the general kernel
STREAMS = {
    "420_ri3_general": (80, 64, 3, "auto"),  # 5 MCUs a row, short last
    "420_ri1_scatter": (160, 120, 1, "scatter"),  # eligible: 80 segments
}
FRAMES = 3


@contextmanager
def env(**values):
    """Environment variables set while the block runs (None: unset)."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def stream_env(name, **more):
    """jpeg_tpu's settings for the stream: rows prep, its placement."""
    return env(JPEG_TPU_PREP="rows", JPEG_TPU_PLACE=STREAMS[name][3],
               JPEG_TPU_PHASED=None, **more)


def port_decoder(name, frame):
    """The port's decoder of the stream as jpeg_tpu's is set: rows prep,
    the general kernel."""
    dec = DeviceDecoder.for_stream(frame, "cpu")
    dec.prep_mode = "rows"
    dec.place_ri = 0
    return dec


_FRAMES = {}
_LEARNED = {}


def frames_of(name):
    """The stream's three frames, encoded by jpeg_tpu."""
    if name not in _FRAMES:
        w, h, ri, _ = STREAMS[name]
        params = JParams(h=2, v=2, quality=75, restart_interval=ri,
                         optimize=False)
        _FRAMES[name] = [jax_encode(make_ppm(w, h, seed=300 + 7 * ri + i),
                                    params) for i in range(FRAMES)]
    return _FRAMES[name]


def chunk_of(name):
    """One chunk of intact, damaged and cut frames."""
    f = frames_of(name)
    return f + [f[0], _damaged(f[1], 1), cut(f[2])]


def learned(name):
    """(jpeg_tpu decoder, port decoder, jpeg_tpu pixels, port pixels)
    after one ``decode_batch`` of ``chunk_of(name)`` in one chunk: the
    learning batch.  Copies of the decoders, so that tests may change
    them."""
    if name not in _LEARNED:
        chunk = chunk_of(name)
        with stream_env(name):
            jd = JaxDecoder.for_stream(chunk[0])
            pd = port_decoder(name, chunk[0])
            assert jd.place_ri == pd.place_ri == 0
            assert jd.lane_steps is pd.lane_steps is None
            before = default_metrics.counters["device_decode.learn_chunks"]
            with pytest.warns(RuntimeWarning, match="MCUs"):
                j_px = np.asarray(jd.decode_batch(chunk, chunk=len(chunk)))
            with pytest.warns(RuntimeWarning, match="MCUs"):
                p_px = pd.decode_batch(chunk, chunk=len(chunk)).numpy()
            assert default_metrics.counters[
                "device_decode.learn_chunks"] == before + 1
        _LEARNED[name] = (jd, pd, j_px, p_px)
    jd, pd, j_px, p_px = _LEARNED[name]
    return copy.copy(jd), copy.copy(pd), j_px, p_px


def assert_same_state(jd, pd, frames):
    assert pd.max_steps == jd.max_steps
    np.testing.assert_array_equal(pd.lane_steps, jd.lane_steps)
    np.testing.assert_array_equal(pd.sort_order, jd.sort_order)
    assert pd.lane_steps.dtype == jd.lane_steps.dtype
    assert pd._phases_for(frames, pd.max_steps) == \
        jd._phases_for(frames, jd.max_steps)


@partial(jax.jit, static_argnames=("plan", "phases", "frames", "spf", "tb"))
def _jax_phased(plan, rows, nbits, perm, phases, frames, spf, tb):
    """jpeg_tpu's ``_decode_device_phased`` up to its coefficients."""
    counts, streams, starved, nsteps = jlj._scan_lanes_phased(
        plan, rows, nbits, phases)
    coeffs = jlj._place_emissions(plan, counts, streams, frames, spf, tb,
                                  perm=perm, combine="set")
    return counts, coeffs, starved, nsteps


def hold_to_phased_program(jd, pd, chunk):
    """The port's sorted decode of ``chunk`` against jpeg_tpu's phased
    program on jpeg_tpu's own "mats" prep and schedule; -> the schedule."""
    F = len(chunk)
    kind, rows, perm, nbits, _ = jd._prepare_native(chunk)
    assert kind == "mats"
    steps_ = max(jd.max_steps, jlj._max_steps_for(
        nbits.astype(np.int64), jd.plan, jd.ri))
    phases = jd._phases_for(F, steps_)
    spf, tb = pd.segs_per_frame, pd.total_blocks
    j_counts, j_coeffs, starved, j_nsteps = (np.asarray(a) for a in _jax_phased(
        jd.plan, rows, nbits, perm, phases, F, spf, tb))
    assert not bool(starved)
    prepared = pd.prepare(chunk, lane_order=True)
    assert prepared.kind == "mats"
    coeffs, counts, nsteps = place_cuda.decode_segments_general(
        pd.plan, prepared[0], prepared[1], F, spf, tb, perm=prepared.perm,
        want_nsteps=True)
    np.testing.assert_array_equal(coeffs.numpy(), j_coeffs)
    fm = np.zeros_like(j_counts)
    fm[perm] = j_counts  # jpeg_tpu's counts are in sorted order
    np.testing.assert_array_equal(counts.numpy(), fm)
    fm[perm] = j_nsteps
    np.testing.assert_array_equal(nsteps.numpy(), fm)
    budgets = dd.phase_budgets(phases, F * spf)
    assert not (nsteps.numpy()[perm] > budgets).any()
    # The decoder's own path: one "mats" chunk, not starved.
    before = dict(default_metrics.counters)
    with pytest.warns(RuntimeWarning, match="MCUs"):
        got = pd.decode_coeffs_batch(chunk, chunk=F)
    delta = {k: default_metrics.counters[k] - before.get(k, 0)
             for k in ("device_decode.mats_chunks",
                       "device_decode.phase_inflate")}
    assert delta == {"device_decode.mats_chunks": 1,
                     "device_decode.phase_inflate": 0}
    np.testing.assert_array_equal(got.numpy().reshape(-1, 64), j_coeffs)
    return phases


@pytest.mark.parametrize("optimistic", [True, False])
def test_max_steps_for_equals_jpeg_tpu(optimistic):
    rng = np.random.default_rng(17)
    for trial in range(200):
        plan = SimpleNamespace(n_mcus=int(rng.integers(0, 9000)),
                               blocks_per_mcu=int(rng.integers(1, 11)))
        nbits = rng.integers(0, 1 << int(rng.integers(1, 22)),
                             int(rng.integers(0, 40)))
        ri = int(rng.integers(0, 3)) * int(rng.integers(1, 70))
        assert steps._max_steps_for(nbits, plan, ri, optimistic) == \
            jlj._max_steps_for(nbits, plan, ri, optimistic), trial


def test_grow_steps_equals_jpeg_tpu():
    for m in range(0, 5000, 37):
        for cap in (64, 128, 1000, 4096, 1 << 20):
            assert steps._grow_steps(m, cap) == jlj._grow_steps(m, cap)


@pytest.mark.parametrize("name", list(STREAMS))
def test_learned_state_equals_jpeg_tpu(name):
    """After the learning batch: equal bounds, order and schedule, intact
    frames within +-1 of ``decode_jpeg(exact=False)``."""
    jd, pd, j_px, p_px = learned(name)
    F = len(chunk_of(name))
    assert_same_state(jd, pd, F)
    assert pd.max_steps > 0 and pd.lane_steps.shape == (pd.segs_per_frame,)
    assert p_px.shape == j_px.shape
    for i, f in enumerate(frames_of(name)):
        want = jpeg_tpu.decode_jpeg(f, exact=False).pixels().astype(int)
        assert np.abs(p_px[i].astype(int) - want).max() <= 1
        assert np.abs(j_px[i].astype(int) - want).max() <= 1


@pytest.mark.parametrize("name", list(STREAMS))
def test_mats_prep_equals_jpeg_tpu(name):
    """Rows, lane order and sorted bit counts byte for byte."""
    jd, pd, _, _ = learned(name)
    chunk = chunk_of(name)
    with stream_env(name):
        kind, rows, perm, nbits, _ = jd._prepare_native(chunk)
        before = default_metrics.counters["device_decode.mats_chunks"]
        p = pd.prepare(chunk, lane_order=True)
        assert pd.prepare(chunk).kind == "mat"  # unless asked, frame-major
    assert kind == p.kind == "mats"
    assert default_metrics.counters["device_decode.mats_chunks"] == before + 1
    assert pd.wn == jd.wn
    np.testing.assert_array_equal(p[0].numpy().view(np.uint32), rows)
    np.testing.assert_array_equal(p[1].numpy(), nbits)
    np.testing.assert_array_equal(p.perm.numpy(), perm)
    assert p.perm.dtype == p[1].dtype == torch.int32
    assert sorted(perm.tolist()) == list(range(len(perm)))
    assert p.max_bits == int(nbits.max())


@pytest.mark.parametrize("name", list(STREAMS))
def test_sorted_decode_equals_phased_program(name):
    """Coefficients, frame-major MCU counts and steps on the learned
    schedule."""
    jd, pd, _, _ = learned(name)
    with stream_env(name):
        phases = hold_to_phased_program(jd, pd, chunk_of(name))
    assert phases[0][0] == len(chunk_of(name)) * pd.segs_per_frame


def test_narrowed_schedule_equals_jpeg_tpu():
    """jpeg_tpu's trick (tests/test_device_decode.py:141-145): the top
    half of the bounds inflated, so the schedule narrows; the program,
    then a second ``decode_batch`` on both decoders."""
    name = "420_ri1_scatter"
    jd, pd, _, p_px = learned(name)
    chunk = chunk_of(name)
    F = len(chunk)
    half = jd.sort_order[: jd.segs_per_frame // 2]
    for d in (jd, pd):
        d.lane_steps = d.lane_steps.copy()
        d.lane_steps[half] *= 4
        d.sort_order = np.argsort(-d.lane_steps, kind="stable")
    assert_same_state(jd, pd, F)
    assert len(pd._phases_for(F, pd.max_steps)) > 1  # narrowing real
    with stream_env(name):
        phases = hold_to_phased_program(jd, pd, chunk)
        assert len(phases) > 1
        before = default_metrics.counters["device_decode.mats_chunks"]
        with pytest.warns(RuntimeWarning, match="MCUs"):
            j_px = np.asarray(jd.decode_batch(chunk, chunk=F))
        with pytest.warns(RuntimeWarning, match="MCUs"):
            px = pd.decode_batch(chunk, chunk=F).numpy()
    assert default_metrics.counters["device_decode.mats_chunks"] == before + 1
    assert_same_state(jd, pd, F)
    # Intact frames as the learning batch decoded them; on damaged ones a
    # coefficient two lanes write goes to the later in the lane order, as
    # in jpeg_tpu, and the order is another.
    np.testing.assert_array_equal(px[:FRAMES + 1], p_px[:FRAMES + 1])
    for i, f in enumerate(frames_of(name)):
        want = jpeg_tpu.decode_jpeg(f, exact=False).pixels().astype(int)
        assert np.abs(px[i].astype(int) - want).max() <= 1
        assert np.abs(j_px[i].astype(int) - want).max() <= 1


def test_starvation_rule_equals_phased_scan():
    """A lane starves when it begins more steps than its phase's budget:
    a budget equal to a retiring group's longest lane (its death step,
    which flushes its last DC) does not starve, one step less does."""
    name = "420_ri3_general"
    jd, pd, _, _ = learned(name)
    chunk = chunk_of(name)
    with stream_env(name):
        p = pd.prepare(chunk, lane_order=True)
    S = p[0].shape[0]
    _, _, nsteps = place_cuda.decode_segments_general(
        pd.plan, p[0], p[1], len(chunk), pd.segs_per_frame, pd.total_blocks,
        perm=p.perm, want_nsteps=True)
    ns = nsteps.numpy()[p.perm.numpy()]  # sorted order
    cut_at = next(n for n in range(S // 2, S)
                  if ns[:n].max() > ns[n:].max() > 0)
    b0 = int(ns[cut_at:].max())
    rows = p[0].numpy().view(np.uint32)
    nbits = p[1].numpy()
    for phases, want in ((((S, b0), (cut_at, int(ns[:cut_at].max()) - b0)),
                          False),
                         (((S, int(ns.max()) - 1),), True)):
        _, _, starved, _ = jlj._scan_lanes_phased(jd.plan, rows, nbits,
                                                  phases)
        assert bool(starved) == want
        assert bool((ns > dd.phase_budgets(phases, S)).any()) == want


def test_misprediction_redoes_the_chunk():
    """Absurd learned bounds (8 steps a lane, tests/test_device_decode.py
    :153-174) on a chunk of more than 128 lanes (the schedule's first
    cut): both decoders starve, redo the chunk frame-major, count
    ``phase_inflate`` and learn the same; the coefficients are the
    classic decode's."""
    name = "420_ri3_general"
    chunk = (chunk_of(name) * 4)[:21]  # 147 lanes
    F = len(chunk)
    jd, pd, _, _ = learned(name)
    _, pd2, _, _ = learned(name)
    for d in (jd, pd, pd2):
        d.lane_steps = np.full(d.segs_per_frame, 8, np.int64)
        d.sort_order = np.arange(d.segs_per_frame)
    assert len(pd._phases_for(F, pd.max_steps)) > 1
    key = "device_decode.phase_inflate"
    with stream_env(name):
        j0, p0 = jax_metrics.counters.get(key, 0), default_metrics.counters[key]
        with pytest.warns(RuntimeWarning, match="MCUs"):
            jd.decode_batch(chunk, chunk=F)
        with pytest.warns(RuntimeWarning, match="MCUs"):
            pd.decode_batch(chunk, chunk=F)
        assert jax_metrics.counters[key] - j0 == 1
        assert default_metrics.counters[key] - p0 == 1
        assert_same_state(jd, pd, F)
        assert pd.lane_steps.min() > 8
        with pytest.warns(RuntimeWarning, match="MCUs"):
            got = pd2.decode_coeffs_batch(chunk, chunk=F)
        assert default_metrics.counters[key] - p0 == 2
        np.testing.assert_array_equal(pd2.lane_steps, pd.lane_steps)
        fresh = port_decoder(name, chunk[0])
        with pytest.warns(RuntimeWarning, match="MCUs"):
            want = fresh.decode_coeffs_batch(chunk, chunk=F)
    assert torch.equal(got, want)
    for i, f in enumerate(frames_of(name)):
        cs, planes = jpeg_tpu.decode_coefficients(f)
        host = np.concatenate([np.asarray(planes[c.cid], np.int32)
                               .reshape(-1, 64) for c in cs.geometry.components])
        np.testing.assert_array_equal(got[i].numpy(), host)


@pytest.mark.parametrize("how", ["prepare", "flat"])
def test_phased_off_and_flat_never_sort(how):
    """A learned decoder's ``prepare`` without ``lane_order`` and its flat
    prep stay frame-major, as jpeg_tpu's prep does under
    ``JPEG_TPU_PHASED=0`` and ``JPEG_TPU_PREP=flat``: no "mats" chunk,
    no learning."""
    name = "420_ri3_general"
    jd, pd, _, _ = learned(name)
    chunk = chunk_of(name)
    more = ({"JPEG_TPU_PHASED": "0"} if how == "prepare"
            else {"JPEG_TPU_PREP": "flat"})
    keys = ("device_decode.mats_chunks", "device_decode.learn_chunks")
    with stream_env(name), env(**more):
        kind = jd._prepare_native(chunk)[0]
    before = [default_metrics.counters[k] for k in keys]
    learned_steps = pd.lane_steps.copy()
    if how == "prepare":
        p = pd.prepare(chunk)
        assert p.kind == kind == "mat"
        pd.decode_prepared(p[0], p[1], len(chunk), place_ri=pd.place_ri)
    else:
        pd.prep_mode = "flat"
        assert pd.prepare(chunk, lane_order=True).kind == kind == "flat"
        with pytest.warns(RuntimeWarning, match="MCUs"):
            pd.decode_batch(chunk, chunk=len(chunk))
    assert [default_metrics.counters[k] for k in keys] == before
    np.testing.assert_array_equal(pd.lane_steps, learned_steps)


@pytest.mark.parametrize("name", list(STREAMS))
@pytest.mark.parametrize("place", ["default", "place_ri=0"])
def test_place_mode(name, place):
    """``for_stream`` takes the region kernel where the stream's segments
    tile the MCU rows (as jpeg_tpu's ``JPEG_TPU_PLACE=pallas``), and
    never learns there; ``place_ri = 0`` takes the general kernel (as
    ``JPEG_TPU_PLACE=scatter``), which learns from its first batch.  The
    general-shape stream takes the general kernel either way."""
    frames = frames_of(name)
    dec = DeviceDecoder.for_stream(frames[0], "cpu")
    region = name == "420_ri1_scatter"
    assert dec.place_ri == (1 if region else 0)
    if place == "place_ri=0":
        dec.place_ri = 0
    mode = "scatter" if dec.place_ri == 0 else "pallas"
    with env(JPEG_TPU_PLACE=mode, JPEG_TPU_PREP="rows"):
        assert JaxDecoder.for_stream(frames[0]).place_ri == dec.place_ri
    dec.decode_batch(frames)
    assert (dec.lane_steps is None) == (dec.place_ri != 0)


def test_general_ref_lane_order():
    """The plain version with an identity order equals it with none; a
    shuffled order gives the same coefficients, counts and steps on intact
    frames, and the same layout on damaged ones."""
    name = "420_ri3_general"
    pd = DeviceDecoder.for_stream(frames_of(name)[0], "cpu")
    spf, tb = pd.segs_per_frame, pd.total_blocks
    for frames in (frames_of(name), chunk_of(name)[FRAMES:]):
        F = len(frames)
        words, nbits, _ = pd.prepare(frames)
        base = place_cuda.decode_segments_general_ref(
            pd.plan, words, nbits, F, spf, tb, want_nsteps=True)
        ident = place_cuda.decode_segments_general(
            pd.plan, words, nbits, F, spf, tb,
            perm=torch.arange(F * spf, dtype=torch.int32),
            want_nsteps=True)
        for a, b in zip(base, ident):
            assert torch.equal(a, b)
        assert torch.equal(
            base[0], place_cuda.decode_segments_general_ref(
                pd.plan, words, nbits, F, spf, tb)[0])
        perm = torch.from_numpy(np.random.default_rng(F).permutation(
            F * spf).astype(np.int32))
        shuffled = place_cuda.decode_segments_general(
            pd.plan, words[perm.long()], nbits[perm.long()], F, spf, tb,
            perm=perm, want_nsteps=True)
        if frames is frames_of(name):
            for a, b in zip(base, shuffled):
                assert torch.equal(a, b)
        lay = place_cuda._general_layout(pd.plan, words, nbits, F, spf,
                                         tb)
        got = place_cuda._general_layout(pd.plan, words[perm.long()],
                                         nbits[perm.long()], F, spf, tb,
                                         perm=perm)
        for a, b in zip(lay, got):
            assert torch.equal(a, b)
    with pytest.raises(dd.UnsupportedError, match="general kernel"):
        pd.decode_prepared(words, nbits, F, place_ri=3,
                           perm=torch.arange(F * spf, dtype=torch.int32))


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A 1-rank gloo group (a file store, no port) and its CPU mesh."""
    import torch.distributed as dist

    from jpeg_tpu_torch.parallel import sharding

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield sharding.make_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", list(STREAMS))
def test_kept_decoder_prepare_is_frame_major(name, one_rank_mesh):
    """After learning, ``words, nbits, qt = dec.prepare(f)`` is still
    frame-major: ``decode_prepared`` on it, on the rows of its last frames
    (a rank's slice) and ``make_sharded_stream_decoder`` give a fresh
    decoder's decode."""
    from jpeg_tpu_torch.parallel import sharding

    _, pd, _, _ = learned(name)
    chunk = chunk_of(name)
    F, spf = len(chunk), pd.segs_per_frame
    with stream_env(name):
        assert pd.sort_order is not None
        words, nbits, qt = pd.prepare(chunk)
        fresh = port_decoder(name, chunk[0])
        with pytest.warns(RuntimeWarning, match="MCUs"):
            want = fresh.decode_coeffs_batch(chunk, chunk=F)
        with pytest.warns(RuntimeWarning, match="MCUs"):  # fresh again
            want_px = port_decoder(name, chunk[0]).decode_batch(chunk,
                                                                chunk=F)
    ri = pd.place_ri  # the decoder's placement (K2 for both streams)
    coeffs, counts = pd.decode_prepared(words, nbits, F, place_ri=ri)
    assert torch.equal(coeffs, want)
    tail, _ = pd.decode_prepared(words[2 * spf:], nbits[2 * spf:], F - 2,
                                 place_ri=ri)
    assert torch.equal(tail, want[2:])
    fn = sharding.make_sharded_stream_decoder(pd, one_rank_mesh, F,
                                              place_ri=ri)
    px, sharded_counts = fn(words, nbits, qt)
    assert torch.equal(px.to_local(), want_px)
    assert torch.equal(sharded_counts.to_local(), counts)


@pytest.mark.parametrize("bad", ["repeated lane", "short", "out of range"])
def test_general_ref_rejects_bad_perm(bad):
    """The plain version checks a lane order's values (the CUDA launch
    reads none back): one that is not a permutation raises."""
    name = "420_ri3_general"
    frames = frames_of(name)
    pd = DeviceDecoder.for_stream(frames[0], "cpu")
    F, spf, tb = len(frames), pd.segs_per_frame, pd.total_blocks
    words, nbits, _ = pd.prepare(frames)
    perm = torch.arange(F * spf, dtype=torch.int32)
    if bad == "repeated lane":
        perm[1] = 0
    elif bad == "short":
        perm = perm[:-1]
    else:
        perm[-1] = F * spf
    with pytest.raises(ValueError, match="perm"):
        place_cuda.decode_segments_general(pd.plan, words, nbits, F, spf, tb,
                                           perm=perm)
    with pytest.raises(ValueError, match="perm"):
        place_cuda._general_layout(pd.plan, words, nbits, F, spf, tb,
                                   perm=perm)


# A kept decoder on a restart interval that does not tile the MCU rows:
# 160x96 4:2:0 is 10x6 MCUs, so ri=7 gives 9 segments a frame, the last of
# 4, most of them across a row break (the benchmark's ri=7 shape, small).
RI7 = (160, 96, 7)
_RI7 = {}


def ri7_frames():
    """Three ri=7 frames encoded by jpeg_tpu."""
    if "frames" not in _RI7:
        w, h, ri = RI7
        params = JParams(h=2, v=2, quality=75, restart_interval=ri,
                         optimize=False)
        _RI7["frames"] = [jax_encode(make_ppm(w, h, seed=900 + i), params)
                          for i in range(FRAMES)]
    return _RI7["frames"]


def ri7_kept():
    """A copy of a kept ri=7 decoder in "rows" prep after its learning
    batch."""
    if "dec" not in _RI7:
        frames = ri7_frames()
        dec = DeviceDecoder.for_stream(frames[0], "cpu")
        assert dec.place_ri == 0 and dec.segs_per_frame == 9
        dec.decode_batch(frames, chunk=2)
        assert dec.sort_order is not None
        _RI7["dec"] = dec
    return copy.copy(_RI7["dec"])


def _deltas(before_counters, before_spans):
    keys = ("device_decode.mats_chunks", "device_decode.lane_order_frames",
            "device_decode.phase_inflate")
    got = {k: default_metrics.counters.get(k, 0) - before_counters.get(k, 0)
           for k in keys}
    for name in ("device_decode.inflate", "device_decode.readback"):
        got[name] = default_metrics.stages[name].calls - before_spans.get(
            name, 0)
    return got


def _snapshot():
    return (dict(default_metrics.counters),
            {k: s.calls for k, s in default_metrics.stages.items()})


def test_ri7_kept_rows_counts_the_frames_in_the_lane_order():
    """A kept ri=7 rows decoder's later batch runs in "mats" chunks:
    ``device_decode.lane_order_frames`` counts their frames, with one host
    read a batch and no redo; the coefficients equal jpeg_tpu's and the
    pixels are within 1 of its ``decode_jpeg(exact=False)``."""
    dec = ri7_kept()
    frames = ri7_frames()
    batch = frames * 2  # chunks of 4 and 2 frames
    before = _snapshot()
    px = dec.decode_batch(batch, chunk=4).numpy()
    got = _deltas(*before)
    coeffs = dec.decode_coeffs_batch(frames, chunk=4)
    assert got == {"device_decode.mats_chunks": 2,
                   "device_decode.lane_order_frames": len(batch),
                   "device_decode.phase_inflate": 0,
                   "device_decode.inflate": 0,
                   "device_decode.readback": 1}
    for i, f in enumerate(frames):
        cs, planes = jpeg_tpu.decode_coefficients(f)
        host = np.concatenate([np.asarray(planes[c.cid], np.int32)
                               .reshape(-1, 64) for c in cs.geometry.components])
        np.testing.assert_array_equal(coeffs[i].numpy(), host)
        want = jpeg_tpu.decode_jpeg(f, exact=False).pixels().astype(int)
        for k in (i, i + FRAMES):
            assert np.abs(px[k].astype(int) - want).max() <= 1


def test_ri7_redo_opens_inflate_and_counts_none_of_its_frames():
    """Bounds of 8 steps a segment starve a chunk of more than 128 lanes
    (16 frames, 144 lanes): it is redone frame-major inside one
    ``device_decode.inflate`` span, and only the frames of the chunk that
    stood (2 frames, 18 lanes: one phase, which cannot starve) count in
    ``device_decode.lane_order_frames``; the pixels are the learned
    decoder's."""
    dec = ri7_kept()
    frames = ri7_frames()
    batch = (frames * 6)[:18]
    want = ri7_kept().decode_batch(batch, chunk=16)
    dec.lane_steps = np.full(dec.segs_per_frame, 8, np.int64)
    dec.sort_order = np.arange(dec.segs_per_frame)
    assert len(dec._phases_for(16, dec.max_steps)) > 1
    assert len(dec._phases_for(2, dec.max_steps)) == 1
    before = _snapshot()
    got_px = dec.decode_batch(batch, chunk=16)
    got = _deltas(*before)
    assert got == {"device_decode.mats_chunks": 2,
                   "device_decode.lane_order_frames": 2,
                   "device_decode.phase_inflate": 1,
                   "device_decode.inflate": 1,
                   "device_decode.readback": 2}
    assert dec.lane_steps.min() > 8
    assert torch.equal(got_px, want)


@pytest.mark.parametrize("bad", ["repeated lane", "out of range", "short"])
def test_cuda_perm_check_host_half(bad):
    """The CUDA launch's check of a caller's lane order (``_check_perm``),
    run on CPU tensors: one that repeats a lane or leaves the lanes raises
    ValueError, as the plain version does; one the caller marks as built
    by it (``checked``) is not read."""
    S = 18
    perm = torch.arange(S, dtype=torch.int32)
    if bad == "repeated lane":
        perm[1] = 0
    elif bad == "out of range":
        perm[-1] = S
    else:
        perm = perm[:-1]
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="perm"):
        place_cuda._check_perm(perm, S, cpu)
    if bad != "short":
        assert place_cuda._check_perm(perm, S, cpu, checked=True) == \
            perm.data_ptr()
    good = torch.arange(S, dtype=torch.int32).flip(0).contiguous()
    assert place_cuda._check_perm(good, S, cpu) == good.data_ptr()
    assert place_cuda._check_perm(None, S, cpu) == 0


def test_decoder_trusts_only_its_own_lane_order(monkeypatch):
    """``decode_prepared`` marks the decoder's own cached order as checked
    (no host read on the card) and a caller's copy of it as not."""
    dec = ri7_kept()
    frames = ri7_frames()
    p = dec.prepare(frames, lane_order=True)
    assert p.kind == "mats"
    seen = []
    real = dd.decode_segments_general

    def spy(*a, perm_checked=False, **k):
        seen.append(perm_checked)
        return real(*a, **k)

    monkeypatch.setattr(dd, "decode_segments_general", spy)
    own = dec.decode_prepared(p[0], p[1], FRAMES, perm=p.perm)
    copied = dec.decode_prepared(p[0], p[1], FRAMES, perm=p.perm.clone())
    assert seen == [True, False]
    for a, b in zip(own, copied):
        assert torch.equal(a, b)
    bad = p.perm.clone()
    bad[1] = bad[0]
    with pytest.raises(ValueError, match="perm"):
        dec.decode_prepared(p[0], p[1], FRAMES, perm=bad)
