"""PyTorch port: multi-device (``jpeg_tpu_torch.parallel``) on the CPU.

The port's sharded paths run in spawned gloo ranks on the CPU
(``parallel.demo.spawn`` of ``check_rank``: the children import the port
only, never this module or JAX), at world size 2 (meshes (2, 1) and
(1, 2), and a 1-D 'frame' mesh of 2) and 4 ((2, 2), both axes, and a
1-D mesh of 4).  Each world size spawns once for all of its paths
(module fixtures); the assertions are parametrized so that every case
counts.  The JAX references run here, on the 8 virtual CPU devices of
``tests/conftest.py``, as ``tests/test_sharding.py`` runs them.  The
tests mirror ``tests/test_sharding.py`` (all but its graft entry
contract, which is JAX's own) and ``tests/test_multihost.py``.

Tolerances:
* the context-parallel frame decode: coefficients integer for integer
  against jpeg_tpu's ``decode_frame_sharded`` on as many devices, intact,
  with seeded damage to the entropy bytes (writes of two ranks into one
  coefficient add, as the JAX ``psum``) and with padding lanes, and
  intact against the serial oracle;
* the stream decoder: pixels equal to the port's single-device
  ``DeviceDecoder.decode_batch`` and within +-1 of jpeg_tpu's
  ``make_sharded_stream_decoder`` (float IDCTs sum in another order);
  region (K1) and scatter (K2) placements equal;
* the stream encoder: bytes equal to the port's single-device
  ``encode_batch``, its all-reduced histogram equal to the single-device
  dry pass;
* ``decode_batch_ycc`` (fast) within atol 2e-3 of jpeg_tpu's (the JAX
  test's own tolerance, test_sharding.py:45); exact mode equal;
* ``encode_batch_ycc`` coefficients within +-1 of jpeg_tpu's, at most
  ``ENCODE_DIFF_SHARE`` of them differing (fast mode; exact mode equal);
* the roundtrip histogram sums to ``b * n_luma_blocks`` and equals the
  single-device histogram;
* ``_cached_frame_decoder`` hits its cache for frames 2..N.
"""

import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from jpeg_tpu.api import decode_coefficients as jax_decode_coefficients
from jpeg_tpu.encoder import EncodeParams as JaxParams
from jpeg_tpu.encoder import encode_jpeg as jax_encode_jpeg
from jpeg_tpu.entropy.lockstep_jax import _max_steps_for
from jpeg_tpu.models import batch as jax_batch
from jpeg_tpu.models.device_decode import DeviceDecoder as JaxDecoder
from jpeg_tpu.parallel import sharding as jax_sharding
from jpeg_tpu.utils.pnm import read_pnm

import jpeg_tpu_torch as jt
from jpeg_tpu_torch.format.parse import parse_codestream
from jpeg_tpu_torch.models import batch as port_batch
from jpeg_tpu_torch.models.device_decode import DeviceDecoder
from jpeg_tpu_torch.models.device_encode import DeviceEncoder
from jpeg_tpu_torch.parallel import demo
from refbin import make_pgm, make_ppm

REPO = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 240.0
# Fast-mode encode: the share of coefficients that may differ by 1 from
# jpeg_tpu's (a float32 FDCT summed in another order lands on the other
# side of a rounding boundary; none differs by more).
ENCODE_DIFF_SHARE = 1e-3
CFG = port_batch.BatchConfig(height=64, width=64, h=2, v=2)
STREAM_PARAMS = dict(h=2, v=2, quality=75, optimize=False,
                     restart_interval=2, exact=False)


def damage_bytes(frame: bytes, seed: int, every: int = 23) -> bytes:
    """Seeded damage to a frame's entropy bytes: about one byte in
    ``every`` of each restart segment becomes a random byte.  Neither a
    0xFF nor the byte after one is touched and no 0xFF is written, so
    the marker structure stays as it was."""
    rng = np.random.default_rng(seed)
    out = bytearray(frame)
    for s, e in parse_codestream(frame).scans[0].ecs_ranges:
        for i in range(s + 1, e):
            if out[i] != 0xFF and out[i - 1] != 0xFF and \
                    rng.random() < 1 / every:
                out[i] = int(rng.integers(0, 0xFF))
    return bytes(out)


def jax_ppm_frames(w, h, seeds, params):
    return [jax_encode_jpeg(make_ppm(w, h, seed=s), JaxParams(**params))
            for s in seeds]


def frame_inputs():
    """The frames of the context-parallel decode: intact (4:2:0,
    optimized tables, DRI 3), the same with seeded damage, and a gray
    frame whose lane count needs padding lanes."""
    intact = jax_encode_jpeg(
        make_ppm(160, 120, seed=33),
        JaxParams(h=2, v=2, quality=80, optimize=True, restart_interval=3))
    gray = jax_encode_jpeg(
        make_pgm(72, 56, seed=8),
        JaxParams(quality=70, optimize=False, restart_interval=5))
    return {"intact": intact, "damaged": damage_bytes(intact, seed=5),
            "padding": gray}


CACHED = dict(h=2, v=2, quality=80, restart_interval=3, optimize=False,
              exact=False)


def spec_paths(world, tmp):
    """Every sharded path a world size runs, and the files they read."""
    frames = frame_inputs()
    demo.frames_file(tmp / "frames.npz", list(frames.values()))
    demo.frames_file(tmp / "cached.npz",
                     jax_ppm_frames(160, 120, range(40, 43), CACHED))
    demo.frames_file(tmp / "scatter.npz",
                     jax_ppm_frames(48, 32, range(60, 64), STREAM_PARAMS))
    demo.frames_file(tmp / "region.npz",
                     jax_ppm_frames(64, 32, range(200, 204), STREAM_PARAMS))
    pix = np.stack([read_pnm(make_ppm(48, 32, seed=180 + s)).data
                    for s in range(4)]).astype(np.uint8)
    np.save(tmp / "pixels.npy", pix)
    cfg = [CFG.height, CFG.width, CFG.h, CFG.v]
    meshes = [[2, 1], [1, 2]] if world == 2 else [[2, 2]]
    paths = [{"name": "mesh_default", "kind": "mesh", "mesh": "default"}]
    for m in meshes:
        tag = f"{m[0]}x{m[1]}"
        paths += [
            {"name": f"dec_{tag}", "kind": "batch_decode", "cfg": cfg,
             "batch": 8, "seed": 0, "mesh": m},
            {"name": f"dec_exact_{tag}", "kind": "batch_decode", "cfg": cfg,
             "batch": 8, "seed": 0, "exact": True, "mesh": m},
            {"name": f"rt_{tag}", "kind": "roundtrip", "cfg": cfg,
             "batch": 8, "seed": 1, "mesh": m},
        ]
    fm = [2, 1] if world == 2 else [2, 2]
    paths += [
        {"name": "scatter", "kind": "stream_decode", "frames": "scatter.npz",
         "place_ri": 0, "mesh": fm},
        {"name": "region_general", "kind": "stream_decode",
         "frames": "region.npz", "place_ri": 0, "mesh": fm},
        {"name": "region", "kind": "stream_decode", "frames": "region.npz",
         "place_ri": 2, "mesh": fm},
        {"name": "encode", "kind": "stream_encode", "pixels": "pixels.npy",
         "params": STREAM_PARAMS, "with_hist": True, "mesh": fm},
        {"name": "frame", "kind": "frame_decode", "frames": "frames.npz",
         "mesh": "frame"},
        {"name": "cached", "kind": "frame_decode", "frames": "cached.npz",
         "mesh": "frame"},
        {"name": "global_batch", "kind": "global_batch",
         "frames": "scatter.npz", "mesh": "frame"},
    ]
    if world == 4:  # the frame decode over the 'frame' axis of (2, 2)
        paths.append({"name": "frame_2x2", "kind": "frame_decode",
                      "frames": "frames.npz", "mesh": [2, 2]})
    return frames, paths


def run_world(world, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"ws{world}")
    frames, paths = spec_paths(world, tmp)
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"paths": paths}))
    demo.spawn(world, "jpeg_tpu_torch.parallel.demo:check_rank", str(spec),
               "cpu", timeout_s=SPAWN_TIMEOUT_S)

    def load(name):
        outs = [dict(np.load(tmp / f"{name}.r{r}.npz"))
                for r in range(world)]
        for o in outs[1:]:  # every rank gathered the same whole results
            for k, v in outs[0].items():
                if k not in ("seconds", "jpegs", "lens"):
                    np.testing.assert_array_equal(o[k], v, err_msg=k)
        return outs

    return {"world": world, "tmp": tmp, "frames": frames, "load": load}


@pytest.fixture(scope="module")
def ws2(tmp_path_factory):
    return run_world(2, tmp_path_factory)


@pytest.fixture(scope="module")
def ws4(tmp_path_factory):
    return run_world(4, tmp_path_factory)


@pytest.fixture
def ws(request):
    return request.getfixturevalue(request.param)


def jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), axis_names=("frame",))


# ---- mirrors of tests/test_sharding.py -----------------------------------


@pytest.mark.parametrize("ws, want", [("ws2", [1, 2]), ("ws4", [2, 2])],
                         indirect=["ws"])
def test_mesh_shape(ws, want):
    """``make_mesh()`` over the group: ('frame', 'tile') with tile 2 when
    the rank count is even, as jpeg_tpu's ``make_mesh``."""
    for o in ws["load"]("mesh_default"):
        assert list(o["mesh_shape"]) == want
        assert list(o["mesh_names"]) == ["frame", "tile"]


DECODE_CASES = [("ws2", "2x1"), ("ws2", "1x2"), ("ws4", "2x2")]


@pytest.mark.parametrize("ws, tag", DECODE_CASES, indirect=["ws"])
@pytest.mark.parametrize("exact", [False, True])
def test_sharded_decode_matches_single_device(ws, tag, exact):
    """The sharded batch decode (tile shards all-gathered over 'tile')
    against jpeg_tpu's single-device ``decode_batch_ycc``: atol 2e-3 in
    fast mode, equal in exact mode."""
    y, cb, cr, ql, qc = demo.batch_inputs(CFG, 8, 0)
    ref = np.asarray(jax_batch.decode_batch_ycc(
        jax_batch.BatchConfig(64, 64, 2, 2), y, cb, cr, ql, qc, exact=exact))
    got = ws["load"](f"dec_{'exact_' if exact else ''}{tag}")[0]["px"]
    assert got.shape == ref.shape == (8, 64, 64, 3)
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=2e-3)


@pytest.mark.parametrize("ws, tag", DECODE_CASES, indirect=["ws"])
def test_sharded_roundtrip_runs_and_reduces(ws, tag):
    """Decode + re-encode + histogram all-reduce: the histogram sums to
    every luma block of the batch and equals the single-device step's;
    the planes keep their shapes and equal the single-device step's."""
    y, cb, cr, ql, qc = demo.batch_inputs(CFG, 8, 1)
    o = ws["load"](f"rt_{tag}")[0]
    assert o["y2"].shape == y.shape and o["cb2"].shape == cb.shape
    assert int(o["hist"].sum()) == 8 * CFG.n_luma_blocks
    ref = port_batch.roundtrip_step_ycc(
        CFG, *(torch.from_numpy(a) for a in (y, cb, cr, ql, qc)))
    for name, r in zip(("y2", "cb2", "cr2", "hist"), ref):
        np.testing.assert_array_equal(o[name], r.numpy(), err_msg=name)


@functools.lru_cache(maxsize=None)
def jax_stream(frames: tuple):
    """jpeg_tpu's ``make_sharded_stream_decoder`` on make_mesh(8), as
    test_sharding.py runs it (scatter placement)."""
    dec = JaxDecoder.for_stream(frames[0])
    prepared = dec.prepare(frames)
    if prepared[0] == "flat":
        buf, starts, nbits, qts = prepared[1:]
        idx = starts[:, None] + np.arange(dec.wn, dtype=np.int32)[None, :]
        words = np.asarray(buf)[np.minimum(idx, buf.shape[0] - 1)]
    else:
        words, _, nbits, qts = prepared[1:]
    steps = _max_steps_for(nbits.astype(np.int64), dec.plan, dec.ri,
                           optimistic=False)
    fn = jax_sharding.make_sharded_stream_decoder(
        dec.plan, dec.geom, jax_sharding.make_mesh(8), len(frames),
        dec.segs_per_frame, steps)
    px, starved = fn(words, nbits, qts)
    assert not np.asarray(starved).any()
    return np.asarray(px)


@pytest.mark.parametrize("ws", ["ws2", "ws4"], indirect=True)
def test_sharded_full_stream_decode_matches_single_device(ws):
    """Segment kernel + dense tail sharded over 'frame' == the port's
    single-device decode exactly, within +-1 of jpeg_tpu's sharded
    decoder, every frame decoded whole."""
    frames = demo.read_frames(ws["tmp"] / "scatter.npz")
    o = ws["load"]("scatter")[0]
    single = DeviceDecoder.for_stream(frames[0], "cpu").decode_batch(frames)
    np.testing.assert_array_equal(o["px"], single.numpy())
    assert int(o["counts"].sum()) == int(o["n_mcus"]) * len(frames)
    diff = np.abs(o["px"].astype(int) - jax_stream(tuple(frames)).astype(int))
    assert diff.max() <= 1


@pytest.mark.parametrize("ws", ["ws2", "ws4"], indirect=True)
def test_sharded_stream_decode_region_placement(ws):
    """The region placement (K1, the Pallas kernel's port) equals the
    general placement (K2) shard for shard, and the single-device
    decode."""
    frames = demo.read_frames(ws["tmp"] / "region.npz")
    region = ws["load"]("region")[0]
    general = ws["load"]("region_general")[0]
    np.testing.assert_array_equal(region["px"], general["px"])
    np.testing.assert_array_equal(region["counts"], general["counts"])
    single = DeviceDecoder.for_stream(frames[0], "cpu").decode_batch(frames)
    np.testing.assert_array_equal(region["px"], single.numpy())


@pytest.mark.parametrize("ws", ["ws2", "ws4"], indirect=True)
def test_sharded_full_stream_encode_matches_single_device(ws):
    """Dense + entropy encode sharded over 'frame': each rank's bytes equal
    the single-device ``encode_batch`` of its frames, and the all-reduced
    histogram the single-device dry pass."""
    pix = np.load(ws["tmp"] / "pixels.npy")
    enc = DeviceEncoder.for_config(32, 48, 3, jt.EncodeParams(**STREAM_PARAMS),
                                   device="cpu")
    expected = enc.encode_batch(torch.from_numpy(pix))
    outs = ws["load"]("encode")
    got = []
    for o in outs[::ws["world"] // 2]:  # one rank of each 'frame' index
        data, ends = o["jpegs"].tobytes(), np.cumsum(o["lens"])
        got += [data[e - n:e] for e, n in zip(ends, o["lens"])]
    assert got == [bytes(e) for e in expected]
    hist = enc.histogram(enc.dense(torch.from_numpy(pix)))
    np.testing.assert_array_equal(outs[0]["hist"], hist.numpy())


FRAME_CASES = [("ws2", "frame", 2), ("ws4", "frame", 4),
               ("ws4", "frame_2x2", 2)]


@pytest.mark.parametrize("ws, path, n", FRAME_CASES, indirect=["ws"])
@pytest.mark.parametrize("which", ["intact", "damaged", "padding"])
def test_single_frame_segments_across_chips(ws, path, n, which):
    """Context parallelism: ONE frame's restart segments shard over ``n``
    ranks; coefficients integer for integer jpeg_tpu's
    ``decode_frame_sharded`` over ``n`` devices (damaged: cross-rank
    overlaps add, as its psum), and the serial oracle where intact."""
    names = list(ws["frames"])
    data = ws["frames"][which]
    o = ws["load"](path)[0]
    _, expect = jax_sharding.decode_frame_sharded(data, jax_mesh(n))
    i = names.index(which)
    for cid, plane in expect.items():
        np.testing.assert_array_equal(o[f"f{i}_c{cid}"], plane)
    if which != "damaged":
        _, serial = jax_decode_coefficients(data, entropy="serial")
        for cid, plane in serial.items():
            np.testing.assert_array_equal(o[f"f{i}_c{cid}"], plane)


@pytest.mark.parametrize("ws", ["ws2", "ws4"], indirect=True)
def test_frame_sharded_decoder_is_cached_across_frames(ws):
    """Frames 2..N of a stream reuse frame 1's decoder."""
    frames = demo.read_frames(ws["tmp"] / "cached.npz")
    for o in ws["load"]("cached"):
        assert int(o["cache_hits"]) >= len(frames) - 1
        assert int(o["cache_misses"]) == 1


@pytest.mark.parametrize("ws", ["ws2", "ws4"], indirect=True)
def test_single_frame_sharded_with_padding_lanes(ws):
    """A lane count the axis does not divide: empty lanes pad it, and
    the decode equals the single-device one."""
    data = ws["frames"]["padding"]
    n_lanes = len(parse_codestream(data).scans[0].ecs_ranges)
    assert n_lanes % ws["world"]  # the frame needs padding lanes
    i = list(ws["frames"]).index("padding")
    o = ws["load"]("frame")[0]
    _, expect = jt.decode_coefficients(data, entropy="lockstep-jax",
                                       device="cpu")
    for cid, plane in expect.items():
        np.testing.assert_array_equal(o[f"f{i}_c{cid}"], plane)


# ---- distributed.py and the demo (tests/test_multihost.py) --------------


@pytest.mark.parametrize("ws", ["ws2", "ws4"], indirect=True)
def test_global_frame_batch(ws):
    """Each rank decodes its ``shard_frames`` slice; ``global_frame_batch``
    spans every rank's frames in rank order."""
    frames = demo.read_frames(ws["tmp"] / "scatter.npz")
    want = DeviceDecoder.for_stream(frames[0], "cpu").decode_batch(frames)
    for o in ws["load"]("global_batch"):
        assert list(o["shape"]) == list(want.shape)
        np.testing.assert_array_equal(o["full"], want.numpy())


def test_shard_frames_matches_jax():
    from jpeg_tpu.parallel.distributed import shard_frames as jax_shard
    from jpeg_tpu_torch.parallel.distributed import shard_frames

    frames = [bytes([i]) for i in range(7)]
    for n in (1, 2, 3, 4):
        for pid in range(n):
            assert shard_frames(frames, pid, n) == jax_shard(frames, pid, n)


def test_single_process_fallbacks():
    """No process group: ``initialize`` reports one process and
    ``global_frame_batch`` returns its input."""
    from jpeg_tpu_torch.parallel import distributed

    assert distributed.initialize(device="cpu") == (0, 1)
    x = np.zeros((2, 4, 4, 3), np.uint8)
    assert distributed.global_frame_batch(x) is x
    assert distributed.backend_for("cuda") == "nccl"
    assert distributed.backend_for("cpu") == "gloo"


def test_parallel_demo_two_ranks():
    """``python -m jpeg_tpu_torch.parallel.demo 2 3 --device cpu``: two
    gloo ranks, each decodes its 3 frames and the all-reduced checksum
    agrees on both."""
    res = subprocess.run(
        [sys.executable, "-m", "jpeg_tpu_torch.parallel.demo", "2", "3",
         "--device", "cpu", "--timeout", "120"],
        capture_output=True, timeout=180, cwd=REPO)
    out = res.stdout.decode() + res.stderr.decode()
    assert res.returncode == 0, out
    assert "parallel demo: OK" in out
    ranks = re.findall(r"\[rank (\d)/2\] decoded (\d+) frames.*?ok=True", out)
    assert sorted(r[0] for r in ranks) == ["0", "1"], out
    assert all(r[1] == "3" for r in ranks)
    gb = re.findall(r"global_batch=\((\d+),", out)
    assert gb and all(g == "6" for g in gb), out
    gsums = re.findall(r"gsum=(\d+)", out)
    assert len(gsums) == 2 and len(set(gsums)) == 1, out


# ---- models/batch.py, one device ---------------------------------------


SAMPLINGS = [(2, 2), (2, 1), (1, 1)]


@pytest.mark.parametrize("h, v", SAMPLINGS)
@pytest.mark.parametrize("exact", [False, True])
def test_decode_batch_ycc_matches_jax(h, v, exact):
    """``decode_batch_ycc`` against jpeg_tpu's: atol 2e-3 in fast mode,
    equal in exact mode; the padded-grid geometry K11 takes holds every
    plane of the batch."""
    cfg = port_batch.BatchConfig(40, 56, h, v)
    y, cb, cr, ql, qc = demo.batch_inputs(cfg, 3, 7)
    ref = np.asarray(jax_batch.decode_batch_ycc(
        jax_batch.BatchConfig(40, 56, h, v), y, cb, cr, ql, qc, exact=exact))
    got = port_batch.decode_batch_ycc(
        cfg, *(torch.from_numpy(a) for a in (y, cb, cr, ql, qc)),
        exact=exact).numpy()
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=2e-3)
    geom = port_batch.batch_geometry(cfg)
    assert (geom.size_y, geom.size_x) == (geom.height, geom.width) == \
        tuple(8 * g for g in cfg.luma_grid)
    assert [c.n_blocks for c in geom.components] == \
        [cfg.n_luma_blocks, cfg.n_chroma_blocks, cfg.n_chroma_blocks]


@pytest.mark.parametrize("h, v", SAMPLINGS)
@pytest.mark.parametrize("exact", [False, True])
def test_encode_batch_ycc_matches_jax(h, v, exact):
    """``encode_batch_ycc`` against jpeg_tpu's: within +-1 and at most
    ``ENCODE_DIFF_SHARE`` differing in fast mode, equal in exact mode."""
    cfg = port_batch.BatchConfig(40, 56, h, v)
    by, bx = cfg.luma_grid
    rgb = np.random.default_rng(9).uniform(
        0, 255, (3, by * 8, bx * 8, 3)).astype(np.float32)
    ql, qc = np.full(64, 6, np.int32), np.full(64, 11, np.int32)
    ref = jax_batch.encode_batch_ycc(jax_batch.BatchConfig(40, 56, h, v),
                                     rgb, ql, qc, exact=exact)
    got = port_batch.encode_batch_ycc(
        cfg, *(torch.from_numpy(a) for a in (rgb, ql, qc)), exact=exact)
    for g, r in zip(got, ref):
        d = np.abs(g.numpy().astype(np.int64) - np.asarray(r))
        if exact:
            assert d.max() == 0
        else:
            assert d.max() <= 1 and (d > 0).mean() <= ENCODE_DIFF_SHARE


def test_roundtrip_step_ycc_matches_jax():
    """The roundtrip step: planes within +-1 of jpeg_tpu's (at most
    ``ENCODE_DIFF_SHARE`` differing), the histogram summing to every luma
    block and within the differing blocks of jpeg_tpu's."""
    y, cb, cr, ql, qc = demo.batch_inputs(CFG, 4, 1)
    ref = jax_batch.roundtrip_step_ycc(jax_batch.BatchConfig(64, 64, 2, 2),
                                       y, cb, cr, ql, qc)
    got = port_batch.roundtrip_step_ycc(
        CFG, *(torch.from_numpy(a) for a in (y, cb, cr, ql, qc)))
    for g, r in zip(got[:3], ref[:3]):
        d = np.abs(g.numpy().astype(np.int64) - np.asarray(r))
        assert d.max() <= 1 and (d > 0).mean() <= ENCODE_DIFF_SHARE
    hist = got[3].numpy()
    assert hist.sum() == 4 * CFG.n_luma_blocks
    dc_diff = int((got[0][..., 0].numpy() != np.asarray(ref[0])[..., 0]).sum())
    assert np.abs(hist - np.asarray(ref[3])).sum() <= 2 * dc_diff


def test_batch_plain_versions_on_cpu():
    """On a CPU tensor each function is its plain version, and the exact
    flag of the block helpers matches jpeg_tpu's."""
    y, cb, cr, ql, qc = demo.batch_inputs(CFG, 2, 3)
    t = [torch.from_numpy(a) for a in (y, cb, cr, ql, qc)]
    a = port_batch.decode_batch_ycc(CFG, *t)
    b = port_batch.decode_batch_ycc_ref(CFG, *t)
    assert torch.equal(a, b)
    for exact in (False, True):
        got = port_batch.decode_blocks_batch(t[0], t[3], 8, 8, 8, exact)
        ref = jax_batch.decode_blocks_batch(jnp.asarray(y), jnp.asarray(ql),
                                            8, 8, 8, exact)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=0 if exact else 2e-3)


def test_place_ri_refuses_ineligible_region():
    """``decode_prepared(place_ri=ri)`` takes the region kernel only where
    it tiles the frame (as jpeg_tpu leaves eligibility to the caller, the
    port refuses rather than place otherwise); 0 is the general kernel,
    equal to the region placement on an intact stream."""
    frames = jax_ppm_frames(64, 32, range(200, 202), STREAM_PARAMS)
    dec = DeviceDecoder.for_stream(frames[0], "cpu")
    words, nbits, _ = dec.prepare(frames)
    with pytest.raises(jt.errors.UnsupportedError):
        dec.decode_prepared(words, nbits, 2, place_ri=3)
    region, _ = dec.decode_prepared(words, nbits, 2, place_ri=2)
    general, _ = dec.decode_prepared(words, nbits, 2, place_ri=0)
    assert torch.equal(region, general)
