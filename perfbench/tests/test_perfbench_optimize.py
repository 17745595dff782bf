"""The cell ``encode.ri4.optimize`` on the CPU at small sizes: each frame
with the optimal Huffman tables of its own symbols.

The plain reference's Annex K.2 equals the program's tables; the judge
of ``drivers/optimized_encode.py`` passes the program's output and fails four controls (the reference
with TF32 products, the Annex K tables, per-batch tables, one coefficient
altered), each by the number meant to catch it; a program without
per-frame tables fails in set-up before its corpus is made; the cell
loads by name and its readers read the window."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import cell as cells
from perfbench import judge
from perfbench import run as runner
from perfbench.tests import tiny

CELL = "encode.ri4.optimize"
# The number each control must fail by.
CONTROLS = {"tf32": "seg_diff_share", "annex_k": "table_off_share",
            "per_batch": "table_off_share", "altered": "coef_max_gap"}


def _small(width=160, height=96, frames=4, chunk=2):
    c = tiny.cell(CELL, width, height)
    c.traffic.update(clip_frames=frames, chunk=chunk, check_calls=1)
    return c


def _driver(c, seed=2 ** 32 + 17):
    pixels, _, _ = c.driver.make_inputs(c, seed)
    return c.driver.Driver(c, seed, torch.device("cpu"), pixels,
                           lambda *a: None)


def test_cell_loads_by_name():
    c = cells.load_cell(tiny.BENCH, CELL)
    assert c.driver.KIND == "encode" and c.traffic["optimize"] == "frame"
    assert c.config["name"] == "cjpeg-1080p-420-q75-optimize-ri4"
    assert c.reference.__name__.startswith("perfbench_file_")
    assert hasattr(c.reference, "decode_segments")
    assert [m["name"] for m in c.end_to_end] == [
        "encode_Mpix_s", "encode_p95_ms", "setup_s"]
    assert [m["name"] for m in c.per_layer] == [
        "hist_ms.opt", "tables_ms.opt", "python_table_share.opt",
        "hist_roofline.opt", "kernel_roofline.opt", "device_idle.opt",
        "finalize_ms.opt", "pull_ms.opt"]
    for m in c.per_layer:
        assert c.reader("layer_metrics", m["name"]).read


def test_reference_tables_equal_the_programs():
    """On seeded frames each frame's DHT holds the reference's K.2
    tables of the symbols the reference decodes from it; on seeded
    histograms (ties, one symbol, every symbol) the reference's K.2 is
    the program's ``tables.optimize_table``."""
    from jpeg_tpu_torch.tables import optimize_table

    c = _small()
    ref, geom = c.reference, c.reference.geometry_of(c.config)
    d = _driver(c)
    frames = d.call(0)
    assert len(frames) == 4
    for frame in frames:
        markers, segs, problem = ref.split_frame(frame)
        assert problem is None
        bad, tables = ref.header_problems(markers, geom, 75, 4)
        assert not bad
        _, hist = ref.decode_segments(segs, geom, 4, tables)
        assert ref.optimal_tables(hist) == tables
    rng = np.random.default_rng(4)
    rows = [rng.integers(0, top, 256) * (rng.random(256) < p)
            for top, p in ((3, 0.5), (40, 0.7), (10 ** 5, 1.0), (2, 0.05))]
    rows += [np.eye(256, dtype=np.int64)[200], np.full(256, 9)]
    for row in rows:
        spec = optimize_table(row)
        assert ref.optimal_table(row) == (spec.counts, spec.values)


def test_the_cell_runs_correct_and_reports_its_metrics(monkeypatch):
    c = _small()
    res = tiny.run_cpu(c)
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"frames_malformed", "table_off_share",
                                  "seg_diff_share", "coef_max_gap"}
    assert res["checks"]["table_off_share"]["value"] == 0
    assert set(res["metrics"]) == {"encode_Mpix_s", "encode_p95_ms",
                                   "setup_s"}
    # Traced: the spans and counters of the measured window (no device
    # here, so no profiled windows and no device metrics).
    monkeypatch.setattr(runner.trace, "profiled_windows",
                        lambda *a, **k: ([], 0))
    res = tiny.run_cpu(c, traced=True)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(m) == {"hist_ms.opt", "tables_ms.opt",
                      "python_table_share.opt", "finalize_ms.opt",
                      "pull_ms.opt"}
    assert m["hist_ms.opt"] > 0 and m["tables_ms.opt"] > 0
    assert m["finalize_ms.opt"] > 0 and m["pull_ms.opt"] > 0
    assert m["python_table_share.opt"] == 0.0


def test_program_passes_and_the_controls_fail():
    """At 320x240 (2-frame clips): the program's output within every
    limit; each control outside the limit meant for it."""
    c = _small(320, 240, frames=2, chunk=2)
    limits = c.config["limits"][c.driver.KIND]
    d = _driver(c)
    program = [(i, d.call(i)) for i in range(2)]
    controls = d.controls(range(2))
    ok, table = judge.verdict(d.judge(program), limits)
    assert ok, table
    assert table["table_off_share"]["value"] == 0
    for name, limit in CONTROLS.items():
        ok, table = judge.verdict(d.judge(controls[name]), limits)
        assert not ok, (name, table)
        failed = [k for k, v in table.items() if v["value"] > v["limit"]]
        assert limit in failed, (name, table)
    assert d.judge(controls["altered"])["seg_diff_share"] <= 0.06


def test_a_program_without_frame_tables_fails_in_setup(monkeypatch):
    from jpeg_tpu_torch import DeviceEncoder

    c = _small()
    made = []
    monkeypatch.setattr(DeviceEncoder, "OPTIMIZE_MODES", (False, True))
    monkeypatch.setattr(c.driver.corpus, "pixels",
                        lambda *a: made.append(a))
    with pytest.raises(RuntimeError, match="no optimize='frame' mode"):
        c.driver.make_inputs(c, 5)
    assert not made


def _run(counters=None, spans=None, profiled=(), calls=4, per_call=16):
    return SimpleNamespace(
        window=SimpleNamespace(counters=counters or {}, spans=spans or {},
                               calls=calls, failed=0,
                               latencies=[0.01] * calls),
        frames_per_call=per_call, profiled=list(profiled),
        cell=tiny.cell(CELL, 1920, 1080))


@pytest.mark.parametrize("counters,want", [
    ({"device_encode.native_table_builds": 24}, 0.0),
    ({"device_encode.native_table_builds": 24,
      "device_encode.python_table_builds": 8}, 25.0),
    ({"device_encode.python_table_builds": 8}, 100.0),
    ({}, None),  # a program without the counters
])
def test_python_table_share_reader(counters, want):
    read = tiny.cell(CELL).reader("layer_metrics",
                                  "python_table_share.opt").read
    got = read(_run(counters))
    assert got == (None if want is None else pytest.approx(want))


def test_hist_roofline_reader():
    """Two profiled calls of 16 1080p frames: 2 x 16 x 48,960 blocks x 64
    coefficients x 2 bytes at 3.35 TB/s is 59.86 us; 119.73 us of the
    kernel reads 50%.  Other kernels do not count; no such kernel reads
    nothing."""
    read = tiny.cell(CELL).reader("layer_metrics", "hist_roofline.opt").read
    win = SimpleNamespace(work=[(0, 0), (0, 0)], device=[
        ("(anonymous namespace)::hist_blocks_kernel(int const*)", 0.0,
         119.72547),
        ("(anonymous namespace)::encode_segments_kernel(int const*)", 0.0,
         500.0),
        ("Memcpy DtoH (Device -> Pageable)", 0.0, 50.0)])
    bound = 2 * 16 * 48960 * 64 * 2 / 3.35e12
    assert bound == pytest.approx(59.8627e-6, rel=1e-5)
    assert read(_run(profiled=[win])) == pytest.approx(50.0, rel=1e-4)
    win.device = win.device[1:]
    assert read(_run(profiled=[win])) is None
    assert read(_run()) is None
