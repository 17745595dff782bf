"""The cell ``decode.ri7.kept-rows`` on the CPU, at a size where a restart
interval of 7 still straddles the MCU rows (160x96: 10x6 MCUs, 9 segments
a frame, the last of 4): a kept decoder in "rows" prep decodes every timed
frame in its learned lane order, and the two metrics that read the order
say so; in "flat" prep, which never sorts, they read nothing."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import judge
from perfbench import run as runner
from perfbench.readings import readings
from perfbench.tests import tiny

CELL = "decode.ri7.kept-rows"
SIZE = (160, 96)


def _small(**traffic):
    c = tiny.cell(CELL, *SIZE)
    c.traffic.update(check_calls=1, **traffic)
    return c


def _traced(c, monkeypatch):
    # The metrics here read the measured window alone: no profiled ones.
    monkeypatch.setattr(runner.trace, "profiled_windows",
                        lambda *a, **k: ([], 0))
    res = tiny.run_cpu(c, traced=True)
    assert res["correct"] is True, res["checks"]
    return {k: v["value"] for k, v in res["metrics"].items()}


def test_the_interval_straddles_the_rows():
    c = _small()
    geom = c.reference.geometry_of(c.config)
    ri = int(c.config["restart_interval"])
    assert ri == 7 and geom.m_x % ri and geom.n_mcus % ri
    assert geom.segments(ri) == 9 and geom.n_mcus - 8 * ri == 4


def test_the_cell_reports_the_rate_and_the_tail():
    res = tiny.run_cpu(_small())
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"decode_Mpix_s", "decode_p95_ms",
                                   "setup_s"}


def test_rows_decoder_takes_every_frame_in_the_learned_order(monkeypatch):
    m = _traced(_small(), monkeypatch)
    assert m["lane_order_share.ri7"] == 100.0
    assert m["inflate_ms.ri7"] == 0.0
    for name in ("prepare_ms.ri7", "upload_ms.ri7", "dispatch_ms.ri7",
                 "readback_ms.ri7"):
        assert m[name] > 0, name


def test_flat_decoder_reads_no_lane_order(monkeypatch):
    m = _traced(_small(prep_mode="flat"), monkeypatch)
    assert "lane_order_share.ri7" not in m
    assert "inflate_ms.ri7" not in m
    assert m["prepare_ms.ri7"] > 0


def _run(counters, spans=None, calls=4, per_call=16):
    return SimpleNamespace(
        window=SimpleNamespace(counters=counters, spans=spans or {},
                               calls=calls, failed=0),
        frames_per_call=per_call)


@pytest.mark.parametrize("metric,counters,spans,want", [
    ("lane_order_share.ri7", {"device_decode.rows_prep_chunks": 8,
                              "device_decode.lane_order_frames": 48}, {},
     75.0),
    # a program without the counter (the parent of the cell), or flat prep
    ("lane_order_share.ri7", {"device_decode.rows_prep_chunks": 8,
                              "device_decode.mats_chunks": 8}, {}, None),
    ("lane_order_share.ri7", {"device_decode.flat_prep_chunks": 8,
                              "device_decode.lane_order_frames": 0}, {},
     None),
    ("inflate_ms.ri7", {"device_decode.mats_chunks": 8,
                        "device_decode.lane_order_frames": 64}, {}, 0.0),
    ("inflate_ms.ri7", {"device_decode.mats_chunks": 8,
                        "device_decode.lane_order_frames": 56},
     {"device_decode.inflate": (1, 0.0064)}, 0.1),
    ("inflate_ms.ri7", {"device_decode.mats_chunks": 8}, {}, None),
    ("inflate_ms.ri7", {"device_decode.rows_prep_chunks": 8,
                        "device_decode.lane_order_frames": 0}, {}, None)])
def test_lane_order_readers(metric, counters, spans, want):
    read = tiny.cell(CELL).reader("layer_metrics", metric).read
    got = read(_run(counters, spans))
    assert got == (None if want is None else pytest.approx(want))


def test_control_fails_and_program_passes():
    c = tiny.cell(CELL, 320, 240)
    c.traffic.update(clip_frames=2, chunk=2)
    limits = c.config["limits"][c.driver.KIND]
    got = dict(readings(c, 2 ** 32 + 17, 2, True, torch.device("cpu")))
    ok, _ = judge.verdict(got["program"], limits)
    assert ok, got["program"]
    ok, table = judge.verdict(got["control"], limits)
    assert not ok, table
