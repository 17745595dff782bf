"""Which file reads a metric, and the refused share's exact count."""

from types import SimpleNamespace

import pytest

from perfbench.tests import tiny


@pytest.mark.parametrize("metric,file", [
    ("spec_refused_share.rstless", "spec_refused_share.py"),
    ("device_idle.rstless", "device_idle.py"),
    ("device_idle.live", "device_idle.py"),
    ("device_idle.encode", "device_idle.py"),
    ("host_other_ms.live", "host_other_ms.py"),
    ("call_p95_ms.decode", "call_p95_ms.py"),
    ("kernel_roofline.some_later_cell", "kernel_roofline.py")])
def test_a_metric_is_read_by_its_own_file_or_its_quantitys(metric, file):
    c = tiny.cell("decode.ri4.clip16")
    assert c.reader("layer_metrics", metric).__file__.endswith(
        "layer_metrics/" + file)


def test_call_p95_is_the_windows_nearest_rank_tail():
    c = tiny.cell("decode.ri4.clip16")
    read = c.reader("layer_metrics", "call_p95_ms.decode").read
    lat = [i / 1000 for i in range(1, 101)]
    assert read(SimpleNamespace(window=SimpleNamespace(
        latencies=lat))) == pytest.approx(95.0)
    assert read(SimpleNamespace(window=SimpleNamespace(latencies=[]))) is None


def _run(counters, calls=10, per_call=16, chunk=8):
    return SimpleNamespace(
        window=SimpleNamespace(counters=counters, calls=calls),
        frames_per_call=per_call,
        cell=SimpleNamespace(traffic={"chunk": chunk}))


@pytest.mark.parametrize("counters,per_call,want", [
    ({"speculative.batches": 20}, 16, 0.0),
    ({"speculative.batches": 21, "mjpeg.rstless_batch_fallbacks": 1,
      "mjpeg.rstless_host_frames": 3, "speculative.fallbacks": 4}, 16, 5.0),
    # more refused batches than the calls hold reads as impossible
    ({"speculative.batches": 40, "mjpeg.rstless_batch_fallbacks": 30}, 16,
     150.0),
    ({"speculative.batches": 20, "mjpeg.rstless_batch_fallbacks": 1}, 12,
     None),
    ({}, 16, None)])
def test_refused_share_counts_the_refused_batches_frames(counters, per_call,
                                                         want):
    c = tiny.cell("decode.rstless.clip16")
    got = c.reader("layer_metrics", "spec_refused_share.rstless").read(
        _run(counters, per_call=per_call))
    assert got == (None if want is None else pytest.approx(want))


def test_clip_cell_reports_its_tail_per_layer_only():
    c = tiny.cell("decode.ri4.clip16")
    assert set(tiny.run_cpu(c)["metrics"]) == {"decode_Mpix_s", "setup_s"}
    m = tiny.run_cpu(c, traced=True)["metrics"]
    assert m["call_p95_ms.decode"]["value"] > 0
    assert m["call_p95_ms.decode"]["unit"] == "ms"
