"""The per-layer metrics that read the program's host spans, and on the
card, that every kernel launch and copy of a decode call starts inside
a layer span.

Run the card's test with ``python3 -m pytest perfbench/tests -m chip``.
"""

from types import SimpleNamespace

import pytest

from perfbench import run as runner
from perfbench.tests import tiny

# The decode cells' span metrics, and the frame size at which each cell's
# path runs on the CPU: the speculative engine takes only RST-less frames
# over 8,192 bytes (384x256 makes about 9,900).
SPAN_METRICS = {
    "decode.ri4.clip16": ((64, 48), [
        "split_ms.decode", "for_stream_ms.decode", "readback_ms.decode",
        "upload_ms.decode", "unspanned_ms.decode"]),
    "decode.rstless.clip16": ((384, 256), [
        "split_ms.rstless", "for_stream_ms.rstless", "readback_ms.rstless",
        "upload_ms.rstless", "prepare_ms.rstless", "dispatch_ms.rstless",
        "unspanned_ms.rstless"]),
    "decode.ri4.live1": ((64, 48), [
        "readback_ms.live", "upload_ms.live", "unspanned_ms.live"]),
}
# Each cell's host_other_ms, read as the sum of the metrics that split it.
SPLITS = {
    "host_other_ms.decode": ["split_ms.decode", "for_stream_ms.decode",
                             "readback_ms.decode", "unspanned_ms.decode"],
    "host_other_ms.live": ["readback_ms.live", "unspanned_ms.live"],
}


def _small(workload):
    (w, h), _ = SPAN_METRICS[workload]
    c = tiny.cell(workload, w, h)
    c.traffic.update(warm_calls=1, check_calls=1)
    if c.traffic["clip_frames"] > 1:  # two chunks a call
        c.traffic.update(clip_frames=4, chunk=2)
    return c


@pytest.mark.parametrize("workload", list(SPAN_METRICS))
def test_span_metrics_are_reported_and_split_host_other(workload,
                                                        monkeypatch):
    # The span metrics read the measured window alone: no profiled ones.
    monkeypatch.setattr(runner.trace, "profiled_windows",
                        lambda *a, **k: ([], 0))
    res = tiny.run_cpu(_small(workload), traced=True)
    assert res["correct"] is True
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in SPAN_METRICS[workload][1]:
        assert m[name] >= 0, name
    for whole, parts in SPLITS.items():
        if whole in m:
            assert sum(m[p] for p in parts) == pytest.approx(m[whole],
                                                             rel=1e-9)


def _run(spans, latencies=(0.010, 0.012), frames_per_call=4):
    return SimpleNamespace(
        window=SimpleNamespace(spans=spans, latencies=list(latencies),
                               calls=len(latencies), failed=0),
        frames_per_call=frames_per_call)


def _read(metric, run):
    return tiny.cell("decode.rstless.clip16").reader(
        "layer_metrics", metric).read(run)


def test_rstless_metrics_split_the_call():
    spans = {"device_decode.stream": (2, 0.0215),
             "device_decode.split": (2, 0.001),
             "device_decode.for_stream": (2, 0.002),
             "device_decode.spec_parse": (8, 0.004),
             "device_decode.spec_prepare": (4, 0.003),
             "device_decode.upload": (12, 0.0015),
             "device_decode.spec_dispatch": (4, 0.002),
             "device_decode.spec_dense": (4, 0.001),
             "device_decode.spec_readback": (4, 0.006)}
    run = _run(spans)  # 22 ms over 8 frames: 2.75 ms a frame
    got = {m: _read(m, run) for m in (
        "split_ms.rstless", "for_stream_ms.rstless", "prepare_ms.rstless",
        "dispatch_ms.rstless", "readback_ms.rstless", "upload_ms.rstless",
        "unspanned_ms.rstless")}
    assert got["prepare_ms.rstless"] == pytest.approx(7 / 8)
    assert got["dispatch_ms.rstless"] == pytest.approx(3 / 8)
    assert got["upload_ms.rstless"] == pytest.approx(1.5 / 8)
    # nested uploads are not subtracted again
    assert got["unspanned_ms.rstless"] == pytest.approx(3 / 8)
    assert sum(v for k, v in got.items() if k != "upload_ms.rstless") == \
        pytest.approx(22 / 8)


@pytest.mark.parametrize("metric", [
    "split_ms.decode", "for_stream_ms.rstless", "readback_ms.live",
    "readback_ms.rstless", "upload_ms.decode", "prepare_ms.rstless",
    "dispatch_ms.rstless", "unspanned_ms.decode"])
def test_a_program_without_the_spans_reads_nothing(metric):
    # what a program that opens only the prepare and dispatch spans gives
    run = _run({"device_decode.prepare": (2, 0.004),
                "device_decode.dispatch": (2, 0.001)})
    assert _read(metric, run) is None


# A decode call's launches and copies that no layer span holds, by the
# operation that makes them: ``_run``'s MCU sums (``counts.sum()``, one a
# chunk, after the chunk's dispatch span) and the final ``torch.cat`` of
# the chunks' pixels (``DeviceDecoder._run`` or ``decode_stream_device``).
OUTSIDE = {"aten::sum": "chunks", "aten::cat": 1}
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cudaMemset")
OUTERMOST = ("device_decode.stream", "device_decode.batch")


def unspanned_launchers(prof):
    """{operation: how many} of the operations that launch a kernel or
    copy outside every layer span: the outermost ``aten::`` operation
    around each such runtime call, counted once however many calls it
    makes."""
    from torch.autograd import DeviceType

    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    layers = [(e.time_range.start, e.time_range.end, e.thread)
              for e in host if e.name.startswith(
                  ("device_decode.", "device_encode."))
              and e.name not in OUTERMOST]
    ops = [e for e in host if e.name.startswith("aten::")]
    launchers = set()
    for e in host:
        if not e.name.startswith(LAUNCHES):
            continue
        s, t = e.time_range.start, e.thread
        if any(a <= s <= b and th == t for a, b, th in layers):
            continue
        around = [(o.time_range.start, o.name) for o in ops
                  if o.thread == t and o.time_range.start <= s
                  <= o.time_range.end]
        launchers.add(min(around) if around else (s, f"{e.name} (no op)"))
    out = {}
    for _, op in launchers:
        out[op] = out.get(op, 0) + 1
    return out


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["decode.ri4.clip16",
                                      "decode.rstless.clip16"])
def test_every_launch_and_copy_starts_inside_a_layer_span(card,
                                                          workload):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from jpeg_tpu_torch import mjpeg
    from perfbench import corpus

    c = tiny.cell(workload, 1920, 1080)
    frames, _, _ = corpus.frames(c.config, 2 ** 31 + 11, 2)
    clip, chunk = b"".join(frames * 2), 2
    mjpeg.decode_stream_device(clip, card, chunk=chunk)
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mjpeg.decode_stream_device(clip, card, chunk=chunk)
        torch.cuda.synchronize(card)
    got = unspanned_launchers(prof)
    print(f"{workload}: launches and copies outside the layer spans {got}")
    chunks = 2 if workload == "decode.ri4.clip16" else 0
    allowed = {op: chunks if n == "chunks" else n
               for op, n in OUTSIDE.items()}
    assert all(got[op] <= allowed.get(op, 0) for op in got), got
