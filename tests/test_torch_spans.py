"""The port's host spans (``utils/metrics.trace``) on the CPU.

Each decode entry opens its layer spans a fixed number of times a call,
chunk or batch; uploads only ever open inside another span; under
``torch.profiler`` every span is a host range of its name, nested as the
code nests it; with no profiler recording, no range is opened.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jpeg_tpu_torch as jt
from jpeg_tpu_torch import mjpeg, native
from jpeg_tpu_torch.encoder import EncodeParams
from jpeg_tpu_torch.models.device_encode import DeviceEncoder
from jpeg_tpu_torch.utils import metrics
from jpeg_tpu_torch.utils.metrics import default_metrics, trace
from refbin import make_ppm

CORPUS = Path(__file__).resolve().parent / "data" / "torch_port"
PREFIXES = ("device_decode.", "device_encode.")

# The span each span opens inside (None: outermost), on the paths below.
PARENTS = {
    "device_decode.stream": {None},
    "device_decode.split": {"device_decode.stream"},
    "device_decode.for_stream": {"device_decode.stream"},
    "device_decode.batch": {"device_decode.stream"},
    "device_decode.prepare": {"device_decode.batch"},
    "device_decode.dispatch": {"device_decode.batch"},
    "device_decode.readback": {"device_decode.batch"},
    "device_decode.upload": {"device_decode.for_stream",
                             "device_decode.prepare",
                             "device_decode.spec_prepare",
                             "device_decode.spec_dense"},
    "device_decode.spec_parse": {"device_decode.stream"},
    "device_decode.spec_prepare": {"device_decode.stream"},
    "device_decode.spec_dispatch": {"device_decode.stream"},
    "device_decode.spec_readback": {"device_decode.stream"},
    "device_decode.spec_dense": {"device_decode.stream"},
    "device_encode.batch": {None},
    "device_encode.dense": {"device_encode.batch"},
    "device_encode.scan": {"device_encode.batch"},
    "device_encode.pull": {"device_encode.batch"},
    "device_encode.finalize": {"device_encode.batch"},
    "device_encode.stuff": {"device_encode.finalize"},
    "device_encode.assemble": {"device_encode.finalize"},
}


def ri_stream(name):
    return (CORPUS / f"{name}.mjpeg").read_bytes()


def rstless_stream(frames=4):
    """RST-less frames over ``RSTLESS_DEVICE_MAX_BYTES``: the speculative
    engine's path."""
    params = EncodeParams(h=2, v=2, quality=95, restart_interval=0,
                          optimize=False, exact=False)
    out = [jt.encode_jpeg(make_ppm(192, 128, seed=s), params, "cpu")
           for s in range(frames)]
    assert min(map(len, out)) > mjpeg.RSTLESS_DEVICE_MAX_BYTES
    return b"".join(out)


def spans_of(fn):
    """(calls, seconds) that ``fn()`` added to each span."""
    before = {k: (s.calls, s.total_s)
              for k, s in default_metrics.stages.items()}
    fn()
    out = {}
    for k, s in default_metrics.stages.items():
        c0, t0 = before.get(k, (0, 0.0))
        if s.calls > c0:
            out[k] = (s.calls - c0, s.total_s - t0)
    return out


def encode_batch():
    enc = DeviceEncoder.for_config(
        48, 64, 3, EncodeParams(h=2, v=2, restart_interval=2,
                                optimize=False, exact=False), device="cpu")
    px = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (3, 48, 64, 3), dtype=np.uint8))
    return enc.encode_batch(px, chunk=2)


@pytest.mark.parametrize("name,chunk,chunks", [
    ("yuv420_ri2", 2, 2), ("gray_ri4", 1, 2), ("yuv444_ri3", 8, 1)])
def test_restart_stream_spans_once_a_call_and_a_chunk(name, chunk, chunks):
    got = spans_of(lambda: mjpeg.decode_stream_device(
        ri_stream(name), "cpu", chunk=chunk))
    calls = {k: c for k, (c, _) in got.items()}
    up = calls.pop("device_decode.upload")
    assert calls == {
        "device_decode.stream": 1, "device_decode.split": 1,
        "device_decode.for_stream": 1, "device_decode.batch": 1,
        "device_decode.readback": 1, "device_decode.prepare": chunks,
        "device_decode.dispatch": chunks}
    assert up >= 1 + chunks  # the tables, then each chunk's words
    holders = got["device_decode.for_stream"][1] + \
        got["device_decode.prepare"][1]
    assert got["device_decode.upload"][1] < holders


@pytest.mark.parametrize("prep", ["native", "python"])
@pytest.mark.parametrize("chunk,batches", [(2, 2), (4, 1)])
def test_rstless_stream_spans_once_a_batch(monkeypatch, chunk, batches, prep):
    """The stream's decoder gives the plan, so no frame is parsed for it.
    Native prep: no parse, and the tables are the decoder's, with no
    upload; the Python prep parses a batch's frames in one span and
    uploads their tables."""
    if prep == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    data = rstless_stream()
    got = spans_of(lambda: mjpeg.decode_stream_device(data, "cpu",
                                                      chunk=chunk))
    calls = {k: c for k, (c, _) in got.items()}
    up = calls.pop("device_decode.upload")
    want = {
        "device_decode.stream": 1, "device_decode.split": 1,
        "device_decode.for_stream": 1,
        "device_decode.spec_prepare": batches,
        "device_decode.spec_dispatch": batches,
        "device_decode.spec_readback": batches,
        "device_decode.spec_dense": batches}
    if prep == "python":
        want["device_decode.spec_parse"] = batches
        assert up >= 1 + 3 * batches  # the tables; words, bits, rows, tables
    else:
        assert up == 1 + 3 * batches  # the tables; words, bits, rows
    assert calls == want
    holders = sum(got[k][1] for k in (
        "device_decode.for_stream", "device_decode.spec_prepare",
        "device_decode.spec_dense"))
    assert got["device_decode.upload"][1] < holders


ENCODE_SPANS = {"device_encode.batch": 1, "device_encode.dense": 2,
                "device_encode.scan": 2, "device_encode.pull": 2,
                "device_encode.finalize": 2}


def test_encode_finalize_splits_into_stuff_and_assemble(monkeypatch):
    """The NumPy tail, taken without the native library."""
    monkeypatch.setattr(native, "available", lambda: False)
    got = spans_of(encode_batch)
    calls = {k: c for k, (c, _) in got.items()}
    assert calls == {**ENCODE_SPANS, "device_encode.stuff": 2,
                     "device_encode.assemble": 2}
    assert got["device_encode.stuff"][1] + got["device_encode.assemble"][1] \
        < got["device_encode.finalize"][1]


def test_encode_native_finalize_is_one_span():
    assert native.available()
    calls = {k: c for k, (c, _) in spans_of(encode_batch).items()}
    assert calls == ENCODE_SPANS


RUNS = {
    "restart": lambda: mjpeg.decode_stream_device(ri_stream("yuv420_ri2"),
                                                  "cpu", chunk=2),
    "rstless": lambda: mjpeg.decode_stream_device(rstless_stream(2), "cpu",
                                                  chunk=2),
    "encode": encode_batch,
}


def span_events(prof):
    """(name, parent span's name or None) of each program span the
    profiler recorded; the parent is the innermost span around it on its
    thread.  (The profiler's raw events: building its op tree would take
    minutes for the RST-less path's plain-PyTorch kernels.)"""
    spans = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(PREFIXES)]
    out = []
    for i, (n, s, e, t) in enumerate(spans):
        around = [(s2, -e2, n2) for j, (n2, s2, e2, t2) in enumerate(spans)
                  if j != i and t2 == t and s2 <= s and e <= e2]
        out.append((n, max(around)[2] if around else None))
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_profiler_sees_every_span_nested_as_the_code_nests_it(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = spans_of(RUNS[run])
    seen = {}
    for name, parent in span_events(prof):
        seen[name] = seen.get(name, 0) + 1
        assert parent in PARENTS[name], (name, parent)
    assert seen == {k: c for k, (c, _) in got.items()}


def test_every_span_name_has_a_read_prefix():
    for run in RUNS.values():
        run()
    assert default_metrics.stages
    assert all(k.startswith(PREFIXES) for k in default_metrics.stages)


@pytest.mark.parametrize("profiling", [False, True])
def test_profiler_range_only_while_a_profiler_records(monkeypatch,
                                                      profiling):
    opened = []

    class Counting:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(metrics, "_profiling", lambda: profiling)
    got = spans_of(RUNS["restart"])
    if profiling:
        assert sorted(opened) == sorted(
            k for k, (c, _) in got.items() for _ in range(c))
    else:
        assert opened == []


def test_a_span_counts_and_closes_when_its_block_raises():
    name = "device_decode.test_raises"
    before = default_metrics.stages[name].calls
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with trace(name):
                raise ValueError("inside")
        with trace("device_decode.test_after"):
            pass
    assert default_metrics.stages[name].calls == before + 1
    assert ("device_decode.test_after", None) in span_events(prof)
    del default_metrics.stages[name]
    del default_metrics.stages["device_decode.test_after"]
