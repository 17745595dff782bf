"""Busy time, idle share, the dropped-event check and the roofline
byte counts."""

import pytest

from perfbench import readers, roofline, trace


def test_busy_us_is_the_union():
    assert trace.busy_us([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.busy_us([(0, 10), (2, 3)]) == 10
    assert trace.busy_us([]) == 0


def test_gaps_are_the_uncovered_parts_of_the_window():
    assert trace.gaps((0, 100), [(10, 20), (15, 30), (50, 60)]) == [
        (0, 10), (30, 50), (60, 100)]
    assert trace.gaps((0, 10), [(-5, 20)]) == []


@pytest.mark.parametrize("events,first,calls,ok", [
    (32, 16, 2, True), (31, 16, 2, False), (33, 16, 2, False),
    (0, 0, 2, False)])
def test_a_window_that_lost_events_is_not_complete(events, first, calls,
                                                   ok):
    assert trace.complete(events, first, calls) is ok


def window(device, spans=(), start=0.0, end=100.0, work=((10, 20),)):
    w = trace.Window(start_us=start, end_us=end,
                     device=list(device), spans=list(spans))
    w.work = list(work)
    return w


def test_window_busy_kernels_and_named_gaps():
    w = window([("k1", 10, 30), ("Memcpy HtoD", 25, 40), ("k2", 60, 70)],
               spans=[("perfbench.call", 0, 100),
                      ("device_decode.prepare", 40, 55)])
    assert w.busy_us == 40
    assert w.kernel_us == 30  # copies left out
    assert w.idle_gaps() == [("perfbench.call", 10), (
        "device_decode.prepare", 20), ("perfbench.call", 30)]


class _Run:
    def __init__(self, profiled):
        self.profiled = profiled


def test_idle_and_roofline_read_only_kept_windows():
    assert readers.idle_pct(_Run([])) is None
    assert readers.roofline_pct(_Run([])) is None
    w = window([("k", 0, 25)], work=[(3_350_000, 0)])
    assert readers.idle_pct(_Run([w])) == pytest.approx(75.0)
    # 3.35 MB at 3.35 TB/s is 1 us of the kernels' 25 us.
    assert readers.roofline_pct(_Run([w])) == pytest.approx(4.0)


def test_roofline_byte_counts():
    assert roofline.decode_bytes(206_000, 1920 * 1080) == (
        206_000, 1920 * 1080 * 3)
    assert roofline.encode_bytes(1920 * 1080, 206_000) == (
        1920 * 1080 * 3, 206_000)
    assert roofline.bound_s(3_350_000, 0) == pytest.approx(1e-6)
    assert roofline.share_pct(1.0, 0.0) is None


def test_breakdown_lists_ops_and_idle_by_span():
    w = window([("k1", 10, 30), ("k2", 60, 70)],
               spans=[("perfbench.call", 0, 100)])
    bd = trace.breakdown([w])
    assert bd["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert bd["idle_gaps"] == [["perfbench.call", pytest.approx(70e-6)]]
    assert trace.breakdown([]) is None
