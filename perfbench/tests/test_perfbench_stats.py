"""The end-to-end arithmetic and the sample count a run logs."""

import statistics

import pytest

from perfbench import stats
from perfbench.tests import tiny


def test_rate_is_work_over_the_window():
    assert stats.rate(300.0, 1.5) == 200.0
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


@pytest.mark.parametrize("n,want,beyond", [(200, 190, 10), (100, 95, 5),
                                           (7, 7, 0), (1, 1, 0)])
def test_p95_is_nearest_rank(n, want, beyond):
    values = list(range(n, 0, -1))  # order does not matter
    assert stats.percentile(values, 95.0) == want
    assert stats.beyond(n, 95.0) == beyond


def test_spread_is_interquartile_over_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_run_logs_its_calls_and_the_tail_count():
    lines = []
    res = tiny.run_cpu(tiny.cell("decode.ri4.live1"), lines=lines)
    window = [ln for ln in lines if ln.startswith("window:")]
    assert len(window) == 1
    n = res["attempted"]
    assert f"window: {n} calls" in window[0]
    assert f"with {stats.beyond(n, 95.0)} calls beyond it" in window[0]
    m = res["metrics"]
    assert set(m) == {"decode_Mpix_s", "decode_p95_ms", "setup_s"}
    assert m["decode_p95_ms"]["value"] > 0 and m["decode_p95_ms"]["unit"] == "ms"
