"""The run's process is in the same state before every window: its
inputs are made by a child process and read back from their file, so it
makes none of them itself whether or not an earlier run of the seed
made them, and it fixes the host allocator's thresholds."""

import ctypes
import sys

import numpy as np
import pytest

from perfbench import corpus, run
from perfbench.tests import tiny


def _refuse(*a, **k):
    raise AssertionError("the corpus was made in the run's process")


@pytest.mark.parametrize("workload", ["decode.ri4.clip16",
                                      "decode.rstless.clip16",
                                      "encode.ri4.clip16"])
def test_inputs_made_by_a_child_then_read(workload, tmp_path, monkeypatch):
    c = tiny.cell(workload)
    seed = 2 ** 33 + 17
    want_pixels = np.stack([corpus.content(seed, i, c.config["width"],
                                           c.config["height"])
                            for i in range(c.traffic["contents"])])
    monkeypatch.setattr(corpus, "CACHE", tmp_path)
    for name in ("_make", "_frame", "_planes", "content"):
        monkeypatch.setattr(corpus, name, _refuse)
    first, _, made = c.driver.make_inputs(c, seed)
    again, _, made_again = c.driver.make_inputs(c, seed)
    assert made and not made_again
    assert len(list(tmp_path.rglob("*.npz"))) == 1
    if c.driver.KIND == "encode":
        assert np.array_equal(first, want_pixels)
        assert np.array_equal(again, want_pixels)
    else:
        assert first == again
        assert len(first) == c.traffic["contents"]
        assert all(f[:2] == b"\xff\xd8" and f[-2:] == b"\xff\xd9"
                   for f in first)


@pytest.mark.skipif(not sys.platform.startswith("linux"),
                    reason="mallopt is glibc's")
def test_the_run_fixes_the_host_allocator(monkeypatch):
    set_to = {}

    class _Libc:
        def mallopt(self, param, value):
            set_to[param] = value
            return 1

    monkeypatch.setattr(ctypes, "CDLL", lambda name: _Libc())
    assert run.fix_allocator() is True
    assert set_to == {run.M_TRIM_THRESHOLD: 128 << 20,
                      run.M_MMAP_THRESHOLD: 32 << 20}
