"""A run whose timed path is broken underneath reads ``correct`` false:
half of each batch left out, an answer altered where it is produced, a
call that returns nothing new.  (A cell on one chip has no exchange
between chips, and no cell carries state from step to step.)"""

import pytest
import torch

from perfbench.tests import tiny


def _halve(out):
    return out[: len(out) // 2]


def _alter(out):
    if isinstance(out, torch.Tensor):
        out = out.clone()
        out[0, :8, :8] ^= 0x40
        return out
    frame = bytearray(out[0])
    frame[-40] ^= 0x5A  # inside the last segment
    return [bytes(frame)] + list(out[1:])


def _stale(out):
    if isinstance(out, torch.Tensor):
        return torch.zeros_like(out)
    return [out[0]] * len(out)


@pytest.mark.parametrize("fault", [_halve, _alter, _stale],
                         ids=["half-batch", "altered", "stale"])
@pytest.mark.parametrize("workload", ["decode.ri4.clip16",
                                      "decode.rstless.clip16",
                                      "encode.ri4.clip16",
                                      "decode.ri4.live1"])
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    c = tiny.cell(workload)
    if fault is _halve and c.traffic["clip_frames"] == 1:
        pytest.skip("a one-frame call has no half to leave out")
    real = c.driver.Driver.call
    monkeypatch.setattr(c.driver.Driver, "call",
                        lambda self, i: fault(real(self, i)))
    res = tiny.run_cpu(c)
    assert res["correct"] is False, res["checks"]


def test_sound_runs_are_correct():
    for workload in ("decode.ri4.clip16", "decode.rstless.clip16",
                     "encode.ri4.clip16", "decode.ri4.live1"):
        res = tiny.run_cpu(tiny.cell(workload))
        assert res["correct"] is True, (workload, res["checks"])
