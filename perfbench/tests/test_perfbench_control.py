"""The control: the plain reference with TF32 products in the program's
place fails the committed limits, at a size a test run holds (on the
host TF32 is emulated by rounding the products' operands)."""

import pytest
import torch

from perfbench import judge
from perfbench.readings import readings
from perfbench.tests import tiny


@pytest.mark.parametrize("workload", ["decode.ri4.clip16",
                                      "encode.ri4.clip16"])
def test_control_fails_and_program_passes(workload):
    c = tiny.cell(workload, 320, 240)
    limits = c.config["limits"][c.driver.KIND]
    got = dict(readings(c, 2 ** 32 + 17, 1, True, torch.device("cpu")))
    ok, _ = judge.verdict(got["program"], limits)
    assert ok, got["program"]
    ok, table = judge.verdict(got["control"], limits)
    assert not ok, table
