"""The guard compares whole top-level module names."""

import subprocess
import sys

from perfbench import guard
from perfbench.tests.tiny import ROOT


def test_whole_top_level_names():
    assert guard.forbidden(["jpeg_tpu_torch", "jpeg_tpu_torch.mjpeg",
                            "numpy", "jaxtyping"]) == []
    assert guard.forbidden(["jpeg_tpu.x", "jax.numpy", "jpeg_tpu",
                            "flax", "jaxlib.xla"]) == [
        "flax", "jax.numpy", "jaxlib.xla", "jpeg_tpu", "jpeg_tpu.x"]


def test_the_harness_and_the_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.run, perfbench.readings, perfbench.series; "
            "import jpeg_tpu_torch; from perfbench import guard; "
            "print(guard.loaded_forbidden())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
