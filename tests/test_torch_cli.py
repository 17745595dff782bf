"""PyTorch port: ``python -m jpeg_tpu_torch.cli`` vs jpeg_tpu's CLI (CPU).

``cli.main([...])`` runs in-process with ``--device cpu``: ``decode``
under every ``--entropy`` choice writes the bytes of
``jpeg_tpu.decode_jpeg(...).to_pnm()``, ``-v`` prints what
``jpeg_tpu.cli.main`` prints, ``encode`` under every
``--entropy-backend`` and the reference's getopt letters writes
jpeg_tpu's bytes, ``mjpeg`` (and ``--isolate``) writes the port's own
API output, within +-1 of jpeg_tpu's fast decode; the
``JPEG_TPU_CHECKS`` cases of ``tests/test_cli.py``; and without a card
and without ``--device cpu`` the CLI fails with exit 1 and names
``--device cpu`` instead of running on the CPU.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jpeg_tpu
from jpeg_tpu import cli as jax_cli
from jpeg_tpu.encoder import EncodeParams as JParams
from jpeg_tpu.encoder import encode_jpeg as jax_encode

import jpeg_tpu_torch as jt
from jpeg_tpu_torch import cli
from jpeg_tpu_torch.utils.pnm import read_pnm
from refbin import make_ppm
from test_torch_host import REPO

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    td = tmp_path_factory.mktemp("cli")
    ppm = make_ppm(64, 48, seed=3)
    (td / "in.ppm").write_bytes(ppm)
    jpg = jax_encode(ppm, JParams(quality=80, restart_interval=2))
    (td / "in.jpg").write_bytes(jpg)
    return td, ppm, jpg


@pytest.mark.parametrize("backend", ["auto", "serial", "lockstep",
                                     "lockstep-jax", "native",
                                     "speculative"])
def test_decode_entropy_flags(sample, backend, tmp_path, capsys):
    td, _, jpg = sample
    out = tmp_path / f"out_{backend}.ppm"
    rc = cli.main(["decode", "--entropy", backend, str(td / "in.jpg"),
                   str(out), *CPU])
    assert rc == 0 and capsys.readouterr().out == "Success.\n"
    assert out.read_bytes() == jpeg_tpu.decode_jpeg(jpg).to_pnm()


def test_decode_verbose_matches_jpeg_tpu(sample, tmp_path, capsys):
    """-v: the qtables, the COM text, the MCU counts and the trailing
    garbage, line for line as jpeg_tpu's CLI prints them."""
    _, _, jpg = sample
    com = b"\xff\xfe" + (2 + 5).to_bytes(2, "big") + b"hello"
    noisy = jpg[:2] + com + jpg[2:] + b"\x00garbage"
    p = tmp_path / "noisy.jpg"
    p.write_bytes(noisy)
    assert jax_cli.main(["decode", "-v", str(p), str(tmp_path / "a.ppm")]) \
        == 0
    want = capsys.readouterr().out
    assert cli.main(["decode", "-v", str(p), str(tmp_path / "b.ppm"),
                     *CPU]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "comment: hello" in got and "garbage after EOI" in got
    assert (tmp_path / "a.ppm").read_bytes() == \
        (tmp_path / "b.ppm").read_bytes()


@pytest.mark.parametrize("backend", ["numpy", "jax", "native"])
@pytest.mark.parametrize("letters", [["-q", "80"],
                                     ["-h", "2", "-v", "2", "-q", "80",
                                      "-o", "0", "-r", "2"]],
                         ids=["defaults", "getopt"])
def test_encode_backend_flags(sample, backend, letters, tmp_path):
    """Every backend writes jpeg_tpu's bytes (its NumPy packer's: the
    three backends are byte-identical there too)."""
    td, _, _ = sample
    want, got = tmp_path / "want.jpg", tmp_path / f"{backend}.jpg"
    assert jax_cli.main(["encode", *letters, str(td / "in.ppm"),
                         str(want)]) == 0
    assert cli.main(["encode", "--entropy-backend", backend, *letters,
                     str(td / "in.ppm"), str(got), *CPU]) == 0
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("isolate", [False, True], ids=["device",
                                                        "isolate"])
def test_mjpeg(isolate, tmp_path, capsys):
    frames = [jax_encode(make_ppm(64, 48, seed=30 + i), JParams(
        h=2, v=2, quality=80, restart_interval=2, optimize=False))
        for i in range(3)]
    stream = tmp_path / "s.mjpeg"
    stream.write_bytes(b"".join(frames))
    out = tmp_path / "frames"
    rc = cli.main(["mjpeg", str(stream), str(out), "--chunk", "2", *CPU,
                   *(["--isolate"] if isolate else [])])
    assert rc == 0
    assert capsys.readouterr().out.startswith("Success. (3")
    if isolate:
        res = jt.mjpeg.decode_stream(stream.read_bytes(), "cpu")
        own = [img.pixels() for img in res.frames]
    else:
        own = jt.mjpeg.decode_stream_device(stream.read_bytes(), "cpu",
                                            chunk=2).numpy()
    for i, frame in enumerate(frames):
        img = read_pnm((out / f"frame_{i:05d}.ppm").read_bytes())
        px = img.data.astype(np.int32)
        np.testing.assert_array_equal(px, np.asarray(own[i], np.int32))
        ref = jpeg_tpu.decode_jpeg(frame, exact=False).pixels()
        assert np.abs(px - ref).max() <= 1


def test_sanitizer_mode(sample, monkeypatch):
    """JPEG_TPU_CHECKS=1: decoded MCU counts match the geometry, and a
    truncated final segment raises, as in jpeg_tpu (tests/test_cli.py)."""
    _, _, jpg = sample
    monkeypatch.setenv("JPEG_TPU_CHECKS", "1")
    for mod in (jt, jpeg_tpu):
        cs, _ = mod.decode_coefficients(jpg)
        assert cs.mcus_decoded == [mod.api.expected_mcus(cs.geometry, s.info)
                                   for s in cs.scans]
    bad = jpg[:-14] + jpg[-2:]
    for entropy in ("serial", "native"):
        for mod in (jt, jpeg_tpu):
            with pytest.raises(mod.JpegError):
                mod.decode_coefficients(bad, entropy=entropy)


def test_no_card_without_device_cpu_exits_1(sample, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    td, _, _ = sample
    for argv in (["decode", str(td / "in.jpg"), str(tmp_path / "o.ppm")],
                 ["encode", str(td / "in.ppm"), str(tmp_path / "o.jpg")],
                 ["mjpeg", str(td / "in.jpg"), str(tmp_path / "f")]):
        assert cli.main(argv) == 1
        err = capsys.readouterr().err
        assert err.count("\n") == 1 and "--device cpu" in err
    assert not any(tmp_path.iterdir())


def test_module_help():
    res = subprocess.run([sys.executable, "-m", "jpeg_tpu_torch.cli",
                          "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for word in ("decode", "encode", "mjpeg"):
        assert word in res.stdout
