"""The plain reference against the program on small frames, and its
encoder read back by its own reader."""

import numpy as np
import pytest
import torch

from perfbench import corpus
from perfbench.references import rtp_jpeg as ref


@pytest.fixture(params=[(64, 48, 4), (72, 40, 0), (128, 96, 3)],
                ids=["64x48-ri4", "72x40-rstless", "128x96-ri3"])
def frame(request):
    w, h, ri = request.param
    geom = ref.Geometry(w, h)
    rgb = corpus.content(2 ** 33 + 1, 0, w, h)
    planes = [p[0].numpy() for p in ref.forward(
        torch.from_numpy(rgb)[None], 75, geom, dtype=torch.float64)]
    return geom, ri, rgb, planes, ref.encode_frame(planes, geom, 75, ri)


def test_the_program_decodes_the_reference_frames(frame):
    import jpeg_tpu_torch as jt

    geom, ri, _, planes, data = frame
    want = ref.inverse([torch.from_numpy(p.astype(np.int32))[None]
                        for p in planes], 75, geom)[0].to(torch.int32)
    for exact in (True, False):
        got = torch.as_tensor(np.asarray(
            jt.decode_jpeg(data, "cpu", exact=exact).pixels()))
        assert (got.to(torch.int32) - want).abs().max() <= 1


def test_the_frame_reads_back(frame):
    geom, ri, _, planes, data = frame
    markers, segs, problem = ref.split_frame(data)
    assert problem is None
    assert ref.header_problems(markers, geom, 75, ri) == []
    assert len(segs) == geom.segments(ri)
    zz = ref._bitstream_blocks(planes, geom)[0]
    per = ri or geom.n_mcus
    at = 0
    for k, s in enumerate(segs):
        mcus = min(per, geom.n_mcus - k * per)
        got = ref.decode_segment(s, geom, mcus)
        np.testing.assert_array_equal(got, zz[at:at + len(got)])
        at += len(got)
    assert at == zz.shape[0]


def test_the_program_encodes_as_the_reference(frame):
    from jpeg_tpu_torch import DeviceEncoder, EncodeParams

    geom, ri, rgb, _, _ = frame
    if not ri:
        pytest.skip("the program's encoder needs a restart interval")
    enc = DeviceEncoder.for_config(geom.height, geom.width, 3, EncodeParams(
        h=2, v=2, quality=75, optimize=False, exact=False,
        restart_interval=ri), device="cpu")
    out = enc.encode_batch(torch.from_numpy(rgb)[None])[0]
    markers, segs, problem = ref.split_frame(out)
    assert problem is None and ref.header_problems(markers, geom, 75,
                                                   ri) == []
    planes = [p[0].numpy() for p in ref.forward(
        torch.from_numpy(rgb)[None], 75, geom)]
    want = ref.encode_segments(planes, geom, ri)
    assert len(segs) == len(want)
    assert sum(a != b for a, b in zip(segs, want)) <= len(want) // 10


def test_header_problems_name_what_departs():
    geom = ref.Geometry(64, 48)
    data = ref.encode_frame([np.zeros((6, 8, 64), np.int64),
                             np.zeros((3, 4, 64), np.int64),
                             np.zeros((3, 4, 64), np.int64)], geom, 75, 4)
    markers, _, _ = ref.split_frame(data)
    assert ref.header_problems(markers, geom, 75, 4) == []
    assert ref.header_problems(markers, geom, 50, 4) == ["DQT 0", "DQT 1"]
    assert ref.header_problems(markers, geom, 75, 2) == ["DRI 4"]
    assert "SOF0" in ref.header_problems(markers, ref.Geometry(64, 64), 75, 4)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -12)])
    assert ref._tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9,
                                     -1.0]
