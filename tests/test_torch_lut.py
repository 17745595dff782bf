"""PyTorch port: the decode kernel's first-level lookup table (CPU).

``place_cuda.lookup_table`` packs, for each Huffman table of a scan plan
and each ``LUT_BITS``-bit prefix, the code length and symbol that the
canonical compare gives when the code is at most ``LUT_BITS`` bits long,
and 0 where the kernel must continue the compare at ``LUT_BITS + 1``.
Decoding every 16-bit window through it (continuing the compare for 0
entries, as ``csrc/decode_segments.cu`` does) must equal the canonical
compare of ``entropy/lockstep.py`` with the kernels' ``vpad`` clip, entry
for entry: on every plan of every committed corpus stream, and under the
hostile tables that ``chip_smoke.py`` phase 3 builds (incomplete codes,
DC categories 17 and 20).  The reference runs on the JAX package's own
plans, so the port's plan copy is held too.
"""

from pathlib import Path

import numpy as np
import pytest

from jpeg_tpu import mjpeg as jmjpeg
from jpeg_tpu.entropy.lockstep import build_scan_plan as jax_build_plan
from jpeg_tpu.format.parse import parse_codestream
from jpeg_tpu.tables import HuffSpec as JaxHuffSpec
from jpeg_tpu.tables import derive_table as jax_derive

from chip_smoke import HOSTILE
from jpeg_tpu_torch.entropy import place_cuda
from jpeg_tpu_torch.entropy.lockstep import build_scan_plan
from jpeg_tpu_torch.format.parse import parse_codestream as port_parse
from jpeg_tpu_torch.tables import derive_table

CORPUS = Path(__file__).resolve().parent / "data" / "torch_port"
STREAMS = sorted(p.stem for p in CORPUS.glob("*.mjpeg"))
CODES = np.arange(1 << 16, dtype=np.int64)


def _plans(name, hostile):
    """(JAX plan, port plan) of every scan of every frame of a stream."""
    out = []
    for frame in jmjpeg.split_stream((CORPUS / f"{name}.mjpeg").read_bytes()):
        cs, pcs = parse_codestream(frame), port_parse(frame)
        for scan, pscan in zip(cs.scans, pcs.scans):
            if hostile:
                specs = {key: HOSTILE[key[0]] for key in pscan.htables}
                tables = {k: jax_derive(JaxHuffSpec(s.counts, s.values))
                          for k, s in specs.items()}
                ptables = {k: derive_table(s) for k, s in specs.items()}
            else:
                tables = {k: jax_derive(s) for k, s in scan.htables.items()}
                ptables = {k: derive_table(s)
                           for k, s in pscan.htables.items()}
            out.append((jax_build_plan(cs.geometry, scan.info, tables),
                        build_scan_plan(pcs.geometry, pscan.info, ptables)))
    return out


def _compare(plan, t, code16, lengths):
    """The canonical compare (entropy/lockstep.py) of ``code16`` in table
    ``t`` over ``lengths``, with the kernels' vidx clip; -> (matched,
    length, value)."""
    ls = np.asarray(lengths)
    prefixes = code16[:, None] >> (16 - ls)[None, :]
    ok = prefixes <= plan.maxcode[t, ls][None, :]
    any_ok = ok.any(axis=1)
    L = np.where(any_ok, ls[np.argmax(ok, axis=1)], 16)
    pref = code16 >> (16 - L)
    vidx = plan.valptr[t, L] + pref - plan.mincode[t, L]
    vpad = ((plan.max_codes + 3) // 4) * 4
    value = plan.huffval[t, np.clip(vidx, 0, vpad - 1)]
    return any_ok, L, value


@pytest.mark.parametrize("hostile", [False, True], ids=["own", "hostile"])
@pytest.mark.parametrize("name", STREAMS)
def test_lookup_table_decodes_as_the_canonical_compare(name, hostile):
    bits = place_cuda.LUT_BITS
    for jplan, pplan in _plans(name, hostile):
        lut = place_cuda.lookup_table(pplan)
        assert lut.shape == (place_cuda.T_MAX, 1 << bits)
        assert lut.dtype == np.uint16
        T = jplan.maxcode.shape[0]
        assert not lut[T:].any()  # unused tables: always the long path
        for t in range(T):
            want_ok, want_len, want_val = _compare(jplan, t, CODES,
                                                   range(1, 17))
            e = lut[t, CODES >> (16 - bits)].astype(np.int64)
            long_ok, long_len, long_val = _compare(pplan, t, CODES,
                                                   range(bits + 1, 17))
            hit = e != 0
            got_ok = hit | long_ok
            got_len = np.where(hit, e >> 8, long_len)
            got_val = np.where(hit, e & 0xFF, long_val)
            np.testing.assert_array_equal(got_ok, want_ok)
            np.testing.assert_array_equal(got_len[want_ok], want_len[want_ok])
            np.testing.assert_array_equal(got_val[want_ok], want_val[want_ok])
            if hostile:  # incomplete codes: some windows match nothing
                assert not want_ok.all()


def test_kernel_tables_carry_the_lookup_table():
    """The packed tables hold the LUT at OFF_LUT, uint16 entries in order,
    and the wrapper stages only the used tables' part of it."""
    _, pplan = _plans("yuv420_ri2", False)[0]
    t = place_cuda.kernel_tables(pplan)
    assert t.shape == (place_cuda.TABLE_INTS,)
    np.testing.assert_array_equal(
        t[place_cuda.OFF_LUT:].view(np.uint16).reshape(place_cuda.T_MAX, -1),
        place_cuda.lookup_table(pplan))
    T = pplan.maxcode.shape[0]
    assert place_cuda._staged_ints(pplan) == \
        place_cuda.OFF_LUT + T * (1 << place_cuda.LUT_BITS) // 2
    assert place_cuda._staged_ints(pplan) % 4 == 0
