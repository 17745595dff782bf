"""Huffman code table machinery.

Three pieces, mirroring the reference's capabilities but built around arrays
so the hot paths vectorize:

1. `HuffSpec`      -- DHT wire form: counts per code length + values
                      (reference `struct htable`, common.h:85-91).
2. `HuffTable`     -- derived code tables per T.81 Annex C (reference
                      huffman.c:45-178) *plus* canonical decode tables
                      (mincode/maxcode/valptr per code length, the
                      libjpeg-style O(16) decode the reference lacks --
                      it linearly scans all codes per bit,
                      huffman.c:193-225) and a flat 16-bit lookup table for
                      single-gather decoding on accelerators.
3. `optimize_table` -- T.81 Annex K.2 optimal length-limited code builder
                      (reference huffman.c:327-537), including the exact
                      "largest V1 on frequency ties" tie-break
                      (huffman.c:327-347) and the BITS(16) length limiting
                      of `adjust_bits` (huffman.c:413-444) so optimized DHT
                      segments are byte-identical to the reference encoder.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np

from .errors import LogicError

MAX_CODE_LEN = 16


@dataclass(frozen=True)
class HuffSpec:
    """DHT wire form: ``counts[i]`` codes of length ``i+1``, values in order."""

    counts: Tuple[int, ...]
    values: Tuple[int, ...]

    def __post_init__(self):
        if len(self.counts) != MAX_CODE_LEN:
            raise LogicError("HuffSpec needs exactly 16 length counts")
        if sum(self.counts) != len(self.values):
            raise LogicError(
                f"HuffSpec counts sum {sum(self.counts)} != {len(self.values)} values"
            )

    @staticmethod
    def from_pair(pair: Sequence) -> "HuffSpec":
        counts, values = pair
        return HuffSpec(tuple(int(c) for c in counts), tuple(int(v) for v in values))

    def dht_payload(self) -> bytes:
        """L[1..16] + V bytes as they appear inside a DHT segment."""
        return bytes(self.counts) + bytes(self.values)


@dataclass(frozen=True)
class HuffTable:
    """Derived encode + decode tables for one Huffman code.

    Encode side (T.81 Annex C / huffman.c:45-178):
      ehufco[v], ehufsi[v]   code and size for symbol value v (0 where the
                             symbol has no code, exactly like EHUFCO/EHUFSI).

    Decode side (canonical-code arithmetic, replaces the reference's
    per-bit linear scan):
      mincode[l], maxcode[l], valptr[l] for l in 1..16 (index 0 unused);
      maxcode[l] == -1 when no codes of length l exist.

      A 16-bit left-aligned window `w` decodes as: find smallest l with
      (w >> (16-l)) <= maxcode[l]; value = huffval[valptr[l] + (w>>(16-l))
      - mincode[l]].

    `lut16` is the fully-unrolled alternative: a [65536] int32 array whose
    entry for window w packs (value << 8) | code_length, or -1 for invalid
    prefixes.  One gather instead of a 16-step search; used by the
    accelerator decode path.
    """

    spec: HuffSpec
    huffval: np.ndarray  # [n] uint8
    huffsize: np.ndarray  # [n] int32
    huffcode: np.ndarray  # [n] int32
    ehufco: np.ndarray  # [256] int32
    ehufsi: np.ndarray  # [256] int32
    mincode: np.ndarray  # [17] int32
    maxcode: np.ndarray  # [17] int32 (-1 = no codes at that length)
    valptr: np.ndarray  # [17] int32
    lut16: np.ndarray = field(repr=False, default=None)  # [65536] int32

    @property
    def n_codes(self) -> int:
        return int(self.huffval.shape[0])


def derive_table(spec: HuffSpec, build_lut: bool = True) -> HuffTable:
    """Annex C derivation (Figures C.1-C.3) + canonical decode tables."""
    counts = np.asarray(spec.counts, dtype=np.int64)
    huffval = np.asarray(spec.values, dtype=np.uint8)
    n = int(counts.sum())

    # Figure C.1: HUFFSIZE — code length for each code index, ascending.
    huffsize = np.repeat(np.arange(1, MAX_CODE_LEN + 1, dtype=np.int32), counts)

    # Figure C.2: HUFFCODE — canonical codes.  Within a length, codes are
    # consecutive; moving to length l+1 doubles the running code.
    huffcode = np.zeros(n, dtype=np.int64)
    code = 0
    k = 0
    for length in range(1, MAX_CODE_LEN + 1):
        c = int(counts[length - 1])
        if c:
            huffcode[k : k + c] = code + np.arange(c)
            code += c
            k += c
        code <<= 1
    huffcode = huffcode.astype(np.int32)

    # Figure C.3: EHUFCO / EHUFSI ordered by symbol value.
    ehufco = np.zeros(256, dtype=np.int32)
    ehufsi = np.zeros(256, dtype=np.int32)
    ehufco[huffval] = huffcode
    ehufsi[huffval] = huffsize

    # Canonical decode tables (per code length).
    mincode = np.zeros(MAX_CODE_LEN + 1, dtype=np.int32)
    maxcode = np.full(MAX_CODE_LEN + 1, -1, dtype=np.int32)
    valptr = np.zeros(MAX_CODE_LEN + 1, dtype=np.int32)
    k = 0
    for length in range(1, MAX_CODE_LEN + 1):
        c = int(counts[length - 1])
        if c:
            valptr[length] = k
            mincode[length] = huffcode[k]
            maxcode[length] = huffcode[k + c - 1]
            k += c

    lut16 = None
    if build_lut:
        # Flat 16-bit window LUT: entry = (value << 8) | length, -1 invalid.
        lut16 = np.full(1 << MAX_CODE_LEN, -1, dtype=np.int32)
        shifts = MAX_CODE_LEN - huffsize
        starts = huffcode.astype(np.int64) << shifts
        spans = np.int64(1) << shifts
        packed = (huffval.astype(np.int32) << 8) | huffsize
        for s, width, p in zip(starts, spans, packed):
            lut16[s : s + width] = p

    return HuffTable(
        spec=spec,
        huffval=huffval,
        huffsize=huffsize,
        huffcode=huffcode,
        ehufco=ehufco,
        ehufsi=ehufsi,
        mincode=mincode,
        maxcode=maxcode,
        valptr=valptr,
        lut16=lut16,
    )


@lru_cache(maxsize=None)
def _default_table(tc: int, th: int) -> HuffTable:
    from .constants import DEFAULT_HTABLES

    return derive_table(HuffSpec.from_pair(DEFAULT_HTABLES[(tc, th)]))


def default_tables() -> dict:
    """The 2x2 default (MJPEG / Annex K.3) table set (common.c:90-99)."""
    return {(tc, th): _default_table(tc, th) for tc in (0, 1) for th in (0, 1)}


# ---------------------------------------------------------------------------
# Annex K.2 optimizer.
# ---------------------------------------------------------------------------


def _code_sizes_from_freq(freq: np.ndarray) -> np.ndarray:
    """Figure K.2 pair-merging, with the reference's exact tie-breaks.

    ``freq`` has 257 entries; entry 256 is the reserved code point (set to 1
    by the caller, common.c:210-225).  Ties on minimum frequency select the
    LARGEST index (huffman.c:327-347: `<=` comparison scanning ascending).
    Returns codesize[257].
    """
    freq = freq.astype(np.int64).copy()
    codesize = np.zeros(257, dtype=np.int64)
    others = np.full(257, -1, dtype=np.int64)

    while True:
        # "least value of FREQ(V1) > 0", ties -> largest index.
        nz = freq > 0
        if not nz.any():
            break
        m = freq[nz].min()
        cands = np.nonzero(nz & (freq == m))[0]
        v1 = int(cands[-1])

        # Next least, excluding v1, ties -> largest index.
        nz2 = nz.copy()
        nz2[v1] = False
        if not nz2.any():
            break
        m2 = freq[nz2].min()
        cands2 = np.nonzero(nz2 & (freq == m2))[0]
        v2 = int(cands2[-1])

        freq[v1] += freq[v2]
        freq[v2] = 0

        codesize[v1] += 1
        while others[v1] != -1:
            v1 = int(others[v1])
            codesize[v1] += 1
        others[v1] = v2

        codesize[v2] += 1
        while others[v2] != -1:
            v2 = int(others[v2])
            codesize[v2] += 1

    return codesize


def _count_and_adjust_bits(codesize: np.ndarray) -> np.ndarray:
    """Figure K.3 COUNT_BITS + Figure K.4 ADJUST_BITS (huffman.c:413-474)."""
    bits = np.zeros(33, dtype=np.int64)
    for cs in codesize:
        if cs != 0:
            if cs >= 33:
                raise LogicError("code size exceeds 32 bits")
            bits[cs] += 1

    # ADJUST_BITS: push codes longer than 16 bits down, then remove the
    # reserved code point from the longest remaining length.
    i = 32
    while True:
        if bits[i] > 0:
            j = i - 1
            j -= 1
            while bits[j] <= 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
            continue
        i -= 1
        if i != 16:
            continue
        while bits[i] == 0:
            i -= 1
        bits[i] -= 1
        break

    return bits


def _sort_input(codesize: np.ndarray) -> np.ndarray:
    """Figure K.5: symbol values sorted by code size then value (0..255)."""
    out = []
    for size in range(1, 33):
        for v in range(256):
            if codesize[v] == size:
                out.append(v)
    return np.asarray(out, dtype=np.uint8)


def optimize_table(freq256: np.ndarray) -> HuffSpec:
    """Build the optimal length-limited table from symbol frequencies.

    ``freq256``: counts for symbol values 0..255 (the dry-pass histogram,
    reference write_block_dry coeffs.c:312-363).  The reserved point
    freq[256]=1 is added here (common.c:219).  Output is byte-identical to
    the reference's `adapt_huffman_table` (huffman.c:508-537).
    """
    freq = np.zeros(257, dtype=np.int64)
    freq[:256] = np.asarray(freq256, dtype=np.int64)
    freq[256] = 1

    codesize = _code_sizes_from_freq(freq)
    bits = _count_and_adjust_bits(codesize)
    huffval = _sort_input(codesize)

    counts = tuple(int(bits[i + 1]) for i in range(MAX_CODE_LEN))
    values = tuple(int(v) for v in huffval[: sum(counts)])
    return HuffSpec(counts, values)
