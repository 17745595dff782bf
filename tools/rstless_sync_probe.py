"""Probe the RST-less sync (K8) on a card: what holds its tail walk, and
which row and strip sizes give the shortest K8 + K9 + K10.

Run from the repository root on a machine with a CUDA card:

    python3 tools/rstless_sync_probe.py [tail] [chain] [lanes] [sizes]

Both on the 8-frame 1080p batch of chip_smoke's phase 13; the card's name
and power limit lead the output, then one JSON line a measurement.

``tail``, ``chain`` and ``lanes`` run probe builds of
``csrc/decode_rstless.cu`` (``probe_library``): the source as it stands
with its walking threads a warp (``HEAD_LANES``, ``TAIL_LANES``) replaced,
a tail walk that skips a negative list entry, and one more entry point,
``jt_probe_sync_tail``, that launches the tail walk alone on a given group
state and survivor list (count, then lanes) with a grid that covers
``max_n`` entries.  The engine's own build is not touched.

``tail`` times the tail walk alone (CUDA events, mean of 10), 32 walking
threads a warp, on three crafted survivor lists, every lane starting at
its row's first bit with its own slot (the walk of a design that does not
group variants): every (row, variant) lane; variant 0 of each row only,
at its place among the lanes (the other threads skip); and variant 0 of
each row packed densely.  If the single-variant walks take about 1/bpm
of the first, the walk is bound by its work; if they take about as long,
by its longest chain.  Beside them: ``rstless_sync`` as the engine runs
it (CUDA events) and its two launches' device times (one profiled call),
with the survivor count.

``chain`` times the tail walk alone, 32 walking threads a warp, on the
engine's own survivors (their group state as K8's first launch leaves
it): the survivor whose walk decodes the most symbols alone, a median
one alone, one warp of 32 survivors that holds the longest, and every
survivor at 32, 8, 2 and 1 a warp (the rest of each warp skips).  Beside
each, the symbols its longest walk decodes (counted with the plain symbol
step on the card), so that a time per symbol of one lane's chain can be
read off.

``lanes`` times ``rstless_sync`` (CUDA events, mean of 10) and its two
launches (device time, mean of 5 profiled calls) with the walking threads
of each warp at 32, 16, 8 and 4 in both walks, each build checked against
the plain version.

``sizes`` times ``rstless_sync``, ``rstless_resolve`` and
``rstless_final`` (CUDA events, mean of 10) at each (chunk, strip) size
of ``SIZES`` with 32-byte pieces, with K8's survivors and K9's rounds and
recovery rows; every size must decode the batch to the same
coefficients.
"""

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from jpeg_tpu_torch import kernels  # noqa: E402
from jpeg_tpu_torch.device import cuda_stream, set_precision  # noqa: E402
from jpeg_tpu_torch.entropy import place_cuda  # noqa: E402
from rstless_piece_sweep import device_ms  # noqa: E402

# (chunk, strip) bytes: the default 512/128 and its neighbours
SIZES = [(512, 128), (512, 64), (512, 256), (256, 128), (256, 64),
         (1024, 128), (1024, 256)]
PIECE = 32
SOURCE = kernels.CSRC / "decode_rstless.cu"
PROBE_DIR = kernels.BUILD_DIR.parent / "rstless_sync_probe"
# The tail walk alone, appended to the source (its kernels are in scope).
PROBE_ENTRY = """
extern "C" int jt_probe_sync_tail(
    const void* tables, const void* words, const void* nbits,
    const void* row0, const void* row_frame, const void* member,
    const void* group, const void* survivors, void* links, void* marks,
    int R, int max_n, int wn, int bpm, int vpad, int tab_ints, int cb_bits,
    int strip_bits, int piece_bits, int n_pieces, void* stream) {
  const Params p{wn,      bpm,        0, 1,          vpad,    tab_ints,
                 cb_bits, strip_bits, 0, piece_bits, n_pieces};
  const Rows rows{static_cast<const int32_t*>(row0),
                  static_cast<const int32_t*>(row_frame), R};
  const int per_cta = TAIL_WARPS * TAIL_LANES;
  tail_kernel<<<(max_n + per_cta - 1) / per_cta, TAIL_WARPS * 32, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tables),
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(nbits), rows, p,
      static_cast<const int32_t*>(member),
      static_cast<const int32_t*>(group),
      static_cast<const int32_t*>(survivors), static_cast<int32_t*>(links),
      static_cast<int32_t*>(marks));
  return static_cast<int>(cudaGetLastError());
}
"""


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{SOURCE.name}: expected one {old!r}")
    return text.replace(old, new)


def probe_source(head_lanes: int, tail_lanes: int) -> str:
    """decode_rstless.cu with its walking threads a warp replaced, a tail
    walk that skips a negative list entry, and ``PROBE_ENTRY``."""
    text = SOURCE.read_text()
    text = _replace(text, "constexpr int HEAD_LANES = 16;",
                    f"constexpr int HEAD_LANES = {head_lanes};")
    text = _replace(text, "constexpr int TAIL_LANES = 4;",
                    f"constexpr int TAIL_LANES = {tail_lanes};")
    text = _replace(text, "  const int lane = survivors[1 + i];\n",
                    "  const int lane = survivors[1 + i];\n"
                    "  if (lane < 0) return;\n")
    return text + PROBE_ENTRY


def probe_library(lanes: list) -> dict:
    """Build (one nvcc each, all started together) and load the probe
    builds for each (head, tail) walking threads a warp in ``lanes``."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, todo, out = kernels._nvcc(), [], {}
    for hl, tl in lanes:
        text = probe_source(hl, tl)
        tag = hashlib.sha256((" ".join(kernels.NVCC_FLAGS) + text).encode())
        so = PROBE_DIR / f"probe_{hl}_{tl}_{tag.hexdigest()[:12]}.so"
        if not so.exists():
            src = so.with_suffix(".cu")
            src.write_text(text)
            todo.append((so, subprocess.Popen(
                [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(so),
                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        out[hl, tl] = so
    for so, proc in todo:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so.name}:\n{log}")
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for key, so in out.items():
        lib = ctypes.CDLL(str(so))
        lib.jt_rstless_sync.argtypes = [p] * 9 + [i] * 9 + [p]
        lib.jt_probe_sync_tail.argtypes = [p] * 10 + [i] * 10 + [p]
        for fn in (lib.jt_rstless_sync, lib.jt_probe_sync_tail):
            fn.restype = i
        libs[key] = lib
    return libs


def tail_alone(lib, plan, words, nbits, rows, member, group, listed, max_n,
               links, marks, cb, sb, pb) -> None:
    """The probe build's tail walk of the ``listed`` survivors from their
    ``group`` state into ``links`` and ``marks``."""
    dev = words.device
    rc = lib.jt_probe_sync_tail(
        place_cuda._device_tables(plan, dev).data_ptr(), words.data_ptr(),
        nbits.data_ptr(), rows.r0.data_ptr(), rows.frame32.data_ptr(),
        member.data_ptr(), group.data_ptr(), listed.data_ptr(),
        links.data_ptr(), marks.data_ptr(), rows.R, max_n, words.shape[1],
        plan.blocks_per_mcu, place_cuda.huffval_pad(plan),
        place_cuda._staged_ints(plan), cb, sb, pb, -(-cb // pb),
        cuda_stream(dev))
    if rc != 0:
        raise RuntimeError(f"probe tail walk failed: CUDA error {rc}")


def group_state(plan, words, nbits, rows, sc, cb, sb, pb):
    """K8's first-launch state as the engine leaves it: (links, member,
    marks, group [R * bpm, GCOL], survivor list)."""
    links, member, marks, listed = sc._sync(plan, words, nbits, rows, cb, sb,
                                            pb)
    # _sync's scratch holds the group state just before the list
    n, g = rows.R * plan.blocks_per_mcu, cs.rstless_modules()[2].GCOL
    group = listed.as_strided((n, g), (g, 1), listed.storage_offset() - n * g)
    return links, member, marks, group, listed


def tail_probe(card, plan, words, nbits, rows, sc, core, lib):
    bpm = plan.blocks_per_mcu
    cb, sb, pb = core.CHUNK_BYTES * 8, core.STRIP_BYTES * 8, PIECE * 8
    dev = words.device
    links, member, marks, _, listed = group_state(plan, words, nbits, rows,
                                                  sc, cb, sb, pb)
    R = rows.R
    lane = torch.arange(R * bpm, device=dev, dtype=torch.int32)
    start = (rows.local.to(torch.int32) * cb).repeat_interleave(bpm)
    group = torch.stack([start, lane % bpm, torch.zeros_like(lane),
                         lane % bpm], 1).contiguous()
    one = torch.tensor([R * bpm], dtype=torch.int32, device=dev)
    lists = {
        "every lane": (torch.cat([one, lane]), R * bpm),
        "variant 0, in place": (torch.cat([one, torch.where(
            lane % bpm == 0, lane, -1)]), R * bpm),
        "variant 0, packed": (torch.cat([torch.tensor(
            [R], dtype=torch.int32, device=dev), lane[::bpm]]), R),
    }
    out = {"probe": "tail", "rows": R, "bpm": bpm, "card": card}
    lk, mk = torch.empty_like(links), torch.empty_like(marks)
    # the probe build's first launch loads its module: not in a timing
    tail_alone(lib, plan, words, nbits, rows, member, group,
               *lists["variant 0, packed"], lk, mk, cb, sb, pb)
    torch.cuda.synchronize()
    for name, (lst, n) in lists.items():
        out[f"{name} ms"] = cs.cuda_ms(
            lambda: tail_alone(lib, plan, words, nbits, rows, member, group,
                               lst, n, lk, mk, cb, sb, pb), 10)
    out["survivors"] = int(listed[0])
    out["rstless_sync ms"] = cs.cuda_ms(
        lambda: sc.sync(plan, words, nbits, rows, cb, sb, pb), 10)
    out["device ms"] = device_ms(
        lambda: sc.sync(plan, words, nbits, rows, cb, sb, pb),
        ("head_kernel", "tail_kernel"))
    print(json.dumps(out), flush=True)


def chain_symbols(plan, words, nbits, rows, group, lanes, links, cb, sb):
    """Symbols the tail walk of each of ``lanes`` decodes from its strip
    mark to where it stops (its link or end; a miss at the successor's
    strip end), by the plain symbol step."""
    st = cs.rstless_modules()[2]
    bpm = plan.blocks_per_mcu
    k, w64 = st._consts(plan, words.device), st._words64(words)
    g = group.reshape(-1, st.GCOL)[lanes].to(torch.int64)
    lk = links[lanes].to(torch.int64)
    row = lanes // bpm
    fr = rows.frame[row]
    nb = nbits.to(torch.int64)[fr]
    end = torch.where(lk[:, st.L_ST] == st.ST_MISS,
                      (rows.local[row] + 1) * cb + sb, lk[:, st.L_BIT])
    bitpos, slot = g[:, st.G_BIT].clone(), g[:, st.G_SLOT].clone()
    coeff, blk = torch.zeros_like(bitpos), torch.zeros_like(bitpos)
    count = torch.zeros_like(bitpos)
    live = bitpos < end
    while bool(live.any()):
        s = st._symbol(plan, k, w64, fr, bitpos, slot, coeff, nb)
        live = live & ~s["dies"]
        bitpos, slot, coeff, blk = st._advance(plan, s, live, bitpos, slot,
                                               coeff, blk)
        count += live.to(torch.int64)
        live = live & ~((coeff == 0) & (bitpos >= end))
    return count


def chain_probe(card, plan, words, nbits, rows, sc, core, lib):
    cb, sb, pb = core.CHUNK_BYTES * 8, core.STRIP_BYTES * 8, PIECE * 8
    dev = words.device
    links, member, marks, group, listed = (
        t.clone() for t in group_state(plan, words, nbits, rows, sc, cb, sb,
                                       pb))
    n = int(listed[0])
    lanes = listed[1:1 + n].to(torch.int64).sort().values
    sym = chain_symbols(plan, words, nbits, rows, group, lanes, links, cb, sb)
    order = sym.argsort()
    longest, median = lanes[order[-1]], lanes[order[n // 2]]

    def listed_of(ls):
        ls = torch.as_tensor(ls, dtype=torch.int32, device=dev)
        return torch.cat([torch.tensor([ls.numel()], dtype=torch.int32,
                                       device=dev), ls]), ls.numel()

    warp = torch.cat([longest[None], lanes[order[:31]]])
    cases = {"longest alone": (listed_of([int(longest)]), int(sym.max())),
             "median alone": (listed_of([int(median)]),
                              int(sym[order[n // 2]])),
             "one warp with the longest": (listed_of(warp), int(sym.max()))}
    for d in (32, 8, 2, 1):
        spread = torch.full((-(-n // d) * 32,), -1, dtype=torch.int64,
                            device=dev)
        i = torch.arange(n, device=dev)
        spread[(i // d) * 32 + i % d] = lanes
        cases[f"all at {d} a warp"] = (listed_of(spread), int(sym.max()))
    out = {"probe": "chain", "survivors": n, "card": card,
           "symbols_mean": float(sym.double().mean()),
           "symbols_max": int(sym.max())}
    for name, ((lst, m), symbols) in cases.items():
        lk, mk = links.clone(), marks.clone()
        ms = cs.cuda_ms(lambda: tail_alone(lib, plan, words, nbits, rows,
                                           member, group, lst, m, lk, mk, cb,
                                           sb, pb), 10)
        out[name] = {"ms": ms, "longest_symbols": symbols,
                     "ns_per_symbol": ms * 1e6 / max(symbols, 1)}
    print(json.dumps(out), flush=True)


def lanes_probe(card, plan, words, nbits, rows, sc, core, libs):
    cb, sb, pb = core.CHUNK_BYTES * 8, core.STRIP_BYTES * 8, PIECE * 8
    want = cs.rstless_modules()[2].sync_ref(plan, words, nbits, rows, cb, sb,
                                            pb)
    engine_lib = sc._lib
    try:
        for lanes in (32, 16, 8, 4):
            sc._lib = lambda lib=libs[lanes, lanes]: lib
            got = sc.sync(plan, words, nbits, rows, cb, sb, pb)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"lanes {lanes}: K8's outputs differ "
                                     "from the plain version's")
            dev_ms = device_ms(lambda: [sc.sync(plan, words, nbits, rows, cb,
                                                sb, pb) for _ in range(5)],
                               ("head_kernel", "tail_kernel"))
            print(json.dumps({
                "probe": "lanes", "lanes": lanes,
                "rstless_sync_ms": cs.cuda_ms(
                    lambda: sc.sync(plan, words, nbits, rows, cb, sb, pb),
                    10),
                "head_ms": dev_ms["head_kernel"] / 5,
                "tail_ms": dev_ms["tail_kernel"] / 5, "card": card}),
                flush=True)
    finally:
        sc._lib = engine_lib


def sizes_probe(card, plan, tb, segs, sc, core):
    dev = torch.device("cuda")
    first = None
    for chunk, strip in SIZES:
        core.check_capacity(chunk, strip, PIECE)
        words, nbits, rows = core.prepare_batch(segs, dev, chunk)
        cb, sb, pb = chunk * 8, strip * 8, PIECE * 8
        rounds = 1 + int(np.diff(rows.row0).max())
        links, member, marks, listed = sc._sync(plan, words, nbits, rows, cb,
                                                sb, pb)
        survivors = int(listed[0])
        res = sc.resolve(plan, words, nbits, rows, links, member, marks, cb,
                         sb, pb, rounds)
        coeffs, ok = sc.final(plan, words, nbits, rows, res.pieces, tb)
        fs = res.frame.cpu().numpy()
        if first is None:
            first = coeffs
        elif not torch.equal(first, coeffs) or not bool((ok == 1).all()):
            raise AssertionError(f"chunk {chunk} strip {strip}: the "
                                 "coefficients differ from the first size's")
        rec = {"probe": "sizes", "chunk_bytes": chunk, "strip_bytes": strip,
               "rows": rows.R, "survivors": survivors,
               "rounds": int(fs[:, 0].max()),
               "recovery_rows": int(fs[:, 1].sum()),
               "rstless_sync_ms": cs.cuda_ms(
                   lambda: sc.sync(plan, words, nbits, rows, cb, sb, pb), 10),
               "rstless_resolve_ms": cs.cuda_ms(
                   lambda: sc.resolve(plan, words, nbits, rows, links, member,
                                      marks, cb, sb, pb, rounds), 10),
               "rstless_final_ms": cs.cuda_ms(
                   lambda: sc.final(plan, words, nbits, rows, res.pieces, tb),
                   10),
               "card": card}
        rec["sum_ms"] = (rec["rstless_sync_ms"] + rec["rstless_resolve_ms"]
                         + rec["rstless_final_ms"])
        print(json.dumps(rec), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("rstless_sync_probe: needs a CUDA card")
    what = sys.argv[1:] or ["tail", "chain", "lanes", "sizes"]
    card = cs.card_label()
    cs.log(card)
    set_precision()
    kernels.load_library()
    dev = torch.device("cuda")
    core, sc, _ = cs.rstless_modules()
    _, _, _, plan, tb, segs = cs.rstless_stream(dev)
    segs = segs[:cs.CHUNK]
    words, nbits, rows = core.prepare_batch(segs, dev)
    libs = probe_library(
        ([(16, 32)] if {"tail", "chain"} & set(what) else [])
        + ([(n, n) for n in (32, 16, 8, 4)] if "lanes" in what else []))
    if "tail" in what:
        tail_probe(card, plan, words, nbits, rows, sc, core, libs[16, 32])
    if "chain" in what:
        chain_probe(card, plan, words, nbits, rows, sc, core, libs[16, 32])
    if "lanes" in what:
        lanes_probe(card, plan, words, nbits, rows, sc, core, libs)
    if "sizes" in what:
        sizes_probe(card, plan, tb, segs, sc, core)


if __name__ == "__main__":
    main()
