// Host-side entropy kernel: fast serial Huffman decode of ECS segments,
// threaded across restart segments.
//
// This is the native runtime component of the engine (the reference's
// entropy layer is its hot path: per-bit linear code scan,
// huffman.c:193-225 + io.c:18-41).  Design here: a 64-bit bit buffer, a
// 16-bit-window LUT per table (one load per symbol instead of a per-bit
// scan), and segment-level parallelism with std::thread -- segments are
// independent because T.81 resets DC prediction and byte-aligns at every
// restart marker.
//
// Semantics mirror jpeg_tpu.entropy.serial exactly, including
// end-of-segment behaviour: a symbol whose code or extra bits would
// consume past the final byte terminates the segment mid-block, keeping
// partially written coefficients and the raw (predictor-less) DC diff,
// like the reference's NO_MORE_DATA unwind (io.c:247-274).
//
// Output is written in VISIT order (block-sequential within the
// segment); the Python caller computes global placement from the
// prefix-sum of per-segment MCU counts (same contract as the lockstep
// engines).
//
// Build: make -C jpeg_tpu/native   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct BitReader {
  const uint8_t* data;
  int64_t nbytes;
  int64_t bitpos = 0;
  uint64_t buf = 0;  // MSB-aligned window of the next bits
  int64_t bytepos = 0;
  int nbuf = 0;

  explicit BitReader(const uint8_t* d, int64_t n) : data(d), nbytes(n) {}

  inline void fill() {
    while (nbuf <= 56) {
      uint64_t b = bytepos < nbytes ? data[bytepos] : 0;
      ++bytepos;
      buf |= b << (56 - nbuf);
      nbuf += 8;
    }
  }

  inline uint32_t peek16() {
    fill();
    return static_cast<uint32_t>(buf >> 48);
  }

  // Consume n bits; returns false when that passes the end of data
  // (reference NO_MORE_DATA).
  inline bool consume(int n) {
    if (bitpos + n > nbytes * 8) {
      bitpos = nbytes * 8;
      return false;
    }
    buf <<= n;
    nbuf -= n;
    bitpos += n;
    return true;
  }

  inline uint32_t peek_after(int skip, int n) {
    // bits [skip, skip+n) of the current window; skip+n <= 48.
    fill();
    if (n == 0) return 0;
    return static_cast<uint32_t>((buf >> (64 - skip - n)) &
                                 ((1u << n) - 1));
  }
};

inline int32_t extend_coeff(int cat, uint32_t extra) {
  if (cat == 0) return 0;
  if (extra >> (cat - 1)) return static_cast<int32_t>(extra);
  return static_cast<int32_t>(extra) - (1 << cat) + 1;
}

// Decode one segment.  Returns blocks written (complete or partial);
// *out_mcus = completed MCU count.
int64_t decode_segment(const uint8_t* bytes, int64_t nbytes,
                       const int32_t* lut16,  // [n_tables][65536]
                       const int32_t* slot_dc_tab, const int32_t* slot_ac_tab,
                       const int32_t* slot_comp, int32_t bpm, int32_t n_comps,
                       int64_t max_blocks, int32_t* out, int64_t* out_mcus) {
  BitReader br(bytes, nbytes);
  std::vector<int32_t> dc_pred(n_comps, 0);
  int64_t block = 0;  // visit-order block index
  int64_t mcus = 0;
  int slot = 0;

  while (block < max_blocks) {
    int32_t* coeffs = out + block * 64;
    std::memset(coeffs, 0, 64 * sizeof(int32_t));
    const int32_t* dc_lut = lut16 + (int64_t)slot_dc_tab[slot] * 65536;
    const int32_t* ac_lut = lut16 + (int64_t)slot_ac_tab[slot] * 65536;
    const int comp = slot_comp[slot];

    // --- DC ---
    int32_t packed = dc_lut[br.peek16()];
    if (packed < 0) goto done;  // invalid prefix: drain like the reference
    {
      int len = packed & 0xff;
      int cat = packed >> 8;
      if (cat > 16) goto done;  // corrupt
      uint32_t extra = br.peek_after(len, cat);
      if (!br.consume(len + cat)) goto done;
      coeffs[0] = extend_coeff(cat, extra);  // raw diff until block done
      ++block;                               // partial block is kept
    }

    // --- AC ---
    {
      int i = 1;
      int rem = 63;
      while (rem > 0) {
        int32_t p = ac_lut[br.peek16()];
        if (p < 0) { goto done; }
        int len = p & 0xff;
        int val = p >> 8;
        int cat = val & 15;
        int zrl = val >> 4;
        uint32_t extra = br.peek_after(len, cat);
        if (!br.consume(len + cat)) goto done;
        if (val == 0) break;  // EOB
        i += zrl;
        if (i > 63) goto done;  // corrupt run
        coeffs[kZigzag[i]] = extend_coeff(cat, extra);
        ++i;
        rem -= zrl + 1;
      }
    }

    // Block completed: fold predictor in (decoder.c:350-355 order).
    coeffs[0] += dc_pred[comp];
    dc_pred[comp] = coeffs[0];

    ++slot;
    if (slot == bpm) {
      slot = 0;
      ++mcus;
    }
  }

done:
  *out_mcus = mcus;
  return block;
}

}  // namespace

extern "C" {

// Decode many segments in parallel.
//   seg_bytes/seg_offsets: concatenated unstuffed segment bytes;
//     segment k = bytes[seg_offsets[k] .. seg_offsets[k+1])
//   out: [n_segments * max_blocks_per_seg * 64] int32, visit order
//   blocks_written / mcu_counts: per-segment results
void jt_decode_segments(const uint8_t* seg_bytes, const int64_t* seg_offsets,
                        int32_t n_segments, const int32_t* lut16,
                        const int32_t* slot_dc_tab, const int32_t* slot_ac_tab,
                        const int32_t* slot_comp, int32_t bpm,
                        int32_t n_comps, int64_t max_blocks_per_seg,
                        int32_t* out, int64_t* blocks_written,
                        int64_t* mcu_counts, int32_t n_threads) {
  auto work = [&](int32_t k) {
    const uint8_t* bytes = seg_bytes + seg_offsets[k];
    int64_t nbytes = seg_offsets[k + 1] - seg_offsets[k];
    blocks_written[k] = decode_segment(
        bytes, nbytes, lut16, slot_dc_tab, slot_ac_tab, slot_comp, bpm,
        n_comps, max_blocks_per_seg, out + (int64_t)k * max_blocks_per_seg * 64,
        &mcu_counts[k]);
  };

  if (n_threads <= 1 || n_segments <= 1) {
    for (int32_t k = 0; k < n_segments; ++k) work(k);
    return;
  }
  int nt = n_threads < n_segments ? n_threads : n_segments;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      for (int32_t k = t; k < n_segments; k += nt) work(k);
    });
  }
  for (auto& th : threads) th.join();
}

// Fast ECS end scan: first index >= start where 0xFF is followed by a
// non-zero byte (or a trailing lone 0xFF); mirrors io.c:247-274.
int64_t jt_find_ecs_end(const uint8_t* data, int64_t n, int64_t start) {
  for (int64_t i = start; i + 1 < n; ++i) {
    if (data[i] == 0xFF && data[i + 1] != 0x00) return i;
  }
  if (n > start && data[n - 1] == 0xFF) return n - 1;
  return n;
}

// Unstuff in place semantics: copy dropping the 0x00 after each 0xFF.
// Returns unstuffed length.
int64_t jt_unstuff(const uint8_t* src, int64_t n, uint8_t* dst) {
  int64_t o = 0;
  for (int64_t i = 0; i < n; ++i) {
    dst[o++] = src[i];
    if (src[i] == 0xFF && i + 1 < n && src[i + 1] == 0x00) ++i;
  }
  return o;
}

// Single-pass batch prep for the device decoder: from `start` (the first
// ECS byte after SOS), unstuff every restart segment directly into
// big-endian uint32 lane rows of `out` [max_rows, wn] (caller-zeroed)
// and record per-segment unstuffed byte lengths.  Ends at EOI.
//
// Returns the number of segments, or a fallback code for the Python
// parser: -1 malformed/unexpected marker (slow parse handles garbage,
// decoder.c:196-214 semantics), -2 row overflow (retry with a wider
// matrix), -3 more segments than rows.
// Flat variant: segments pack back-to-back at word-aligned offsets in a
// single u32 buffer (the device rebuilds the [S, Wn] lane matrix with
// one gather, so the host->device upload is the tight packing, not the
// padded matrix).  starts[r] = word offset of segment r.  Fallback codes
// as jt_prep_ecs, with -2 = buffer capacity exceeded.
int64_t jt_prep_ecs_flat(const uint8_t* data, int64_t n, int64_t start,
                         uint32_t* out, int64_t cap_words, int32_t* starts,
                         int32_t* lens, int64_t max_rows, int64_t* used_words,
                         int64_t* end_off) {
  if (max_rows <= 0) return -3;
  int64_t base = 0;  // word offset of current row
  uint32_t acc = 0;
  int64_t k = 0;
  int64_t r = 0;
  int64_t i = start;
  starts[0] = 0;

  auto close_row = [&]() {
    if (k & 3) out[base + (k >> 2)] = acc << (8 * (4 - (k & 3)));
    lens[r] = static_cast<int32_t>(k);
    base += (k + 3) >> 2;
    acc = 0;
    k = 0;
  };

  while (i < n) {
    uint8_t c = data[i];
    uint8_t lit;
    if (c != 0xFF) {
      lit = c;
      ++i;
    } else {
      if (i + 1 >= n) return -1;
      uint8_t m = data[i + 1];
      if (m == 0x00) {
        lit = 0xFF;
        i += 2;
      } else {
        int64_t j = i + 1;
        while (j < n && data[j] == 0xFF) ++j;
        if (j >= n) return -1;
        m = data[j];
        close_row();
        if (m >= 0xD0 && m <= 0xD7) {
          if (++r >= max_rows) return -3;
          starts[r] = static_cast<int32_t>(base);
          i = j + 1;
          continue;
        }
        if (m == 0xD9) {
          *used_words = base;
          *end_off = j + 1;
          return r + 1;
        }
        return -1;
      }
    }
    if (base + (k >> 2) >= cap_words) return -2;
    acc = (acc << 8) | lit;
    if ((++k & 3) == 0) { out[base + (k >> 2) - 1] = acc; acc = 0; }
  }
  return -1;
}

// Padded-matrix prep with a caller-chosen row order: segment r of this
// frame writes into out + row_map[r] * wn.  The direct-to-lane-matrix
// variant of jt_prep_ecs_flat: the host->device upload is then the
// padded [S, wn] matrix itself and the device needs NO rebuild gather
// (measured ~10 ms per 8-frame 1080p chunk); row_map lets the caller
// order lanes by predicted symbol count for the phased scan.
int64_t jt_prep_ecs_rows(const uint8_t* data, int64_t n, int64_t start,
                         uint32_t* out, int64_t wn, const int32_t* row_map,
                         int64_t max_rows, int32_t* lens, int64_t* end_off) {
  if (max_rows <= 0) return -3;
  const int64_t row_bytes = wn * 4;
  uint32_t* row = out + (int64_t)row_map[0] * wn;
  uint32_t acc = 0;
  int64_t k = 0;
  int64_t r = 0;
  int64_t i = start;

  auto close_row = [&]() {
    if (k & 3) row[k >> 2] = acc << (8 * (4 - (k & 3)));
    lens[r] = static_cast<int32_t>(k);
    acc = 0;
    k = 0;
  };

  while (i < n) {
    uint8_t c = data[i];
    if (c != 0xFF) {
      if (k >= row_bytes) return -2;
      acc = (acc << 8) | c;
      if ((++k & 3) == 0) { row[(k >> 2) - 1] = acc; acc = 0; }
      ++i;
      continue;
    }
    if (i + 1 >= n) return -1;
    uint8_t m = data[i + 1];
    if (m == 0x00) {
      if (k >= row_bytes) return -2;
      acc = (acc << 8) | 0xFFu;
      if ((++k & 3) == 0) { row[(k >> 2) - 1] = acc; acc = 0; }
      i += 2;
      continue;
    }
    int64_t j = i + 1;
    while (j < n && data[j] == 0xFF) ++j;
    if (j >= n) return -1;
    m = data[j];
    close_row();
    if (m >= 0xD0 && m <= 0xD7) {
      if (++r >= max_rows) return -3;
      row = out + (int64_t)row_map[r] * wn;
      i = j + 1;
      continue;
    }
    if (m == 0xD9) {
      *end_off = j + 1;
      return r + 1;
    }
    return -1;
  }
  return -1;
}

int64_t jt_prep_ecs(const uint8_t* data, int64_t n, int64_t start,
                    uint32_t* out, int64_t wn, int64_t max_rows,
                    int32_t* lens, int64_t* end_off) {
  if (max_rows <= 0) return -3;
  const int64_t row_bytes = wn * 4;
  uint32_t* row = out;
  uint32_t acc = 0;
  int64_t k = 0;  // unstuffed bytes in current row
  int64_t r = 0;
  int64_t i = start;

  auto close_row = [&]() {
    if (k & 3) row[k >> 2] = acc << (8 * (4 - (k & 3)));
    lens[r] = static_cast<int32_t>(k);
    acc = 0;
    k = 0;
  };

  while (i < n) {
    uint8_t c = data[i];
    if (c != 0xFF) {
      if (k >= row_bytes) return -2;
      acc = (acc << 8) | c;
      if ((++k & 3) == 0) { row[(k >> 2) - 1] = acc; acc = 0; }
      ++i;
      continue;
    }
    if (i + 1 >= n) return -1;  // truncated at a lone 0xFF
    uint8_t m = data[i + 1];
    if (m == 0x00) {  // stuffed literal 0xFF
      if (k >= row_bytes) return -2;
      acc = (acc << 8) | 0xFFu;
      if ((++k & 3) == 0) { row[(k >> 2) - 1] = acc; acc = 0; }
      i += 2;
      continue;
    }
    // Marker ends the segment; skip fill 0xFF bytes (io.c:186-220).
    int64_t j = i + 1;
    while (j < n && data[j] == 0xFF) ++j;
    if (j >= n) return -1;
    m = data[j];
    close_row();
    if (m >= 0xD0 && m <= 0xD7) {  // RSTn: next segment
      if (++r >= max_rows) return -3;
      row = out + r * wn;
      i = j + 1;
      continue;
    }
    if (m == 0xD9) {  // EOI
      *end_off = j + 1;
      return r + 1;
    }
    return -1;  // any other marker mid-scan -> slow parser
  }
  return -1;  // ran off the end without EOI
}

}  // extern "C"

namespace {

// MSB-first bit writer with JPEG byte stuffing (io.c:43-63, 277-290).
struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t n = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  inline void put(uint32_t code, int len) {
    acc = (acc << len) | (code & ((len < 32 ? (1u << len) : 0u) - 1u));
    nbits += len;
    while (nbits >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (nbits - 8));
      nbits -= 8;
      if (n >= cap) { overflow = true; return; }
      out[n++] = b;
      if (b == 0xFF) {
        if (n >= cap) { overflow = true; return; }
        out[n++] = 0x00;  // stuffing
      }
    }
  }

  inline void flush() {  // 1-pad the tail byte (io.c:65-87)
    if (nbits > 0) {
      uint8_t b = static_cast<uint8_t>(
          (acc << (8 - nbits)) | ((1u << (8 - nbits)) - 1u));
      nbits = 0;
      if (n >= cap) { overflow = true; return; }
      out[n++] = b;
      if (b == 0xFF) {
        if (n >= cap) { overflow = true; return; }
        out[n++] = 0x00;
      }
    }
  }
};

inline int bit_length(int32_t m) {
  int c = 0;
  while (m) { ++c; m >>= 1; }
  return c;
}

// Encode one segment's blocks (visit order, DC already differential).
// Returns 0 ok, 1 missing code, 2 output overflow.
int encode_segment(const int32_t* zz, int64_t b0, int64_t b1,
                   const int32_t* dc_tab, const int32_t* ac_tab,
                   const int32_t* ehufco, const int32_t* ehufsi,
                   uint8_t* out, int64_t cap, int64_t* out_len) {
  BitWriter w{out, cap};
  for (int64_t b = b0; b < b1; ++b) {
    const int32_t* blk = zz + b * 64;
    const int32_t* dco = ehufco + dc_tab[b] * 256;
    const int32_t* dsi = ehufsi + dc_tab[b] * 256;
    const int32_t* aco = ehufco + ac_tab[b] * 256;
    const int32_t* asi = ehufsi + ac_tab[b] * 256;

    int32_t v = blk[0];
    int cat = bit_length(v < 0 ? -v : v);
    if (dsi[cat] == 0) return 1;
    w.put(static_cast<uint32_t>(dco[cat]), dsi[cat]);
    if (cat) {
      int32_t adj = v < 0 ? v - 1 : v;
      w.put(static_cast<uint32_t>(adj) & ((1u << cat) - 1u), cat);
    }

    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int32_t a = blk[k];
      if (a == 0) { ++run; continue; }
      while (run > 15) {  // ZRL
        if (asi[0xF0] == 0) return 1;
        w.put(static_cast<uint32_t>(aco[0xF0]), asi[0xF0]);
        run -= 16;
      }
      int acat = bit_length(a < 0 ? -a : a);
      int sym = (run << 4) | acat;
      if (asi[sym] == 0) return 1;
      w.put(static_cast<uint32_t>(aco[sym]), asi[sym]);
      int32_t adj = a < 0 ? a - 1 : a;
      w.put(static_cast<uint32_t>(adj) & ((1u << acat) - 1u), acat);
      run = 0;
    }
    if (run > 0) {  // EOB
      if (asi[0] == 0) return 1;
      w.put(static_cast<uint32_t>(aco[0]), asi[0]);
    }
    if (w.overflow) return 2;
  }
  w.flush();
  if (w.overflow) return 2;
  *out_len = w.n;
  return 0;
}

}  // namespace

extern "C" {

// Threaded entropy encode: visit-ordered DC-differential zigzag blocks ->
// stuffed, flush-padded per-segment byte streams (the native counterpart
// of the reference's write_ecs hot loop, encoder.c:560-587).
void jt_encode_segments(const int32_t* zz, const int32_t* dc_tab,
                        const int32_t* ac_tab,
                        const int64_t* seg_block_offsets,  // [S+1]
                        int32_t n_segments, const int32_t* ehufco,
                        const int32_t* ehufsi, uint8_t* out,
                        int64_t max_bytes_per_seg, int64_t* out_lens,
                        int32_t* errors, int32_t n_threads) {
  auto work = [&](int32_t s) {
    errors[s] = encode_segment(
        zz, seg_block_offsets[s], seg_block_offsets[s + 1], dc_tab, ac_tab,
        ehufco, ehufsi, out + static_cast<int64_t>(s) * max_bytes_per_seg,
        max_bytes_per_seg, &out_lens[s]);
  };
  if (n_threads <= 1 || n_segments <= 1) {
    for (int32_t s = 0; s < n_segments; ++s) work(s);
    return;
  }
  int nt = n_threads < n_segments ? n_threads : n_segments;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      for (int32_t s = t; s < n_segments; s += nt) work(s);
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
