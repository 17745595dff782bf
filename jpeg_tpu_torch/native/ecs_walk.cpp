// ECS walk: unstuff a frame's restart segments and pack them into
// big-endian 32-bit words, one 0xFF-free run at a time.
//
// From `start` (the first entropy-coded byte after SOS) to EOI, each run
// of bytes with no 0xFF in it is copied to byte 4*w + k of the output
// (segment word w, byte k of the segment): with AVX2, 32 bytes a compare
// and a store while the input and the room hold 32, the run's last bytes
// by a short exact copy; then, or without AVX2, the rest of the run is
// found with one memchr, checked against the room once and copied with
// one memcpy.  Nothing is written past a run's last byte.  At a 0xFF the
// walk does what scanner.cpp's jt_prep_ecs* loops do, in their order:
// FF 00 is a literal 0xFF, fill FFs before a marker are skipped, RSTn
// closes the segment and opens the next, EOI ends the frame, any other
// marker or a lone trailing 0xFF is refused.  A closed segment's last
// word gets zeros past its last byte and its words are byte-swapped in
// place, so the output holds what the byte-at-a-time loops write, word
// for word.
//
// Two entry points keep the contracts of scanner.cpp's three loops
// (same arguments, results and codes): jt_walk_ecs_flat that of
// jt_prep_ecs_flat, jt_walk_ecs_rows that of jt_prep_ecs_rows and, given
// no row_map, that of jt_prep_ecs.  Codes, the first met in stream order:
// -1 a lone trailing 0xFF, another marker mid-scan or no EOI; -2 a byte
// past the segment's room; -3 more segments than max_rows.  Where the
// code is a segment count, the output holds what the old loop writes;
// below 0, the words within the room are undefined (a run may be copied
// before the walk meets what refuses the frame), as the callers discard
// them.
//
// One thread, no allocation: the caller owns every buffer.

#include <cstdint>
#include <cstring>
#if defined(__AVX2__)
#include <immintrin.h>
#endif

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the walk packs bytes in memory order, then swaps each word");

namespace {

// Segments back to back at word offsets of one buffer of cap_words.
struct FlatSink {
  uint32_t* out;
  int64_t cap_words;
  int32_t* starts;  // word offset of each segment
  int64_t base = 0;  // word offset of the open segment

  uint32_t* open(int64_t r, int64_t* room) {
    starts[r] = static_cast<int32_t>(base);
    *room = 4 * (cap_words - base);
    return out + base;
  }
  void close(int64_t k) { base += (k + 3) >> 2; }
};

// Segment r in row row_map[r] (row r without a map) of a [rows, wn]
// matrix.
struct RowSink {
  uint32_t* out;
  int64_t wn;
  const int32_t* row_map;

  uint32_t* open(int64_t r, int64_t* room) {
    *room = 4 * wn;
    return out + (row_map ? static_cast<int64_t>(row_map[r]) : r) * wn;
  }
  void close(int64_t) {}
};

// Zero a closed segment's last word past its k bytes, then swap its
// words to big-endian.
inline void seal(uint32_t* seg, int64_t k) {
  const int64_t words = (k + 3) >> 2;
  if (k & 3) {
    std::memset(reinterpret_cast<uint8_t*>(seg) + k, 0, 4 - (k & 3));
  }
  for (int64_t w = 0; w < words; ++w) seg[w] = __builtin_bswap32(seg[w]);
}

#if defined(__AVX2__)
// Copy p < 32 bytes exactly: two overlapping copies of a power of two.
inline void copy_short(uint8_t* dst, const uint8_t* src, int p) {
  if (p >= 16) {
    std::memcpy(dst, src, 16);
    std::memcpy(dst + p - 16, src + p - 16, 16);
  } else if (p >= 8) {
    std::memcpy(dst, src, 8);
    std::memcpy(dst + p - 8, src + p - 8, 8);
  } else if (p >= 4) {
    std::memcpy(dst, src, 4);
    std::memcpy(dst + p - 4, src + p - 4, 4);
  } else {
    for (int t = 0; t < p; ++t) dst[t] = src[t];
  }
}
#endif

// Copy the run of literals at the head of src [avail] (up to its first
// 0xFF, or all of it) to dst [room] -> the run's length, or -1 when it
// does not fit in room.
inline int64_t copy_run(const uint8_t* src, int64_t avail, uint8_t* dst,
                        int64_t room) {
  int64_t done = 0;
#if defined(__AVX2__)
  const __m256i ff = _mm256_set1_epi8(static_cast<char>(0xFF));
  while (avail - done >= 32 && room - done >= 32) {
    const __m256i v =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(src + done));
    const uint32_t hit = static_cast<uint32_t>(
        _mm256_movemask_epi8(_mm256_cmpeq_epi8(v, ff)));
    if (hit == 0) {
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + done), v);
      done += 32;
      continue;
    }
    const int p = __builtin_ctz(hit);
    copy_short(dst + done, src + done, p);
    return done + p;
  }
#endif
  const void* hit =
      std::memchr(src + done, 0xFF, static_cast<size_t>(avail - done));
  const int64_t len = hit ? static_cast<const uint8_t*>(hit) - src : avail;
  if (len > room) return -1;
  std::memcpy(dst + done, src + done, static_cast<size_t>(len - done));
  return len;
}

template <class Sink>
int64_t walk(const uint8_t* data, int64_t n, int64_t start, Sink& sink,
             int32_t* lens, int64_t max_rows, int64_t* end_off) {
  if (max_rows <= 0) return -3;
  int64_t room = 0;  // bytes the open segment may hold
  uint32_t* seg = sink.open(0, &room);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(seg);
  int64_t k = 0;  // bytes in the open segment
  int64_t r = 0;
  int64_t i = start;
  while (i < n) {
    const int64_t run = copy_run(data + i, n - i, bytes + k, room - k);
    if (run < 0) return -2;  // a literal past the room
    k += run;
    i += run;
    if (i == n) break;
    if (i + 1 >= n) return -1;  // truncated at a lone 0xFF
    if (data[i + 1] == 0x00) {  // stuffed literal 0xFF
      if (k >= room) return -2;
      bytes[k++] = 0xFF;
      i += 2;
      continue;
    }
    // A marker ends the segment; skip fill 0xFF bytes (io.c:186-220).
    int64_t j = i + 1;
    while (j < n && data[j] == 0xFF) ++j;
    if (j >= n) return -1;
    const uint8_t m = data[j];
    seal(seg, k);
    lens[r] = static_cast<int32_t>(k);
    sink.close(k);
    k = 0;
    if (m >= 0xD0 && m <= 0xD7) {  // RSTn: next segment
      if (++r >= max_rows) return -3;
      seg = sink.open(r, &room);
      bytes = reinterpret_cast<uint8_t*>(seg);
      i = j + 1;
      continue;
    }
    if (m == 0xD9) {  // EOI
      *end_off = j + 1;
      return r + 1;
    }
    return -1;  // any other marker mid-scan
  }
  return -1;  // ran off the end without EOI
}

}  // namespace

extern "C" {

// jt_prep_ecs_flat's contract: segments back to back in out [cap_words],
// starts[r] the word offset of segment r, lens[r] its bytes;
// *used_words and *end_off set on success.
int64_t jt_walk_ecs_flat(const uint8_t* data, int64_t n, int64_t start,
                         uint32_t* out, int64_t cap_words, int32_t* starts,
                         int32_t* lens, int64_t max_rows, int64_t* used_words,
                         int64_t* end_off) {
  FlatSink sink{out, cap_words, starts};
  const int64_t rc = walk(data, n, start, sink, lens, max_rows, end_off);
  if (rc > 0) *used_words = sink.base;
  return rc;
}

// jt_prep_ecs_rows' contract: segment r in row row_map[r] of out
// [*, wn] (caller-zeroed); with a null row_map, jt_prep_ecs': segment r
// in row r of out [max_rows, wn].
int64_t jt_walk_ecs_rows(const uint8_t* data, int64_t n, int64_t start,
                         uint32_t* out, int64_t wn, const int32_t* row_map,
                         int64_t max_rows, int32_t* lens, int64_t* end_off) {
  RowSink sink{out, wn, row_map};
  return walk(data, n, start, sink, lens, max_rows, end_off);
}

}  // extern "C"
