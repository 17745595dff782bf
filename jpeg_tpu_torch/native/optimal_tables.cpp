// Optimal Huffman tables (T.81 Annex K.2) for many symbol histograms in
// one call: the per-frame tables of a chunk.
//
// The same tables as tables.optimize_table, the reference encoder's
// adapt_huffman_table (huffman.c:327-537), table for table:
//   - Figure K.1, code sizes: the reserved point 256 gets a count of 1
//     (so no code is all 1-bits); while two symbols have counts, merge
//     the least count V1 and the next least V2, ties going to the larger
//     symbol value (the reference's `<=` scan).  Keys (count, 511 -
//     value) sorted once give that order; each merged node goes back in
//     by a binary search.
//   - Figures K.2-K.4, BITS: the count of each code size, codes longer
//     than 16 bits pushed down, then the reserved point taken off the
//     longest length.
//   - Figure K.5, HUFFVAL: symbol values by code size (the sizes before
//     the adjustment), then by value.
// and, from BITS and HUFFVAL, the encode tables of Annex C (EHUFCO,
// EHUFSI by symbol value, 0 where a symbol has no code).
//
// One thread, no allocation: the caller owns every buffer.

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr int SYMBOLS = 257;  // 256 values and the reserved point

// One table from counts[256] -> 0, or -1 when no symbol has a count, -2
// when a code size passes 32 bits or a length holds more than 255 codes.
int optimal_table(const int32_t* counts, uint8_t* bits_out,
                  uint8_t* values_out, int32_t* ehufco, int32_t* ehufsi) {
  int64_t freq[SYMBOLS];
  int codesize[SYMBOLS];
  int others[SYMBOLS];
  uint64_t keys[2 * SYMBOLS];  // keys[head, end): the live nodes, ascending
  int end = 0;
  for (int v = 0; v < SYMBOLS; ++v) {
    freq[v] = v < 256 ? counts[v] : 1;
    codesize[v] = 0;
    others[v] = -1;
    if (freq[v] > 0)
      keys[end++] = (static_cast<uint64_t>(freq[v]) << 9) | (511 - v);
  }
  std::sort(keys, keys + end);
  int head = 0;
  while (end - head >= 2) {
    const int v1 = 511 - static_cast<int>(keys[head] & 511);
    const int v2 = 511 - static_cast<int>(keys[head + 1] & 511);
    head += 2;
    freq[v1] += freq[v2];
    freq[v2] = 0;
    int c = v1;
    ++codesize[c];
    while (others[c] >= 0) {
      c = others[c];
      ++codesize[c];
    }
    others[c] = v2;
    c = v2;
    ++codesize[c];
    while (others[c] >= 0) {
      c = others[c];
      ++codesize[c];
    }
    const uint64_t key = (static_cast<uint64_t>(freq[v1]) << 9) | (511 - v1);
    const int at = static_cast<int>(
        std::lower_bound(keys + head, keys + end, key) - keys);
    std::memmove(keys + at + 1, keys + at, (end - at) * sizeof(uint64_t));
    keys[at] = key;
    ++end;
  }

  int64_t bits[33] = {0};
  for (int v = 0; v < SYMBOLS; ++v) {
    if (codesize[v] == 0) continue;
    if (codesize[v] > 32) return -2;
    ++bits[codesize[v]];
  }
  for (int i = 32; i > 16; --i) {
    while (bits[i] > 0) {
      int j = i - 2;
      while (j > 0 && bits[j] <= 0) --j;
      if (j <= 0) return -2;
      bits[i] -= 2;
      bits[i - 1] += 1;
      bits[j + 1] += 2;
      bits[j] -= 1;
    }
  }
  int i = 16;
  while (i > 0 && bits[i] == 0) --i;
  if (i == 0) return -1;
  bits[i] -= 1;  // the reserved point's code

  for (int l = 1; l <= 16; ++l) {
    if (bits[l] > 255) return -2;
    bits_out[l - 1] = static_cast<uint8_t>(bits[l]);
  }
  // HUFFVAL: a counting sort of the values by code size, stable in value.
  int at[34] = {0};
  for (int v = 0; v < 256; ++v)
    if (codesize[v]) ++at[codesize[v] + 1];
  for (int size = 2; size < 34; ++size) at[size] += at[size - 1];
  for (int v = 0; v < 256; ++v)
    if (codesize[v]) values_out[at[codesize[v]]++] = static_cast<uint8_t>(v);
  for (int v = at[32]; v < 256; ++v) values_out[v] = 0;

  for (int v = 0; v < 256; ++v) ehufco[v] = ehufsi[v] = 0;
  int32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int n = 0; n < bits[l]; ++n, ++k, ++code) {
      ehufco[values_out[k]] = code;
      ehufsi[values_out[k]] = l;
    }
    code <<= 1;
  }
  return 0;
}

}  // namespace

extern "C" {

// hist [n, 256]: symbol counts; bits [n, 16] (DHT L1..L16), values
// [n, 256] (HUFFVAL, zeros past the table's codes), ehufco / ehufsi
// [n, 256].  Returns 0, or -(t + 1) for the first table t that has no
// symbol, or -(n + t + 1) for the first whose codes do not fit.
int64_t jt_optimal_tables(const int32_t* hist, int64_t n, uint8_t* bits,
                          uint8_t* values, int32_t* ehufco, int32_t* ehufsi) {
  for (int64_t t = 0; t < n; ++t) {
    const int rc = optimal_table(hist + 256 * t, bits + 16 * t,
                                 values + 256 * t, ehufco + 256 * t,
                                 ehufsi + 256 * t);
    if (rc == -1) return -(t + 1);
    if (rc == -2) return -(n + t + 1);
  }
  return 0;
}

}  // extern "C"
