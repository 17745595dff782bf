// Encode host tail: a chunk's compacted segment words -> framed JPEG
// bytes, in one pass.
//
// The device encoder (entropy/encode_cuda.encode_scan) leaves each
// restart segment's Huffman bits MSB-first in u32 words, segment s at
// word sum(ceil(bits/32)) of the segments before it.  Per frame this
// writes the frame's header (one shared by the chunk, or each frame's
// own where its Huffman tables are its own), then each segment's ceil(bits/8) live bytes with
// the last byte's pad bits set to 1 (T.81 F.1.2.3), a 0x00 after every
// 0xFF (F.1.2.3, the byte stuffing), RSTn between segments (n = s & 7
// with s counted from 0 in the frame) and EOI after the last one.  The
// same bytes as models/device_encode.DeviceEncoder._finalize_flat_ref.
//
// One thread, no allocation: the caller owns every buffer.

#include <cstdint>
#include <cstring>

namespace {

// Nonzero iff some byte of w is 0xFF (the classic has-zero-byte test on
// ~w, exact as a whole-word answer).
inline bool has_ff(uint32_t w) {
  const uint32_t v = ~w;
  return ((v - 0x01010101u) & ~v & 0x80808080u) != 0;
}

inline uint8_t* put_stuffed(uint8_t* o, uint8_t b) {
  *o++ = b;
  if (b == 0xFF) *o++ = 0x00;
  return o;
}

}  // namespace

extern "C" {

// words [n_words]: the stream; seg_bits [frames * ns]: bits a segment;
// headers: SOI..SOS, headers[0, hlen) for every frame, or with hdr_off
// [frames + 1] frame f's own, headers[hdr_off[f], hdr_off[f + 1]);
// out [cap]; frame_off [frames + 1]: frame f is out[frame_off[f],
// frame_off[f + 1]).  Returns the bytes written, -1 when cap is below the
// worst case, the headers + 2 * live bytes + 2 * segments (every live
// byte 0xFF), -2 when a bit count or a header length is negative or the
// segments need more than n_words words.
int64_t jt_finalize_flat(const uint32_t* words, int64_t n_words,
                         const int64_t* seg_bits, int64_t frames, int64_t ns,
                         const uint8_t* headers, const int64_t* hdr_off,
                         int64_t hlen, uint8_t* out, int64_t cap,
                         int64_t* frame_off) {
  int64_t need_words = 0;
  int64_t worst = 0;
  for (int64_t f = 0; f < frames; ++f) {
    const int64_t n = hdr_off ? hdr_off[f + 1] - hdr_off[f] : hlen;
    if (n < 0) return -2;
    worst += n;
  }
  for (int64_t s = 0; s < frames * ns; ++s) {
    if (seg_bits[s] < 0) return -2;
    need_words += (seg_bits[s] + 31) >> 5;
    worst += 2 * ((seg_bits[s] + 7) >> 3) + 2;
  }
  if (need_words > n_words) return -2;
  if (worst > cap) return -1;

  uint8_t* o = out;
  const uint32_t* w = words;
  for (int64_t f = 0; f < frames; ++f) {
    frame_off[f] = o - out;
    const int64_t h0 = hdr_off ? hdr_off[f] : 0;
    const int64_t n = hdr_off ? hdr_off[f + 1] - h0 : hlen;
    std::memcpy(o, headers + h0, static_cast<size_t>(n));
    o += n;
    for (int64_t s = 0; s < ns; ++s) {
      const int64_t bits = seg_bits[f * ns + s];
      if (bits > 0) {
        const int64_t nbytes = (bits + 7) >> 3;
        const int64_t last = (nbytes - 1) >> 2;  // the word of the last byte
        for (int64_t i = 0; i < last; ++i) {
          const uint32_t v = w[i];
          if (!has_ff(v)) {
            const uint32_t be = __builtin_bswap32(v);
            std::memcpy(o, &be, 4);
            o += 4;
          } else {
            for (int k = 24; k >= 0; k -= 8)
              o = put_stuffed(o, static_cast<uint8_t>(v >> k));
          }
        }
        // The last word: its live bytes, the last one padded with 1s.
        const uint32_t v = w[last];
        const int n = static_cast<int>(nbytes - 4 * last);
        for (int k = 0; k < n - 1; ++k)
          o = put_stuffed(o, static_cast<uint8_t>(v >> (24 - 8 * k)));
        const int pad = static_cast<int>(8 * nbytes - bits);
        o = put_stuffed(o, static_cast<uint8_t>((v >> (24 - 8 * (n - 1)))
                                                | ((1u << pad) - 1)));
        w += last + 1;
      }
      *o++ = 0xFF;
      *o++ = s + 1 < ns ? static_cast<uint8_t>(0xD0 + (s & 7)) : 0xD9;
    }
  }
  frame_off[frames] = o - out;
  return o - out;
}

}  // extern "C"
