// Stream entry: cut a concatenated Motion-JPEG byte stream into frames
// in one pass.
//
// The same rules as mjpeg._split_stream_py (the NumPy walk): a marker
// candidate is 0xFF followed by a byte that is not 0x00 (stuffing), not
// 0xFF (fill) and not RST0-7 (the entropy-coded data goes on).  Bytes
// before the first SOI are skipped; EOI closes a frame; a stray SOI or
// TEM carries no payload; a length under 2 steps over the marker alone;
// every other marker's length-prefixed payload is skipped, which hides
// an embedded thumbnail's own SOI/EOI; a marker whose length does not
// fit in the input ends the walk.  memchr finds each 0xFF.
//
// One thread, no allocation: the caller owns every buffer.

#include <cstdint>
#include <cstring>

extern "C" {

// data [n]; frame k is data[starts[k], ends[k]) for k < the result.
// Returns the number of frames, or -1 when there are more than cap.
int64_t jt_split_stream(const uint8_t* data, int64_t n, int64_t* starts,
                        int64_t* ends, int64_t cap) {
  if (n < 4) return 0;
  int64_t frames = 0;
  int64_t start = -1;  // the open frame's SOI, -1 outside a frame
  int64_t p = 0;
  while (p + 1 < n) {
    const void* hit =
        std::memchr(data + p, 0xFF, static_cast<size_t>(n - 1 - p));
    if (hit == nullptr) break;
    const int64_t pos = static_cast<const uint8_t*>(hit) - data;
    const uint8_t m = data[pos + 1];
    if (m == 0x00 || m == 0xFF || (m >= 0xD0 && m <= 0xD7)) {
      p = pos + 1;
      continue;
    }
    p = pos + 2;
    if (start < 0) {
      if (m == 0xD8) start = pos;
      continue;
    }
    if (m == 0xD9) {  // EOI
      if (frames >= cap) return -1;
      starts[frames] = start;
      ends[frames] = pos + 2;
      ++frames;
      start = -1;
      continue;
    }
    if (m == 0xD8 || m == 0x01) continue;  // stray SOI / TEM
    if (pos + 4 > n) break;
    const int64_t seglen = (static_cast<int64_t>(data[pos + 2]) << 8)
                           | data[pos + 3];
    if (seglen >= 2) p = pos + 2 + seglen;
  }
  return frames;
}

}  // extern "C"
