"""Spec constants for baseline sequential JPEG (ITU-T T.81).

Contents mirror the constants the reference carries (common.h:34-43 zig-zag,
encoder.c:14-34 Annex K.1 quantization tables, encoder.c:38-65 libjpeg
quality scaling, mjpeg.h Annex K.3 default Huffman tables) but are laid out
for array programming: everything is a NumPy array ready to be broadcast
over `[num_blocks, 64]` coefficient tensors.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Zig-zag scan (T.81 Figure 5; reference common.h:34-43).
#
# ZIGZAG[k] = raster index of the k-th coefficient in zig-zag order, i.e. a
# zig-zag -> raster permutation.  INV_ZIGZAG is its inverse
# (raster -> zig-zag).
# ---------------------------------------------------------------------------

ZIGZAG = np.array(
    [
        0,  1,  8, 16,  9,  2,  3, 10,
        17, 24, 32, 25, 18, 11,  4,  5,
        12, 19, 26, 33, 40, 48, 41, 34,
        27, 20, 13,  6,  7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36,
        29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46,
        53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)

INV_ZIGZAG = np.argsort(ZIGZAG).astype(np.int32)

# ---------------------------------------------------------------------------
# Marker codes (T.81 Table B.1).  Only the subset the reference dispatches on
# (decoder.c:472-659) plus the ones it emits (encoder.c:195-410).
# ---------------------------------------------------------------------------

M_SOF0 = 0xFFC0  # Baseline DCT
M_SOF1 = 0xFFC1  # Extended sequential DCT
M_SOF2 = 0xFFC2  # Progressive DCT (parsed then rejected)
M_SOF3 = 0xFFC3  # Lossless (rejected)
M_DHT = 0xFFC4
M_SOF9 = 0xFFC9  # Arithmetic (rejected)
M_SOF10 = 0xFFCA  # Arithmetic progressive (rejected)
M_DAC = 0xFFCC
M_RST0 = 0xFFD0
M_RST7 = 0xFFD7
M_SOI = 0xFFD8
M_EOI = 0xFFD9
M_SOS = 0xFFDA
M_DQT = 0xFFDB
M_DRI = 0xFFDD
M_APP0 = 0xFFE0
M_COM = 0xFFFE
M_TEM = 0xFF01

# APPn markers the reference skips (decoder.c:498-510: e0..e8, eb..ee).
APPN_SKIPPED = tuple(range(0xFFE0, 0xFFE9)) + tuple(range(0xFFEB, 0xFFEF))


def is_rst(marker: int) -> bool:
    return M_RST0 <= marker <= M_RST7


# ---------------------------------------------------------------------------
# Annex K.1 quantization tables (reference encoder.c:14-34), raster order.
# ---------------------------------------------------------------------------

STD_LUMINANCE_QUANT = np.array(
    [
        16, 11, 10, 16, 24, 40, 51, 61,
        12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56,
        14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77,
        24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101,
        72, 92, 95, 98, 112, 100, 103, 99,
    ],
    dtype=np.int64,
)

STD_CHROMINANCE_QUANT = np.array(
    [
        17, 18, 24, 47, 99, 99, 99, 99,
        18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99,
        47, 66, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    dtype=np.int64,
)


def quality_to_sf(q: int) -> int:
    """libjpeg-compatible quality -> scaling factor (encoder.c:38-56)."""
    q = min(max(int(q), 1), 100)
    if q < 50:
        return 5000 // q
    return 200 - q * 2


def scale_qtable(ref: np.ndarray, q: int) -> np.ndarray:
    """Quality-scaled quantization table (encoder.c:58-65).

    Q = clamp(1, (ref*sf + 50) / 100, 255), integer arithmetic.
    """
    sf = quality_to_sf(q)
    scaled = (ref.astype(np.int64) * sf + 50) // 100
    return np.clip(scaled, 1, 255).astype(np.uint16)


# ---------------------------------------------------------------------------
# Default (Motion-JPEG / T.81 Annex K.3) Huffman table specs.
#
# These are the standard "typical" tables from the spec, installed into every
# fresh context by the reference (common.c:90-99, mjpeg.h) so headerless
# MJPEG frames decode and the `-o 0` encoder path emits them verbatim.
# Stored in DHT wire form: (counts-per-length L[1..16], values in order).
# ---------------------------------------------------------------------------

# K.3.1 typical DC luminance: categories 0..11, code lengths 2..9.
DEFAULT_DC_LUMA = (
    (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11),
)

# K.3.1 typical DC chrominance.
DEFAULT_DC_CHROMA = (
    (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11),
)

# K.3.2 typical AC luminance.
DEFAULT_AC_LUMA = (
    (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125),
    (
        1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113,
        20, 50, 129, 145, 161, 8, 35, 66, 177, 193, 21, 82, 209, 240, 36,
        51, 98, 114, 130, 9, 10, 22, 23, 24, 25, 26, 37, 38, 39, 40, 41,
        42, 52, 53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74,
        83, 84, 85, 86, 87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105,
        106, 115, 116, 117, 118, 119, 120, 121, 122, 131, 132, 133, 134,
        135, 136, 137, 138, 146, 147, 148, 149, 150, 151, 152, 153, 154,
        162, 163, 164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181,
        182, 183, 184, 185, 186, 194, 195, 196, 197, 198, 199, 200, 201,
        202, 210, 211, 212, 213, 214, 215, 216, 217, 218, 225, 226, 227,
        228, 229, 230, 231, 232, 233, 234, 241, 242, 243, 244, 245, 246,
        247, 248, 249, 250,
    ),
)

# K.3.2 typical AC chrominance.
DEFAULT_AC_CHROMA = (
    (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119),
    (
        0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34,
        50, 129, 8, 20, 66, 145, 161, 177, 193, 9, 35, 51, 82, 240, 21,
        98, 114, 209, 10, 22, 36, 52, 225, 37, 241, 23, 24, 25, 26, 38,
        39, 40, 41, 42, 53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72,
        73, 74, 83, 84, 85, 86, 87, 88, 89, 90, 99, 100, 101, 102, 103,
        104, 105, 106, 115, 116, 117, 118, 119, 120, 121, 122, 130, 131,
        132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150, 151,
        152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178,
        179, 180, 181, 182, 183, 184, 185, 186, 194, 195, 196, 197, 198,
        199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218,
        226, 227, 228, 229, 230, 231, 232, 233, 234, 242, 243, 244, 245,
        246, 247, 248, 249, 250,
    ),
)

# Indexed like the reference's htable[Tc][Th] 2x2 default corner
# (common.c:90-94): [Tc=0 DC / Tc=1 AC][Th=0 luma / Th=1 chroma].
DEFAULT_HTABLES = {
    (0, 0): DEFAULT_DC_LUMA,
    (0, 1): DEFAULT_DC_CHROMA,
    (1, 0): DEFAULT_AC_LUMA,
    (1, 1): DEFAULT_AC_CHROMA,
}
