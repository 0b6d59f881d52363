"""RFC 1951 / RFC 1950 format constants, as numpy tables.

These are the DEFLATE alphabets and closed-form code mappings that the C
reference derives on the fly (reference: get_len_code/get_dist_code
src/deflate_compress.c:182-217, decode inverses src/deflate_decompress.c:251-277,
fixed-code tables src/deflate_decompress.c:70-131, HCLEN permutation
src/deflate_decompress.c:23). Here they are precomputed dense LUTs so the
device encode/decode paths are pure gathers with no data-dependent control
flow.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Alphabet sizes (RFC 1951 §3.2.5-3.2.7; reference src/include/deflate.h:4-6)
# ---------------------------------------------------------------------------
MAX_MATCH = 258
MIN_MATCH = 3
WINDOW_SIZE = 32768
NUM_LITLEN = 286          # 0-255 literals, 256 EOB, 257-285 lengths
NUM_DIST = 30
NUM_CLEN = 19             # code-length alphabet
MAX_CODE_BITS = 15
MAX_CLEN_BITS = 7
EOB = 256

# ---------------------------------------------------------------------------
# Length codes 257..285 (RFC 1951 §3.2.5 Table 1)
# LENGTH_BASE[c-257] = smallest match length for code c
# LENGTH_EXTRA[c-257] = number of extra bits
# ---------------------------------------------------------------------------
LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
     35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258],
    dtype=np.int32)
LENGTH_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
     3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0],
    dtype=np.int32)

# Dense LUT: match length (3..258) -> length code / extra-bit value.
# LEN_TO_CODE[l-3] in 257..285 ; LEN_TO_EXTRA_VAL[l-3] = l - base(code)
_l2c = np.zeros(256, dtype=np.int32)
_l2e = np.zeros(256, dtype=np.int32)
for _c in range(29):
    _lo = LENGTH_BASE[_c]
    _hi = LENGTH_BASE[_c + 1] - 1 if _c < 28 else 258
    if _c == 28:        # code 285 is exactly length 258
        _lo = 258
    else:
        _hi = min(_hi, 257)
    for _l in range(_lo, _hi + 1):
        _l2c[_l - 3] = 257 + _c
        _l2e[_l - 3] = _l - LENGTH_BASE[_c]
LEN_TO_CODE = _l2c
LEN_TO_EXTRA_VAL = _l2e

# ---------------------------------------------------------------------------
# Distance codes 0..29 (RFC 1951 §3.2.5 Table 2)
# ---------------------------------------------------------------------------
DIST_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
     257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
     12289, 16385, 24577],
    dtype=np.int32)
DIST_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
     7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13],
    dtype=np.int32)

# Dense LUT trick (as in zlib): for dist 1..256 use DIST_TO_CODE_LO[dist-1];
# for dist 257..32768 use DIST_TO_CODE_HI[(dist-1) >> 7].
_dlo = np.zeros(256, dtype=np.int32)
_dhi = np.zeros(256, dtype=np.int32)
for _c in range(30):
    _lo = DIST_BASE[_c]
    _hi = (DIST_BASE[_c + 1] - 1) if _c < 29 else 32768
    for _d in range(_lo, _hi + 1):
        if _d <= 256:
            _dlo[_d - 1] = _c
        if _d >= 257:
            _dhi[(_d - 1) >> 7] = _c
DIST_TO_CODE_LO = _dlo
DIST_TO_CODE_HI = _dhi

# ---------------------------------------------------------------------------
# Code-length alphabet (RFC 1951 §3.2.7)
# Order in which HCLEN code lengths are transmitted
# (reference: D1_INIT_CODE_LENS src/deflate_decompress.c:23)
# ---------------------------------------------------------------------------
CLEN_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32)
# Inverse permutation: position of symbol s in the transmitted sequence
CLEN_ORDER_INV = np.zeros(19, dtype=np.int32)
CLEN_ORDER_INV[CLEN_ORDER] = np.arange(19, dtype=np.int32)

# Extra bits for code-length symbols 16/17/18 and their repeat bases
CLEN_EXTRA = np.zeros(19, dtype=np.int32)
CLEN_EXTRA[16], CLEN_EXTRA[17], CLEN_EXTRA[18] = 2, 3, 7
CLEN_REPEAT_BASE = np.zeros(19, dtype=np.int32)
CLEN_REPEAT_BASE[16], CLEN_REPEAT_BASE[17], CLEN_REPEAT_BASE[18] = 3, 3, 11

# ---------------------------------------------------------------------------
# Fixed (BTYPE=1) Huffman code lengths (RFC 1951 §3.2.6;
# reference closed forms src/deflate_decompress.c:70-131)
# ---------------------------------------------------------------------------
FIXED_LITLEN_LENGTHS = np.concatenate([
    np.full(144, 8), np.full(112, 9), np.full(24, 7), np.full(8, 8),
]).astype(np.int32)            # 288 entries; 286/287 never used but defined
FIXED_DIST_LENGTHS = np.full(32, 5, dtype=np.int32)

# Block types
BTYPE_STORED = 0
BTYPE_FIXED = 1
BTYPE_DYNAMIC = 2

# zlib container (RFC 1950; reference src/deflate_decompress.c:347-368)
ZLIB_CM_DEFLATE = 8
ADLER_MOD = 65521

# gzip container (RFC 1952)
GZIP_MAGIC = b"\x1f\x8b"


def reverse_bits_vec(codes: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """Vectorized exact bit reversal of `codes` within width `nbits`.

    DEFLATE packs Huffman codes MSB-first into an LSB-first bitstream, so
    codes must be reversed before packing (reference: reverse_bits
    src/include/globals.h:78-86).
    """
    c = codes.astype(np.int64)
    r = np.zeros_like(c)
    for i in range(MAX_CODE_BITS):
        bit = (c >> i) & 1
        # bit i of input becomes bit (nbits-1-i) of output, when i < nbits
        shift = nbits - 1 - i
        valid = shift >= 0
        r = r | np.where(valid, bit << np.maximum(shift, 0), 0)
    return r.astype(np.uint32)
