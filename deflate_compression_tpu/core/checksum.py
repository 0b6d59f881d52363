"""Checksums: Adler-32 (zlib footer) and CRC-32 (PNG/gzip), host and device
paths.

Reference analogues: adler32 src/deflate_decompress.c:60-68 (byte-serial
mod-65521 pair) and the table-driven CRC-32 src/include/crc.h:4,22-30.

Device design: both are reassociated into chunk-parallel forms.
  * Adler-32: per-chunk (sum, weighted-sum) reductions + the standard
    sequential combine A = A1+A2-1, B = B1+B2+len2*(A1-1) over few chunks.
  * CRC-32: CRC is GF(2)-linear, so chunk CRCs combine with shift matrices;
    within a lane batch we process byte-position-by-byte-position across many
    chunks at once (vectorized table lookup), turning the byte-serial loop
    into ~chunk_len vector steps.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

ADLER_MOD = 65521
# Largest n with n*(n+1)/2*255 + (n+1)*(65520) < 2^32 (zlib's NMAX): safe
# number of bytes before the running u32 sums must be reduced mod 65521.
ADLER_NMAX = 5552

# ---------------------------------------------------------------------------
# Adler-32
# ---------------------------------------------------------------------------


def adler32_np(data: np.ndarray, value: int = 1) -> int:
    """Adler-32 of u8 array, numpy chunk-vectorized."""
    data = np.asarray(data, dtype=np.uint8)
    a = value & 0xFFFF
    b = (value >> 16) & 0xFFFF
    n = data.size
    for start in range(0, n, ADLER_NMAX):
        chunk = data[start:start + ADLER_NMAX].astype(np.uint32)
        m = chunk.size
        # b += m*a + sum((m - i) * chunk[i]); a += sum(chunk)
        w = np.arange(m, 0, -1, dtype=np.uint32)
        b = (b + m * a + int(np.dot(w, chunk))) % ADLER_MOD
        a = (a + int(chunk.sum())) % ADLER_MOD
    return ((b << 16) | a) & 0xFFFFFFFF


@jax.jit
def adler32_jax(data: jnp.ndarray, valid_len: jnp.ndarray) -> jnp.ndarray:
    """Adler-32 over data[:valid_len] (u8[S], S static), returns u32 scalar.

    Chunked fori_loop: each step reduces one NMAX-sized chunk with vector
    ops; the cross-chunk recurrence is the cheap scalar part.
    """
    S = data.shape[0]
    nchunks = (S + ADLER_NMAX - 1) // ADLER_NMAX
    pad = nchunks * ADLER_NMAX - S
    d = jnp.concatenate([data, jnp.zeros((pad,), jnp.uint8)]).astype(jnp.uint32)
    d = jnp.where(jnp.arange(nchunks * ADLER_NMAX) < valid_len, d, 0)
    d = d.reshape(nchunks, ADLER_NMAX)
    # per-chunk valid counts
    base = jnp.arange(nchunks) * ADLER_NMAX
    m = jnp.clip(valid_len - base, 0, ADLER_NMAX).astype(jnp.uint32)

    w = jnp.arange(ADLER_NMAX, dtype=jnp.uint32)
    csum = jnp.sum(d, axis=1, dtype=jnp.uint32)                # sum of bytes
    # weighted sum with per-chunk valid length: sum((m - i) * d[i]) for i < m
    wsum = m[:, None] * d - w[None, :] * d
    wsum = jnp.sum(wsum, axis=1, dtype=jnp.uint32)

    def body(c, carry):
        a, b = carry
        b = (b + m[c] * a + wsum[c]) % ADLER_MOD
        a = (a + csum[c]) % ADLER_MOD
        return (a, b)

    # data-dependent init keeps varying-axis types stable under shard_map
    zero = csum[0] * 0
    a, b = jax.lax.fori_loop(0, nchunks, body,
                             (jnp.uint32(1) + zero, jnp.uint32(0) + zero))
    return ((b << np.uint32(16)) | a).astype(jnp.uint32)


def adler32_combine(ad1: int, ad2: int, len2: int) -> int:
    """Adler of concat(A, B) from adler(A), adler(B), len(B)."""
    a1 = ad1 & 0xFFFF
    b1 = (ad1 >> 16) & 0xFFFF
    a2 = ad2 & 0xFFFF
    b2 = (ad2 >> 16) & 0xFFFF
    rem = len2 % ADLER_MOD
    a = (a1 + a2 - 1) % ADLER_MOD
    b = (b1 + b2 + rem * (a1 - 1)) % ADLER_MOD
    return ((b % ADLER_MOD) << 16) | (a % ADLER_MOD)


# ---------------------------------------------------------------------------
# CRC-32 (reflected, poly 0xEDB88320)
# ---------------------------------------------------------------------------

def _crc_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = np.uint32(i)
        for _ in range(8):
            c = (c >> np.uint32(1)) ^ (np.uint32(0xEDB88320) * (c & np.uint32(1)))
        t[i] = c
    return t


CRC_TABLE = _crc_table()


def _crc32_serial(data: np.ndarray, crc: int) -> int:
    c = np.uint32(crc)
    t = CRC_TABLE
    for byte in data:
        c = t[(c ^ byte) & 0xFF] ^ (c >> np.uint32(8))
    return int(c)


def _gf2_matrix_times(mat: np.ndarray, vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= int(mat[i])
        vec >>= 1
        i += 1
    return s


def _gf2_matrix_square(mat: np.ndarray) -> np.ndarray:
    return np.array([_gf2_matrix_times(mat, int(m)) for m in mat], dtype=np.uint64)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of concat(A, B) from crc(A), crc(B), len(B) (zlib algorithm)."""
    if len2 == 0:
        return crc1
    odd = np.zeros(32, dtype=np.uint64)
    odd[0] = 0xEDB88320
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    even = _gf2_matrix_square(odd)
    odd = _gf2_matrix_square(even)
    while True:
        even = _gf2_matrix_square(odd)
        if len2 & 1:
            crc1 = _gf2_matrix_times(even, crc1)
        len2 >>= 1
        if len2 == 0:
            break
        odd = _gf2_matrix_square(even)
        if len2 & 1:
            crc1 = _gf2_matrix_times(odd, crc1)
        len2 >>= 1
        if len2 == 0:
            break
    return (crc1 ^ crc2) & 0xFFFFFFFF


def crc32_np(data, crc: int = 0) -> int:
    """CRC-32, numpy lane-parallel: split into L lanes, run the byte-serial
    recurrence across all lanes at once (one table gather per byte position),
    then combine lane CRCs with the GF(2) shift matrices."""
    data = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(data, np.uint8)
    n = data.size
    crc = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    if n < 4096:
        return _crc32_serial(data, crc) ^ 0xFFFFFFFF

    lanes = 256
    chunk = n // lanes
    body = data[:lanes * chunk].reshape(lanes, chunk)
    c = np.zeros(lanes, dtype=np.uint32)
    c[0] = crc          # seed only lane 0; other lanes start at 0
    t = CRC_TABLE
    for j in range(chunk):
        c = t[(c ^ body[:, j]) & 0xFF] ^ (c >> np.uint32(8))
    # combine lanes left to right
    acc = int(c[0])
    for l in range(1, lanes):
        # shift acc forward by `chunk` bytes, xor lane l's crc
        acc = crc32_combine_raw(acc, int(c[l]), chunk)
    tail = data[lanes * chunk:]
    acc = _crc32_serial(tail, acc)
    return acc ^ 0xFFFFFFFF


@functools.lru_cache(maxsize=64)
def _shift_matrix(len2: int) -> tuple:
    """Matrix (as tuple of 32 ints) applying a len2-byte zero-append to a raw
    crc register, for crc32_combine_raw."""
    odd = np.zeros(32, dtype=np.uint64)
    odd[0] = 0xEDB88320
    row = 1
    for nn in range(1, 32):
        odd[nn] = row
        row <<= 1
    # matrices above shift by 1 bit; square to 8*len2 bits worth
    mat = odd
    # build shift-by-8*len2 via repeated squaring over bit count
    nbits = 8 * len2
    result = None
    cur = mat
    while nbits:
        if nbits & 1:
            if result is None:
                result_mat = cur
                result = True
            else:
                result_mat = np.array(
                    [_gf2_matrix_times(cur, int(m)) for m in result_mat],
                    dtype=np.uint64)
        cur = _gf2_matrix_square(cur)
        nbits >>= 1
    return tuple(int(x) for x in result_mat)


def crc32_combine_raw(crc1_raw: int, crc2_raw: int, len2: int) -> int:
    """Combine raw (pre/post-conditioning already applied consistently)
    registers: shift crc1 by len2 zero bytes and xor crc2."""
    if len2 == 0:
        return crc1_raw ^ crc2_raw
    mat = np.array(_shift_matrix(len2), dtype=np.uint64)
    return _gf2_matrix_times(mat, crc1_raw) ^ crc2_raw
