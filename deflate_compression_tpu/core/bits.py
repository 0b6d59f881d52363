"""Bitstream primitives.

Data-parallel replacement for the reference's byte-at-a-time LSB-first bit
cursor
(reference: _bits32/read_bits32 src/include/globals.h:52-64, bit_inc/byte_roundup
src/include/globals.h:15-17). Instead of a sequential cursor, serialization is
expressed as an array of (value, nbits) *items* with precomputed absolute bit
offsets; packing is a data-parallel scatter of each item into at most two u32
words. Bits within an item are disjoint from all other items' bits, so
scatter-ADD is exactly scatter-OR and XLA can fuse/parallelize freely.

DEFLATE bit order (RFC 1951 §3.1.1): bytes are filled LSB-first; Huffman codes
are packed MSB-of-code-first (hence codes must be bit-reversed before becoming
items — see core/huffman.reverse_bits).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "pack_items_to_words",
    "pack_items64_to_words",
    "words_to_bytes",
    "reverse_bits",
    "BitReader",
]


def reverse_bits(codes: jnp.ndarray, nbits: jnp.ndarray, max_bits: int = 15) -> jnp.ndarray:
    """Bit-reverse each code within its own width (vectorized, jittable).

    Reference analogue: reverse_bits src/include/globals.h:78-86.
    """
    c = codes.astype(jnp.uint32)
    r = jnp.zeros_like(c)
    for i in range(max_bits):
        bit = (c >> np.uint32(i)) & np.uint32(1)
        shift = (nbits - 1 - i).astype(jnp.int32)
        valid = shift >= 0
        sh = jnp.maximum(shift, 0).astype(jnp.uint32)
        r = r | jnp.where(valid, bit << sh, np.uint32(0))
    return r


def pack_items_to_words(values: jnp.ndarray,
                        nbits: jnp.ndarray,
                        offsets: jnp.ndarray,
                        num_words: int) -> jnp.ndarray:
    """Scatter items into a u32 word array (LSB-first bit packing).

    Args:
      values: u32[N] item payloads (low `nbits` bits are significant; higher
        bits are masked off here for safety).
      nbits: i32[N] bit widths, 0..32. Width-0 items contribute nothing.
      offsets: i32[N] absolute starting bit offset of each item in the stream.
        Items must occupy disjoint bit ranges.
      num_words: static output size in 32-bit words.

    Returns:
      u32[num_words] packed words; word w holds stream bits [32w, 32w+32),
      bit k of word w = stream bit 32w + k (LSB-first).
    """
    values = values.astype(jnp.uint32)
    nbits = nbits.astype(jnp.int32)
    offsets = offsets.astype(jnp.int32)

    # Mask values to their width. (1 << 32) overflows u32, so build the mask as
    # 0xFFFFFFFF >> (32 - nbits), guarding nbits == 0.
    nb = nbits.astype(jnp.uint32)
    full = np.uint32(0xFFFFFFFF)
    mask = jnp.where(nbits >= 32, full,
                     jnp.where(nbits <= 0, np.uint32(0),
                               full >> (np.uint32(32) - nb)))
    v = values & mask

    word = offsets >> 5
    shift = (offsets & 31).astype(jnp.uint32)

    lo = v << shift                       # u32 shift wraps high bits away: OK
    # High part: v >> (32 - shift); shift-by-32 is undefined, so express as
    # (v >> 1) >> (31 - shift) which is exact for shift in [0, 31].
    hi = (v >> np.uint32(1)) >> (np.uint32(31) - shift)

    live = nbits > 0
    word_lo = jnp.where(live, word, num_words)        # drop dead items
    word_hi = jnp.where(live, word + 1, num_words)

    out = jnp.zeros((num_words,), dtype=jnp.uint32)
    out = out.at[word_lo].add(lo, mode="drop")
    out = out.at[word_hi].add(hi, mode="drop")
    return out


def pack_items64_to_words(lo: jnp.ndarray,
                          hi: jnp.ndarray,
                          nbits: jnp.ndarray,
                          offsets: jnp.ndarray,
                          num_words: int,
                          sorted_indices: bool = False) -> jnp.ndarray:
    """Scatter up-to-64-bit items into a u32 word array (LSB-first).

    Wider sibling of pack_items_to_words: each item is (hi << 32) | lo with
    the low `nbits` (0..64) significant. An item spans at most 3 u32 words
    ((31 + 64 - 1) >> 5 == 2 word crossings), so serialization is three
    word-contribution streams, landed by three flat scatter-adds.
    Scatter-add == scatter-OR here because items occupy disjoint bit ranges.

    sorted_indices=True: the caller guarantees `offsets` are non-decreasing
    over the WHOLE array (including zero-width items, which must sit at
    their natural stream position instead of being parked) — the scatters
    then run with indices_are_sorted, letting XLA pick the sorted-update
    lowering. Zero-width items contribute 0 bits at a real word (harmless).
    """
    lo = lo.astype(jnp.uint32)
    hi = hi.astype(jnp.uint32)
    nbits = nbits.astype(jnp.int32)
    offsets = offsets.astype(jnp.int32)
    full = np.uint32(0xFFFFFFFF)

    nb_lo = jnp.clip(nbits, 0, 32)
    nb_hi = jnp.clip(nbits - 32, 0, 32)
    mask_lo = jnp.where(nb_lo >= 32, full,
                        jnp.where(nb_lo <= 0, np.uint32(0),
                                  full >> (np.uint32(32) - nb_lo.astype(jnp.uint32))))
    mask_hi = jnp.where(nb_hi >= 32, full,
                        jnp.where(nb_hi <= 0, np.uint32(0),
                                  full >> (np.uint32(32) - nb_hi.astype(jnp.uint32))))
    lo = lo & mask_lo
    hi = hi & mask_hi

    w = offsets >> 5
    sh = (offsets & 31).astype(jnp.uint32)
    # v >> (32 - sh) expressed as (v >> 1) >> (31 - sh): exact for sh in
    # [0, 31] (plain >> by 32 is undefined).
    w0 = lo << sh
    w1 = ((lo >> np.uint32(1)) >> (np.uint32(31) - sh)) | (hi << sh)
    w2 = (hi >> np.uint32(1)) >> (np.uint32(31) - sh)

    if sorted_indices:
        out = jnp.zeros((num_words + 2,), jnp.uint32)
        out = out.at[w].add(w0, indices_are_sorted=True)
        out = out.at[w + 1].add(w1, indices_are_sorted=True)
        out = out.at[w + 2].add(w2, indices_are_sorted=True)
        return out[:num_words]

    live = nbits > 0
    w0t = jnp.where(live, w, num_words)
    w1t = jnp.where(live, w + 1, num_words)
    w2t = jnp.where(live, w + 2, num_words)
    out = jnp.zeros((num_words,), jnp.uint32)
    out = out.at[w0t].add(w0, mode="drop")
    out = out.at[w1t].add(w1, mode="drop")
    out = out.at[w2t].add(w2, mode="drop")
    return out


def pack_items96_to_words(w0v: jnp.ndarray,
                          w1v: jnp.ndarray,
                          w2v: jnp.ndarray,
                          nbits: jnp.ndarray,
                          offsets: jnp.ndarray,
                          num_words: int,
                          sorted_indices: bool = True) -> jnp.ndarray:
    """Scatter up-to-96-bit items (value = w2v<<64 | w1v<<32 | w0v, low
    `nbits` significant) into a u32 word array. A 96-bit item spans at most
    4 words, so four sorted scatter-add streams — callers use this to PAIR
    adjacent <= 48-bit items, cutting the pack's scatter traffic from
    3 streams x N to 4 streams x N/2 (the design assumed a cost per
    scatter ELEMENT; not yet measured on the GPU). Offsets must be
    non-decreasing; zero-width items contribute nothing but must sit at
    their natural stream position."""
    w0v = w0v.astype(jnp.uint32)
    w1v = w1v.astype(jnp.uint32)
    w2v = w2v.astype(jnp.uint32)
    nbits = nbits.astype(jnp.int32)
    offsets = offsets.astype(jnp.int32)
    full = np.uint32(0xFFFFFFFF)

    def _m(nb):
        nb = jnp.clip(nb, 0, 32)
        return jnp.where(nb >= 32, full,
                         jnp.where(nb <= 0, np.uint32(0),
                                   full >> (np.uint32(32)
                                            - nb.astype(jnp.uint32))))
    w0v = w0v & _m(nbits)
    w1v = w1v & _m(nbits - 32)
    w2v = w2v & _m(nbits - 64)

    w = offsets >> 5
    sh = (offsets & 31).astype(jnp.uint32)
    # carry(v) = v >> (32 - sh), expressed shift-safely for sh in [0, 31]
    c0 = (w0v >> np.uint32(1)) >> (np.uint32(31) - sh)
    c1 = (w1v >> np.uint32(1)) >> (np.uint32(31) - sh)
    c2 = (w2v >> np.uint32(1)) >> (np.uint32(31) - sh)
    s0 = w0v << sh
    s1 = (w1v << sh) | c0
    s2 = (w2v << sh) | c1
    s3 = c2

    out = jnp.zeros((num_words + 3,), jnp.uint32)
    out = out.at[w].add(s0, indices_are_sorted=sorted_indices)
    out = out.at[w + 1].add(s1, indices_are_sorted=sorted_indices)
    out = out.at[w + 2].add(s2, indices_are_sorted=sorted_indices)
    out = out.at[w + 3].add(s3, indices_are_sorted=sorted_indices)
    return out[:num_words]


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Host-side: u32 LSB-first words -> byte string of ceil(total_bits/8)."""
    nbytes = (int(total_bits) + 7) // 8
    b = np.ascontiguousarray(words).view(np.uint8)
    if b.size < nbytes:  # pragma: no cover - caller sized words correctly
        raise ValueError("word buffer too small for total_bits")
    # u32 little-endian byte order == LSB-first stream order on all supported
    # hosts (x86/arm are little-endian); assert to be safe.
    if not np.little_endian:  # pragma: no cover
        b = np.ascontiguousarray(words.byteswap()).view(np.uint8)
    return b[:nbytes].tobytes()


class BitReader:
    """Host-side LSB-first bit reader over a bytes-like object.

    Mirrors the reference's (byte*, bit) cursor (src/include/globals.h:52-64)
    for the host inflater and for golden-trace tooling.
    """

    __slots__ = ("data", "pos")  # pos in bits

    def __init__(self, data: bytes, bit_pos: int = 0):
        self.data = data
        self.pos = bit_pos

    def read(self, n: int) -> int:
        """Read n bits LSB-first, advancing the cursor."""
        pos = self.pos
        end = pos + n
        if (end + 7) // 8 > len(self.data):
            raise EOFError("bit stream exhausted")
        byte0 = pos >> 3
        nbytes = ((end + 7) >> 3) - byte0
        chunk = int.from_bytes(self.data[byte0:byte0 + nbytes], "little")
        val = (chunk >> (pos & 7)) & ((1 << n) - 1)
        self.pos = end
        return val

    def peek(self, n: int) -> int:
        """Peek up to n bits without advancing (zero-padded past the end)."""
        pos = self.pos
        byte0 = pos >> 3
        nbytes = ((pos + n + 7) >> 3) - byte0
        chunk = int.from_bytes(self.data[byte0:byte0 + nbytes], "little")
        return (chunk >> (pos & 7)) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.pos += n

    def align_byte(self) -> None:
        """Advance to the next byte boundary (reference: byte_roundup
        src/include/globals.h:17)."""
        self.pos = (self.pos + 7) & ~7

    def read_bytes(self, n: int) -> bytes:
        assert self.pos % 8 == 0, "read_bytes requires byte alignment"
        start = self.pos >> 3
        if start + n > len(self.data):
            raise EOFError("byte stream exhausted")
        self.pos += 8 * n
        return self.data[start:start + n]

    @property
    def bits_left(self) -> int:
        return 8 * len(self.data) - self.pos
