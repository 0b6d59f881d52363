"""Canonical Huffman machinery (JAX, fixed-shape, jittable).

Reference analogues:
  * encode-side tree building: two-queue O(n log n) merge,
    src/h_tree.c:231-280 (h_tree_builder_build). The reference's builder is
    NOT length-limited and can exceed the 15-bit RFC 1951 cap (SURVEY §7.1);
    here we use dense package-merge instead, which is exactly optimal under
    the cap and maps to fixed-shape sort/merge passes that vmap over blocks.
  * RFC 1951 §3.2.2 canonical code assignment from code lengths:
    src/deflate_decompress.c:146-161 (form_h_tree) — vectorized counting.
  * decode-side tree: the reference walks a pointer tree bit by bit
    (src/h_tree.c:24-40); we build flat LUTs instead (host paths).

Determinism: stable sorts with leaf-before-package tie-break and
symbol-index tie-breaks, so the code lengths depend on the frequencies
alone. Whole streams can still differ between backends: the block planner
(core/cost.py) scores splits with float32 log2, whose last bits may differ.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INF_W = np.int32(1 << 28)


def histogram(symbols: jnp.ndarray, num_classes: int,
              mask: jnp.ndarray | None = None,
              weights: jnp.ndarray | None = None) -> jnp.ndarray:
    """Masked bincount with static length (i32)."""
    sym = symbols.astype(jnp.int32)
    if mask is not None:
        sym = jnp.where(mask, sym, num_classes)
    w = None if weights is None else weights.astype(jnp.int32)
    counts = jnp.bincount(sym.reshape(-1),
                          weights=None if w is None else w.reshape(-1),
                          length=num_classes + 1)
    return counts[:num_classes].astype(jnp.int32)


def histogram_rows_matmul(sym: jnp.ndarray, num_classes: int) -> jnp.ndarray:
    """Per-row histogram as one-hot × ones: (M, L) i32 symbols ->
    (M, num_classes) i32 counts. Out-of-range symbols (e.g. masked-out
    positions mapped to num_classes) match no class and drop out for free.

    A dense form chosen where scatter-adds were the scarce resource; kept
    on the GPU by a timing against a flat bincount (PERF.md).
    int8 × int8 -> int32 keeps counts exact (L <= 2^23 per row ensures no overflow anywhere near i32).
    """
    M, L = sym.shape
    cls = jnp.arange(num_classes, dtype=jnp.int32)
    oh = (sym[:, :, None] == cls[None, None, :]).astype(jnp.int8)
    ones = jnp.ones((M, 1, L), jnp.int8)
    out = jax.lax.dot_general(ones, oh, (((2,), (1,)), ((0,), (0,))),
                              preferred_element_type=jnp.int32)
    return out[:, 0, :]


def rows_lookup(sym: jnp.ndarray, tab: jnp.ndarray) -> jnp.ndarray:
    """Per-row table lookup: out[m, l] = tab[m, sym[m, l]] as u32,
    out-of-range symbols -> 0. sym (M, L) i32, tab (M, C).

    An integer gather, exact for any table word. (A float32 one-hot dot
    did the same job before; on the GPU it was slower, and at default
    precision TF32 would corrupt table words near 2^20 — PERF.md.)"""
    ok = (sym >= 0) & (sym < tab.shape[1])
    v = jnp.take_along_axis(tab, jnp.where(ok, sym, 0), axis=1)
    return jnp.where(ok, v, 0).astype(jnp.uint32)


def _package_merge_lengths(leaf_w: jnp.ndarray, k: jnp.ndarray, n: int,
                           max_bits: int) -> jnp.ndarray:
    """Optimal length-limited code lengths via dense package-merge.

    leaf_w: i32[n] ascending-sorted active leaf weights, INF-padded.
    k: active count (>= 2 for the main path; 0/1 handled by caller).
    Returns i32[n]: length of the j-th sorted leaf (0 for j >= k).

    Each level list P_l = merge(leaves, pairs(P_{l-1})) is kept as a sorted
    i32[2n] weight array plus a leaf-count prefix sum; after building L
    levels, a top-down pass m_{l-1} = 2 * (#packages among first m_l of P_l)
    yields per-level chosen-leaf counts; leaf j's length = #levels with
    j < nleaf_l. (Larmore-Hirschberg; see SURVEY §7.3 item 3.)
    """
    m2 = 2 * n
    pad = jnp.full((n,), INF_W, dtype=jnp.int32)
    leaves2 = jnp.concatenate([leaf_w, pad])            # i32[2n]
    leaf_flag2 = jnp.concatenate([jnp.ones((n,), jnp.int32),
                                  jnp.zeros((n,), jnp.int32)])

    def cumleaf(w, f):
        is_leaf = f * (w < INF_W)
        return jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                jnp.cumsum(is_leaf)])

    # Level 1 list = leaves only; levels 2..L built by a scan (one compiled
    # merge body instead of max_bits-1 unrolled copies — keeps the HLO, and
    # the compile time, small).
    cum1 = cumleaf(leaves2, leaf_flag2)

    jn = jnp.arange(n, dtype=jnp.int32)

    def level_step(w, _):
        # Both merge inputs are already sorted ascending (leaves by
        # construction; adjacent-pair sums of a sorted list), so the merge is
        # a rank computation — a compare matrix + two n-element scatters —
        # instead of a stable argsort (the 14 level sorts were once the bulk
        # of the encoder's tree stage).
        pw = jnp.minimum(w.reshape(n, 2).sum(axis=1), INF_W)  # pairs; INF abs.
        lv = leaves2[:n]
        # ties: leaf before package (same key rule as the reference's
        # two-queue pop order, src/h_tree.c:192-229)
        rank_l = jn + jnp.sum(pw[None, :] < lv[:, None], axis=1)
        rank_p = jn + jnp.sum(lv[None, :] <= pw[:, None], axis=1)
        w2 = jnp.full((m2,), INF_W, jnp.int32).at[rank_l].set(lv)
        w2 = w2.at[rank_p].set(pw)
        f2 = jnp.zeros((m2,), jnp.int32).at[rank_l].set(1)
        return w2, cumleaf(w2, f2)

    _, cums = jax.lax.scan(level_step, leaves2, None, length=max_bits - 1)
    levels_cumleaf = jnp.concatenate([cum1[None], cums], axis=0)  # (L, 2n+1)

    # Top-down: choose first 2k-2 items at the deepest level.
    def down_step(m, cum):
        nleaf = cum[jnp.clip(m, 0, m2)]
        return 2 * (m - nleaf), nleaf

    m0 = jnp.maximum(2 * k - 2, 0)
    _, nleafs = jax.lax.scan(down_step, m0, levels_cumleaf, reverse=True)
    # nleafs[l] = chosen-leaf count at depth l+1

    j = jnp.arange(n, dtype=jnp.int32)
    length = jnp.sum((j[None, :] < nleafs[:, None]).astype(jnp.int32), axis=0)
    return jnp.where(j < k, length, 0)


def huffman_code_lengths(freqs: jnp.ndarray, max_bits: int = 15) -> jnp.ndarray:
    """Optimal length-limited Huffman code lengths for one alphabet.

    freqs: i32[n] symbol frequencies (0 = unused symbol).
    Returns i32[n] code lengths in 0..max_bits; deterministic: among active
    symbols, lower frequency => longer code, ties by symbol index.
    """
    n = freqs.shape[-1]
    freqs = freqs.astype(jnp.int32)
    active = freqs > 0
    k = jnp.sum(active.astype(jnp.int32))

    key = jnp.where(active, freqs, INF_W)
    order = jnp.argsort(key, stable=True)   # (freq asc, symbol asc)
    leaf_w = key[order]

    length_sorted = _package_merge_lengths(leaf_w, k, n, max_bits)
    # k == 1: single active symbol gets length 1.
    j = jnp.arange(n, dtype=jnp.int32)
    length_sorted = jnp.where(k == 1, jnp.where(j == 0, 1, 0), length_sorted)

    lengths = jnp.zeros((n,), jnp.int32).at[order].set(length_sorted)
    return jnp.where(active, lengths, 0)


def canonical_codes(lengths: jnp.ndarray, max_bits: int = 15) -> jnp.ndarray:
    """RFC 1951 §3.2.2 canonical codes from code lengths (jittable).

    Returns u32[n] codes (MSB-first convention, NOT yet bit-reversed for the
    LSB-first stream). Reference: form_h_tree src/deflate_decompress.c:146-161.
    """
    n = lengths.shape[-1]
    lengths = lengths.astype(jnp.int32)
    bl_count = histogram(lengths, max_bits + 1, mask=lengths > 0)

    code = jnp.int32(0)
    ncs = [jnp.int32(0)]
    blc = bl_count.at[0].set(0)
    for l in range(1, max_bits + 1):
        code = (code + blc[l - 1]) << 1
        ncs.append(code)
    next_code = jnp.stack(ncs)  # i32[max_bits+1]

    # rank among symbols of the same length, by symbol order
    onehot = (lengths[:, None] == jnp.arange(max_bits + 1)[None, :]).astype(jnp.int32)
    ranks = jnp.cumsum(onehot, axis=0) - onehot  # exclusive
    rank = jnp.take_along_axis(ranks, lengths[:, None], axis=1)[:, 0]

    codes = next_code[lengths] + rank
    return jnp.where(lengths > 0, codes, 0).astype(jnp.uint32)


@functools.partial(jax.jit, static_argnums=(1,))
def build_code_table(freqs: jnp.ndarray, max_bits: int = 15):
    """freqs -> (lengths, codes) for one alphabet."""
    lengths = huffman_code_lengths(freqs, max_bits)
    codes = canonical_codes(lengths, max_bits)
    return lengths, codes


# ---------------------------------------------------------------------------
# Host-side decode LUTs (numpy) for the inflater.
# ---------------------------------------------------------------------------

def canonical_codes_np(lengths: np.ndarray, max_bits: int = 15) -> np.ndarray:
    """numpy mirror of canonical_codes for host decode paths."""
    lengths = np.asarray(lengths, dtype=np.int64)
    n = lengths.shape[0]
    bl_count = np.bincount(lengths, minlength=max_bits + 1)
    bl_count[0] = 0
    next_code = np.zeros(max_bits + 1, dtype=np.int64)
    code = 0
    for l in range(1, max_bits + 1):
        code = (code + bl_count[l - 1]) << 1
        next_code[l] = code
    codes = np.zeros(n, dtype=np.int64)
    cnt = np.zeros(max_bits + 1, dtype=np.int64)
    for s in range(n):
        l = lengths[s]
        if l > 0:
            codes[s] = next_code[l] + cnt[l]
            cnt[l] += 1
    return codes.astype(np.uint32)


def decode_lut_np(lengths: np.ndarray, max_bits: int = 15):
    """Flat LUT decoder table from code lengths (numpy host path).

    Returns (sym_lut, len_lut) of size 2^max_bits: index with the next
    max_bits stream bits (LSB-first peek); sym_lut gives the symbol and
    len_lut how many bits to consume. Unused patterns get len 0 (invalid).
    Raises ValueError on over-subscribed code lengths.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    n = lengths.shape[0]
    size = 1 << max_bits
    sym_lut = np.full(size, -1, dtype=np.int32)
    len_lut = np.zeros(size, dtype=np.int32)
    codes = canonical_codes_np(lengths, max_bits)

    kraft = int(np.sum((lengths > 0) * (1 << (max_bits - np.minimum(lengths, max_bits)))))
    if kraft > size:
        raise ValueError("over-subscribed Huffman code lengths")

    for s in range(n):
        l = int(lengths[s])
        if l == 0:
            continue
        c = int(codes[s])
        r = 0
        cc = c
        for _ in range(l):
            r = (r << 1) | (cc & 1)
            cc >>= 1
        idx = np.arange(r, size, 1 << l)
        sym_lut[idx] = s
        len_lut[idx] = l
    return sym_lut, len_lut
