"""DEFLATE shard encoder: tokens -> RFC 1951 bitstream (fixed-shape JAX).

This is the encode-side mirror of the reference's (unfinished) compressor:
where src/deflate_compress.c:269,279 says "// TODO: write lit / len,dist",
this module actually serializes. Architecture (data-parallel, SURVEY §7):

  * One shard (S bytes, S % 32768 == 0) is tokenized once by core/lz77 with a
    true 32 KB window crossing block boundaries (RFC window semantics).
  * The shard is cut into NB = S/32768 coding blocks. Per block we compute
    litlen/dist histograms (segmented bincount), optimal length-limited
    Huffman tables (core/huffman, vmapped), the RLE-coded code-length tree
    (vectorized run detection, mirroring h_tree_d_lens src/h_tree.c:75-148
    including runs that carry from the litlen into the dist lengths), and the
    exact bit cost of stored/fixed/dynamic encodings; the cheapest block type
    wins (reference README.md:15-20's optimization goal 2).
  * Serialization is ONE uniform item list: every field (3-bit header, 14-bit
    HLIT/HDIST/HCLEN, tree lengths, RLE symbols, Huffman-coded tokens, stored
    payload words) becomes a (value, nbits, absolute bit offset) triple, and
    core/bits.pack_items_to_words scatters them all in parallel. The only
    sequential piece is a tiny per-block scan (NB steps) resolving stored-
    block byte-alignment padding.
  * A non-final shard ends with an empty stored block (sync flush), so shard
    substreams are byte-aligned and concatenate into one valid DEFLATE
    stream — this is what makes multi-chip data-parallel encoding format-
    legal (SURVEY §2.2).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import bits as bits_mod
from ..core import huffman, lz77
from . import constants as C

BLOCK = C.WINDOW_SIZE            # 32768 input bytes per coding block
_RLE_SLOTS = 316                 # max hlit (286) + max hdist (30)
# header slots: 3-bit hdr | 14-bit dynhdr | 19 clen | RLE (code+extra merged,
# <= 14 bits each) | stored pad | LEN/NLEN | EOB (offset overridden to the
# block's token end — still row-monotone, since token end <= next block's
# base). Stored PAYLOADS are NOT items: they are byte-aligned contiguous
# ranges, written with per-block shifted-slice ORs after the packs (round 5
# — the 64-bit payload item rows cost ~3x8K scatter elements per block even
# when zero-width, since the sorted streams cannot drop them).
_H_ITEMS = 1 + 1 + 19 + _RLE_SLOTS + 1 + 1 + 1
_SLOT_PAD = 337
_SLOT_LENNLEN = 338
_SLOT_EOB = _H_ITEMS - 1
TREE_LIMIT = 11          # emitted Huffman code-length cap (RFC allows 15;
                         # 11 keeps decode LUTs at 2^11 — see encode_shard)

# Fixed-tree tables as host constants (codes already canonical per RFC).
_FIXED_LL_LEN = C.FIXED_LITLEN_LENGTHS[:C.NUM_LITLEN]
_FIXED_LL_CODE = None
_FIXED_D_LEN = C.FIXED_DIST_LENGTHS[:C.NUM_DIST]
_FIXED_D_CODE = None


def out_words(shard_size: int) -> int:
    """Worst-case output capacity (u32 words) for a shard of `shard_size`:
    merged incompressible blocks can't use stored but fixed caps literals at
    9 bits/byte; 42 covers per-block headers + padding."""
    nb = shard_size // BLOCK
    return (nb * (42 + 9 * BLOCK) + 96) // 32


def _init_fixed_tables():
    global _FIXED_LL_CODE, _FIXED_D_CODE
    from ..core.huffman import canonical_codes_np
    _FIXED_LL_CODE = canonical_codes_np(C.FIXED_LITLEN_LENGTHS, 15)[:C.NUM_LITLEN]
    _FIXED_D_CODE = canonical_codes_np(C.FIXED_DIST_LENGTHS, 15)[:C.NUM_DIST]


_init_fixed_tables()


def _ilog2(v: jnp.ndarray) -> jnp.ndarray:
    """floor(log2(v)) for v >= 1, elementwise, exact for v < 2^24 (f32
    mantissa width): the float's biased exponent IS the answer. Replaces
    the reference's __builtin_clz (src/deflate_compress.c:182-217) — and
    replaces full-shard LUT gathers with pure elementwise math."""
    f = v.astype(jnp.float32)
    return (jax.lax.bitcast_convert_type(f, jnp.int32) >> 23) - 127


def _len_fields(length: jnp.ndarray):
    """Closed-form RFC 1951 §3.2.5 Table 1 mapping: match length (3..258) ->
    (code 257..285, extra_val, extra_bits). Mirrors get_len_code
    (src/deflate_compress.c:182-200) as elementwise vector math; no gathers.
    Callers mask non-match positions."""
    m = jnp.clip(length - C.MIN_MATCH, 0, 255)
    k = _ilog2(jnp.maximum(m, 1))
    eb = jnp.maximum(k - 2, 0)
    code_hi = 257 + 4 * (k - 1) + ((m - (1 << k)) >> eb)
    code = jnp.where(m < 8, 257 + m, code_hi)
    code = jnp.where(m >= 255, 285, code)           # length 258 is exact
    eb = jnp.where((m < 8) | (m >= 255), 0, eb)
    ev = m & ((1 << eb) - 1)
    return code, ev, eb


def _dist_fields(dist: jnp.ndarray):
    """Closed-form RFC 1951 §3.2.5 Table 2 mapping: distance (1..32768) ->
    (code 0..29, extra_val, extra_bits). Mirrors get_dist_code
    (src/deflate_compress.c:202-217); elementwise, no gathers."""
    v = jnp.maximum(dist, 1) - 1                    # 0..32767
    k = _ilog2(jnp.maximum(v, 1))
    code_hi = 2 * k + (v >> (k - 1)) - 2
    code = jnp.where(v < 4, v, code_hi)
    eb = jnp.where(v < 4, 0, k - 1)
    ev = v & ((1 << eb) - 1)
    return code, ev, eb


def _force_two_codes(freqs: jnp.ndarray) -> jnp.ndarray:
    """Ensure at least two active symbols per tree (zlib build_tree does the
    same) so transmitted trees are complete and strict inflaters accept them.
    freqs: (NB, n)."""
    cnt = jnp.sum((freqs > 0).astype(jnp.int32), axis=1)
    f0 = freqs[:, 0]
    add0 = ((cnt == 0) | ((cnt == 1) & (f0 == 0))).astype(jnp.int32)
    add1 = ((cnt == 0) | ((cnt == 1) & (f0 > 0))).astype(jnp.int32)
    return freqs.at[:, 0].add(add0).at[:, 1].add(add1)


def _tree_rle(comb: jnp.ndarray, total: jnp.ndarray):
    """Vectorized RLE of code-length sequences (RFC 1951 §3.2.7 symbols
    0-18). comb: i32[NB, 316] concatenated litlen+dist lengths (-1 past
    `total`). Returns (sym, extra_val, extra_bits) each i32[NB, 316] with
    sym == -1 where position t emits nothing.

    Each position decides independently what symbol (if any) begins there,
    from its run's (value, start, length) — no scan. Runs may cross the
    litlen/dist boundary exactly like the reference's carry-over rule
    (src/h_tree.c:89-101, src/deflate_decompress.c:223-231).
    """
    NB, W = comb.shape
    t = jnp.arange(W, dtype=jnp.int32)[None, :]

    prev = jnp.concatenate([jnp.full((NB, 1), -2, jnp.int32), comb[:, :-1]], axis=1)
    neq = comb != prev                               # run starts
    rs = jax.lax.cummax(jnp.where(neq, t, -1), axis=1)
    # next run start strictly after t (or W)
    nxt = jnp.where(neq, t, W)
    ns = jnp.flip(jax.lax.cummin(jnp.flip(nxt, axis=1), axis=1), axis=1)
    ns = jnp.concatenate([ns[:, 1:], jnp.full((NB, 1), W, jnp.int32)], axis=1)
    ne = jnp.minimum(ns, total[:, None])             # run end (exclusive)

    r = ne - rs                                      # run length
    o = t - rs                                       # offset within run
    v = comb

    valid = (t < total[:, None]) & (v >= 0)

    # ---- v != 0 ----
    n_rep = r - 1
    q6 = n_rep // 6
    m6 = n_rep - 6 * q6
    j = o - 1
    nz_first = o == 0
    nz_full16 = (j >= 0) & (j < 6 * q6) & (j % 6 == 0)
    nz_tail16 = (m6 >= 3) & (j == 6 * q6)
    nz_lit = (m6 < 3) & (j >= 6 * q6) & (j >= 0)
    nz_sym = jnp.where(nz_first | nz_lit, v,
                       jnp.where(nz_full16 | nz_tail16, 16, -1))
    nz_ebits = jnp.where(nz_full16 | nz_tail16, 2, 0)
    nz_eval = jnp.where(nz_full16, 6 - 3, jnp.where(nz_tail16, m6 - 3, 0))

    # ---- v == 0 ----
    q138 = r // 138
    m138 = r - 138 * q138
    in_full = o < 138 * q138
    z_full18 = in_full & (o % 138 == 0)
    o2 = o - 138 * q138
    z_tail18 = (~in_full) & (m138 >= 11) & (o2 == 0)
    z_tail17 = (~in_full) & (m138 >= 3) & (m138 < 11) & (o2 == 0)
    z_lit = (~in_full) & (m138 < 3)
    z_sym = jnp.where(z_full18 | z_tail18, 18,
                      jnp.where(z_tail17, 17, jnp.where(z_lit, 0, -1)))
    z_ebits = jnp.where(z_full18 | z_tail18, 7, jnp.where(z_tail17, 3, 0))
    z_eval = jnp.where(z_full18, 138 - 11,
                       jnp.where(z_tail18, m138 - 11,
                                 jnp.where(z_tail17, m138 - 3, 0)))

    is_zero = v == 0
    sym = jnp.where(is_zero, z_sym, nz_sym)
    ebits = jnp.where(is_zero, z_ebits, nz_ebits)
    evals = jnp.where(is_zero, z_eval, nz_eval)

    sym = jnp.where(valid, sym, -1)
    ebits = jnp.where(valid & (sym >= 0), ebits, 0)
    evals = jnp.where(valid & (sym >= 0), evals, 0)
    return sym, evals, ebits


def encode_shard(data: jnp.ndarray, valid_len: jnp.ndarray,
                 final: jnp.ndarray, num_candidates: int = 32,
                 lazy: bool = True, adaptive_blocks: bool = True,
                 max_merge: int = 8, force_btype: int | None = None,
                 _test_stride: int | None = None):
    """Encode one shard into a DEFLATE bitstream (jit-friendly, fixed shape).

    Args:
      data: u8[S], S % 32768 == 0, S >= 32768.
      valid_len: i32 scalar in [1, S].
      final: bool scalar — if True the last block gets BFINAL and no sync
        flush; if False a byte-aligning empty stored block is appended.
      adaptive_blocks: choose coding-block boundaries with the tile-histogram
        cost model (core/cost.py — the AHT chunk-split capability,
        reference README.md:15-20) instead of fixed 32 KB blocks.
      max_merge: max 32 KB tiles merged into one coding block.
      force_btype: None for cost-based selection, or BTYPE_STORED/FIXED/
        DYNAMIC to force every block's type (BASELINE config 1 emits a whole
        file as ONE fixed-Huffman block: force_btype=1 merges the shard into
        a single block since fixed blocks carry no tree cost).

    Returns dict: words u32[OW], total_bits i32, plus per-block stats.
    """
    S = data.shape[0]
    assert S % BLOCK == 0 and S >= BLOCK
    NB = S // BLOCK                  # tiles == max number of coding blocks
    OUT_WORDS = out_words(S)

    data = data.astype(jnp.uint8)
    valid_len = valid_len.astype(jnp.int32)
    pos = jnp.arange(S, dtype=jnp.int32)
    micro_of_pos = pos // BLOCK
    b_idx = jnp.arange(NB, dtype=jnp.int32)
    LB_micro = jnp.maximum((valid_len - 1) // BLOCK, 0)

    # ------------------------------------------------------------------ LZ77
    tok = lz77.tokenize(data, valid_len, num_candidates=num_candidates,
                        lazy=lazy)
    chosen, length, dist = tok["chosen"], tok["length"], tok["dist"]

    # Token fields at position granularity — closed-form code mappings
    # (_len_fields/_dist_fields): zero table gathers on the hot S-sized path.
    is_match = chosen & (length >= C.MIN_MATCH)
    len_extra = jnp.asarray(C.LENGTH_EXTRA)
    dist_extra = jnp.asarray(C.DIST_EXTRA)

    lcode, lev, leb = _len_fields(length)
    ll_sym_pos = jnp.where(is_match, lcode, data.astype(jnp.int32))
    ll_ev_pos = jnp.where(is_match, lev, 0)
    ll_eb_pos = jnp.where(is_match, leb, 0)
    dcode, dev_, deb_ = _dist_fields(dist)
    d_sym_pos = jnp.where(is_match, dcode, 0)
    d_ev_pos = jnp.where(is_match, dev_, 0)
    d_eb_pos = jnp.where(is_match, deb_, 0)

    # -------------------------------------------------------- block planning
    # Per-tile histograms at position granularity: sufficient statistics for
    # the split DP AND (segment-summed) for the per-block Huffman trees, so
    # the token-slot arrays never need re-histogramming. Computed as an int8
    # one-hot × ones dot (core/huffman.histogram_rows_matmul); masked
    # positions map to the dropped class num_classes.
    ll_sym_t = jnp.where(chosen, ll_sym_pos, C.NUM_LITLEN)
    ll_freq_micro = huffman.histogram_rows_matmul(
        ll_sym_t.reshape(NB, BLOCK), C.NUM_LITLEN)
    d_sym_t = jnp.where(is_match, d_sym_pos, C.NUM_DIST)
    d_freq_micro = huffman.histogram_rows_matmul(
        d_sym_t.reshape(NB, BLOCK), C.NUM_DIST)

    if force_btype == C.BTYPE_FIXED and NB > 1:
        # fixed blocks carry no tree description: one block for the shard
        split = jnp.zeros((NB,), jnp.bool_).at[0].set(True)
    elif force_btype == C.BTYPE_STORED:
        split = jnp.ones((NB,), jnp.bool_)   # LEN is 16-bit: one per tile
    elif adaptive_blocks and NB > 1:
        from ..core.cost import block_plan
        tile_bytes = jnp.clip(valid_len - b_idx * BLOCK, 0, BLOCK)
        split, _ = block_plan(ll_freq_micro, d_freq_micro, LB_micro + 1,
                              max_merge=max_merge, tile_bytes=tile_bytes)
        split = split.at[0].set(True)
    else:
        split = jnp.ones((NB,), jnp.bool_)

    blk_id_micro = jnp.cumsum(split.astype(jnp.int32)) - 1     # i32[NB]
    # per-position block id as a broadcast (repeat of a static factor lowers
    # to reshape), NOT an S-sized gather
    blk_of_pos = jnp.repeat(blk_id_micro, BLOCK, total_repeat_length=S)
    LB = blk_id_micro[LB_micro]                  # last emitted coding block
    b_emitted = b_idx <= LB

    # start/end tile of each coding block (NB buckets, tail unused)
    m_idx = jnp.arange(NB, dtype=jnp.int32)
    start_micro = jnp.full((NB,), NB, jnp.int32).at[
        jnp.where(split, blk_id_micro, NB)].min(m_idx, mode="drop")
    end_micro = jnp.concatenate([start_micro[1:], jnp.array([NB], jnp.int32)])
    end_micro = jnp.minimum(end_micro, NB)
    # unused buckets (b > LB) have start == NB: clamp for safe indexing,
    # their items are masked by b_emitted everywhere
    start_micro_c = jnp.minimum(start_micro, NB - 1)
    end_micro = jnp.maximum(end_micro, start_micro_c + 1)
    n_micros_b = end_micro - start_micro_c
    start_pos_b = start_micro_c * BLOCK
    end_pos_b = jnp.minimum(end_micro * BLOCK, S)

    # ------------------------------------------------------- histograms/trees
    # Per-block histograms = segment-sum of the tile histograms (NB-row
    # scatter, ~2K elements) + one EOB per emitted block — no T-sized
    # re-histogramming of the token slots.
    ll_freq = jnp.zeros((NB, C.NUM_LITLEN), jnp.int32).at[
        blk_id_micro].add(ll_freq_micro)
    ll_freq = ll_freq.at[:, C.EOB].add(b_emitted.astype(jnp.int32))
    d_freq = jnp.zeros((NB, C.NUM_DIST), jnp.int32).at[
        blk_id_micro].add(d_freq_micro)

    ll_freq_t = _force_two_codes(ll_freq)
    d_freq_t = _force_two_codes(d_freq)

    # Trees are length-limited to TREE_LIMIT (< the RFC's 15): package-
    # merge at 11 cost +0.07% on a text literal histogram and once let the
    # device decoder build 2^11 LUTs instead of 2^15 (that decoder has
    # since dropped its LUTs). Any conformant inflater accepts the streams
    # (11 <= 15).
    #
    # The dist alphabet rides the SAME vmapped package-merge as litlen
    # (zero-padded 30 -> 286): the extra inactive symbols change nothing
    # (package-merge ignores zero-frequency leaves) and one 2NB-wide level
    # scan replaces two sequential scan pipelines — the level steps are
    # tiny, so their count (not their width) is what costs.
    build_lim = jax.vmap(
        lambda f: huffman.huffman_code_lengths(f, TREE_LIMIT))
    d_freq_pad = jnp.concatenate(
        [d_freq_t, jnp.zeros((NB, C.NUM_LITLEN - C.NUM_DIST), jnp.int32)],
        axis=1)
    both_len = build_lim(jnp.concatenate([ll_freq_t, d_freq_pad], axis=0))
    ll_len_dyn = both_len[:NB]                            # (NB, 286)
    d_len_dyn = both_len[NB:, :C.NUM_DIST]                # (NB, 30)
    codes_lim = jax.vmap(lambda l: huffman.canonical_codes(l, TREE_LIMIT))
    both_code = codes_lim(both_len)
    ll_code_dyn = both_code[:NB]
    d_code_dyn = both_code[NB:, :C.NUM_DIST]

    # ------------------------------------------------- tree description (RLE)
    sym_max = jnp.max(jnp.where(ll_len_dyn > 0,
                                jnp.arange(C.NUM_LITLEN)[None, :], 0), axis=1)
    hlit = jnp.maximum(sym_max + 1, 257)
    dmax = jnp.max(jnp.where(d_len_dyn > 0,
                             jnp.arange(C.NUM_DIST)[None, :], 0), axis=1)
    hdist = jnp.maximum(dmax + 1, 1)
    total_lens = hlit + hdist

    t_idx = jnp.arange(_RLE_SLOTS, dtype=jnp.int32)[None, :]
    in_ll = t_idx < hlit[:, None]
    ll_idx = jnp.broadcast_to(jnp.clip(t_idx, 0, C.NUM_LITLEN - 1),
                              (NB, _RLE_SLOTS))
    d_idx = jnp.clip(t_idx - hlit[:, None], 0, C.NUM_DIST - 1)
    ll_part = jnp.take_along_axis(ll_len_dyn, ll_idx, axis=1)
    d_part = jnp.take_along_axis(d_len_dyn, d_idx, axis=1)
    comb = jnp.where(in_ll, ll_part, d_part)
    comb = jnp.where(t_idx < total_lens[:, None], comb, -1)

    rle_sym, rle_ev, rle_eb = _tree_rle(comb, total_lens)
    rle_emitted = rle_sym >= 0

    clen_key = b_idx[:, None] * C.NUM_CLEN + jnp.maximum(rle_sym, 0)
    clen_freq = huffman.histogram(clen_key, NB * C.NUM_CLEN,
                                  mask=rle_emitted).reshape(NB, C.NUM_CLEN)
    clen_freq_t = _force_two_codes(clen_freq)
    clen_len = jax.vmap(lambda f: huffman.huffman_code_lengths(f, 7))(clen_freq_t)
    clen_code = jax.vmap(lambda l: huffman.canonical_codes(l, 7))(clen_len)

    clen_order = jnp.asarray(C.CLEN_ORDER)
    lens_perm = clen_len[:, clen_order]                  # (NB, 19)
    perm_max = jnp.max(jnp.where(lens_perm > 0,
                                 jnp.arange(C.NUM_CLEN)[None, :], 0), axis=1)
    hclen = jnp.maximum(perm_max + 1, 4)

    # ------------------------------------------------------------- bit costs
    ll_extra_tot = jnp.sum(ll_freq[:, 257:286] * len_extra[None, :], axis=1)
    d_extra_tot = jnp.sum(d_freq * dist_extra[None, :], axis=1)

    dyn_payload = (jnp.sum(ll_freq * ll_len_dyn, axis=1) + ll_extra_tot
                   + jnp.sum(d_freq * d_len_dyn, axis=1) + d_extra_tot)
    rle_bits_mat = jnp.where(
        rle_emitted,
        jnp.take_along_axis(clen_len, jnp.maximum(rle_sym, 0), axis=1) + rle_eb,
        0)
    tree_bits = 14 + 3 * hclen + jnp.sum(rle_bits_mat, axis=1)
    dyn_cost = 3 + tree_bits + dyn_payload

    fll = jnp.asarray(_FIXED_LL_LEN)
    fdl = jnp.asarray(_FIXED_D_LEN)
    fix_cost = (3 + jnp.sum(ll_freq * fll[None, :], axis=1) + ll_extra_tot
                + jnp.sum(d_freq * fdl[None, :], axis=1) + d_extra_tot)

    blen = jnp.clip(jnp.minimum(end_pos_b, valid_len) - start_pos_b, 0, S)
    sto_cost = 3 + 7 + 32 + 8 * blen
    # stored blocks are emitted single-tile only (LEN field is 16-bit)
    sto_cost = jnp.where(n_micros_b == 1, sto_cost, jnp.int32(1 << 30))

    costs = jnp.stack([sto_cost, fix_cost, dyn_cost], axis=1)
    btype = jnp.argmin(costs, axis=1).astype(jnp.int32)  # 0/1/2 == RFC BTYPE
    if force_btype is not None:
        btype = jnp.full_like(btype, force_btype)

    # Effective per-block code tables for token emission.
    use_dyn = (btype == C.BTYPE_DYNAMIC)[:, None]
    ll_len_eff = jnp.where(use_dyn, ll_len_dyn, fll[None, :])
    d_len_eff = jnp.where(use_dyn, d_len_dyn, fdl[None, :])
    ll_code_eff = jnp.where(use_dyn, ll_code_dyn,
                            jnp.asarray(_FIXED_LL_CODE.astype(np.int32))[None, :])
    d_code_eff = jnp.where(use_dyn, d_code_dyn,
                           jnp.asarray(_FIXED_D_CODE.astype(np.int32))[None, :])
    ll_code_rev = bits_mod.reverse_bits(ll_code_eff.astype(jnp.uint32),
                                        ll_len_eff)
    d_code_rev = bits_mod.reverse_bits(d_code_eff.astype(jnp.uint32),
                                       d_len_eff)
    # fuse (code, len) into one table word so token lookup is ONE gather per
    # alphabet (code <= 15 bits, len <= 4 bits at bit 16)
    ll_tab = ll_code_rev | (ll_len_eff.astype(jnp.uint32) << np.uint32(16))
    d_tab = d_code_rev | (d_len_eff.astype(jnp.uint32) << np.uint32(16))

    # ------------------------------------------------------------ token items
    # Items are FINISHED at position granularity — one per-row table
    # lookup per alphabet (huffman.rows_lookup); each token is ONE <= 48-bit
    # (lo, hi, nbits) item at its own position.
    tabv_ll = huffman.rows_lookup(
        ll_sym_t.reshape(NB, BLOCK),
        ll_tab[blk_id_micro]).reshape(S)                 # code_rev | len<<16
    tabv_d = huffman.rows_lookup(
        d_sym_t.reshape(NB, BLOCK), d_tab[blk_id_micro]).reshape(S)

    huff_b = (btype != C.BTYPE_STORED) & b_emitted           # (NB,)
    huff_pos = jnp.repeat(huff_b[blk_id_micro], BLOCK,
                          total_repeat_length=S)             # no S-gather

    tk_ll_bits = (tabv_ll >> np.uint32(16)).astype(jnp.int32)
    tk_ll_code = tabv_ll & np.uint32(0xFFFF)
    tk_d_bits = (tabv_d >> np.uint32(16)).astype(jnp.int32)
    tk_d_code = tabv_d & np.uint32(0xFFFF)

    # ONE 48-bit item per token: litlen code+extra (<= 20 bits) in the low
    # bits, dist code+extra (<= 28 bits) above it.
    it_ll_val = (tk_ll_code
                 | (ll_ev_pos.astype(jnp.uint32) << tk_ll_bits.astype(jnp.uint32)))
    it_ll_nb = jnp.where(huff_pos, tk_ll_bits + ll_eb_pos, 0)
    it_d_val = (tk_d_code
                | (d_ev_pos.astype(jnp.uint32) << tk_d_bits.astype(jnp.uint32)))
    it_d_nb = jnp.where(huff_pos & is_match, tk_d_bits + d_eb_pos, 0)

    sh_a = it_ll_nb.astype(jnp.uint32)
    lo_pos = it_ll_val | (it_d_val << sh_a)
    hi_pos = (it_d_val >> np.uint32(1)) >> (np.uint32(31) - sh_a)
    nbs_pos = (it_ll_nb + it_d_nb).astype(jnp.uint32)    # <= 48

    # The token stream packs DIRECTLY at position granularity: lo/hi/nbs are
    # already per-position (nbits 0 where no token starts), and offsets are
    # one exclusive cumsum rebased per block — so the position->slot row
    # scatter, the T-sized offset gathers and the slot arrays all disappear
    # (each was costly as designed). EOBs ride the header
    # item matrix (_SLOT_EOB), placed at each block's token end.
    nbs_chosen = jnp.where(chosen, nbs_pos.astype(jnp.int32), 0)
    micro_bits = jnp.sum(nbs_chosen.reshape(NB, BLOCK), axis=1)
    T_b = jnp.zeros((NB,), jnp.int32).at[blk_id_micro].add(micro_bits)
    P_excl = jnp.cumsum(nbs_chosen) - nbs_chosen         # (S,) exclusive

    # EOB item (symbol 256) per emitted huffman block.
    eob_tab = ll_tab[:, C.EOB]
    eob_nbs = jnp.where(huff_b, eob_tab >> np.uint32(16), np.uint32(0))

    # ----------------------------------------------------------- header items
    hdr_lo = jnp.zeros((NB, _H_ITEMS), jnp.uint32)
    hdr_hi = jnp.zeros((NB, _H_ITEMS), jnp.uint32)
    hdr_nbs = jnp.zeros((NB, _H_ITEMS), jnp.int32)

    is_dyn = btype == C.BTYPE_DYNAMIC
    is_sto = btype == C.BTYPE_STORED
    bfinal = (b_idx == LB) & final
    hdr_lo = hdr_lo.at[:, 0].set(
        (bfinal.astype(jnp.uint32)) | (btype.astype(jnp.uint32) << 1))
    hdr_nbs = hdr_nbs.at[:, 0].set(jnp.where(b_emitted, 3, 0))

    dynhdr = ((hlit - 257) | ((hdist - 1) << 5) | ((hclen - 4) << 10)).astype(jnp.uint32)
    hdr_lo = hdr_lo.at[:, 1].set(dynhdr)
    hdr_nbs = hdr_nbs.at[:, 1].set(jnp.where(b_emitted & is_dyn, 14, 0))

    j19 = jnp.arange(19)[None, :]
    hdr_lo = hdr_lo.at[:, 2:21].set(lens_perm.astype(jnp.uint32))
    hdr_nbs = hdr_nbs.at[:, 2:21].set(
        jnp.where((b_emitted & is_dyn)[:, None] & (j19 < hclen[:, None]), 3, 0))

    # RLE symbol + its extra bits merged into ONE <= 14-bit item per slot
    clen_code_rev = bits_mod.reverse_bits(clen_code, clen_len, 7)
    rle_code = jnp.take_along_axis(clen_code_rev, jnp.maximum(rle_sym, 0), axis=1)
    rle_code_bits = jnp.take_along_axis(clen_len, jnp.maximum(rle_sym, 0), axis=1)
    emit_mask = (b_emitted & is_dyn)[:, None] & rle_emitted
    rle_val = (rle_code.astype(jnp.uint32)
               | (rle_ev.astype(jnp.uint32) << rle_code_bits.astype(jnp.uint32)))
    hdr_lo = hdr_lo.at[:, 21:21 + _RLE_SLOTS].set(rle_val)
    hdr_nbs = hdr_nbs.at[:, 21:21 + _RLE_SLOTS].set(
        jnp.where(emit_mask, rle_code_bits + rle_eb, 0))

    # stored: pad (slot filled after the scan), LEN/NLEN, payload
    lennlen = (blen.astype(jnp.uint32)
               | ((~blen.astype(jnp.uint32) & np.uint32(0xFFFF)) << np.uint32(16)))
    hdr_lo = hdr_lo.at[:, _SLOT_LENNLEN].set(lennlen)
    hdr_nbs = hdr_nbs.at[:, _SLOT_LENNLEN].set(
        jnp.where(b_emitted & is_sto, 32, 0))

    # per-tile payload WORDS for the stored-block slice writes below
    # (elementwise reshape; stored blocks are always single-tile — the cost
    # table bars merged stored blocks)
    q = data.reshape(S // 4, 4).astype(jnp.uint32)
    tile_words = (q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16)
                  | (q[:, 3] << 24)).reshape(NB, BLOCK // 4)

    # EOB: last item of each block's row; its offset is overridden below to
    # the block's token end (monotone: token end <= next block's base).
    hdr_lo = hdr_lo.at[:, _SLOT_EOB].set(eob_tab & np.uint32(0x7FFF))
    hdr_nbs = hdr_nbs.at[:, _SLOT_EOB].set(eob_nbs.astype(jnp.int32))

    # --------------------------------------------- block layout scan (NB steps)
    hdr_fixed = jnp.sum(hdr_nbs, axis=1)     # without pad; WITH the EOB item
    pay_bits_b = jnp.where(b_emitted & is_sto, 8 * blen, 0)

    def layout_step(p, b):
        pad = jnp.where(b_emitted[b] & is_sto[b], (8 - ((p + 3) % 8)) % 8, 0)
        block_total = hdr_fixed[b] + pad + T_b[b] + pay_bits_b[b]
        return p + block_total, (p, pad)

    # data-dependent zero init keeps the carry's varying-axis type stable
    # under shard_map (see core/lz77.greedy_parse)
    p0 = jnp.int32(0) + hdr_fixed[0] * 0
    p_end, (block_base, pad_b) = jax.lax.scan(layout_step, p0, b_idx)

    hdr_nbs = hdr_nbs.at[:, _SLOT_PAD].set(pad_b)

    # Tail: sync flush when not final (empty stored block + byte align).
    sf_pad = (8 - ((p_end + 3) % 8)) % 8
    tail_vals = jnp.array([0, 0, 0xFFFF0000], dtype=jnp.uint32)
    tail_nbs = jnp.where(final,
                         jnp.zeros((3,), jnp.int32),
                         jnp.array([3, 0, 32], jnp.int32).at[1].set(sf_pad))
    tail_offs = jnp.stack([p_end, p_end + 3, p_end + 3 + sf_pad]).astype(jnp.int32)
    total_bits = jnp.where(final, p_end, p_end + 3 + sf_pad + 32)

    # ----------------------------------------------------------- item offsets
    hdr_excl = jnp.cumsum(hdr_nbs, axis=1) - hdr_nbs
    hdr_offs = block_base[:, None] + hdr_excl

    token_base = block_base + (hdr_fixed - eob_nbs.astype(jnp.int32)) + pad_b
    hdr_offs = hdr_offs.at[:, _SLOT_EOB].set(token_base + T_b)

    # Position-level token offsets: the global exclusive cumsum P_excl,
    # rebased so each block's first position lands at its token_base. The
    # rebase constant is per-BLOCK (NB-sized gathers), broadcast to
    # positions by repeat — zero S-sized gathers.
    rebase_b = token_base - P_excl[start_pos_b]          # (NB,)
    off_pos = jnp.repeat(rebase_b[blk_id_micro], BLOCK,
                         total_repeat_length=S) + P_excl

    # Two SORTED packs instead of one mixed pack: the header-item stream
    # (row-major over blocks: block_base non-decreasing, in-row cumsum;
    # each row's EOB override stays below the next row's base) and the
    # position-level token stream (offsets non-decreasing by construction)
    # are each offset-monotone, so both scatters run with
    # indices_are_sorted and OR together bit-disjointly.
    words_h = bits_mod.pack_items64_to_words(
        jnp.concatenate([hdr_lo.reshape(-1), tail_vals]),
        jnp.concatenate([hdr_hi.reshape(-1), jnp.zeros((3,), jnp.uint32)]),
        jnp.concatenate([hdr_nbs.reshape(-1), tail_nbs]),
        jnp.concatenate([hdr_offs.reshape(-1), tail_offs]),
        OUT_WORDS, sorted_indices=True)

    # Pair-combine adjacent positions into one <= 96-bit item: within a
    # block position offsets are gapless (off[2i+1] == off[2i] + nb[2i]) and
    # blocks are 32768-aligned so pairs never straddle one — v = v1 |
    # (v2 << nb1) exactly. Halves the pack's scatter streams' element count
    # (4 x S/2 vs 3 x S; the design assumes a cost per scatter element).
    full32 = np.uint32(0xFFFFFFFF)
    nb_lo = jnp.clip(nbs_chosen, 0, 32)
    nb_hi = jnp.clip(nbs_chosen - 32, 0, 32)
    lo_m = lo_pos & jnp.where(nb_lo >= 32, full32,
                              jnp.where(nb_lo <= 0, np.uint32(0),
                                        full32 >> (np.uint32(32)
                                                   - nb_lo.astype(jnp.uint32))))
    hi_m = hi_pos & jnp.where(nb_hi <= 0, np.uint32(0),
                              full32 >> (np.uint32(32)
                                         - jnp.maximum(nb_hi, 1)
                                         .astype(jnp.uint32)))
    l1, h1, n1 = lo_m[0::2], hi_m[0::2], nbs_chosen[0::2]
    l2, h2, n2 = lo_m[1::2], hi_m[1::2], nbs_chosen[1::2]
    n1u = n1.astype(jnp.uint32)
    hiq = n1u >= 32                     # v2 starts in word 1 (n1 <= 48)
    rsh = n1u & np.uint32(31)
    a0 = l2 << rsh
    car0 = (l2 >> np.uint32(1)) >> (np.uint32(31) - rsh)
    a1 = (h2 << rsh) | car0
    a2 = (h2 >> np.uint32(1)) >> (np.uint32(31) - rsh)
    c0 = l1 | jnp.where(hiq, np.uint32(0), a0)
    c1 = h1 | jnp.where(hiq, a0, a1)
    c2 = jnp.where(hiq, a1, a2)         # bits >= 96 provably vanish
    words_t = bits_mod.pack_items96_to_words(
        c0, c1, c2, n1 + n2, off_pos[0::2], OUT_WORDS, sorted_indices=True)
    words = words_h | words_t

    # Stored payloads: byte-aligned CONTIGUOUS ranges — per emitted stored
    # block, OR a shifted window of its tile's words in place (2 dynamic
    # slices + elementwise; zero scatter elements). Alignment: payload
    # starts at block_base + 3 + pad + 32, a byte boundary by construction.
    _PW = BLOCK // 4
    sto_any = is_sto & b_emitted

    def pay_write(b, wds):
        live = sto_any[b]
        bit0 = block_base[b] + 3 + pad_b[b] + 32
        byte0 = bit0 >> 3
        w0 = jnp.clip(byte0 >> 2, 0, OUT_WORDS - 1)
        sh = ((byte0 & 3) << 3).astype(jnp.uint32)      # 0/8/16/24
        src = tile_words[start_micro_c[b]]              # (_PW,)
        # mask source to blen valid bytes (tail bytes must contribute 0)
        nby = 8 * jnp.clip(blen[b] - 4 * jnp.arange(_PW, dtype=jnp.int32),
                           0, 4)
        m = jnp.where(nby >= 32, np.uint32(0xFFFFFFFF),
                      jnp.where(nby <= 0, np.uint32(0),
                                np.uint32(0xFFFFFFFF)
                                >> (np.uint32(32) - nby.astype(jnp.uint32))))
        sv = src & m
        prev = jnp.concatenate([jnp.zeros((1,), jnp.uint32), sv[:-1]])
        up = (np.uint32(32) - sh) & np.uint32(31)
        nz = sh > 0
        shifted = (sv << sh) | jnp.where(nz, prev >> up, np.uint32(0))
        carry = jnp.where(nz, sv[-1] >> up, np.uint32(0))
        win = jnp.concatenate([shifted, carry[None]])   # (_PW + 1,)
        cur = jax.lax.dynamic_slice(wds, (w0,), (_PW + 1,))
        new = jnp.where(live, cur | win, cur)
        return jax.lax.dynamic_update_slice(wds, new, (w0,))

    words = jax.lax.fori_loop(0, NB, pay_write,
                              jnp.concatenate(
                                  [words, jnp.zeros((_PW + 1,), jnp.uint32)])
                              )[:OUT_WORDS]

    # ---------------------------------------------- sub-block decode entries
    # TOKEN-UNIFORM decode checkpoints: every `stride`-th token plus each
    # emitted huffman block's first token, stride chosen so the entry count
    # fits the static NSUB lane capacity. Output-uniform spacing (the old
    # scheme) made literal-dense lanes decode ~4x more symbols than match-
    # dense ones — and the decoder's while_loop runs until the SLOWEST lane
    # finishes, so uniform tokens-per-lane is what actually cuts steps
    # (decode/tpu_inflate.py phase B).
    NSUB = S // 64                         # lane capacity (static): more
    # lanes = fewer decoder while_loop steps (the loop's per-step
    # overhead, not its gather traffic, dominated at S//256 as designed)
    # stride is sized on HUFFMAN tokens only: stored-block tokens never ride
    # decode lanes, and counting them inflated the stride (= the decoder's
    # while_loop step count, worst lane) ~2.5x on mixed corpora
    tok_h = chosen & huff_pos
    cs = jnp.cumsum(tok_h.astype(jnp.int32)) - tok_h.astype(jnp.int32)
    n_tok_h = cs[-1] + tok_h[-1].astype(jnp.int32)
    csb = jnp.repeat(cs[start_pos_b][blk_id_micro], BLOCK,
                     total_repeat_length=S)      # huff tokens before own block
    first_in_blk = tok_h & (cs == csb)
    stride = jnp.maximum((n_tok_h + NSUB - NB - 1) // (NSUB - NB), 1)
    if _test_stride is not None:       # test seam: force sub_overflow to fire
        stride = jnp.int32(_test_stride)
    sel = tok_h & ((cs % stride == 0) | first_in_blk)
    sel_rank = jnp.cumsum(sel.astype(jnp.int32)) - sel.astype(jnp.int32)
    # overflow (unreachable with the stride arithmetic above) DROPS the
    # entry and raises a loud stat instead of silently clamp-colliding on
    # slot NSUB-1 — a dropped BLOCK-FIRST entry would leave that block's
    # range undecoded with ok still True (advisor r3 finding)
    sub_overflow = jnp.any(sel & (sel_rank >= NSUB))
    tgt_e = jnp.where(sel & (sel_rank < NSUB), sel_rank, NSUB)
    sub = jnp.full((NSUB + 1, 3), jnp.int32(-1)).at[:, 1].set(
        jnp.int32(1 << 30)).at[tgt_e].set(
        jnp.stack([off_pos, pos, blk_of_pos], axis=1))
    entry_bit, entry_pos, entry_blk = sub[:NSUB, 0], sub[:NSUB, 1], sub[:NSUB, 2]
    ev = entry_blk >= 0

    # chosen/is_match are already confined to [0, valid_len); EOBs count as
    # tokens (one per emitted block).
    n_tokens = jnp.sum(chosen.astype(jnp.int32)) + LB + 1
    n_matches = jnp.sum(is_match.astype(jnp.int32))
    stats = {
        "btype": jnp.where(b_emitted, btype, -1),
        "block_bits": jnp.where(b_emitted, hdr_fixed + pad_b + T_b, 0),
        "block_bytes": blen,
        "tree_bits": jnp.where(b_emitted & is_dyn, tree_bits, 0),
        "n_tokens": n_tokens,
        "n_matches": n_matches,
        # decode index (decode/tpu_inflate.py): per-block bit offset in the
        # shard substream, output byte range, and block count
        "block_bit_base": jnp.where(b_emitted, block_base, 0),
        "block_out_start": jnp.where(b_emitted, start_pos_b, 0),
        "n_blocks": LB + 1,
        # sub-block decode entries (shard-relative; -1/huge = dead entry)
        "sub_bit": jnp.where(ev, entry_bit, -1),
        "sub_out": jnp.where(ev, entry_pos, jnp.int32(1 << 30)),
        "sub_blk": jnp.where(ev, entry_blk, -1),
        "sub_overflow": sub_overflow,
    }
    return {"words": words, "total_bits": total_bits, **stats}


@functools.partial(jax.jit, static_argnames=("num_candidates", "lazy",
                                             "adaptive_blocks", "max_merge",
                                             "force_btype", "_test_stride"))
def encode_shard_jit(data, valid_len, final, num_candidates: int = 32,
                     lazy: bool = True, adaptive_blocks: bool = True,
                     max_merge: int = 8, force_btype: int | None = None,
                     _test_stride: int | None = None):
    return encode_shard(data, valid_len, final, num_candidates, lazy,
                        adaptive_blocks, max_merge, force_btype, _test_stride)


def deflate_compress_bytes(raw: bytes, shard_size: int = 1 << 20,
                           num_candidates: int = 32, lazy: bool = True) -> bytes:
    """Host convenience: raw bytes -> complete DEFLATE stream (single
    process; shards sequentially through the jitted kernel)."""
    if len(raw) == 0:
        # one empty final stored block
        return b"\x01\x00\x00\xff\xff"
    out = []
    n = len(raw)
    shard_size = max(BLOCK, (shard_size // BLOCK) * BLOCK)
    nsh = (n + shard_size - 1) // shard_size
    for s in range(nsh):
        part = raw[s * shard_size:(s + 1) * shard_size]
        vl = len(part)
        buf = np.zeros(shard_size, dtype=np.uint8)
        buf[:vl] = np.frombuffer(part, dtype=np.uint8)
        r = encode_shard_jit(jnp.asarray(buf), jnp.int32(vl),
                             jnp.asarray(s == nsh - 1),
                             num_candidates=num_candidates, lazy=lazy)
        tb = int(r["total_bits"])
        out.append(bits_mod.words_to_bytes(np.asarray(r["words"]), tb))
    return b"".join(out)
