"""Device-parallel DEFLATE decoder (indexed, sub-block-parallel).

Huffman decoding is bit-serial, so a data-parallel decoder restructures it
(SURVEY §7.3 item 4; PAPERS.md "Massively-Parallel Lossless Data
Decompression" / rapidgzip):

  Phase A — per-block header parse + canonical PER-SYMBOL decode tables,
    vectorized ACROSS blocks: a short masked loop over RLE symbols, then
    per-symbol (reversed code, mask, payload) triples (_sym_tables) from
    the RFC 1951 §3.2.2 counting rule — pure elementwise math, no LUTs.
  Phase B — symbol decode, lanes = token-uniform SUB-BLOCK entry points
    (the encoder emits a (bit, out) checkpoint every `stride` tokens —
    free, because it knows every token's bit offset): lanes are regrouped
    into padded per-block GROUPS of Lg so each group shares one table row,
    then one `while_loop` whose body fetches ONE 192-bit peek row per lane
    and decodes up to KSYM symbols from it; each Huffman code resolves by
    a fused dense compare over the SYMBOL axis (288/32 entries — chosen
    over a LUT gather by a design not yet re-measured on the GPU), so the
    loop's only per-symbol random access is the token scatter.
    A lane stops when its output cursor reaches the next entry, so EOB is
    only ever *written*, never required.
  Phase C — LZ copy resolution: overlapping copies collapse analytically
    (a match at start s, dist d pulls byte j from s - d + ((j-s) mod d) —
    the reference's byte-serial back-copy src/deflate_decompress.c:47-57
    replays this one byte at a time), then convergence-checked pointer
    doubling resolves cross-token chains in log2(chain-depth) gathers;
    after _CPRE rounds the tagged minority is extracted SCATTER-FREE
    (dense 64-lane front-compaction + segment fills) and finished in
    CAP = S/_CDIV-sized gathers through the frozen array (each remaining
    pointer is 2^_CPRE-hop-composed).

Strictness (never return silently-wrong data): invalid prefixes (cl == 0),
litlen symbols >= 286 and dist symbols >= 30 (RFC 1951 §3.2.5-3.2.6 "will
never actually occur" — the reference's structure rejects them,
src/deflate_decompress.c:278-279), HLIT > 286 / HDIST > 30, oversubscribed
trees (Kraft sum), premature EOB, lane overrun, negative copy distances,
and a hard bit-budget/step bound all flag the lane bad; `ok=False` whenever
any live lane is bad. The loops are bounded, so corrupt input can't hang.

The index (per-block bit/output offsets + sub-entries) comes free from our
encoder (format/deflate.py stats) or from one host pass over a foreign
stream (decode/index.py build_index). This is the deliberate trade:
random access + device-parallel decode in exchange for a sidecar the
sequential format doesn't carry.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..format import constants as C

MAX_BITS = 15
SUB_SIZE = 1024                  # sub-block entry spacing (output bytes)
_N_LL = 288                      # decode-side litlen alphabet (286/287 bad)
_N_D = 32                        # decode-side dist alphabet (30/31 bad)


# fixed trees, full decode-side alphabets (RFC 1951 §3.2.6: lengths are
# DEFINED for 286/287 and dist codes 30/31 — they shape the canonical
# counts even though the symbols themselves must never occur)
_FIXED_LL_LEN_FULL = np.zeros(_N_LL, np.int32)
_FIXED_LL_LEN_FULL[:len(C.FIXED_LITLEN_LENGTHS)] = C.FIXED_LITLEN_LENGTHS
_FIXED_D_LEN_FULL = np.zeros(_N_D, np.int32)
_FIXED_D_LEN_FULL[:len(C.FIXED_DIST_LENGTHS)] = C.FIXED_DIST_LENGTHS
if len(C.FIXED_DIST_LENGTHS) < _N_D:
    _FIXED_D_LEN_FULL[len(C.FIXED_DIST_LENGTHS):] = 5

# Static per-symbol payloads (host constants, independent of code lengths).
# litlen entry: val(9: literal byte or len_base) | leb(3)<<9 | kind(2)<<12
#   (0=lit, 1=eob, 2=len, 3=bad), code length rides at bit 14.
# dist entry: dbase(15) | deb(4)<<15 | bad(1)<<19, code length at bit 20.
_ls = np.arange(_N_LL)
_lkind = np.where(_ls < 256, 0,
                  np.where(_ls == 256, 1, np.where(_ls < 286, 2, 3)))
_lli = np.clip(_ls - 257, 0, 28)
_lval = np.where(_lkind == 0, _ls,
                 np.where(_lkind == 2, np.asarray(C.LENGTH_BASE)[_lli], 0))
_leb = np.where(_lkind == 2, np.asarray(C.LENGTH_EXTRA)[_lli], 0)
_LL_PAY_STATIC = (_lval | (_leb << 9) | (_lkind << 12)).astype(np.int32)
_ds = np.arange(_N_D)
_dsi = np.clip(_ds, 0, 29)
_dbad = (_ds >= 30).astype(np.int64)
_D_PAY_STATIC = (np.where(_dbad == 0, np.asarray(C.DIST_BASE)[_dsi], 0)
                 | (np.where(_dbad == 0, np.asarray(C.DIST_EXTRA)[_dsi], 0)
                    << 15)
                 | (_dbad << 19)).astype(np.int32)


# ---------------------------------------------------------------------------
# bit windows
# ---------------------------------------------------------------------------

def _peek32(words: jnp.ndarray, bit_pos: jnp.ndarray) -> jnp.ndarray:
    """32-bit LSB-first window at arbitrary bit positions (vectorized)."""
    W = words.shape[0]
    wi = jnp.clip(bit_pos >> 5, 0, W - 1)
    sh = (bit_pos & 31).astype(jnp.uint32)
    lo = words[wi]
    hi = words[jnp.clip(wi + 1, 0, W - 1)]
    return (lo >> sh) | jnp.where(sh > 0, hi << ((np.uint32(32) - sh)
                                                 & np.uint32(31)),
                                  np.uint32(0))


def _peek64(words: jnp.ndarray, bit_pos: jnp.ndarray):
    """64-bit LSB-first window as (lo, hi) u32 pair (3 word gathers)."""
    W = words.shape[0]
    wi = jnp.clip(bit_pos >> 5, 0, W - 1)
    sh = (bit_pos & 31).astype(jnp.uint32)
    w0 = words[wi]
    w1 = words[jnp.clip(wi + 1, 0, W - 1)]
    w2 = words[jnp.clip(wi + 2, 0, W - 1)]
    up = (np.uint32(32) - sh) & np.uint32(31)
    nz = sh > 0
    lo = (w0 >> sh) | jnp.where(nz, w1 << up, np.uint32(0))
    hi = (w1 >> sh) | jnp.where(nz, w2 << up, np.uint32(0))
    return lo, hi


def _extract2(lo: jnp.ndarray, hi: jnp.ndarray, off: jnp.ndarray) -> jnp.ndarray:
    """32-bit window at bit offset `off` in [0, 48] of a (lo, hi) u32 pair."""
    o = off.astype(jnp.uint32)
    ol = o & np.uint32(31)
    below = (lo >> ol) | jnp.where(ol > 0,
                                   hi << ((np.uint32(32) - ol) & np.uint32(31)),
                                   np.uint32(0))
    above = hi >> ((o - np.uint32(32)) & np.uint32(31))
    return jnp.where(o < 32, below, above)


_NWIN = 8                # peek-row width in u32 words (256 bits)
_CB = 64                 # compact-tail local-compaction row width
_CPRE = 3                # full doubling rounds before the compact tail
_CDIV = 8                # compact capacity = S // _CDIV (tail overflows
                         # beyond it fall back to full rounds)
_CC_MAX = 16             # compact linear-round bound (then full fallback)
KSYM = 10                # symbols decoded per peek row (window-budgeted)
LG = 64                  # lanes per dense-lookup group


def _winwords(words: jnp.ndarray) -> jnp.ndarray:
    """u32[W] -> u32[2W, _NWIN] half-word-granularity row table: row i holds
    bits [16i, 16i + 32*_NWIN) as LSB-first words. Built once, elementwise;
    the symbol loop fetches a whole window with ONE row gather — the design
    assumes row-gather cost is per ROW, not per element — and the
    >= 32*_NWIN-15 valid bits cover a RUN of tokens (any single token needs
    <= 48 bits: cl+leb+dcl+deb)."""
    w = words.astype(jnp.uint32)

    def sh(k):          # w shifted k words (tail zero-filled)
        return jnp.concatenate([w[k:], jnp.zeros((k,), jnp.uint32)])
    even = [sh(k) for k in range(_NWIN)]                  # rows at bit 32k
    odd = [(even[k] >> np.uint32(16)) | (sh(k + 1) << np.uint32(16))
           for k in range(_NWIN)]
    return jnp.stack([jnp.stack(even, axis=1),
                      jnp.stack(odd, axis=1)], axis=1).reshape(-1, _NWIN)


def _peekwin(hw: jnp.ndarray, bit_pos: jnp.ndarray):
    """>= 32*_NWIN-15 valid LSB-first bits as _NWIN u32 (ONE row gather)."""
    H = hw.shape[0]
    i = jnp.clip(bit_pos >> 4, 0, H - 1)
    sh = (bit_pos & 15).astype(jnp.uint32)
    row = hw[i]                                   # (..., _NWIN)
    up = (np.uint32(32) - sh) & np.uint32(31)
    nz = sh > 0
    vs = []
    for k in range(_NWIN):
        lo = row[..., k] >> sh
        if k + 1 < _NWIN:
            lo = lo | jnp.where(nz, row[..., k + 1] << up, np.uint32(0))
        vs.append(lo)
    return tuple(vs)


def _extractw(win, off: jnp.ndarray) -> jnp.ndarray:
    """Bit window at offset `off` in [0, 32*_NWIN-1] of the word window
    (bits past the last word read as zero — callers bound consumption)."""
    o = off.astype(jnp.uint32)
    ol = o & np.uint32(31)
    up = (np.uint32(32) - ol) & np.uint32(31)
    nz = ol > 0

    def ext(lo, hi):
        return (lo >> ol) | jnp.where(nz, hi << up, np.uint32(0))
    w = o >> np.uint32(5)
    res = win[-1] >> ol
    for k in range(_NWIN - 2, -1, -1):
        res = jnp.where(w == k, ext(win[k], win[k + 1]), res)
    return res


def _mask(nb: jnp.ndarray) -> jnp.ndarray:
    """(1 << nb) - 1 for nb in [0, 16]."""
    return (np.uint32(1) << nb.astype(jnp.uint32)) - np.uint32(1)


# ---------------------------------------------------------------------------
# canonical per-symbol decode tables (dense compare — no LUTs, no gathers)
# ---------------------------------------------------------------------------

def _canon_first(lengths: jnp.ndarray, max_bits: int):
    """From code lengths (NB, n): first-code-per-length table
    (NB, max_bits+1) and the Kraft oversubscription flag. Mirrors
    form_h_tree's binary counting (src/deflate_decompress.c:146-161) as
    pure vector math."""
    NB = lengths.shape[0]
    lvl = jnp.arange(max_bits + 1)
    count = jnp.sum((lengths[:, :, None] == lvl[None, None, :])
                    & (lengths[:, :, None] > 0), axis=1).astype(jnp.int32)
    firsts = [jnp.zeros((NB,), jnp.int32)]
    code = jnp.zeros((NB,), jnp.int32)
    for l in range(1, max_bits + 1):
        code = (code + count[:, l - 1]) << 1
        firsts.append(code)
    first = jnp.stack(firsts, axis=1)                    # (NB, max_bits+1)
    kraft = jnp.sum(count[:, 1:] << (max_bits - lvl[1:])[None, :], axis=1)
    over = kraft > (1 << max_bits)
    return first, over


def _sym_tables(lengths: jnp.ndarray, first: jnp.ndarray, max_bits: int,
                pay_static, cl_shift: int):
    """Per-SYMBOL decode tables for the dense prefix compare:
      rcode[b,s] — bit-REVERSED canonical code (compares directly against
                   the raw LSB-first peek), -1 where the symbol is absent;
      mask[b,s]  — (1 << len) - 1;
      pay[b,s]   — pay_static[s] | (len << cl_shift), 0 where absent.
    The canonical code is first[len] + rank-within-length (RFC 1951
    §3.2.2), computed with max_bits elementwise passes — no sorts, no
    gathers. Replaces the (NB, 2^lut_bits) flat LUT entirely: the symbol
    loop resolves a code by a fused compare-select-reduce over the SYMBOL
    axis (288/32/19 — far smaller than any peek space), chosen over the
    LUT gather and width-independent, so 15-bit foreign streams
    ride the same path.
    """
    NB, n = lengths.shape
    rank = jnp.zeros((NB, n), jnp.int32)
    first_s = jnp.zeros((NB, n), jnp.int32)
    for l in range(1, max_bits + 1):
        is_l = lengths == l
        il = is_l.astype(jnp.int32)
        ex = jnp.cumsum(il, axis=1) - il                 # exclusive count
        rank = jnp.where(is_l, ex, rank)
        first_s = jnp.where(is_l, first[:, l:l + 1], first_s)
    code = (first_s + rank).astype(jnp.uint32)
    from ..core.bits import reverse_bits
    rcode = reverse_bits(code, lengths).astype(jnp.int32)
    present = lengths > 0
    rcode = jnp.where(present, rcode, -1)
    mask = jnp.where(present, (1 << lengths) - 1, 0)
    pay = jnp.where(present,
                    jnp.asarray(pay_static, jnp.int32)[None, :]
                    | (lengths << cl_shift), 0)
    return rcode, mask, pay


def _dense_sym(pk: jnp.ndarray, rcode_g, mask_g, pay_g, Gn: int, Lg: int):
    """Resolve one Huffman code per lane by dense prefix compare:
    out[l] = pay of the unique symbol whose reversed code equals the low
    len bits of pk[l]; 0 => invalid prefix. Lanes are grouped (Gn, Lg) so a
    group shares one table row (broadcast, XLA fuses compare+select+reduce
    into a single elementwise pass — no materialized one-hot)."""
    p = pk.astype(jnp.int32).reshape(Gn, Lg)[:, :, None]
    hit = (p & mask_g[:, None, :]) == rcode_g[:, None, :]
    return jnp.sum(jnp.where(hit, pay_g[:, None, :], 0),
                   axis=2).reshape(-1)


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("out_size", "lut_bits",
                                             "_ablate"))
def decode_blocks(comp_words: jnp.ndarray,
                  blk_bit: jnp.ndarray,
                  blk_out: jnp.ndarray,
                  blk_btype: jnp.ndarray,
                  n_blocks: jnp.ndarray,
                  sub_bit: jnp.ndarray,
                  sub_out: jnp.ndarray,
                  sub_blk: jnp.ndarray,
                  n_subs: jnp.ndarray,
                  valid_out: jnp.ndarray,
                  out_size: int,
                  prefix: jnp.ndarray | None = None,
                  prefix_len: jnp.ndarray | None = None,
                  lut_bits: int = MAX_BITS,
                  max_dist: jnp.ndarray | int = C.WINDOW_SIZE,
                  blk_end: jnp.ndarray | None = None,
                  _ablate: str = ""):
    # _ablate: PROFILING ONLY — comma list of stages to stub out (wrong
    # output, same shapes): "lut"/"canon" (symbol tables), "slices",
    # "toksc", "hw", "scans".
    """Decode a DEFLATE substream given its block index + sub-entries.

    Args:
      comp_words: u32[CW] — the substream as LSB-first words.
      blk_bit/blk_out/blk_btype: i32[NB] per coding block: bit offset of the
        3-bit header, output byte offset, BTYPE (-1 for unused slots).
      n_blocks: i32 — live block count.
      sub_bit/sub_out/sub_blk: i32[NL] sub-entry lanes: bit offset of the
        first token (-1 => "first token of the block": resolved from the
        phase-A header-parse end), output byte offset, owning block id
        (-1 => dead lane). Entries must be sorted by sub_out; each
        Huffman block's start must appear as its first sub-entry. Stored
        blocks need no entries (they decode positionally).
      valid_out: i32 — total decompressed bytes (incl. prefix).
      out_size: static output capacity (>= valid_out).
      prefix/prefix_len: optional u8[W]/i32 window context occupying output
        [0, prefix_len) so match distances may reach into the previous
        decode group (caller shifts all out offsets by prefix_len).

      lut_bits: accepted for API compatibility, UNUSED since round 5 — the
        dense symbol-space decode (_sym_tables/_dense_sym) has no LUT and
        handles any RFC code length (15-bit foreign streams included) on
        the single code path.
      max_dist: declared sliding-window size — any match distance above it
        flags the lane bad (the reference bounds distances by the zlib
        header's CINFO window, src/deflate_decompress.c:360,278-279).

    Returns dict(out=u8[out_size], ok=bool, bad_lanes=bool[NL]).
    """
    _abl = frozenset(_ablate.split(","))
    max_dist = jnp.asarray(max_dist, jnp.int32)
    NB = blk_bit.shape[0]
    NL = sub_bit.shape[0]
    S = out_size
    CW = comp_words.shape[0]
    comp_words = comp_words.astype(jnp.uint32)

    blanes = jnp.arange(NB, dtype=jnp.int32)
    # dead slots carry btype == -1 (batch mode interleaves them per shard)
    blive = (blanes < n_blocks) & (blk_btype >= 0)
    is_dyn = blive & (blk_btype == C.BTYPE_DYNAMIC)
    is_fix = blive & (blk_btype == C.BTYPE_FIXED)
    is_sto = blive & (blk_btype == C.BTYPE_STORED)
    bbad = blive & (blk_btype == 3)                      # reserved BTYPE
    huff = is_dyn | is_fix

    if blk_end is None:
        blk_end = jnp.where(blanes + 1 < n_blocks,
                            blk_out[jnp.clip(blanes + 1, 0, NB - 1)],
                            valid_out)
        blk_end = jnp.where(blive, blk_end, blk_out)

    # ------------------------------------------------ phase A: block headers
    bp = blk_bit + 3                                     # skip BFINAL/BTYPE
    w = _peek32(comp_words, bp)
    hlit = jnp.where(is_dyn, (w & np.uint32(31)).astype(jnp.int32) + 257, 257)
    hdist = jnp.where(is_dyn,
                      ((w >> np.uint32(5)) & np.uint32(31)).astype(jnp.int32) + 1, 1)
    hclen = jnp.where(is_dyn,
                      ((w >> np.uint32(10)) & np.uint32(15)).astype(jnp.int32) + 4, 4)
    bbad = bbad | (is_dyn & ((hlit > 286) | (hdist > 30)))
    bp = jnp.where(is_dyn, bp + 14, bp)

    clen_lens = jnp.zeros((NB, C.NUM_CLEN), jnp.int32)
    clen_order = jnp.asarray(C.CLEN_ORDER)
    for j in range(C.NUM_CLEN):
        v = (_peek32(comp_words, bp) & np.uint32(7)).astype(jnp.int32)
        use = is_dyn & (j < hclen)
        clen_lens = clen_lens.at[:, clen_order[j]].set(jnp.where(use, v, 0))
        bp = jnp.where(use, bp + 3, bp)

    cl_first, cl_over = _canon_first(clen_lens, C.MAX_CLEN_BITS)
    bbad = bbad | (is_dyn & cl_over)
    # per-symbol entry: symbol (5 bits) | code_len << 5 — dense compare over
    # the 19-symbol clen alphabet per RLE step (no LUT, no gather)
    cl_rc, cl_mk, cl_pay = _sym_tables(clen_lens, cl_first, C.MAX_CLEN_BITS,
                                       np.arange(C.NUM_CLEN, dtype=np.int32),
                                       5)

    # RLE loop over code-length symbols (masked, <= 316 effective steps)
    total_lens = hlit + hdist
    _RLE_W = C.NUM_LITLEN + C.NUM_DIST
    t316 = jnp.arange(_RLE_W, dtype=jnp.int32)
    bit_budget = jnp.int32(32 * CW)

    def rle_cond(st):
        bp, i, prev, lens, bad, steps = st
        return jnp.any(is_dyn & (i < total_lens) & ~bad) & (steps < _RLE_W + 4)

    def rle_body(st):
        bp, i, prev, lens, bad, steps = st
        act = is_dyn & (i < total_lens) & ~bad
        lo, hi = _peek64(comp_words, bp)
        e = _dense_sym(lo, cl_rc, cl_mk, cl_pay, NB, 1)
        cl = e >> 5
        bad = bad | (act & (cl == 0))
        sym = e & 0x1F
        is_lit = sym < 16
        is16 = sym == 16
        is17 = sym == 17
        is18 = sym == 18
        eb = jnp.where(is16, 2, jnp.where(is17, 3, jnp.where(is18, 7, 0)))
        ev = (_extract2(lo, hi, cl) & _mask(eb)).astype(jnp.int32)
        rep = jnp.where(is_lit, 1,
                        jnp.where(is16 | is17, 3 + ev, 11 + ev))
        fill = jnp.where(is_lit, sym, jnp.where(is16, prev, 0))
        bad = bad | (act & is16 & (prev < 0))
        cover = (t316[None, :] >= i[:, None]) & \
                (t316[None, :] < (i + rep)[:, None]) & act[:, None]
        lens = jnp.where(cover, fill[:, None], lens)
        i = jnp.where(act, i + rep, i)
        bad = bad | (act & (i > total_lens))
        prev = jnp.where(act, jnp.where(is_lit, sym,
                                        jnp.where(is16, prev, 0)), prev)
        bp = jnp.where(act, bp + cl + eb, bp)
        bad = bad | (act & (bp > bit_budget))
        return bp, i, prev, lens, bad, steps + 1

    def rle_body4(st):
        # 4x unroll: the RLE loop is bound by per-iteration latency, not by
        # its (NB, 316) element work (act-masked, so overshoot is safe)
        return rle_body(rle_body(rle_body(rle_body(st))))

    lens0 = jnp.zeros((NB, _RLE_W), jnp.int32)
    st0 = (bp, jnp.zeros((NB,), jnp.int32), jnp.full((NB,), -1, jnp.int32),
           lens0, bbad, jnp.int32(0))
    bp, _, _, lens, bbad, _ = jax.lax.while_loop(rle_cond, rle_body4, st0)

    # split into litlen / dist lengths (decode-side widths 288 / 32)
    tl = jnp.arange(_N_LL, dtype=jnp.int32)
    ll_dyn = jnp.concatenate(
        [lens[:, :C.NUM_LITLEN],
         jnp.zeros((NB, _N_LL - C.NUM_LITLEN), jnp.int32)], axis=1)
    ll_lens = jnp.where(tl[None, :] < hlit[:, None], ll_dyn, 0)
    td = jnp.arange(_N_D, dtype=jnp.int32)
    d_gather = jnp.clip(hlit[:, None] + td[None, :], 0, _RLE_W - 1)
    d_lens = jnp.take_along_axis(lens, d_gather, axis=1)
    d_lens = jnp.where(td[None, :] < hdist[:, None], d_lens, 0)

    ll_lens = jnp.where(is_fix[:, None],
                        jnp.asarray(_FIXED_LL_LEN_FULL)[None, :], ll_lens)
    d_lens = jnp.where(is_fix[:, None],
                       jnp.asarray(_FIXED_D_LEN_FULL)[None, :], d_lens)

    if "canon" in _abl or "lut" in _abl:           # profiling stubs
        ll_rc = ll_mk = ll_pay = jnp.zeros((NB, _N_LL), jnp.int32)
        d_rc = d_mk = d_pay = jnp.zeros((NB, _N_D), jnp.int32)
    else:
        ll_first, ll_over = _canon_first(ll_lens, MAX_BITS)
        d_first, d_over = _canon_first(d_lens, MAX_BITS)
        bbad = bbad | (huff & (ll_over | d_over))
        ll_rc, ll_mk, ll_pay = _sym_tables(ll_lens, ll_first, MAX_BITS,
                                           _LL_PAY_STATIC, 14)
        d_rc, d_mk, d_pay = _sym_tables(d_lens, d_first, MAX_BITS,
                                        _D_PAY_STATIC, 20)

    # -------------------------------------------- phase B: sub-entry lanes
    if "hw" in _abl:                                  # profiling stub
        hw4 = jnp.zeros((2 * CW, _NWIN), jnp.uint32)
    else:
        hw4 = _winwords(comp_words)

    llanes = jnp.arange(NL, dtype=jnp.int32)
    lblk = jnp.clip(sub_blk, 0, NB - 1)
    llive = (llanes < n_subs) & (sub_blk >= 0) & huff[lblk]
    next_sub = jnp.where(llanes + 1 < n_subs,
                         sub_out[jnp.clip(llanes + 1, 0, NL - 1)],
                         jnp.int32(1 << 30))
    lane_end = jnp.minimum(next_sub, blk_end[lblk])
    lbad_init = llive & bbad[lblk]
    bp_init = jnp.where(sub_bit >= 0, sub_bit, bp[lblk])

    # ---- padded per-block lane GROUPS: the dense symbol lookup needs every
    # group of Lg lanes to share one table row. Lanes arrive sorted so each
    # block's live lanes are contiguous; scatter them into a layout where
    # each block's lanes start at a Lg-aligned base (padding slots are dead
    # lanes). Device-side and format-independent — foreign-stream indexes
    # get the same treatment.
    Lg = LG
    live_i = llive.astype(jnp.int32)
    scat_b = jnp.where(llive, lblk, NB)
    cnt_b = jnp.zeros((NB + 1,), jnp.int32).at[scat_b].add(1)[:NB]
    padded_b = ((cnt_b + Lg - 1) // Lg) * Lg
    base_b = jnp.cumsum(padded_b) - padded_b
    NLP = ((NL + NB * Lg + Lg - 1) // Lg) * Lg          # static capacity
    Gn = NLP // Lg
    g_rank = jnp.cumsum(live_i) - live_i                # live rank (global)
    first_rank_b = jnp.full((NB + 1,), 1 << 30, jnp.int32).at[
        scat_b].min(g_rank)[:NB]
    pslot = jnp.where(llive,
                      base_b[lblk] + (g_rank - first_rank_b[lblk]), NLP)

    lane_state = jnp.stack([bp_init, sub_out, lane_end, lblk,
                            lbad_init.astype(jnp.int32)], axis=1)
    pad = jnp.zeros((NLP + 1, 5), jnp.int32).at[:, 3].set(-1).at[
        pslot].set(lane_state, mode="drop")[:NLP]
    bp0 = pad[:, 0]
    ocur0 = pad[:, 1]
    plane_end = pad[:, 2]
    plblk = pad[:, 3]
    plive = plblk >= 0
    lbad0 = plive & (pad[:, 4] == 1)
    done0 = ~plive | (ocur0 >= plane_end)

    # per-GROUP tables: small row gathers (Gn rows) once per dispatch
    gb = jnp.clip(jnp.max(plblk.reshape(Gn, Lg), axis=1), 0, NB - 1)
    ll_rc_g, ll_mk_g, ll_pay_g = ll_rc[gb], ll_mk[gb], ll_pay[gb]
    d_rc_g, d_mk_g, d_pay_g = d_rc[gb], d_mk[gb], d_pay[gb]

    tok0 = jnp.zeros((S + 1,), jnp.int32)

    def one_sym_at(win, off, can, ocur, done, lbad):
        """Decode one symbol per lane from the shared 128-bit window at
        local bit offset `off`: ZERO gathers — the Huffman code resolves by
        dense symbol-space compare (_dense_sym), extra bits by _extract4."""
        act = can & ~done & ~lbad
        pk = _extractw(win, off)
        e = _dense_sym(pk, ll_rc_g, ll_mk_g, ll_pay_g, Gn, Lg)
        cl = (e >> 14) & 0xF
        lbad = lbad | (act & (cl == 0))                  # invalid prefix
        kind = (e >> 12) & 3                             # 0 lit/1 eob/2 len/3 bad
        is_lit = kind == 0
        is_eob = kind == 1
        is_len = kind == 2
        lbad = lbad | (act & (kind == 3))                # RFC: never occurs
        leb = (e >> 9) & 0x7
        lev = (_extractw(win, off + cl) & _mask(leb)).astype(jnp.int32)
        mlen = (e & 0x1FF) + lev
        off2 = off + cl + jnp.where(is_len, leb, 0)
        de = _dense_sym(_extractw(win, off2), d_rc_g, d_mk_g, d_pay_g,
                        Gn, Lg)
        dcl = (de >> 20) & 0xF
        lbad = lbad | (act & is_len & ((dcl == 0) | ((de >> 19) & 1 != 0)))
        deb = (de >> 15) & 0xF
        off3 = off2 + dcl
        dev = (_extractw(win, off3) & _mask(deb)).astype(jnp.int32)
        mdist = (de & 0x7FFF) + dev
        lbad = lbad | (act & is_len & (mdist > max_dist))  # declared window

        emit = act & (is_lit | is_len)
        adv = jnp.where(is_len, mlen, 1)
        pack = (jnp.where(is_lit, e & 0x1FF, mlen)
                | (jnp.where(is_len, mdist, 0) << 9)
                | (1 << 25)
                | (jnp.where(is_len, 1, 0) << 26))
        # non-emitting lanes park at sink row S (garbage there is sliced
        # off); the scatter is BATCHED across the KSYM window symbols in
        # dec_body (slots within a window are distinct per lane since ocur
        # strictly advances on emit)
        slot = jnp.where(emit, jnp.clip(ocur, 0, S), S + 1)
        ocur2 = jnp.where(emit, ocur + adv, ocur)
        lbad = lbad | (act & (ocur2 > plane_end))        # token overran lane
        lbad = lbad | (act & is_eob)                     # EOB before lane end
        done = done | (act & (ocur2 >= plane_end) & ~lbad)
        consumed = jnp.where(
            act, cl + jnp.where(is_len, leb + dcl + deb, 0), 0)
        return consumed, ocur2, done, lbad, slot, pack

    # One 192-bit row gather feeds up to KSYM symbols: >= 177 bits are
    # valid, a token consumes <= 48 (15+5+15+13), so a lane keeps decoding
    # while its window offset is <= 128. Typical tokens are ~9-12 bits ->
    # ~10+ symbols per row; worst-case lanes still make >= 2.
    _WSAFE = 32 * _NWIN - 15 - 49   # token <= 48 bits, >= 32*_NWIN-15 valid
    # steps advance by KSYM per body but a body may decode fewer symbols
    # (>= floor(_WSAFE/48)+1 = 3 per window even with worst-case 48-bit
    # tokens), so the bound must cover KSYM/3 x the worst lane's tokens
    # (<= S) — S + 64 could flag a VALID all-15-bit-literal foreign stream
    # as unconverged (round-5 review finding)
    max_steps = 4 * S + 64

    def dec_cond(st):
        bp, ocur, done, lbad, tok, steps = st
        return jnp.any(~done & ~lbad) & (steps < max_steps)

    def dec_body(st):
        bp, ocur, done, lbad, tok, steps = st
        act0 = ~done & ~lbad
        win = _peekwin(hw4, bp)
        off = jnp.zeros((NLP,), jnp.int32)
        slots, packs = [], []
        for _ in range(KSYM):
            can = off <= _WSAFE
            consumed, ocur, done, lbad, slot, pack = one_sym_at(
                win, off, can, ocur, done, lbad)
            off = off + consumed
            slots.append(slot)
            packs.append(pack)
        tok = tok.at[jnp.stack(slots)].set(jnp.stack(packs), mode="drop")
        bp = bp + off
        lbad = lbad | (act0 & (bp > bit_budget))         # ran off the stream
        return bp, ocur, done, lbad, tok, steps + KSYM

    st = (bp0, ocur0, done0, lbad0, tok0, jnp.int32(0))
    _, ocur, done, lbad, tok, _ = jax.lax.while_loop(dec_cond, dec_body, st)

    # map padded-lane status back to the caller's lane order (one gather)
    stat = lbad.astype(jnp.int32) * 2 + done.astype(jnp.int32)
    stat_l = stat[jnp.clip(pslot, 0, NLP - 1)]
    lbad = llive & ((stat_l >= 2) | ((stat_l & 1) == 0))  # bad or unconverged

    # ------------------------------------------ phase C: output construction
    j_idx = jnp.arange(S, dtype=jnp.int32)
    t_valid = ((tok[:S] >> 25) & 1) == 1
    t_match = ((tok[:S] >> 26) & 1) == 1
    t_a = tok[:S] & 0x1FF

    # Everything phase C gathers is u32/i32 and batched into as few
    # gathers as possible (sub-word (u8) gathers were much slower than word
    # gathers where this was designed): 4 S-sized gathers, all word-typed.
    if prefix is not None:
        plen = prefix_len.astype(jnp.int32)
        W = prefix.shape[0]
        pref_pad = jnp.concatenate(
            [prefix.astype(jnp.uint32),
             jnp.zeros((max(S - W, 0),), jnp.uint32)])[:S]
        lit_val = jnp.where(j_idx < plen, pref_pad, 0)
    else:
        plen = jnp.int32(0)
        lit_val = jnp.zeros((S,), jnp.uint32)
    lit_val = jnp.where(t_valid & ~t_match, t_a.astype(jnp.uint32), lit_val)

    sto_pay_byte = ((blk_bit + 3 + 7) >> 3) + 4           # after LEN/NLEN
    # Covering-block flags per position WITHOUT an S-sized gather: scatter a
    # PACKED per-block word at each block's start and forward-fill with one
    # cummax — valid because the block id rides the high bits (monotone in
    # position, so cummax is exactly segment-fill). Only (block id, is_sto)
    # are packed — stored-block SOURCES come from the contiguous slice
    # copies below, so this works at any NB/S (the round-4 offset field and
    # its 31-bit gate were vestigial).
    # Out-of-range starts are DROPPED, not clamped (a degenerate empty
    # trailing block at blk_out == S must not alias onto position S-1).
    start_slot = jnp.where(blive & (blk_out >= 0) & (blk_out < S), blk_out, S)
    # exact per-position coverage: blk_end is nondecreasing over live blocks,
    # so a start-scatter + cummax yields "this position is inside some live
    # block" — the precise domain for match/strictness checks (in batch
    # mode the flat layout has dead gaps between shards' valid ends)
    from ..core import scans as _scans
    _scan_max = ((lambda x: x) if "scans" in _abl     # profiling stub
                 else _scans.cummax)                     # blocked two-level
    cend = _scan_max(jnp.zeros((S,), jnp.int32).at[start_slot].max(
        jnp.where(blive, blk_end, 0), mode="drop"))
    pos_live = j_idx < cend
    markv = ((blanes + 1) << 1) | is_sto.astype(jnp.int32)
    pc = _scan_max(jnp.zeros((S,), jnp.int32).at[start_slot].max(
        jnp.where(blive, markv, 0), mode="drop"))
    pos_sto = ((pc & 1) == 1) & (j_idx >= plen) & ((pc >> 1) > 0)
    # stored payloads are CONTIGUOUS byte ranges: copy each live stored
    # block with one fixed-width dynamic slice pair (2 contiguous ops per
    # block) instead of an S-sized random gather — stored DEFLATE blocks
    # are <= 65535 output bytes (16-bit LEN), so a 64 KB window covers any
    # block. fori_loop keeps compile time flat at large NB (flat batches).
    _WSTO = 1 << 16
    if "slices" not in _ablate:
        cbytes = ((comp_words[:, None]
                   >> (jnp.arange(4, dtype=jnp.uint32)[None, :]
                       * np.uint32(8))) & np.uint32(0xFF)).reshape(-1)
        cpad = jnp.concatenate([cbytes,
                                jnp.zeros((_WSTO,), jnp.uint32)])
        lv_pad = jnp.concatenate([lit_val,
                                  jnp.zeros((_WSTO,), jnp.uint32)])
        t65 = jnp.arange(_WSTO, dtype=jnp.int32)

        def sto_body(b, lv):
            live_sto = is_sto[b]
            src0 = jnp.clip(sto_pay_byte[b], 0, 4 * CW)
            dst0 = jnp.clip(blk_out[b], 0, S)
            pay = jax.lax.dynamic_slice(cpad, (src0,), (_WSTO,))
            cur = jax.lax.dynamic_slice(lv, (dst0,), (_WSTO,))
            ln = jnp.clip(blk_end[b] - blk_out[b], 0, _WSTO)
            new = jnp.where(live_sto & (t65 < ln), pay, cur)
            return jax.lax.dynamic_update_slice(lv, new, (dst0,))

        lv_pad = jax.lax.fori_loop(0, NB, sto_body, lv_pad)
        lit_val = lv_pad[:S]

    # covering token per position, then SAME-DISTANCE RUN collapse: the
    # byte-level source of any match-covered position is exactly j - d
    # (RFC 1951 §3.2.3 back-copy; the reference replays it byte-serially,
    # src/deflate_decompress.c:47-57). Over a maximal run [r, j] of
    # positions all covered at the SAME d, the iterated chain lands at
    # r - d + ((j - (r-d)) mod d) in ONE elementwise step — this collapses
    # both intra-token overlap AND the arbitrarily deep cross-token chains
    # of periodic data (d-periodic tilings previously cost log2(run/d)
    # doubling rounds, each an S-sized gather). Only chains that hop
    # between DIFFERENT distances remain for the pointer doubling below.
    # Covering-token distance per position WITHOUT the full-S tok[s_j]
    # gather (once the largest item of phase C's fixed machinery):
    # a u32 pack (local_pos+1)<<16 | d is
    # monotone within 32 KB rows (cummax = segment fill; literal tokens
    # carry d == 0), and a tiny per-row carry chain forward-fills across
    # row boundaries (token extent <= 258 bytes, but empty rows pass the
    # carry through, so the chain is a second small cummax). Positions with
    # no covering token are masked by pos_sto/pos_live below.
    t_d16 = jnp.where(t_match, (tok[:S] >> 9) & 0xFFFF, 0).astype(jnp.uint32)
    _SROW = C.WINDOW_SIZE
    if "toksc" in _abl:                               # profiling stub
        d_j = t_d16.astype(jnp.int32)
    elif S % _SROW == 0 and S >= _SROW:
        jloc = (j_idx & (_SROW - 1)).astype(jnp.uint32)
        pk32 = jnp.where(t_valid, ((jloc + np.uint32(1)) << np.uint32(16))
                         | t_d16, np.uint32(0)).reshape(-1, _SROW)
        within = _scans.cummax_rows(pk32)
        rowlast = within[:, -1]
        R = S // _SROW
        rowpk = jnp.where(rowlast > 0,
                          ((jnp.arange(R, dtype=jnp.uint32) + np.uint32(1))
                           << np.uint32(16)) | (rowlast & np.uint32(0xFFFF)),
                          np.uint32(0))
        carry = _scans.cummax(rowpk)
        carry_x = jnp.concatenate([jnp.zeros((1,), jnp.uint32), carry[:-1]])
        d_j = jnp.where(within > 0, within & np.uint32(0xFFFF),
                        jnp.where(carry_x[:, None] > 0,
                                  carry_x[:, None] & np.uint32(0xFFFF),
                                  np.uint32(0))).reshape(S).astype(jnp.int32)
    else:
        # small/odd shapes (host-side grouped decode of tiny streams):
        # original covering-start scan + one gather
        start_mark = jnp.where(t_valid, j_idx, -1)
        s_j = _scan_max(start_mark)
        tok_sc = tok[jnp.clip(s_j, 0, S - 1)]
        d_j = jnp.where((s_j >= 0) & (((tok_sc >> 26) & 1) == 1),
                        (tok_sc >> 9) & 0xFFFF, 0)
    mpos = (d_j > 0) & ~pos_sto & (j_idx >= plen) & pos_live
    rd = jnp.where(mpos, d_j, 0)
    prev_rd = jnp.concatenate([jnp.full((1,), -1, jnp.int32), rd[:-1]])
    r = _scan_max(jnp.where(rd != prev_rd, j_idx, -1))   # run start >= 0
    base = r - rd
    g = base + jnp.where(mpos, (j_idx - base) % jnp.maximum(rd, 1), 0)
    bad_dist = jnp.any(mpos & (g < 0))

    # TAGGED-VALUE pointer doubling: v holds either a resolved byte or
    # TAG | source-index; each round jumps tagged entries through one
    # doubling gather v[v & addr]. Chains strictly decrease (g < j), so
    # either all tags clear or the round bound flags unconverged. Compared
    # with index-space doubling + a final value gather this saves one full
    # S-sized gather (the last round lands on values directly).
    _tag_bit = max(24, int(S - 1).bit_length())          # above any index
    _TAG = np.uint32(1) << np.uint32(_tag_bit)
    _ADDR = np.uint32((1 << _tag_bit) - 1)
    v0 = jnp.where(mpos & (g >= 0),
                   _TAG | jnp.clip(g, 0, S - 1).astype(jnp.uint32), lit_val)

    max_rounds = int(np.ceil(np.log2(max(S, 2)))) + 2

    def c_cond(st):
        v, ch, rr = st
        return ch & (rr < max_rounds)

    def c_body(st):
        v, ch, rr = st
        tag = (v & _TAG) != 0
        hop = v[(v & _ADDR).astype(jnp.int32)]   # indices < S by construction
        vn = jnp.where(tag, hop, v)
        return vn, jnp.any((vn & _TAG) != 0), rr + 1

    # Compact-tail finishing: after _CPRE full doubling rounds the tagged
    # minority (depth > 2^_CPRE, a small share of S on text) no longer
    # justifies full-S gather rounds. The obvious extraction (a full-S
    # mostly-dropped scatter) was pathologically slow where this was
    # designed, so the extraction uses the dense small-index mechanism
    # instead (not re-measured on the GPU):
    #   * front-compact tagged lanes inside 64-lane rows with a fused
    #     one-hot compare-select-reduce (index space 64 => dense > gather);
    #   * locate the k-th tagged element via two tiny scatter-max + cummax
    #     segment fills over CAP (row id + row offset) — no searchsorted;
    #   * ONE CAP row gather pulls compacted global indices; compact rounds
    #     hop through the FROZEN full array (every still-tagged pointer is
    #     2^_CPRE-hop-composed, so each linear round advances 2^_CPRE
    #     chain hops); scatter-back is CAP updates, ALL kept.
    # If the tagged count exceeds CAP (adversarial data) or tags survive
    # _CC_MAX compact rounds, the checked full-round loop below finishes —
    # correctness never depends on the compact phase.
    use_compact = ("nocmp" not in _abl) and S % _CB == 0 and S >= (1 << 18)
    if "chase" in _abl:                               # profiling stub
        v, unconverged = v0, jnp.asarray(False)
    elif not use_compact:
        v, unconverged, _ = jax.lax.while_loop(
            c_cond, c_body, (v0, jnp.any((v0 & _TAG) != 0), jnp.int32(0)))
    else:
        v1, ch1, rr1 = jax.lax.while_loop(
            lambda st: st[1] & (st[2] < _CPRE), c_body,
            (v0, jnp.any((v0 & _TAG) != 0), jnp.int32(0)))
        CAP = S // _CDIV
        R = S // _CB
        m = (v1 & _TAG) != 0
        mr = m.reshape(R, _CB)
        ti = mr.astype(jnp.int32)
        rank = jnp.cumsum(ti, axis=1) - ti
        cnt = jnp.sum(ti, axis=1)
        off = _scans.cumsum(cnt)
        off_x = off - cnt
        total = off[-1]

        def _compact(vin):
            # dense-compact BOTH payloads (global index + current value) so
            # one (CAP, 2) ROW gather replaces two CAP element gathers (row
            # gathers cost per row, not per element — ROADMAP governing fact)
            gi = jnp.arange(S, dtype=jnp.uint32).reshape(R, _CB)
            vr = vin.reshape(R, _CB)
            lane = jnp.arange(_CB, dtype=jnp.int32)
            w = mr[:, :, None] & (rank[:, :, None] == lane[None, None, :])
            lci = jnp.sum(jnp.where(w, gi[:, :, None], np.uint32(0)), axis=1)
            lcv = jnp.sum(jnp.where(w, vr[:, :, None], np.uint32(0)), axis=1)
            ilv = jnp.stack([lci.reshape(-1), lcv.reshape(-1)], axis=1)
            ks = jnp.arange(CAP, dtype=jnp.int32)
            dst = jnp.where(cnt > 0, jnp.clip(off_x, 0, CAP - 1), CAP)
            rows = _scans.cummax(jnp.zeros((CAP,), jnp.int32).at[dst].max(
                jnp.arange(R, dtype=jnp.int32), mode="drop"))
            offs = _scans.cummax(jnp.zeros((CAP,), jnp.int32).at[dst].max(
                off_x, mode="drop"))
            live = ks < total
            src = jnp.clip(rows * _CB + (ks - offs), 0, S - 1)
            pair = ilv[src]                           # (CAP, 2) row gather
            cidx = jnp.where(live, pair[:, 0].astype(jnp.int32), 0)
            # junk lanes (k >= total) must write their own unchanged value
            # back at index 0: seed them with vin[0]
            cval = jnp.where(live, pair[:, 1], vin[0])

            def cc_body(st):
                cv, ch, rr = st
                tag = live & ((cv & _TAG) != 0)
                hop = vin[jnp.clip((cv & _ADDR).astype(jnp.int32), 0, S - 1)]
                cvn = jnp.where(tag, hop, cv)
                return cvn, jnp.any(live & ((cvn & _TAG) != 0)), rr + 1

            cval, _, _ = jax.lax.while_loop(
                lambda st: st[1] & (st[2] < _CC_MAX), cc_body,
                (cval, jnp.any(live & ((cval & _TAG) != 0)), jnp.int32(0)))
            return vin.at[cidx].set(cval)

        v2 = jax.lax.cond(ch1 & (total <= CAP), _compact, lambda x: x, v1)
        v, unconverged, _ = jax.lax.while_loop(
            c_cond, c_body, (v2, jnp.any((v2 & _TAG) != 0), rr1))

    out = (v & np.uint32(0xFF)).astype(jnp.uint8)
    out = jnp.where(j_idx < valid_out, out, jnp.uint8(0))

    ok = (~jnp.any(lbad & llive) & ~jnp.any(bbad & blive)
          & ~bad_dist & ~unconverged)
    return {"out": out, "ok": ok, "bad_lanes": lbad}


@functools.partial(jax.jit, static_argnames=("out_size", "lut_bits",
                                             "_ablate"))
def decode_blocks_batch(comp_words, blk_bit, blk_out, blk_btype, n_blocks,
                        sub_bit, sub_out, sub_blk, valid_out,
                        out_size: int, lut_bits: int = MAX_BITS,
                        max_dist: jnp.ndarray | int = C.WINDOW_SIZE,
                        _ablate: str = ""):
    """Decode B independent shard substreams in ONE flat dispatch.

    All leading arguments carry a batch dimension B (as produced by a
    vmapped encode_shard): comp_words u32[B, CW]; blk_* [B, NB] (dead slots
    btype == -1); n_blocks i32[B]; sub_* [B, NL] (dead lanes sub_blk == -1);
    valid_out i32[B] — decoded byte count per shard (shards may be ragged).
    Returns dict(out=u8[B, out_size], ok, bad_lanes).

    Rationale: vmapping decode_blocks gives every gather/scatter in the
    symbol loop a batch dimension, which lowers to far slower batched
    gathers than the flat 1-D form (as designed; not re-measured on the
    GPU). Folding the shard id into
    the index arithmetic — word offsets s*CW*32 bits, output offsets s*S,
    block ids s*NB — makes every gather and scatter flat while keeping shards
    logically independent: tokens cannot cross shard ends (lane_end clamps
    at block ends) and back-copies cannot reach before a shard's first
    token for well-formed streams (malformed ones fail verification)."""
    B, CW = comp_words.shape
    NBs = blk_bit.shape[1]
    S = out_size
    sidx = jnp.arange(B, dtype=jnp.int32)
    word_bits = CW * 32

    blive = (jnp.arange(NBs, dtype=jnp.int32)[None, :] < n_blocks[:, None]) \
        & (blk_btype >= 0)
    fb = jnp.where(blive, blk_bit + sidx[:, None] * word_bits, 0)
    fo = jnp.where(blive, blk_out + sidx[:, None] * S, -1)
    ft = jnp.where(blive, blk_btype, -1)
    # per-block end: next live block in the SAME shard (live blocks are a
    # prefix of each row) else the shard's valid end
    nxt = jnp.concatenate([blk_out[:, 1:], jnp.zeros((B, 1), jnp.int32)],
                          axis=1)
    lastb = jnp.arange(NBs, dtype=jnp.int32)[None, :] + 1 >= n_blocks[:, None]
    valid_s = jnp.asarray(valid_out, jnp.int32).reshape(B)
    fe = jnp.where(blive,
                   jnp.where(lastb, valid_s[:, None], nxt)
                   + sidx[:, None] * S, -1)

    slive = sub_blk >= 0
    fsb = jnp.where(slive, sub_bit + sidx[:, None] * word_bits, -1)
    fso = jnp.where(slive, sub_out + sidx[:, None] * S, jnp.int32(1 << 30))
    fsk = jnp.where(slive, sub_blk + sidx[:, None] * NBs, -1)

    r = decode_blocks(comp_words.reshape(-1), fb.reshape(-1),
                      fo.reshape(-1), ft.reshape(-1), jnp.int32(B * NBs),
                      fsb.reshape(-1), fso.reshape(-1), fsk.reshape(-1),
                      jnp.int32(fsb.size), jnp.int32(B * S), B * S,
                      lut_bits=lut_bits, max_dist=max_dist,
                      blk_end=fe.reshape(-1), _ablate=_ablate)
    out = r["out"].reshape(B, S)
    out = jnp.where(jnp.arange(S, dtype=jnp.int32)[None, :]
                    < valid_s[:, None], out, jnp.uint8(0))
    return {"out": out, "ok": r["ok"],
            "bad_lanes": r["bad_lanes"].reshape(B, -1)}


def decode_shard_indexed(comp_words, bit_base, out_start, btype, n_blocks,
                         valid_out, out_size, prefix=None, prefix_len=None):
    """Back-compat wrapper: one lane per block (no sub-entries). Prefer
    decode_blocks with encoder-emitted sub-entries for throughput."""
    NB = bit_base.shape[0]
    lanes = jnp.arange(NB, dtype=jnp.int32)
    hufflane = (btype == C.BTYPE_DYNAMIC) | (btype == C.BTYPE_FIXED)
    sub_blk = jnp.where(hufflane, lanes, -1)
    return decode_blocks(comp_words, bit_base, out_start, btype, n_blocks,
                         jnp.full((NB,), -1, jnp.int32), out_start, sub_blk,
                         n_blocks, valid_out, out_size,
                         prefix=prefix, prefix_len=prefix_len)
