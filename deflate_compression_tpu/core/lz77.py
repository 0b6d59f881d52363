"""LZ77 match finding + parse (fixed-shape JAX, jittable).

Reference analogue: the 32 KB sliding-window hash-chain match finder
(src/deflate_compress.c:14-62 design comment; dup_hash :115-135; chain walk +
check_dup_str :164-180; greedy decision :243-339). The reference processes
one byte at a time, appending each position to a per-bucket chain and
walking it sequentially.

Design — chosen for hardware where random gathers were the scarce resource
while sorts, shifts and elementwise vector ops ran near bandwidth; not yet
re-measured on the GPU:

  1. hash every 3-byte prefix (elementwise);
  2. ONE stable argsort by hash; positions AND a 36-byte window payload
     (9 u32 words, one (S,9) row gather) follow the permutation. In sorted
     order a position's same-hash predecessors are exactly its nearest
     previous chain entries, so candidate generation and byte-exact scoring
     up to 35 bytes are pure shifted-slice compares — zero scalar gathers;
  3. matches longer than the payload extend by 4-byte-stride gathers up to a
     configurable cap (gather traffic only when the cap exceeds 8 words);
  4. constant runs (period 1) are detected exactly with two scans, so long
     zero/fill runs stay optimal regardless of the cap;
  5. one-step lazy heuristic (zlib-style), then greedy parse selection via
     pointer doubling: the chosen token set is the orbit of 0 under
     next[i] = i + len[i], extracted in log2(S) scatter rounds.

All shapes static; matches are found across the whole shard so the 32 KB
window crosses DEFLATE block boundaries exactly as RFC 1951 allows, but a
token never EXTENDS past a 32 KB tile boundary (coding-block alignment +
stored-block correctness), while shards themselves stay independent (fresh
window per shard — SURVEY §2.2).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..format import constants as C

HASH_BITS = 16
HASH_MUL = np.uint32(2654435761)   # Knuth multiplicative hash
# zlib deflate.c's TOO_FAR (drop length-3 matches farther than 4096) helps
# text a little but costs pixel/periodic data a lot (len-3 far matches are
# how RGB triples compress); measured net-negative here, so disabled.
TOO_FAR = 0
LAZY2 = True        # two-step lazy look-ahead (see tokenize): −0.3% on text


def _shift_down(x: jnp.ndarray, k: int, fill) -> jnp.ndarray:
    """y[i] = x[i-k] (first k filled)."""
    return jnp.concatenate([jnp.full((k,), fill, x.dtype), x[:-k]])


def _padded(x: jnp.ndarray, kmax: int, fill) -> jnp.ndarray:
    """Pad kmax fill-values in front ONCE so per-k shifts become slices.

    A concatenate per (candidate, word) materializes a fresh buffer and
    breaks XLA fusion (the candidate-scoring stage then ran far off
    bandwidth from op overhead); slicing one shared padded buffer keeps the
    whole score chain a single fused elementwise kernel."""
    return jnp.concatenate([jnp.full((kmax,), fill, x.dtype), x])


def _shifted(xpad: jnp.ndarray, k: int, kmax: int, S: int) -> jnp.ndarray:
    """y[i] = x[i-k] over a _padded buffer (pure slice, fuses)."""
    return jax.lax.slice(xpad, (kmax - k,), (kmax - k + S,))


def _words4(data: jnp.ndarray) -> jnp.ndarray:
    """w4[i] = data[i..i+3] as LSB-first u32 (tail zero-padded)."""
    d32 = data.astype(jnp.uint32)
    b0 = jnp.concatenate([d32, jnp.zeros((3,), jnp.uint32)])
    return (b0[:-3] | (b0[1:-2] << np.uint32(8)) | (b0[2:-1] << np.uint32(16))
            | (b0[3:] << np.uint32(24)))


def _tail_bytes(diff):
    """Leading equal bytes (0-3) of a u32 word diff (LSB-first)."""
    return jnp.where((diff & np.uint32(0xFF)) != 0, 0,
                     jnp.where((diff & np.uint32(0xFFFF)) != 0, 1,
                               jnp.where((diff & np.uint32(0xFFFFFF)) != 0,
                                         2, 3)))


def find_matches(data: jnp.ndarray, num_candidates: int = 32,
                 max_match_words: int = 8):
    """Best match per position. Returns (length i32[S], dist i32[S]);
    length 0 where no usable match. Lengths capped at
    min(4 * max_match_words + 3, 258).

    For caps up to 8 words the whole score is computed from payload carried
    through the sort: ONE (S, PW+1)-row gather replaces the per-word
    permutation gathers plus the extension and tail gathers (one row
    gather was designed to cost far less than the scalar gathers). Caps > 8
    words additionally use the strided-gather extension path."""
    S = data.shape[0]
    pos = jnp.arange(S, dtype=jnp.int32)
    d = data.astype(jnp.uint32)

    b1 = jnp.concatenate([d[1:], jnp.zeros((1,), jnp.uint32)])
    b2 = jnp.concatenate([d[2:], jnp.zeros((2,), jnp.uint32)])
    tri = d | (b1 << np.uint32(8)) | (b2 << np.uint32(16))
    h = ((tri * HASH_MUL) >> np.uint32(32 - HASH_BITS)).astype(jnp.uint32)

    w4 = _words4(data)
    PW = min(max_match_words, 8)       # payload words scored through the sort
    # payload table P[i, t] = w4[i + 4t], t = 0..PW (last column scores the
    # tail byte run past the last full word) — elementwise slices
    cols = [w4]
    for t in range(1, PW + 1):
        cols.append(jnp.concatenate([w4[4 * t:],
                                     jnp.zeros((4 * t,), jnp.uint32)]))
    P = jnp.stack(cols, axis=1)                       # (S, PW+1)

    # A single-operand packed sort ((hash14 << 18) | pos) was no faster
    # when this was designed, so argsort keeps the full 16-bit hash. On the
    # H100 the sort lowers to a radix sort, a small share of a shard's time
    # (PERF.md).
    order = jnp.argsort(h, stable=True)
    hs = h[order]
    ps = order.astype(jnp.int32)        # == pos[order]
    # Single-tier scoring (row-gather-bound as designed): ALL candidates
    # get a 2-word (11-byte-exact) preselect over NARROW 3-column sorted
    # rows, then the one winner is rescored exactly
    # IN POSITION ORDER, where a position's own payload row is just P's
    # natural layout — so the whole stage spends TWO row-gather streams
    # (narrow sorted preselect rows + the winner's rows) and ONE 1-column
    # scatter, instead of three full-width streams. Selection quality loss
    # is only among candidates that tie beyond 11 leading bytes (nearest
    # wins the tie — zlib's own chain walk has the same nearest-first
    # bias); measured ratio cost on the bench corpus is < 0.01%.
    FAR_WORDS = min(2, PW - 1) if PW >= 2 else 0
    KM = num_candidates
    ps_pad = _padded(ps, KM, -1)
    if S <= (1 << 20) and FAR_WORDS == 2 and num_candidates <= 64:
        # STACKED preselect: all K candidates scored in one (K, S) batch of
        # fused elementwise ops (the per-k Python loop was ~300 tiny
        # dispatches). Same-hash candidacy comes from ONE run-start scan
        # over the sorted keys instead of K shifted hash compares, and the
        # winner is selected by a single packed max —
        # key = (nbytes+1)<<26 | (K-k)<<20 | cand — which preserves the
        # strict nearest-wins tie-break (smaller k first) without a gather.
        pr = P[:, :FAR_WORDS + 1][order]         # NARROW (S, 3) row gather
        pw = [pr[:, t] for t in range(FAR_WORDS + 1)]
        pw_pad = [_padded(pw[t], KM, np.uint32(0))
                  for t in range(FAR_WORDS + 1)]
        K = num_candidates
        idx_s = jnp.arange(S, dtype=jnp.int32)
        run_ne = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                                  hs[1:] != hs[:-1]])
        from . import scans
        seg_start = scans.cummax(jnp.where(run_ne, idx_s, -1))
        dseg = idx_s - seg_start

        # unrolled fused max-reduce: no (K, S) materialization
        mk = jnp.full((S,), -1, jnp.int32)
        for k in range(1, K + 1):
            cnd = _shifted(ps_pad, k, KM, S)
            ok = (k <= dseg) & (cnd >= 0) & \
                ((ps - cnd) <= C.WINDOW_SIZE)
            d0f = pw[0] ^ _shifted(pw_pad[0], k, KM, S)
            d1f = pw[1] ^ _shifted(pw_pad[1], k, KM, S)
            dlf = pw[2] ^ _shifted(pw_pad[2], k, KM, S)
            e0f = d0f == 0
            e1f = d1f == 0
            nwf = e0f.astype(jnp.int32) + (e0f & e1f).astype(jnp.int32)
            fdf = jnp.where(~e0f, d0f, jnp.where(~e1f, d1f, dlf))
            nbf = 4 * nwf + _tail_bytes(fdf)
            keyf = jnp.where(ok, ((nbf + 1) << 26) | ((K - k) << 20)
                             | cnd, -1)
            mk = jnp.maximum(mk, keyf)
        best_cand = jnp.where(mk >= (1 << 26), mk & 0xFFFFF, -1)
        # back to position order — ONE 1-column scatter (ps is a permutation)
        cand_p = jnp.full((S,), -1, jnp.int32).at[ps].set(best_cand)
        valid = cand_p >= 0
        cand_c = jnp.maximum(cand_p, 0)
        # exact rescore IN POSITION ORDER: own rows are P's layout (no
        # gather), only the winner's rows are fetched
        fr = P[cand_c]                                 # (S, PW+1) row gather
        run = jnp.ones((S,), jnp.int32)
        nw = jnp.zeros((S,), jnp.int32)
        first_diff = jnp.zeros((S,), jnp.uint32)
        for t in range(PW):
            diff = P[:, t] ^ fr[:, t]
            hit = (run > 0) & (diff != 0)
            first_diff = jnp.where(hit, diff, first_diff)
            eq = (diff == 0).astype(jnp.int32)
            nw = nw + run * eq
            run = run * eq
        dlast = P[:, PW] ^ fr[:, PW]
        first_diff = jnp.where(run > 0, dlast, first_diff)
        blen_p = jnp.where(valid, 4 * nw + _tail_bytes(first_diff), -1)
    else:
        pr = P[order]                                  # full (S, PW+1) rows
        pw = [pr[:, t] for t in range(PW + 1)]
        hs_pad = _padded(hs, KM, np.uint32(0xFFFFFFFF))
        pw_pad = [_padded(pw[t], KM, np.uint32(0)) for t in range(PW + 1)]

        def score_k(k, words):
            """Byte-exact leading-match length vs the k-th sorted
            predecessor, scored over the first `words` payload words
            (+1 tail word)."""
            same = hs == _shifted(hs_pad, k, KM, S)
            cnd = _shifted(ps_pad, k, KM, S)
            ok = same & (cnd >= 0) & (ps - cnd <= C.WINDOW_SIZE)
            run = jnp.ones((S,), jnp.int32)
            nw = jnp.zeros((S,), jnp.int32)
            first_diff = jnp.zeros((S,), jnp.uint32)
            for t in range(words):
                diff = pw[t] ^ _shifted(pw_pad[t], k, KM, S)
                hit = (run > 0) & (diff != 0)
                first_diff = jnp.where(hit, diff, first_diff)
                eq = (diff == 0).astype(jnp.int32)
                nw = nw + run * eq
                run = run * eq
            dlast = pw[words] ^ _shifted(pw_pad[words], k, KM, S)
            first_diff = jnp.where(run > 0, dlast, first_diff)
            nbytes = 4 * nw + _tail_bytes(first_diff)  # exact to 4*words+3
            return jnp.where(ok, nbytes, -1), cnd

        best_bytes = jnp.full((S,), -1, jnp.int32)
        best_cand = jnp.full((S,), -1, jnp.int32)
        for k in range(1, num_candidates + 1):
            nbytes, cnd = score_k(k, FAR_WORDS)
            upd = nbytes > best_bytes   # strict: earlier k (nearer) wins ties
            best_bytes = jnp.where(upd, nbytes, best_bytes)
            best_cand = jnp.where(upd, cnd, best_cand)

        # exact rescore of the winner in sorted order + 2-column scatter
        fc = jnp.maximum(best_cand, 0)
        fr = P[fc]                                     # (S, PW+1)
        run = jnp.ones((S,), jnp.int32)
        nw = jnp.zeros((S,), jnp.int32)
        first_diff = jnp.zeros((S,), jnp.uint32)
        for t in range(PW):
            diff = pr[:, t] ^ fr[:, t]
            hit = (run > 0) & (diff != 0)
            first_diff = jnp.where(hit, diff, first_diff)
            eq = (diff == 0).astype(jnp.int32)
            nw = nw + run * eq
            run = run * eq
        dlast = pr[:, PW] ^ fr[:, PW]
        first_diff = jnp.where(run > 0, dlast, first_diff)
        best_bytes = jnp.where(best_cand >= 0,
                               4 * nw + _tail_bytes(first_diff), -1)
        bc = jnp.full((S, 2), -1, jnp.int32).at[ps].set(
            jnp.stack([best_bytes, best_cand], axis=1))
        blen_p = bc[:, 0]
        cand_p = bc[:, 1]
        valid = cand_p >= 0
        cand_c = jnp.maximum(cand_p, 0)

    if max_match_words > PW:
        # extension beyond the payload: 4-byte-stride gathers where the whole
        # payload matched (the only gather traffic; width = cap - payload)
        EXT = max_match_words - PW
        t4 = 4 * PW + 4 * jnp.arange(EXT, dtype=jnp.int32)
        src_i = jnp.clip(cand_c[:, None] + t4[None, :], 0, S - 1)
        dst_i = jnp.clip(pos[:, None] + t4[None, :], 0, S - 1)
        eq_ext = jnp.take(w4, src_i, axis=0) == jnp.take(w4, dst_i, axis=0)
        ext_words = jnp.sum(jnp.cumprod(eq_ext.astype(jnp.int32), axis=-1),
                            axis=-1)
        full_pay = blen_p >= 4 * PW
        nwords = jnp.minimum(PW + ext_words, max_match_words)
        # tail after the extended run (2 gathers, extension path only)
        tw = jnp.clip(4 * nwords, 0, S - 1)
        sx = w4[jnp.clip(cand_c + tw, 0, S - 1)]
        dx = w4[jnp.clip(pos + tw, 0, S - 1)]
        ext_len = 4 * nwords + _tail_bytes(sx ^ dx)
        length = jnp.where(full_pay, ext_len, blen_p)
    else:
        length = blen_p
    length = jnp.minimum(length, C.MAX_MATCH)
    length = jnp.minimum(length, S - pos)   # padding equality is fake
    length = jnp.where(valid, length, 0)
    length = jnp.where(length >= C.MIN_MATCH, length, 0)
    dist = jnp.where(length > 0, pos - cand_c, 0)
    return length.astype(jnp.int32), dist.astype(jnp.int32)


def greedy_parse_flat(token_len: jnp.ndarray) -> jnp.ndarray:
    """Reference parse: plain pointer doubling over the whole shard
    (log2(S) scatter+gather rounds). Kept as the oracle for the chunked
    version below."""
    S = token_len.shape[0]
    nxt = jnp.minimum(jnp.arange(S, dtype=jnp.int32) + token_len, S)
    jump = jnp.concatenate([nxt, jnp.array([S], jnp.int32)])  # S absorbing
    # `| (jump < 0)` is always False but ties the carry to the data so its
    # varying-axis type matches inside shard_map (scan-vma rule).
    chosen = jnp.zeros((S + 1,), jnp.bool_).at[0].set(True) | (jump < 0)

    rounds = max(1, int(np.ceil(np.log2(max(S, 2)))))

    def body(carry, _):
        chosen, jump = carry
        tgt = jnp.where(chosen, jump, S)
        chosen = chosen.at[tgt].set(True)
        jump = jump[jump]
        return (chosen, jump), None

    (chosen, _), _ = jax.lax.scan(body, (chosen, jump), None, length=rounds)
    return chosen[:S]


def greedy_parse(token_len: jnp.ndarray, chunk: int = 64,
                 scan_batch: int = 8, reset: int = 0) -> jnp.ndarray:
    """Greedy left-to-right parse: mark the positions where tokens start.

    token_len[i] >= 1 is the number of bytes a token starting at i consumes;
    the chosen set is the orbit of 0 under next[i] = i + token_len[i].

    Chunked resolution (random accesses were the design's bottleneck): within
    `chunk`-position chunks, exit pointers resolve in log2(chunk) doubling
    rounds (phase A, the only full-S gathers); a cheap scan threads entries
    across chunks, `scan_batch` chunks per step (phase B); the within-chunk
    walks from each entry are then marked by ONE lockstep scan of `chunk`
    steps over all chunks simultaneously — per step a (nchunks,)-element
    gather + scatter instead of full-S doubling rounds (phase C; designed
    to be much cheaper than the scatter-doubling variant).

    `reset` > 0 asserts that every multiple of `reset` is a token start —
    true for the codec because tokenize clamps tokens at 32 KB tile
    boundaries — which makes the phase-B threading INDEPENDENT per tile:
    the walks run in lockstep across all tiles, dividing the serial
    dependent-gather chain (the parse's real cost as designed: latency per
    dependent hop) by the tile count.
    """
    S = token_len.shape[0]
    if S % chunk or S <= chunk or (S // chunk) % scan_batch:
        return greedy_parse_flat(token_len)
    if reset and (S % reset or reset % chunk
                  or (reset // chunk) % scan_batch):
        reset = 0
    nchunks = S // chunk
    pos = jnp.arange(S, dtype=jnp.int32)
    g = jnp.minimum(pos + token_len, S)

    # phase A: e[i] = first walk position >= end of i's chunk.
    # Right-to-left lockstep column scan over the (nchunks, chunk) layout:
    # column j's exit either leaves the chunk directly or equals the exit of
    # a LATER column (walks only move forward), which is already resolved.
    # One (nchunks,)-gather per step — S gathers total — versus log2(chunk)
    # full-S doubling rounds (once the parse hot spot).
    # TRANSPOSED (chunk, nchunks) layout: each scan step updates one
    # CONTIGUOUS row (in-place in the scan carry) and gathers along axis 0
    # — the axis-1 dynamic_update_slice of the row-major form forced a
    # full-buffer copy per step.
    base = jnp.arange(nchunks, dtype=jnp.int32) * chunk
    g2t = g.reshape(nchunks, chunk).T                    # (chunk, nchunks)
    endc = base + chunk                                  # (nchunks,)

    row_iota = jnp.arange(chunk, dtype=jnp.int32)[:, None]

    def exit_col(e2t, j):
        tgt = jax.lax.dynamic_slice_in_dim(g2t, j, 1, axis=0)[0]  # (nchunks,)
        out = tgt >= endc
        loc = jnp.clip(tgt - base, 0, chunk - 1)
        # dense small-index select (row space = chunk): replaces the
        # per-step (nchunks,)-gather — a fused compare-select-reduce was
        # chosen over gathers wherever the index space is small. Rows > j
        # are the only ones selectable (g moves strictly forward within the
        # chunk).
        inner = jnp.sum(jnp.where(row_iota == loc[None, :], e2t, 0), axis=0)
        col = jnp.where(out, tgt, inner)
        return jax.lax.dynamic_update_slice_in_dim(
            e2t, col[None, :], j, axis=0), None

    e2t_0 = jnp.zeros((chunk, nchunks), jnp.int32) + g2t * 0   # data-tied
    e2t, _ = jax.lax.scan(exit_col, e2t_0,
                          jnp.arange(chunk - 1, -1, -1, dtype=jnp.int32))
    e = e2t.T.reshape(S)

    # phase B: thread entries across chunks (batched scan: `scan_batch`
    # dependent 1-element hops per step — same data, fewer step overheads).
    # With `reset`, all T tiles thread in LOCKSTEP (p is a (T,) vector and
    # each hop is one (T,)-gather): the dependent chain shrinks T-fold.
    T = (S // reset) if reset else 1
    cpt = nchunks // T                  # chunks per tile
    tile_base = jnp.arange(T, dtype=jnp.int32) * (S // T)

    def chunk_batch_step(p, c0):
        entries = []
        for j in range(scan_batch):
            cl = c0 * scan_batch + j
            start = tile_base + cl * chunk        # (T,)
            inside = (p >= start) & (p < start + chunk)
            entries.append(jnp.where(inside, p, -1))
            p = jnp.where(inside, e[jnp.clip(p, 0, S - 1)], p)
        return p, jnp.stack(entries)

    p0 = tile_base + g[0] * 0          # data-tied (shard_map vma)
    _, entries = jax.lax.scan(chunk_batch_step, p0,
                              jnp.arange(cpt // scan_batch,
                                         dtype=jnp.int32))
    # entries: (steps, scan_batch, T) with chunk id t*cpt + step*sb + j
    entries = entries.reshape(cpt, T).T.reshape(nchunks)

    # phase C: walk all chunks from their entries in lockstep (transposed
    # (chunk+1, nchunks) jump table, axis-0 gathers — same layout rule as
    # phase A). Local successor or `chunk` (parked) once past the end.
    basec = jnp.arange(nchunks, dtype=jnp.int32) * chunk
    g2t_c = g.reshape(nchunks, chunk).T                  # (chunk, nchunks)
    loct = jnp.where(g2t_c < (basec + chunk)[None, :], g2t_c - basec[None, :],
                     chunk)
    locpt = jnp.concatenate([loct, jnp.full((1, nchunks), chunk, jnp.int32)],
                            axis=0)                      # (chunk+1, nchunks)
    cur0 = jnp.where(entries >= 0, entries - basec, chunk)  # local entry
    row_iota1 = jnp.arange(chunk + 1, dtype=jnp.int32)[:, None]

    def walk_step(st, _):
        cur, ch = st
        # dense small-index forms (row space = chunk+1) for BOTH the mark
        # (was a scatter) and the hop (was a gather) — same rationale as
        # phase A; parked lanes (cur == chunk) mark row `chunk`, sliced off
        ch = ch | (row_iota1 == cur[None, :])
        nxt = jnp.sum(jnp.where(row_iota1 == cur[None, :], locpt, 0), axis=0)
        return (nxt, ch), None

    # data-tied False init: scan carries must be "varying" under shard_map
    # (same vma rule as greedy_parse's p0/e2t_0 — see CLAUDE.md)
    ch0 = jnp.zeros((chunk + 1, nchunks), jnp.bool_) | (locpt < 0)
    (cur, chosen2t), _ = jax.lax.scan(walk_step, (cur0, ch0), None,
                                      length=chunk)
    return chosen2t[:chunk].T.reshape(S)


@functools.partial(jax.jit, static_argnames=("num_candidates", "lazy",
                                             "boundary", "max_match_words",
                                             "parse_chunk",
                                             "parse_scan_batch"))
def tokenize(data: jnp.ndarray, valid_len: jnp.ndarray,
             num_candidates: int = 32, lazy: bool = True,
             boundary: int = C.WINDOW_SIZE, max_match_words: int = 8,
             parse_chunk: int = 64, parse_scan_batch: int = 8):
    """Full LZ77 stage for one shard.

    Args:
      data: u8[S] shard bytes (S static; tail beyond valid_len is padding).
      valid_len: i32 scalar, number of real bytes.
      max_match_words: general-match length cap in 4-byte words (8 => 32 B;
        65 => full 258). Constant runs always reach 258 via the run detector.

    Returns dict with, per position (fixed shape S):
      chosen:  bool — a token starts here
      length:  i32 — match length (0 => literal)
      dist:    i32 — match distance (0 => literal)
    Padding positions (>= valid_len) are never chosen.
    """
    S = data.shape[0]
    pos = jnp.arange(S, dtype=jnp.int32)

    length, dist = find_matches(data, num_candidates, max_match_words)

    # Constant runs (period-1): exact dist-1 matches without any gathers.
    from . import scans
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32),
                            data[:-1].astype(jnp.int32)])
    neq = data.astype(jnp.int32) != prev
    nxt_start = jnp.where(neq, pos, S)
    run_end = jnp.flip(scans.cummin(jnp.flip(
        jnp.concatenate([nxt_start[1:], jnp.array([S], jnp.int32)]))))
    run_len = jnp.where(~neq, jnp.minimum(run_end - pos, C.MAX_MATCH), 0)
    better = run_len > length
    length = jnp.where(better, run_len, length)
    dist = jnp.where(better, 1, dist)

    # Chain extension to MAX_MATCH with ZERO gathers (log-doubling over
    # shifted slices). If i's match is certified through i+s-1 at dist d and
    # position i+s holds a match at the SAME d, the lengths chain:
    # true_len[i] >= s + len[i+s]. Three rounds (s = 32, 64, 128) lift the
    # 35-byte payload cap to >= 258. Every claimed byte stays certified
    # (lower-bound composition), so emitted tokens remain byte-exact.
    # Reference analogue: check_dup_str's unbounded byte walk to MAXLEN=258
    # (src/deflate_compress.c:164-180) — here re-shaped as a parallel
    # pointer-doubling closure instead of a serial compare loop.
    for s in (32, 64, 128):
        if s >= S:
            break
        l_s = jnp.concatenate([length[s:], jnp.zeros((s,), jnp.int32)])
        d_s = jnp.concatenate([dist[s:], jnp.zeros((s,), jnp.int32)])
        can = (length >= s + 3) & (d_s == dist) & (dist > 0)
        length = jnp.where(can, jnp.maximum(length, s + l_s), length)
    length = jnp.minimum(length, C.MAX_MATCH)

    # Clamp matches to the valid region and to coding-block (tile)
    # boundaries: a token must not EXTEND past a boundary so every block's
    # output starts exactly at its tile (stored-block payload correctness +
    # exact decode index); matches may still look BACK across boundaries
    # (RFC window semantics).
    length = jnp.minimum(length, jnp.maximum(valid_len - pos, 0))
    if boundary:
        length = jnp.minimum(length, boundary - (pos % boundary))
    length = jnp.where(length >= C.MIN_MATCH, length, 0)
    # zlib's TOO_FAR rule (deflate.c): a length-3 match beyond distance
    # TOO_FAR usually costs more bits than 3 literals — drop it.
    if TOO_FAR:
        length = jnp.where((length == 3) & (dist > TOO_FAR), 0, length)
        length = jnp.where(length >= C.MIN_MATCH, length, 0)
        dist = jnp.where(length > 0, dist, 0)

    if lazy:
        # One-step lazy: defer to i+1 if it has a strictly longer match
        # (zlib-style lazy evaluation; reference's greedy has no deferral).
        # Two-step look-ahead: also defer if i+2 has a match long enough to
        # pay for the extra literal (covers the same bytes plus more).
        nxt_len = jnp.concatenate([length[1:], jnp.zeros((1,), jnp.int32)])
        demote = (length > 0) & (nxt_len > length)
        if LAZY2:
            nxt2_len = jnp.concatenate([length[2:],
                                        jnp.zeros((2,), jnp.int32)])
            demote = demote | ((length > 0) & (nxt2_len > length + 1))
        length = jnp.where(demote, 0, length)
        dist = jnp.where(demote, 0, dist)

    token_len = jnp.where(length >= C.MIN_MATCH, length, 1)
    # the boundary clamp makes every `boundary` multiple a token start, so
    # the parse walk provably resets there (greedy_parse `reset`)
    chosen = greedy_parse(token_len, parse_chunk, parse_scan_batch,
                          reset=boundary if boundary else 0)
    chosen = chosen & (pos < valid_len)

    return {"chosen": chosen, "length": length, "dist": dist}
