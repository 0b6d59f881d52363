"""Cost model: adaptive DEFLATE block splitting from tile histograms.

The data-parallel replacement for the reference's AHT-driven chunk-split
heuristic (README.md:15-20; the per-symbol cost probe at
src/deflate_compress.c:290-308 rebuilds a full Huffman tree after EVERY
emitted symbol — O(n log n) per symbol). Here the same information — "optimal
bits if we cut a block here" — comes from 32 KB tile histograms:

  * per-tile litlen/dist histograms are exact sufficient statistics;
  * the cost of coding tiles [i, j) as ONE dynamic block is estimated in
    closed form as Σ f·log2(n/f) (the entropy lower bound the AHT's
    Σ weight·depth score tracks; see core/aht.py) + extra bits (exact) +
    a tree-description estimate;
  * a small dynamic program over tile boundaries picks the optimal
    segmentation (bounded merge run), instead of the reference's greedy
    online split.

All fixed-shape and jittable; vmaps over shards.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..format import constants as C

# estimated bits to describe one dynamic Huffman tree pair: 17 header bits +
# ~HCLEN*3 + roughly 5.5 bits/active symbol of RLE-coded lengths
_TREE_FIXED = 17.0 + 3 * 15
_TREE_PER_SYM = 5.5


def block_plan(ll_freq_micro: jnp.ndarray, d_freq_micro: jnp.ndarray,
               n_micro_valid: jnp.ndarray, max_merge: int = 8,
               tile_bytes: jnp.ndarray | None = None):
    """Choose dynamic-block boundaries over 32 KB micro-tiles.

    Args:
      ll_freq_micro: i32[M, 286] litlen histograms per tile (no EOB).
      d_freq_micro: i32[M, 30] distance-code histograms per tile.
      n_micro_valid: i32 scalar — number of tiles covering real bytes.
      max_merge: static bound on tiles per block.
      tile_bytes: optional i32[M] — real bytes per tile, so the stored
        alternative is priced from the actual (possibly short) tail length
        instead of a full 32 KB.

    Returns (split: bool[M], n_blocks: i32) — split[m] marks the first tile
    of each block; split[0] is always True.
    """
    M = ll_freq_micro.shape[0]
    len_extra = jnp.asarray(C.LENGTH_EXTRA, jnp.float32)
    dist_extra = jnp.asarray(C.DIST_EXTRA, jnp.float32)

    llf = ll_freq_micro.astype(jnp.float32)
    df = d_freq_micro.astype(jnp.float32)
    cum_ll = jnp.concatenate([jnp.zeros((1, llf.shape[1]), jnp.float32),
                              jnp.cumsum(llf, axis=0)], axis=0)
    cum_d = jnp.concatenate([jnp.zeros((1, df.shape[1]), jnp.float32),
                             jnp.cumsum(df, axis=0)], axis=0)

    def seg_cost(i, j):
        """Estimated bits for tiles [i, j) as one dynamic block (i<j)."""
        fll = cum_ll[j] - cum_ll[i]
        fd = cum_d[j] - cum_d[i]
        nll = jnp.sum(fll) + 1.0                       # + EOB
        nd = jnp.maximum(jnp.sum(fd), 1.0)
        h_ll = jnp.sum(jnp.where(fll > 0,
                                 fll * (jnp.log2(nll) - jnp.log2(
                                     jnp.maximum(fll, 1e-9))), 0.0))
        h_d = jnp.sum(jnp.where(fd > 0,
                                fd * (jnp.log2(nd) - jnp.log2(
                                    jnp.maximum(fd, 1e-9))), 0.0))
        extra = (jnp.sum(fll[257:286] * len_extra)
                 + jnp.sum(fd * dist_extra))
        active = (jnp.sum((fll > 0).astype(jnp.float32))
                  + jnp.sum((fd > 0).astype(jnp.float32)))
        return (h_ll + h_d + extra + _TREE_FIXED + _TREE_PER_SYM * active
                + jnp.log2(nll))                        # + EOB code ~log2

    # DP: opt[j] = min_{1<=k<=max_merge} opt[j-k] + cost(j-k, j)
    BIG = jnp.float32(3.4e38)

    if tile_bytes is None:
        tile_bytes = jnp.full((M,), C.WINDOW_SIZE, jnp.int32)

    # All (end-tile, merge-width) segment costs in ONE batched evaluation —
    # inside the scan they were M sequential loop steps of tiny ops (pure
    # loop overhead).
    ks = jnp.arange(1, max_merge + 1, dtype=jnp.int32)
    js = jnp.arange(1, M + 1, dtype=jnp.int32)
    cost_all = jax.vmap(lambda j: jax.vmap(
        lambda k: seg_cost(jnp.maximum(j - k, 0), j))(ks))(js)  # (M, mm)
    # single tiles may fall back to a stored block (merged blocks cannot:
    # LEN is 16-bit); give the DP that option so incompressible tiles stay
    # single. Priced from the tile's REAL byte count — a short
    # incompressible tail must not look 32 KB expensive.
    stored_all = 42.0 + 8.0 * tile_bytes.astype(jnp.float32)
    cost_all = cost_all.at[:, 0].min(stored_all)

    def step(opt_tail, j):
        # opt_tail: f32[max_merge] = opt[j-1], opt[j-2], ..., opt[j-max_merge]
        i_s = j - ks
        cand = jnp.where(i_s >= 0, opt_tail + cost_all[j - 1], BIG)
        best_k = jnp.argmin(cand)
        opt_j = cand[best_k]
        new_tail = jnp.concatenate([opt_j[None], opt_tail[:-1]])
        return new_tail, (opt_j, (best_k + 1).astype(jnp.int32))

    # `+ cost_all[0, 0] * 0` ties the carry to the (device-varying) data so
    # its varying-axis type is stable inside shard_map at NB > 1 (the
    # scan-vma rule; same trick as core/lz77.greedy_parse). A constant init
    # fails to trace under jax.shard_map with "carry input and carry output
    # must have equal types ... {V:shards}".
    init_tail = jnp.concatenate([jnp.zeros((1,), jnp.float32),
                                 jnp.full((max_merge - 1,), BIG)]) \
        + cost_all[0, 0] * 0
    if M <= 16:
        # Small M: UNROLL both sequential passes. Each scan step is a
        # handful of ~8-element ops — as lax.scan that is 2M device loop
        # iterations of pure overhead; unrolled, XLA fuses the whole DP
        # into a few kernels.
        opt_tail = init_tail
        back_list = []
        for jj in range(1, M + 1):
            opt_tail, (_, bk) = step(opt_tail, jj)
            back_list.append(bk)
        back_k = jnp.stack(back_list)
    else:
        _, (_, back_k) = jax.lax.scan(step, init_tail,
                                      jnp.arange(1, M + 1, dtype=jnp.int32))
    # back_k[j-1] = merge width chosen ending at tile j

    # Backtrack from n_micro_valid down to 0, marking block starts.
    # `* 0 > 0` data-ties split0 for shard_map's varying-type rule without
    # semantic coupling to back_k's sign (always False by construction)
    split0 = jnp.zeros((M,), jnp.bool_).at[0].set(True) | (back_k[:1] * 0 > 0)
    if M <= 16:
        jcur = n_micro_valid + back_k[0] * 0
        split = split0
        for _ in range(M):
            k = back_k[jnp.maximum(jcur - 1, 0)]
            start = jnp.maximum(jcur - k, 0)
            split = split.at[jnp.where(jcur > 0, start, M)].set(
                True, mode="drop")
            jcur = jnp.where(jcur > 0, start, 0)
    else:
        def bt_step(carry, _):
            j, split = carry
            k = back_k[jnp.maximum(j - 1, 0)]
            start = jnp.maximum(j - k, 0)
            split = split.at[start].set(jnp.where(j > 0, True, split[start]))
            return (jnp.where(j > 0, start, 0), split), None

        (_, split), _ = jax.lax.scan(bt_step,
                                     (n_micro_valid + back_k[0] * 0, split0),
                                     None, length=M)
    n_blocks = jnp.sum(split & (jnp.arange(M) < n_micro_valid))
    return split, n_blocks.astype(jnp.int32)
