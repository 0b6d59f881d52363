"""Huffman machinery tests.

Reference strategy analogue: the AHT invariant checker aht_check_score
(src/aht.c:330-349) recomputes Σ weight·depth independently; here the
independent recomputation is a plain-python package-merge reference.
"""
import heapq

import numpy as np
import jax.numpy as jnp
import pytest

from deflate_compression_tpu.core import huffman


def py_package_merge_cost(freqs, L):
    """Independent plain-python package-merge: total cost of the optimal
    L-limited code (sum of smallest 2k-2 items in the level-L list)."""
    ws = sorted(int(f) for f in freqs if f > 0)
    k = len(ws)
    if k <= 1:
        return ws[0] if k else 0
    cur = list(ws)
    for _ in range(L - 1):
        pk = [cur[i] + cur[i + 1] for i in range(0, len(cur) - 1, 2)]
        cur = sorted(ws + pk)
    return sum(cur[:2 * k - 2])


def py_unlimited_cost(freqs):
    h = [int(f) for f in freqs if f > 0]
    heapq.heapify(h)
    if len(h) == 1:
        return h[0]
    cost = 0
    while len(h) > 1:
        a, b = heapq.heappop(h), heapq.heappop(h)
        cost += a + b
        heapq.heappush(h, a + b)
    return cost


CASES = []
_rng = np.random.default_rng(42)
for i in range(6):
    f = _rng.integers(0, 2000, size=286)
    if i % 2:
        f[_rng.random(286) < 0.8] = 0
    CASES.append(f)
CASES += [
    np.zeros(286, int),
    np.eye(1, 286, 5, dtype=int).ravel() * 9,              # single symbol
    np.ones(286, int),                                     # uniform
    np.array([2 ** min(i, 25) for i in range(40)] + [0] * 246),  # deep skew
    np.array([1, 1] + [0] * 284),
]


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_lengths_valid_and_optimal(idx):
    freqs = CASES[idx]
    lengths = np.asarray(huffman.huffman_code_lengths(
        jnp.array(freqs, jnp.int32), 15))
    act = freqs > 0
    assert (lengths[~act] == 0).all()
    k = int(act.sum())
    if k == 0:
        assert (lengths == 0).all()
        return
    assert (lengths[act] >= 1).all() and (lengths[act] <= 15).all()
    kraft = np.sum(2.0 ** (-lengths[act].astype(float)))
    if k == 1:
        assert lengths[act][0] == 1
    else:
        assert abs(kraft - 1.0) < 1e-12
    got = int(np.sum(freqs[act] * lengths[act]))
    assert got == py_package_merge_cost(freqs, 15)


def test_monotone_freq_to_length():
    freqs = np.array([100, 10, 10, 1, 0, 50], dtype=np.int64)
    lengths = np.asarray(huffman.huffman_code_lengths(jnp.array(freqs, jnp.int32)))
    assert lengths[0] <= lengths[5] <= lengths[1] <= lengths[3]
    # deterministic tie-break: among equal freqs the earlier symbol sorts
    # first and receives the longer-or-equal code
    assert lengths[1] >= lengths[2]


def test_canonical_codes_match_numpy_mirror():
    freqs = _rng.integers(0, 500, size=286)
    lengths, codes = huffman.build_code_table(jnp.array(freqs, jnp.int32), 15)
    np_codes = huffman.canonical_codes_np(np.asarray(lengths), 15)
    assert (np.asarray(codes) == np_codes).all()


def test_canonical_property_rfc_example():
    # RFC 1951 §3.2.2 worked example: lengths (3,3,3,3,3,2,4,4)
    lengths = np.array([3, 3, 3, 3, 3, 2, 4, 4])
    codes = huffman.canonical_codes_np(lengths, 15)
    assert list(codes) == [0b010, 0b011, 0b100, 0b101, 0b110,
                           0b00, 0b1110, 0b1111]


def test_decode_lut_roundtrip():
    freqs = _rng.integers(1, 100, size=30)
    lengths, codes = huffman.build_code_table(jnp.array(freqs, jnp.int32), 15)
    lengths = np.asarray(lengths)
    codes = np.asarray(codes)
    sym_lut, len_lut = huffman.decode_lut_np(lengths, 15)
    for s in range(30):
        l = int(lengths[s])
        if l == 0:
            continue
        # bit-reverse code into received order, check LUT returns the symbol
        r = 0
        c = int(codes[s])
        for _ in range(l):
            r = (r << 1) | (c & 1)
            c >>= 1
        assert sym_lut[r] == s and len_lut[r] == l


def test_decode_lut_rejects_oversubscribed():
    with pytest.raises(ValueError):
        huffman.decode_lut_np(np.array([1, 1, 1]), 15)


def test_histogram_masked():
    sym = jnp.array([0, 1, 1, 2, 9])
    mask = jnp.array([True, True, False, True, True])
    h = np.asarray(huffman.histogram(sym, 10, mask=mask))
    assert list(h) == [1, 1, 1, 0, 0, 0, 0, 0, 0, 1]


@pytest.mark.parametrize("n_cls", [286, 30])
def test_rows_lookup_exact_near_2_20(n_cls):
    """Table words near 2^20 (code | len << 16) come back exactly;
    out-of-range symbols give 0."""
    rng = np.random.default_rng(3)
    sym = rng.integers(-1, n_cls + 2, (4, 4096)).astype(np.int32)
    tab = rng.integers((1 << 20) - 4096, 1 << 20, (4, n_cls)).astype(np.uint32)
    ok = (sym >= 0) & (sym < n_cls)
    want = np.where(ok, np.take_along_axis(tab, np.clip(sym, 0, n_cls - 1),
                                           axis=1), 0)
    got = np.asarray(huffman.rows_lookup(jnp.asarray(sym), jnp.asarray(tab)))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_histogram_rows_matmul_matches_bincount():
    rng = np.random.default_rng(4)
    sym = rng.integers(0, 287, (3, 5000)).astype(np.int32)
    got = np.asarray(huffman.histogram_rows_matmul(jnp.asarray(sym), 286))
    want = np.stack([np.bincount(r[r < 286], minlength=286) for r in sym])
    np.testing.assert_array_equal(got, want)
