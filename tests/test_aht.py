"""Adaptive Huffman tree tests.

The killer property (Gallager's theorem): a sibling-property tree is an
optimal Huffman tree for its weights, so after EVERY insert the running
`score` must equal the static optimal Huffman cost of the histogram so far.
This is a much stronger check than the reference's aht_check_score
(src/aht.c:330-349), which only re-verifies the incremental bookkeeping.
"""
import heapq

import numpy as np
import pytest

from deflate_compression_tpu.core.aht import AdaptiveHuffmanTree, aht_cost_trace
from corpora import TEXT_37K


def opt_cost(counts):
    # the NYT node is a real zero-weight leaf in the adaptive tree: the
    # optimal achievable cost is the Huffman cost over counts ∪ {0}
    h = [c for c in counts.values() if c > 0]
    if not h:
        return 0
    h.append(0)
    heapq.heapify(h)
    cost = 0
    while len(h) > 1:
        a, b = heapq.heappop(h), heapq.heappop(h)
        cost += a + b
        heapq.heappush(h, a + b)
    return cost


STREAMS = [
    np.random.default_rng(0).integers(0, 5, 300),
    np.random.default_rng(1).integers(0, 50, 600),
    np.array([1] * 100),
    np.random.default_rng(2).zipf(1.5, 800) % 64,
    np.frombuffer(
        TEXT_37K[:2000], np.uint8),
]


@pytest.mark.parametrize("idx", range(len(STREAMS)))
def test_score_equals_static_optimal_after_every_insert(idx):
    stream = STREAMS[idx]
    t = AdaptiveHuffmanTree(286)
    counts = {}
    for i, s in enumerate(stream):
        s = int(s)
        t.insert(s)
        counts[s] = counts.get(s, 0) + 1
        if i % 23 == 0 or i == len(stream) - 1:
            t.check()
            assert t.score == opt_cost(counts), i


def test_depths_form_prefix_code():
    t = AdaptiveHuffmanTree(64)
    for s in np.random.default_rng(5).integers(0, 40, 500):
        t.insert(int(s))
    d = t.depths()
    # Kraft: active leaves plus the NYT leaf exactly fill the tree
    nyt_depth = 0
    n = t.nyt
    while n.parent is not None:
        nyt_depth += 1
        n = n.parent
    kraft = sum(2.0 ** -v for v in d.values()) + 2.0 ** -nyt_depth
    assert abs(kraft - 1.0) < 1e-12


def test_trace_is_monotone_and_matches_reference_format():
    data = np.frombuffer(b"abracadabra" * 20, np.uint8)
    trace = aht_cost_trace(data, 286)
    assert len(trace) == len(data)
    assert all(b >= a for a, b in zip(trace, trace[1:]))
    # 'a' repeated: second symbol costs little; late symbols ~ entropy
    assert trace[-1] < 8 * len(data)


def test_vitter_at_most_one_interchange_per_insert():
    # Vitter's theorem: the slide-and-increment update needs at most one
    # leaf interchange per inserted symbol (vs FGK's one per level).
    for stream in STREAMS:
        t = AdaptiveHuffmanTree(286)
        for s in stream:
            t.insert(int(s))
            assert t._last_insert_interchanges <= 1
        t.check()  # includes the leaves-before-internal block invariant


def test_dump_runs():
    t = AdaptiveHuffmanTree(8)
    for s in [1, 2, 1, 3, 1]:
        t.insert(s)
    out = t.dump()
    assert "leaf[1] w=3" in out and "NYT" in out


def test_dump_flags_depth_mismatch_inline():
    """The tree printer flags stored-vs-actual depth disagreements in place
    (reference aht_print's red flag, src/aht.c:298-301)."""
    t = AdaptiveHuffmanTree(16)
    for s in b"abracadabra":
        t.insert(s)
    d = t.dump()
    assert "DEPTH MISMATCH" not in d          # healthy tree: no flags
    assert "leaf" in d and "w=" in d
    # corrupt one stored depth; the flag must appear exactly there
    t.root.left.depth += 7
    d2 = t.dump()
    assert "DEPTH MISMATCH" in d2
    dc = t.dump(color=True)
    assert "\x1b[31m" in dc                   # ANSI red on the bad node
