"""LZ77 tokenizer property tests.

The decode-as-you-encode idea of tests/check_lld.c (reference :1-6, :20-39):
every emitted token is replayed through an independent window to reconstruct
the input. Here that replay is the core property test for the tokenizer.
"""
import jax
import numpy as np
import jax.numpy as jnp
import pytest

from deflate_compression_tpu.core import lz77
from deflate_compression_tpu.format import constants as C
from corpora import TEXT_37K

S = 32768


def replay(data, valid_len, chosen, length, dist):
    """Independent sliding-window replay (mirrors check_lld.c's do_write ring
    replay, reference tests/check_lld.c:20-39)."""
    out = bytearray()
    i = 0
    while i < valid_len:
        assert chosen[i], f"position {i} not covered by a token"
        if length[i] >= C.MIN_MATCH:
            d, l = int(dist[i]), int(length[i])
            assert 1 <= d <= C.WINDOW_SIZE and d <= len(out)
            assert l <= C.MAX_MATCH
            start = len(out) - d
            for k in range(l):
                out.append(out[start + k])
            i += l
        else:
            out.append(int(data[i]))
            i += 1
    return bytes(out)


def run_case(raw: bytes):
    vl = len(raw)
    buf = np.zeros(S, np.uint8)
    buf[:vl] = np.frombuffer(raw, np.uint8)
    tok = lz77.tokenize(jnp.asarray(buf), jnp.int32(vl))
    chosen = np.asarray(tok["chosen"])
    length = np.asarray(tok["length"])
    dist = np.asarray(tok["dist"])
    # no token may start at padding
    assert not chosen[vl:].any()
    got = replay(buf, vl, chosen, length, dist)
    assert got == raw
    return chosen, length


def test_text():
    raw = TEXT_37K[:S]
    chosen, length = run_case(raw)
    # text must actually find matches
    assert (length[chosen] >= 3).sum() > 100


def test_repeats():
    chosen, length = run_case(b"abcabcabc" * 3000)
    # heavy repetition: nearly everything should be matched
    n_lit = int((chosen & (length < 3)).sum())
    assert n_lit < 32


def test_random_incompressible():
    raw = np.random.default_rng(3).integers(0, 256, S).astype(np.uint8).tobytes()
    run_case(raw)


def test_all_same_byte():
    run_case(b"\x7f" * 20000)


def test_short_inputs():
    for n in (1, 2, 3, 4, 7):
        run_case(bytes(range(n)))


def test_window_limit():
    # a repeat 40000 bytes apart must NOT be matched across > 32KB
    raw = (b"UNIQUEPATTERN" + bytes(np.random.default_rng(1).integers(0, 256, 40000, dtype=np.uint8)) + b"UNIQUEPATTERN")
    # use a 2-block shard
    vl = len(raw)
    buf = np.zeros(2 * S, np.uint8)
    buf[:vl] = np.frombuffer(raw, np.uint8)
    tok = lz77.tokenize(jnp.asarray(buf), jnp.int32(vl))
    dist = np.asarray(tok["dist"])
    assert (dist <= C.WINDOW_SIZE).all()
    got = replay(buf, vl, np.asarray(tok["chosen"]), np.asarray(tok["length"]), dist)
    assert got == raw


def test_match_crosses_block_boundary_within_shard():
    # pattern right before the 32KB boundary repeated right after it: the
    # window legally crosses coding-block boundaries inside a shard
    pat = b"0123456789abcdef" * 4
    raw = bytearray(np.random.default_rng(2).integers(0, 256, 2 * S, dtype=np.uint8))
    raw[S - 64:S] = pat
    raw[S:S + 64] = pat
    raw = bytes(raw)
    buf = np.frombuffer(raw, np.uint8)
    tok = lz77.tokenize(jnp.asarray(buf), jnp.int32(len(raw)))
    got = replay(buf, len(raw), np.asarray(tok["chosen"]),
                 np.asarray(tok["length"]), np.asarray(tok["dist"]))
    assert got == raw


def test_chunked_parse_equals_flat():
    rng = np.random.default_rng(9)
    for trial in range(6):
        Sz = 4096
        tl = np.ones(Sz, np.int32)
        # random mix of matches and literals
        m = rng.random(Sz) < 0.3
        tl[m] = rng.integers(3, 259, m.sum())
        got = np.asarray(jax.jit(lz77.greedy_parse)(jnp.asarray(tl)))
        want = np.asarray(jax.jit(lz77.greedy_parse_flat)(jnp.asarray(tl)))
        assert (got == want).all(), trial


def test_chain_extension_reaches_max_match():
    """Periodic data (period > payload width) must emit full-length matches:
    the zero-gather chain extension lifts the 35-byte payload cap to 258
    (reference analogue: check_dup_str walks to MAXLEN=258,
    src/deflate_compress.c:164-180)."""
    rng = np.random.default_rng(7)
    tile = rng.integers(0, 256, 64, dtype=np.uint8)
    raw = np.tile(tile, 256).tobytes()       # 16 KB, period 64
    chosen, length = run_case(raw)
    # the bulk of the stream must be covered by 258-byte matches
    assert (length[chosen] == C.MAX_MATCH).sum() >= 50
    # token count near the optimal ~ len/258 (+ first period of literals)
    assert chosen.sum() < 64 + 2 * (len(raw) // C.MAX_MATCH)
