"""Property tests for the round-5 decoder internals: dense symbol-space
tables vs the host LUT oracle, wide peek windows, row scans, and the
tile-reset parse equivalence."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from deflate_compression_tpu.core import scans
from deflate_compression_tpu.core.huffman import decode_lut_np
from deflate_compression_tpu.decode import tpu_inflate as TI
from corpora import TEXT_37K


def _random_lengths(rng, n, max_bits=15):
    """Random COMPLETE canonical code-length set over n symbols (Kraft
    sum exactly 2^max_bits), built by splitting leaves."""
    # start from {0: len 1, 1: len 1} and randomly deepen
    lens = {0: 1, 1: 1}
    syms = [0, 1]
    next_sym = 2
    for _ in range(rng.integers(0, n - 2)):
        if next_sym >= n:
            break
        s = syms[rng.integers(0, len(syms))]
        if lens[s] >= max_bits:
            continue
        lens[s] += 1
        lens[next_sym] = lens[s]
        syms.append(next_sym)
        next_sym += 1
    out = np.zeros(n, np.int64)
    for s, l in lens.items():
        out[s] = l
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sym_tables_match_host_lut(seed):
    rng = np.random.default_rng(seed)
    n = 288
    lens = _random_lengths(rng, n)
    sym_lut, len_lut = decode_lut_np(lens[:286], 15)   # host oracle

    lengths = jnp.asarray(lens, jnp.int32)[None, :]
    first, over = TI._canon_first(lengths, 15)
    assert not bool(over[0])
    pay_static = np.arange(n, dtype=np.int32)          # payload = symbol id
    rcode, mask, pay = TI._sym_tables(lengths, first, 15, pay_static, 20)
    rcode, mask, pay = (np.asarray(x)[0] for x in (rcode, mask, pay))

    peeks = rng.integers(0, 1 << 15, 300)
    for pk in peeks:
        hits = [s for s in range(n)
                if lens[s] > 0 and (pk & mask[s]) == rcode[s]]
        assert len(hits) <= 1
        if len_lut[pk] > 0 and int(sym_lut[pk]) < 286:
            assert hits == [int(sym_lut[pk])]
            assert (pay[hits[0]] & 0xFFFFF) == hits[0]
            assert (pay[hits[0]] >> 20) == lens[hits[0]]


def test_dense_sym_resolves_groups():
    rng = np.random.default_rng(7)
    n = 32
    Gn, Lg = 4, 64
    lens = np.stack([_random_lengths(rng, n) for _ in range(Gn)])
    lengths = jnp.asarray(lens, jnp.int32)
    first, _ = TI._canon_first(lengths, 15)
    pay_static = np.arange(n, dtype=np.int32) + 1      # 0 => invalid
    rcode, mask, pay = TI._sym_tables(lengths, first, 15, pay_static, 20)
    pk = jnp.asarray(rng.integers(0, 1 << 15, Gn * Lg, dtype=np.int64),
                     jnp.int32)
    out = np.asarray(TI._dense_sym(pk, rcode, mask, pay, Gn, Lg))
    rc, mk, py = np.asarray(rcode), np.asarray(mask), np.asarray(pay)
    pkh = np.asarray(pk).reshape(Gn, Lg)
    for g in range(Gn):
        for l in range(Lg):
            hits = [py[g, s] for s in range(n)
                    if lens[g, s] > 0 and (pkh[g, l] & mk[g, s]) == rc[g, s]]
            want = hits[0] if hits else 0
            assert out[g * Lg + l] == want


def test_peekwin_extractw_bits():
    rng = np.random.default_rng(3)
    nbytes = 256
    data = rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
    bits = int.from_bytes(data, "little")
    words = np.frombuffer(data, np.uint32)
    hw = TI._winwords(jnp.asarray(words))
    for bp in [0, 1, 13, 16, 31, 32, 100, 555, 1000]:
        win = TI._peekwin(hw, jnp.asarray([bp], jnp.int32))
        valid = 32 * TI._NWIN - 15
        for off in [0, 5, 31, 32, 63, 64, 95, 96, 120]:
            got = int(np.asarray(
                TI._extractw(win, jnp.asarray([off], jnp.int32)))[0])
            nvalid = min(32, max(0, valid - off),
                         8 * nbytes - bp - off)    # bits actually defined
            if nvalid <= 0:
                continue
            want = (bits >> (bp + off)) & ((1 << nvalid) - 1)
            assert got & ((1 << nvalid) - 1) == want, (bp, off)


def test_cummax_rows_matches_lax():
    rng = np.random.default_rng(11)
    for B, S in [(3, 256), (2, 4096), (1, 64), (4, 100)]:
        x = jnp.asarray(rng.integers(0, 1 << 30, (B, S), dtype=np.int64),
                        jnp.int32)
        got = np.asarray(scans.cummax_rows(x))
        want = np.maximum.accumulate(np.asarray(x), axis=1)
        assert (got == want).all()
    # u32 with zero sentinel (the decoder's covering-d pack dtype)
    xu = jnp.asarray(rng.integers(0, 1 << 31, (2, 4096), dtype=np.int64)
                     .astype(np.uint32))
    got = np.asarray(scans.cummax_rows(xu))
    want = np.maximum.accumulate(np.asarray(xu), axis=1)
    assert (got == want).all()


def test_greedy_parse_reset_equals_flat():
    from deflate_compression_tpu.core.lz77 import (greedy_parse,
                                                   greedy_parse_flat)
    rng = np.random.default_rng(5)
    S = 1 << 16
    reset = 1 << 13
    for trial in range(3):
        # random token lengths, clamped at `reset` boundaries exactly like
        # tokenize's boundary clamp (the precondition for the reset trick)
        tl = rng.integers(1, 40, S).astype(np.int32)
        mask_long = rng.random(S) < 0.9
        tl[mask_long] = 1
        pos = np.arange(S)
        tl = np.minimum(tl, reset - (pos % reset))
        tlj = jnp.asarray(tl)
        a = np.asarray(greedy_parse(tlj, reset=reset))
        b = np.asarray(greedy_parse_flat(tlj))
        assert (a == b).all()
        # every reset boundary must be a token start (precondition holds)
        assert a[::reset].all()


def test_decoder_handles_foreign_15bit_codes():
    # a zlib level-9 stream (can contain up to 15-bit codes) through the
    # dense symbol-space decoder via a foreign-built index
    import zlib
    from deflate_compression_tpu.decode.index import (build_index,
                                                      decompress_indexed)
    rng = np.random.default_rng(9)
    # skewed data drives deep trees
    raw = (rng.choice(np.frombuffer(b"abcdefgh" * 4 + b"\x00" * 200, np.uint8),
                      1 << 16).tobytes()
           + TEXT_37K)
    z = zlib.compress(raw, 9)
    body = z[2:-4]
    idx = build_index(body, prefer_native=False)
    out = decompress_indexed(body, idx,
                             expected_adler=int.from_bytes(z[-4:], "big"))
    assert out == raw


class _BitWriter:
    """LSB-first bit writer (test-local; codes must arrive pre-reversed)."""

    def __init__(self):
        self.bits = 0
        self.n = 0

    def put(self, value, nbits):
        self.bits |= (value & ((1 << nbits) - 1)) << self.n
        self.n += nbits

    def bytes(self):
        return self.bits.to_bytes((self.n + 7) // 8, "little")


def _rev(code, n):
    r = 0
    for _ in range(n):
        r = (r << 1) | (code & 1)
        code >>= 1
    return r


def test_deep_15bit_literal_stream_single_lane():
    """Regression (round-5 review): a VALID foreign stream whose literals
    use 15-bit codes, decoded with ONE lane spanning > 576 bytes, must not
    exhaust the symbol loop's step bound (steps advance by KSYM per body
    while as few as 9 symbols decode per 192-bit window at 15-bit codes)."""
    # complete litlen tree: lens[256+k] = k+1 for k in 0..13 (unused),
    # lens[0] = lens[1] = 15 (kraft: sum 2^-1..2^-14 + 2*2^-15 == 1)
    ll = np.zeros(288, np.int64)
    for k in range(14):
        ll[256 + k] = k + 1          # EOB itself gets the 1-bit code (k=0)
    ll[0] = 15
    ll[1] = 15
    dd = np.zeros(30, np.int64)
    dd[0] = 1                        # single 1-bit dist code (incomplete: ok)

    from deflate_compression_tpu.core.huffman import canonical_codes_np
    llc = canonical_codes_np(ll, 15)
    w = _BitWriter()
    w.put(1, 1)                      # BFINAL
    w.put(2, 2)                      # BTYPE dynamic
    w.put(286 - 257, 5)              # HLIT
    w.put(0, 5)                      # HDIST
    # clen alphabet: we must transmit 286 litlen lens + 1 dist len via the
    # RLE code. Used clen symbols: {0, 1..15, 18} — a COMPLETE 17-leaf
    # tree: one 1-bit code (symbol 0) + sixteen 5-bit codes (kraft
    # 1/2 + 16/32 == 1).
    clen_lens = np.zeros(19, np.int64)
    clen_lens[0] = 1
    for v in list(range(1, 16)) + [18]:
        clen_lens[v] = 5
    clc = canonical_codes_np(clen_lens, 7)
    from deflate_compression_tpu.format import constants as C
    order = list(C.CLEN_ORDER)
    hclen_syms = [int(clen_lens[order[j]]) for j in range(19)]
    last = max(j for j in range(19) if hclen_syms[j] > 0)
    w.put(last + 1 - 4, 4)           # HCLEN
    for j in range(last + 1):
        w.put(hclen_syms[j], 3)

    def put_clen(sym, extra=None, ebits=0):
        assert clen_lens[sym] > 0, sym
        w.put(_rev(int(clc[sym]), int(clen_lens[sym])), int(clen_lens[sym]))
        if ebits:
            w.put(extra, ebits)

    # litlen lens: [15, 15, 0 x 254, 1..12, 14, 15... ] per ll above:
    put_clen(15)                     # lens[0] = 15
    put_clen(15)                     # lens[1] = 15
    # 254 zeros: 18(+127), 18(+127... max run 138): 138 + 116
    put_clen(18, 138 - 11, 7)
    put_clen(18, 116 - 11, 7)
    for k in range(14):              # lens[256..269] = 1..14
        put_clen(k + 1)
    # lens[270..285] zeros: 16 zeros
    put_clen(18, 16 - 11, 7)
    put_clen(1)                      # the single dist len
    # body: N 15-bit literals (symbol 0), then EOB (1-bit code)
    N = 2000
    lit_code = _rev(int(llc[0]), 15)
    for _ in range(N):
        w.put(lit_code, 15)
    w.put(_rev(int(llc[256]), 1), 1)
    body = w.bytes()

    # sanity: the host oracle decodes it
    from deflate_compression_tpu.decode.inflate import _inflate_raw_py
    out, _ = _inflate_raw_py(body)
    assert out == b"\x00" * N

    # ONE lane spanning all N bytes (no sub-entries): the step-bound path
    words = np.frombuffer(body + b"\x00" * ((-len(body)) % 4), np.uint32)
    S = 2048
    r = TI.decode_shard_indexed(
        jnp.asarray(words), jnp.asarray([0], jnp.int32),
        jnp.asarray([0], jnp.int32), jnp.asarray([2], jnp.int32),
        jnp.int32(1), jnp.int32(N), S)
    assert bool(r["ok"])
    assert np.asarray(r["out"])[:N].tobytes() == b"\x00" * N
