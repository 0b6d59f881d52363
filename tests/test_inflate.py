"""Inflater tests: decode zlib-oracle-produced streams bit-exactly
(BASELINE.md: 'our inflater must bit-exactly reproduce originals from
zlib-produced streams')."""
import zlib

import numpy as np
import pytest

from deflate_compression_tpu.decode.inflate import inflate_raw, zlib_decompress
from deflate_compression_tpu.utils.errors import DeflateError
from corpora import TEXT_20K, TEXT_57K

CORPORA = {
    "bee": lambda: TEXT_57K,
    "rfc1950": lambda: TEXT_20K,
    "random": lambda: np.random.default_rng(0).integers(0, 256, 50000).astype(np.uint8).tobytes(),
    "zeros": lambda: b"\0" * 100000,
    "short": lambda: b"xyz",
    "empty": lambda: b"",
}


@pytest.mark.parametrize("name", list(CORPORA))
@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_inflate_zlib_streams(name, level):
    raw = CORPORA[name]()
    assert zlib_decompress(zlib.compress(raw, level)) == raw


@pytest.mark.parametrize("strategy", [zlib.Z_FIXED, zlib.Z_RLE, zlib.Z_HUFFMAN_ONLY])
def test_inflate_strategies(strategy):
    raw = CORPORA["bee"]()
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 8, strategy)
    comp = co.compress(raw) + co.flush()
    assert zlib_decompress(comp) == raw


def test_inflate_raw_stream():
    raw = CORPORA["rfc1950"]()
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(raw) + co.flush()
    got, _ = inflate_raw(comp)
    assert got == raw


def test_sync_flush_points_decode():
    # multiple sync flushes = empty stored blocks mid-stream
    raw1, raw2 = b"hello world " * 100, b"goodbye " * 77
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(raw1) + co.flush(zlib.Z_SYNC_FLUSH) \
        + co.compress(raw2) + co.flush()
    got, _ = inflate_raw(comp)
    assert got == raw1 + raw2


def test_bad_adler_rejected():
    comp = bytearray(zlib.compress(b"data data data"))
    comp[-1] ^= 0xFF
    with pytest.raises(DeflateError):
        zlib_decompress(bytes(comp))


def test_bad_fcheck_rejected():
    comp = bytearray(zlib.compress(b"data"))
    comp[1] ^= 0x01
    with pytest.raises(DeflateError):
        zlib_decompress(bytes(comp))


def test_fdict_rejected():
    # reference rejects FDICT too (src/deflate_decompress.c:361-364)
    cmf = 0x78
    flg = 0x20  # FDICT set
    flg |= (31 - ((cmf << 8 | flg) % 31)) % 31
    comp = bytes([cmf, flg]) + b"\x00" * 8
    with pytest.raises(DeflateError):
        zlib_decompress(comp)


def test_stored_len_nlen_mismatch():
    bad = bytes([0x01, 0x05, 0x00, 0x00, 0x00])  # NLEN not ~LEN
    with pytest.raises(DeflateError):
        inflate_raw(bad)


def test_distance_too_far_rejected():
    # fixed block: length-3 match at distance 1 against an empty window must
    # be rejected (reference bounds check src/deflate_decompress.c:278-279)
    acc, nb = 0, 0

    def put(v, n):
        nonlocal acc, nb
        acc |= v << nb
        nb += n

    put(1, 1)          # BFINAL
    put(1, 2)          # BTYPE=01 fixed
    put(1 << 6, 7)     # litlen 257 (7-bit code 0000001, bit-reversed)
    put(0, 5)          # dist code 0 => distance 1
    data = acc.to_bytes((nb + 7) // 8, "little")
    with pytest.raises((DeflateError, EOFError)):
        inflate_raw(data)
