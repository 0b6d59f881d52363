"""C++ native runtime tests (native/deflate_native.cpp via ctypes bridge)."""
import zlib

import numpy as np
import pytest

from deflate_compression_tpu import native_bridge as nb
from deflate_compression_tpu.utils.errors import DeflateError
from corpora import TEXT_57K

pytestmark = pytest.mark.skipif(not nb.available(),
                                reason="native toolchain unavailable")


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_zlib_roundtrip_levels(level):
    raw = TEXT_57K
    assert nb.zlib_decompress_native(zlib.compress(raw, level)) == raw


def test_inflate_raw_with_bit_offset():
    raw = b"offset stream " * 2000
    comp = zlib.compress(raw, 6)
    out, end_bits = nb.inflate_raw_native(comp, 16)
    assert out == raw
    # adler32 footer begins at the next byte boundary
    assert (end_bits + 7) // 8 + 4 == len(comp)


def test_growth_retry_path():
    # high-ratio stream: initial capacity guess (4x input) must grow
    raw = b"\x00" * (1 << 20)
    comp = zlib.compress(raw, 9)
    assert len(comp) * 4 < len(raw)
    assert nb.zlib_decompress_native(comp) == raw


def test_checksums_match_zlib():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 4096, 100001):
        d = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert nb.crc32_native(d) == zlib.crc32(d)
        assert nb.adler32_native(d) == zlib.adler32(d)
    # incremental
    a, b = b"part one ", b"part two"
    assert nb.crc32_native(b, nb.crc32_native(a)) == zlib.crc32(a + b)
    assert nb.adler32_native(b, nb.adler32_native(a)) == zlib.adler32(a + b)


def test_error_codes():
    with pytest.raises(DeflateError):
        nb.zlib_decompress_native(b"\x78\x9c\xff\xff\xff\xff\xff\xff")
    bad_adler = bytearray(zlib.compress(b"data data"))
    bad_adler[-1] ^= 0xFF
    with pytest.raises(DeflateError) as e:
        nb.zlib_decompress_native(bytes(bad_adler))
    assert "E_ADLER" in str(e.value)
    # verify=False skips the adler check
    assert nb.zlib_decompress_native(bytes(bad_adler), verify=False) == \
        b"data data"


def test_truncated_stream():
    comp = zlib.compress(b"truncate me " * 1000)
    with pytest.raises(DeflateError):
        nb.zlib_decompress_native(comp[:len(comp) // 2])
