"""Declared-window (CINFO) enforcement across all three inflaters.

The reference derives the window from the zlib header — window =
1 << (CINFO + 8) (src/deflate_decompress.c:360) — and bounds every back-copy
distance (:278-279). A stream declaring a small window but using larger
distances must be rejected by every decode path, while conformant
small-window streams (the reference's own pngtest.png declares CINFO=1,
png/pngtest.png.txt:23-29) keep decoding.
"""
import zlib

import numpy as np
import pytest

from deflate_compression_tpu.decode.inflate import (_inflate_raw_py,
                                                    zlib_decompress)
from deflate_compression_tpu.utils.errors import DeflateError

# data whose best match is ~2 KB away: zlib-9 at wbits=15 emits dist > 512
PAT = b"The quick brown fox jumps over the lazy dog 0123456789!"
DATA = PAT * 20 + bytes(np.random.default_rng(3).integers(
    0, 256, 2000, dtype=np.uint8)) + PAT * 20


def _violating_stream() -> bytes:
    """A zlib container whose header declares a 512-byte window (CINFO=1)
    but whose DEFLATE body uses distances beyond it. The adler32 footer is
    kept valid, so only window enforcement can reject it."""
    comp = zlib.compress(DATA, 9)
    body, adler = comp[2:-4], comp[-4:]
    cmf = (1 << 4) | 8                      # CINFO=1 => 512-byte window
    flg = (31 - (cmf * 256) % 31) % 31      # valid FCHECK, no FDICT
    assert ((cmf << 8) | flg) % 31 == 0
    return bytes([cmf, flg]) + body + adler


def _has_far_dist() -> bool:
    # sanity: the fixture really does contain a distance > 512
    try:
        _inflate_raw_py(zlib.compress(DATA, 9), 16, max_dist=512)
        return False
    except DeflateError as e:
        return e.name == "E_DIST"


def test_fixture_uses_far_distances():
    assert _has_far_dist()


def test_python_inflater_rejects_window_violation():
    with pytest.raises(DeflateError):
        _inflate_raw_py(_violating_stream(), 16, max_dist=512)


def test_zlib_decompress_rejects_window_violation():
    # dispatches to the native C++ inflater when available, else Python —
    # both must derive the window from CINFO and reject
    with pytest.raises(DeflateError):
        zlib_decompress(_violating_stream())


def test_native_inflater_rejects_window_violation():
    from deflate_compression_tpu import native_bridge
    if not native_bridge.available():
        pytest.skip("native runtime unavailable")
    with pytest.raises(DeflateError):
        native_bridge.zlib_decompress_native(_violating_stream())


def test_device_decoder_rejects_window_violation():
    from deflate_compression_tpu.decode.index import (build_index,
                                                      decompress_indexed)
    s = _violating_stream()
    body = s[2:]
    idx = build_index(body)
    with pytest.raises(DeflateError):
        decompress_indexed(body, idx, max_dist=512)
    # same stream, honest window: decodes exactly
    assert decompress_indexed(body, idx, max_dist=32768) == DATA


def test_conformant_small_window_stream_decodes():
    """wbits=9 (CINFO=1) streams keep distances <= 512 and must decode."""
    co = zlib.compressobj(9, zlib.DEFLATED, 9)
    comp = co.compress(DATA) + co.flush()
    assert comp[0] >> 4 == 1
    assert zlib_decompress(comp) == DATA
    assert _inflate_raw_py(comp, 16, max_dist=512)[0] == DATA


def test_reference_pngtest_small_window_still_decodes():
    """The reference's own pngtest.png declares CINFO=1 (512-byte window,
    png/pngtest.png.txt:23-29); its IDAT must keep decoding."""
    from deflate_compression_tpu.png.decoder import png_decode
    img = png_decode(open("/root/reference/png/img/pngtest.png", "rb").read())
    assert img.width == 4 and img.height == 4
