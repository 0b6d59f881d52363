"""End-to-end encoder round-trips, cross-validated two ways (SURVEY §4):
  1. our stream -> CPython zlib inflate (external oracle),
  2. our stream -> our own independent inflater.
"""
import zlib

import numpy as np
import pytest

from deflate_compression_tpu.format.deflate import deflate_compress_bytes
from deflate_compression_tpu.decode.inflate import inflate_raw
from corpora import PIXELS, TEXT_20K, TEXT_37K, TEXT_57K

SHARD = 65536


def roundtrip(raw: bytes, **kw):
    comp = deflate_compress_bytes(raw, shard_size=SHARD, **kw)
    assert zlib.decompress(comp, wbits=-15) == raw
    got, _ = inflate_raw(comp)
    assert got == raw
    return comp


def test_empty():
    assert roundtrip(b"") == b"\x01\x00\x00\xff\xff"


def test_single_byte():
    roundtrip(b"A")


def test_small_text():
    roundtrip(b"the quick brown fox jumps over the lazy dog " * 10)


def test_bee_movie_corpus():
    raw = TEXT_57K
    comp = roundtrip(raw)
    # sanity on ratio: must beat 50% on this text corpus
    assert len(comp) < len(raw) * 0.5


def test_rfc1951_corpus():
    raw = TEXT_37K
    roundtrip(raw)


def test_sunrise_pixels():
    raw = PIXELS
    roundtrip(raw)


def test_random_picks_stored():
    raw = np.random.default_rng(0).integers(0, 256, 100000).astype(np.uint8).tobytes()
    comp = roundtrip(raw)
    # stored-block fallback keeps expansion tiny: <= 5 bytes per 32KB block + slack
    assert len(comp) <= len(raw) + 5 * 5 + 16


def test_zeros():
    comp = roundtrip(b"\0" * 200000)
    # ~7 coding blocks, each a few dozen bytes of dynamic-tree overhead
    assert len(comp) < 400


def test_multi_shard_boundary_sizes():
    rng = np.random.default_rng(1)
    base = (b"abcdefgh" * 5000)
    for n in (SHARD - 1, SHARD, SHARD + 1, 2 * SHARD + 17):
        raw = (base * ((n // len(base)) + 1))[:n]
        roundtrip(raw)


def test_shard_sizes_change_stream_not_content():
    raw = TEXT_20K
    c1 = deflate_compress_bytes(raw, shard_size=32768)
    c2 = deflate_compress_bytes(raw, shard_size=SHARD)
    assert zlib.decompress(c1, wbits=-15) == raw
    assert zlib.decompress(c2, wbits=-15) == raw


def test_determinism():
    raw = TEXT_37K
    assert deflate_compress_bytes(raw, shard_size=SHARD) == \
        deflate_compress_bytes(raw, shard_size=SHARD)


def test_baseline_config1_single_fixed_block():
    """BASELINE.json config 1: round-trip docs/rfc1951.txt as ONE
    fixed-Huffman (type-1) block."""
    from deflate_compression_tpu.models.codec import DeflateCodec
    from deflate_compression_tpu.utils.config import CodecConfig
    from deflate_compression_tpu.decode.index import build_index

    raw = TEXT_37K
    codec = DeflateCodec(CodecConfig(shard_size=65536, block_type="fixed",
                                     container="raw"))
    comp = codec.compress(raw)
    assert zlib.decompress(comp, wbits=-15) == raw
    got, _ = inflate_raw(comp)
    assert got == raw
    idx = build_index(comp)
    assert idx.n_blocks == 1
    assert idx.btype[0] == 1                 # fixed


def test_forced_stored_blocks():
    from deflate_compression_tpu.models.codec import DeflateCodec
    from deflate_compression_tpu.utils.config import CodecConfig
    raw = b"stored please " * 3000
    codec = DeflateCodec(CodecConfig(shard_size=65536, block_type="stored",
                                     container="raw"))
    comp = codec.compress(raw)
    assert zlib.decompress(comp, wbits=-15) == raw
    assert len(comp) > len(raw)              # stored never compresses


def test_forced_dynamic_blocks():
    from deflate_compression_tpu.models.codec import DeflateCodec
    from deflate_compression_tpu.utils.config import CodecConfig
    raw = np.random.default_rng(0).integers(0, 256, 70000,
                                            dtype=np.uint8).tobytes()
    codec = DeflateCodec(CodecConfig(shard_size=65536, block_type="dynamic",
                                     container="raw"))
    comp = codec.compress(raw)
    assert zlib.decompress(comp, wbits=-15) == raw


def test_closed_form_code_mappings_match_luts():
    """_len_fields/_dist_fields (elementwise closed forms) must agree with
    the dense RFC tables for every legal length and distance."""
    import jax.numpy as jnp
    import numpy as np
    from deflate_compression_tpu.format import constants as C
    from deflate_compression_tpu.format.deflate import _len_fields, _dist_fields

    lens = jnp.arange(3, 259, dtype=jnp.int32)
    code, ev, eb = _len_fields(lens)
    exp_code = C.LEN_TO_CODE[np.arange(3, 259) - 3]
    exp_ev = C.LEN_TO_EXTRA_VAL[np.arange(3, 259) - 3]
    exp_eb = C.LENGTH_EXTRA[exp_code - 257]
    np.testing.assert_array_equal(np.asarray(code), exp_code)
    np.testing.assert_array_equal(np.asarray(ev), exp_ev)
    np.testing.assert_array_equal(np.asarray(eb), exp_eb)

    dists = np.arange(1, 32769, dtype=np.int32)
    dcode, dev, deb = map(np.asarray, _dist_fields(jnp.asarray(dists)))
    exp_d = np.where(dists <= 256,
                     C.DIST_TO_CODE_LO[np.minimum(dists - 1, 255)],
                     C.DIST_TO_CODE_HI[(dists - 1) >> 7])
    np.testing.assert_array_equal(dcode, exp_d)
    np.testing.assert_array_equal(dev, dists - C.DIST_BASE[exp_d])
    np.testing.assert_array_equal(deb, C.DIST_EXTRA[exp_d])
