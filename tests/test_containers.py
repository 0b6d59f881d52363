"""Container-level tests: zlib + gzip codecs, stats channel, interop."""
import gzip as gzip_mod
import io
import zlib

import numpy as np
import pytest

from deflate_compression_tpu.models.codec import (
    DeflateCodec, GzipCodec, ZlibCodec, make_codec)
from deflate_compression_tpu.utils.config import CodecConfig
from corpora import TEXT_20K, TEXT_37K, TEXT_57K

CFG = CodecConfig(shard_size=65536)


def test_zlib_container_interop():
    raw = TEXT_20K
    codec = ZlibCodec(CFG)
    comp = codec.compress(raw)
    # external oracle decodes our container
    assert zlib.decompress(comp) == raw
    # we decode our own container
    assert codec.decompress(comp) == raw
    # we decode the oracle's container
    assert codec.decompress(zlib.compress(raw, 6)) == raw


def test_gzip_container_interop():
    raw = TEXT_37K
    codec = GzipCodec(CFG)
    comp = codec.compress(raw)
    assert gzip_mod.decompress(comp) == raw
    assert codec.decompress(comp) == raw
    assert codec.decompress(gzip_mod.compress(raw, 6)) == raw
    # gzip header with FNAME
    buf = io.BytesIO()
    with gzip_mod.GzipFile(filename="some_name.txt", mode="wb", fileobj=buf) as f:
        f.write(raw)
    assert codec.decompress(buf.getvalue()) == raw


def test_raw_codec():
    raw = b"raw deflate body " * 999
    codec = DeflateCodec(CFG)
    comp = codec.compress(raw)
    assert zlib.decompress(comp, wbits=-15) == raw
    assert codec.decompress(comp) == raw


def test_empty_zlib():
    codec = ZlibCodec(CFG)
    comp = codec.compress(b"")
    assert zlib.decompress(comp) == b""
    assert codec.decompress(comp) == b""


def test_stats_channel():
    raw = TEXT_57K
    codec = ZlibCodec(CFG)
    comp, stats = codec.compress(raw, return_stats=True)
    assert stats.input_bytes == len(raw)
    assert stats.output_bytes == len(comp)
    assert stats.n_blocks == sum(stats.btype_counts) == len(stats.block_bits)
    assert stats.n_tokens >= stats.n_matches > 0
    assert 0 < stats.rate_bits_per_byte < 8
    csv = stats.to_csv()
    assert csv.startswith("bytes,compressed_bits\n")
    last = csv.strip().rsplit("\n", 1)[1]
    assert int(last.split(",")[0]) == len(raw)


def test_make_codec_dispatch():
    assert isinstance(make_codec(CodecConfig(container="zlib")), ZlibCodec)
    assert isinstance(make_codec(CodecConfig(container="gzip")), GzipCodec)
    assert isinstance(make_codec(CodecConfig(container="raw")), DeflateCodec)
    with pytest.raises(ValueError):
        CodecConfig(container="nope")
    with pytest.raises(ValueError):
        CodecConfig(shard_size=1000)
