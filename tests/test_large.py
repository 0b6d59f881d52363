"""Scaled-down versions of the big BASELINE.json configs.

Config 4 ("AHT-based adaptive chunk splitting on mixed text+binary") and
config 5's ordered-assembly semantics at a few MB, CPU-runnable in CI; the
full-size runs are a bench/driver concern.
"""
import zlib

import numpy as np
import pytest

from deflate_compression_tpu.models.codec import ZlibCodec
from deflate_compression_tpu.utils.config import CodecConfig
from deflate_compression_tpu.format import constants as C
from corpora import TEXT_57K


def mixed_corpus(total: int, seed=7) -> bytes:
    rng = np.random.default_rng(seed)
    bee = TEXT_57K
    parts = []
    size = 0
    while size < total:
        parts.append(bee[:40000])
        parts.append(rng.integers(0, 256, 30000, dtype=np.uint8).tobytes())
        parts.append(bytes(np.tile(rng.integers(0, 256, 32,
                                                dtype=np.uint8), 512)))
        parts.append(b"\x00" * 100000)   # long homogeneous run => merges
        size += 40000 + 30000 + 32 * 512 + 100000
    return b"".join(parts)[:total]


@pytest.mark.parametrize("mb", [4])
def test_mixed_corpus_adaptive_blocks(mb):
    raw = mixed_corpus(mb << 20)
    codec = ZlibCodec(CodecConfig(shard_size=1 << 20))
    comp, stats = codec.compress(raw, return_stats=True)
    assert zlib.decompress(comp) == raw
    assert codec.decompress(comp) == raw
    # adaptive splitting must actually merge blocks somewhere (fewer blocks
    # than 32KB tiles) and use more than one block type on this mix
    n_tiles = (len(raw) + 32767) // 32768
    assert stats.n_blocks < n_tiles
    # (block-type diversity on tile-aligned content is covered by
    # test_roundtrip.test_random_picks_stored)
    # ratio sanity vs zlib-6 on the same data
    z = len(zlib.compress(raw, 6))
    assert len(comp) < 1.1 * z


def test_window_distance_exactly_32768():
    # a match at the maximum window distance must round-trip
    pat = b"WINDOWEDGEPATTERN123"
    filler = np.random.default_rng(1).integers(0, 256, C.WINDOW_SIZE - len(pat),
                                               dtype=np.uint8).tobytes()
    raw = pat + filler + pat + b"tail"
    codec = ZlibCodec(CodecConfig(shard_size=1 << 17))
    comp = codec.compress(raw)
    assert zlib.decompress(comp) == raw


def test_incompressible_then_compressible_shards():
    rng = np.random.default_rng(2)
    raw = (rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
           + b"compressible " * 100000)
    codec = ZlibCodec(CodecConfig(shard_size=1 << 20))
    comp = codec.compress(raw)
    assert zlib.decompress(comp) == raw
