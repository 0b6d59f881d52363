"""Checkpoint / resume tests (SURVEY §5.4): kill the job mid-run, re-invoke,
output must be byte-identical to an uninterrupted run."""
import os
import zlib

import numpy as np
import pytest

from deflate_compression_tpu.parallel.checkpoint import (
    CheckpointManager, compress_file_resumable)
from deflate_compression_tpu.utils.config import CodecConfig
from corpora import TEXT_57K

CFG = CodecConfig(shard_size=32768)


class Boom(Exception):
    pass


@pytest.fixture
def corpus(tmp_path):
    rng = np.random.default_rng(0)
    raw = (TEXT_57K
           + rng.integers(0, 256, 50000, dtype=np.uint8).tobytes())
    src = tmp_path / "input.bin"
    src.write_bytes(raw)
    return src, raw


def test_uninterrupted(corpus, tmp_path):
    src, raw = corpus
    dst = tmp_path / "out.zz"
    info = compress_file_resumable(str(src), str(dst), CFG)
    assert info["resumed_at_shard"] == 0
    assert zlib.decompress(dst.read_bytes()) == raw
    assert not os.path.exists(str(dst) + ".ckpt")


def test_resume_after_crash(corpus, tmp_path):
    src, raw = corpus
    dst = tmp_path / "out.zz"

    def bomb(s, n):
        if s == 1:
            raise Boom()

    with pytest.raises(Boom):
        compress_file_resumable(str(src), str(dst), CFG, progress_cb=bomb)
    assert os.path.exists(str(dst) + ".ckpt")

    info = compress_file_resumable(str(src), str(dst), CFG)
    assert info["resumed_at_shard"] == 2          # shards 0,1 were durable
    assert zlib.decompress(dst.read_bytes()) == raw

    # identical to an uninterrupted run (bit-exact resume)
    dst2 = tmp_path / "out2.zz"
    compress_file_resumable(str(src), str(dst2), CFG)
    assert dst.read_bytes() == dst2.read_bytes()


def test_stale_checkpoint_restarts(corpus, tmp_path):
    src, raw = corpus
    dst = tmp_path / "out.zz"

    def bomb(s, n):
        raise Boom()

    with pytest.raises(Boom):
        compress_file_resumable(str(src), str(dst), CFG, progress_cb=bomb)
    # input changed -> checkpoint must be discarded
    src.write_bytes(b"Q" + raw[1:])
    info = compress_file_resumable(str(src), str(dst), CFG)
    assert info["resumed_at_shard"] == 0
    assert zlib.decompress(dst.read_bytes()) == b"Q" + raw[1:]


def test_manifest_roundtrip(tmp_path):
    cp = CheckpointManager(str(tmp_path / "m.ckpt"))
    assert cp.load() is None
    cp.save({"version": 1, "x": 42})
    assert cp.load()["x"] == 42
    cp.clear()
    assert cp.load() is None


def test_empty_input(tmp_path):
    """0-byte file: output must decode to b"" with a valid adler (VERDICT r1
    weak #5: the phantom 0x00-byte bug)."""
    src = tmp_path / "empty.bin"
    src.write_bytes(b"")
    dst = tmp_path / "empty.zz"
    info = compress_file_resumable(str(src), str(dst), CFG)
    assert info["input_bytes"] == 0
    assert zlib.decompress(dst.read_bytes()) == b""
