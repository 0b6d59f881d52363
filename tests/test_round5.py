"""Round-5 behavior: streaming bytes API, online self-check, distributed
gzip/force_btype/index, loud sub_overflow, truncation guards.

These close VERDICT r4's "missing" items #1/#2 and weak items #3/#4/#5, plus
the advisor's replay_stream truncation finding."""
import gzip as _gzip
import io
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from deflate_compression_tpu.decode.index import index_from_shards
from deflate_compression_tpu.decode.verify import replay_stream
from deflate_compression_tpu.models import codec as codec_mod
from deflate_compression_tpu.models.codec import (ZlibCodec, compress_stream,
                                                  make_codec)
from deflate_compression_tpu.parallel import dist
from deflate_compression_tpu.utils.config import CodecConfig
from deflate_compression_tpu.utils.errors import CodecError, DeflateError
from corpora import TEXT_57K

SHARD = 32768


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8
    return dist.make_mesh(jax.devices()[:8])


@pytest.fixture(scope="module")
def bee():
    return TEXT_57K


# ------------------------------------------------------------- truncation
def test_replay_stream_truncation_raises(bee):
    # Before the guard, a truncated dynamic block could loop forever: peek()
    # zero-pads past the end and the all-zeros code is usually a literal.
    body = zlib.compress(bee, 6)[2:-4]
    for frac in (3, 2):
        with pytest.raises((CodecError, EOFError)):
            replay_stream(body[:len(body) // frac])


def test_python_inflater_truncation_raises(bee):
    from deflate_compression_tpu.decode.inflate import _inflate_raw_py
    body = zlib.compress(bee, 6)[2:-4]
    with pytest.raises((CodecError, EOFError)):
        _inflate_raw_py(body[:len(body) // 2])


# ------------------------------------------------------------ sub_overflow
def test_sub_overflow_fires_and_is_loud(bee):
    from deflate_compression_tpu.format.deflate import encode_shard_jit
    buf = np.zeros(SHARD, np.uint8)
    buf[:SHARD] = np.frombuffer(bee[:SHARD], np.uint8)
    # stride 1 selects EVERY huffman token: tokens >> NSUB == S//64
    r = encode_shard_jit(jnp.asarray(buf), jnp.int32(SHARD),
                         jnp.asarray(True), _test_stride=1)
    assert bool(r["sub_overflow"])
    stats = {k: np.asarray(v) for k, v in r.items() if k != "words"}
    with pytest.raises(DeflateError) as ei:
        index_from_shards([stats], [int(r["total_bits"])], [SHARD])
    assert ei.value.name == "E_INDEX"


def test_no_overflow_normally(bee):
    from deflate_compression_tpu.format.deflate import encode_shard_jit
    buf = np.frombuffer(bee[:SHARD], np.uint8)
    r = encode_shard_jit(jnp.asarray(buf), jnp.int32(SHARD),
                         jnp.asarray(True))
    assert not bool(r["sub_overflow"])


# -------------------------------------------------------- distributed gzip
def test_distributed_gzip_roundtrip(mesh, bee):
    from deflate_compression_tpu.format.containers import gzip_decompress
    raw = bee[:3 * SHARD + 1000]
    comp = dist.compress_distributed(raw, mesh, shard_size=SHARD,
                                     container="gzip")
    assert gzip_decompress(comp) == raw        # our path (verifies CRC/ISIZE)
    assert _gzip.decompress(comp) == raw       # external oracle


def test_distributed_gzip_empty(mesh):
    comp = dist.compress_distributed(b"", mesh, shard_size=SHARD,
                                     container="gzip")
    assert _gzip.decompress(comp) == b""


def test_distributed_unknown_container_refuses(mesh):
    with pytest.raises(ValueError):
        dist.compress_distributed(b"x", mesh, container="zip")


def test_distributed_force_btype_fixed(mesh, bee):
    # BASELINE config 1's forced-fixed mode through the distributed path
    raw = bee[:2 * SHARD]
    comp = dist.compress_distributed(raw, mesh, shard_size=SHARD,
                                     force_btype=1)
    assert zlib.decompress(comp) == raw
    # every block must be BTYPE=1
    from deflate_compression_tpu.decode.verify import verify_stream
    reports, checks = verify_stream(comp, raw)
    # every data-carrying block is fixed; empty stored sync flushes between
    # shards are the format-legal byte aligners (parallel/dist.py docstring)
    assert all(b.btype == 1 for b in reports if b.out_bytes > 0)
    assert any(b.btype == 1 for b in reports)
    assert all(ok for _, ok, _ in checks)


def test_distributed_emits_index(mesh, bee):
    from deflate_compression_tpu.decode.index import decompress_indexed
    raw = (bee[:3 * SHARD] + bytes(np.random.default_rng(7)
                                   .integers(0, 256, SHARD, dtype=np.uint8)))
    comp, idx = dist.compress_distributed(raw, mesh, shard_size=SHARD,
                                          return_index=True)
    assert idx.out_len == len(raw)
    assert idx.n_subs > 0
    expected = int.from_bytes(comp[-4:], "big")
    out = decompress_indexed(comp[2:], idx, expected_adler=expected)
    assert out == raw


# --------------------------------------------------------------- streaming
class _BoundedReader(io.RawIOBase):
    """File-like that records the largest single read request."""

    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.max_req = 0

    def read(self, n=-1):
        assert n > 0, "compress_stream must read bounded chunks"
        self.max_req = max(self.max_req, n)
        b = self.data[self.pos:self.pos + n]
        self.pos += len(b)
        return b


@pytest.mark.parametrize("container", ["zlib", "gzip", "raw"])
def test_stream_matches_buffered(bee, container):
    raw = bee[:3 * SHARD + 777]
    cfg = CodecConfig(shard_size=SHARD, container=container)
    src = _BoundedReader(raw)
    streamed = b"".join(compress_stream(src, cfg))
    assert src.max_req <= SHARD            # O(shard) reads
    assert streamed == make_codec(cfg).compress(raw)


def test_stream_iterable_source_odd_chunks(bee):
    raw = bee[:2 * SHARD + 5]
    cfg = CodecConfig(shard_size=SHARD)
    pieces = [raw[i:i + 1000] for i in range(0, len(raw), 1000)]
    streamed = b"".join(compress_stream(iter(pieces), cfg))
    assert streamed == ZlibCodec(cfg).compress(raw)
    assert zlib.decompress(streamed) == raw


def test_stream_empty():
    cfg = CodecConfig(shard_size=SHARD)
    out = b"".join(compress_stream(io.BytesIO(b""), cfg))
    assert zlib.decompress(out) == b""


def test_stream_index_sink_feeds_indexed_decode(bee):
    from deflate_compression_tpu.decode.index import (decompress_indexed,
                                                      index_from_shards)
    raw = (bee * 2)[:2 * SHARD + 123]
    cfg = CodecConfig(shard_size=SHARD)
    sink = []
    out = b"".join(compress_stream(io.BytesIO(raw), cfg, index_sink=sink))
    assert len(sink) == 3
    idx = index_from_shards([t[0] for t in sink], [t[1] for t in sink],
                            [t[2] for t in sink])
    assert idx.out_len == len(raw)
    expected = int.from_bytes(out[-4:], "big")
    assert decompress_indexed(out[2:], idx, expected_adler=expected) == raw


def test_compress_file_streaming(tmp_path, bee):
    from deflate_compression_tpu.models.codec import compress_file
    raw = bee[:2 * SHARD + 99]
    src = tmp_path / "in.bin"
    dst = tmp_path / "out.z"
    ix = tmp_path / "out.dcx"
    src.write_bytes(raw)
    n = compress_file(str(src), str(dst), CodecConfig(shard_size=SHARD),
                      index_path=str(ix))
    blob = dst.read_bytes()
    assert len(blob) == n
    assert zlib.decompress(blob) == raw
    from deflate_compression_tpu.decode.index import DecodeIndex
    idx = DecodeIndex.from_bytes(ix.read_bytes())
    assert idx.out_len == len(raw)


def test_cli_stream_gzip(tmp_path, bee):
    from deflate_compression_tpu.cli import main
    raw = bee[:SHARD + 50]
    src = tmp_path / "a.txt"
    dst = tmp_path / "a.gz"
    src.write_bytes(raw)
    rc = main(["compress", str(src), "-o", str(dst), "--stream",
               "--container", "gzip", "--shard-size", str(SHARD)])
    assert rc == 0
    assert _gzip.decompress(dst.read_bytes()) == raw


# --------------------------------------------------------------- self-check
def test_self_check_passes(bee):
    raw = bee[:2 * SHARD + 100]
    cfg = CodecConfig(shard_size=SHARD, self_check=True)
    comp = ZlibCodec(cfg).compress(raw)
    assert zlib.decompress(comp) == raw


def test_self_check_stream_passes(bee):
    raw = bee[:2 * SHARD]
    cfg = CodecConfig(shard_size=SHARD, self_check=True)
    out = b"".join(compress_stream(io.BytesIO(raw), cfg))
    assert zlib.decompress(out) == raw


def test_self_check_catches_corrupt_encoder(monkeypatch, bee):
    # corrupt the SECOND shard's emitted words: the online replay must fail
    # at shard 1, before any output is committed
    real = codec_mod.encode_shard_jit
    calls = {"n": 0}

    def corrupt(data, valid_len, final, **kw):
        r = dict(real(data, valid_len, final, **kw))
        if calls["n"] == 1:
            r["words"] = r["words"].at[10].set(
                r["words"][10] ^ jnp.uint32(0xDEADBEEF))
        calls["n"] += 1
        return r

    monkeypatch.setattr(codec_mod, "encode_shard_jit", corrupt)
    raw = bee[:3 * SHARD]
    cfg = CodecConfig(shard_size=SHARD, self_check=True)
    with pytest.raises(DeflateError) as ei:
        ZlibCodec(cfg).compress(raw)
    assert ei.value.name == "E_SELFCHECK"
    assert "shard 1" in str(ei.value)


def test_replay_stream_stop_at_bits_substream(bee):
    # a non-final shard substream ends with a BFINAL=0 sync flush; the
    # bounded replay must terminate cleanly without BFINAL
    from deflate_compression_tpu.core import bits as bits_mod
    from deflate_compression_tpu.format.deflate import encode_shard_jit
    raw = bee[:SHARD]
    r = encode_shard_jit(jnp.asarray(np.frombuffer(raw, np.uint8)),
                         jnp.int32(SHARD), jnp.asarray(False))
    tb = int(r["total_bits"])
    blob = bits_mod.words_to_bytes(np.asarray(r["words"]), tb)
    out, end, reports = replay_stream(blob, 0, stop_at_bits=tb)
    assert out == raw
    assert end == tb
