"""Multi-device data-parallel encode tests on the 8-device virtual CPU mesh
(SURVEY §4: CPU-simulated distributed tests)."""
import zlib

import numpy as np
import jax
import pytest

from deflate_compression_tpu.parallel import dist
from deflate_compression_tpu.decode.inflate import zlib_decompress
from corpora import TEXT_20K, TEXT_37K, TEXT_57K

SHARD = 32768  # small per-shard size keeps compiles fast


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return dist.make_mesh(jax.devices()[:8])


def test_distributed_roundtrip_text(mesh):
    raw = TEXT_57K
    comp = dist.compress_distributed(raw, mesh, shard_size=SHARD)
    assert zlib.decompress(comp) == raw          # external oracle
    assert zlib_decompress(comp) == raw          # our inflater


def test_distributed_matches_single_device_stream(mesh):
    # bit-exactness across backends/mesh sizes (SURVEY §7.3 item 6): the
    # distributed container must byte-equal the sequential one for the same
    # shard plan.
    from deflate_compression_tpu.models.codec import ZlibCodec
    from deflate_compression_tpu.utils.config import CodecConfig
    raw = TEXT_37K
    comp_d = dist.compress_distributed(raw, mesh, shard_size=SHARD)
    comp_s = ZlibCodec(CodecConfig(shard_size=SHARD)).compress(raw)
    assert comp_d == comp_s


def test_distributed_multi_wave(mesh):
    # more shards than devices: several waves
    rng = np.random.default_rng(0)
    raw = (b"wave wave wave " * 3000 +
           rng.integers(0, 256, 100000, dtype=np.uint8).tobytes()) * 3
    comp = dist.compress_distributed(raw, mesh, shard_size=SHARD)
    assert zlib.decompress(comp) == raw


def test_distributed_exact_shard_multiple(mesh):
    raw = b"z" * (8 * SHARD)
    comp = dist.compress_distributed(raw, mesh, shard_size=SHARD)
    assert zlib.decompress(comp) == raw


def test_distributed_empty(mesh):
    comp = dist.compress_distributed(b"", mesh, shard_size=SHARD)
    assert zlib.decompress(comp) == b""


def test_fault_injection_retry(mesh):
    """SURVEY §5.3: failed waves re-encode deterministically."""
    calls = []

    def hook(wave, attempt):
        calls.append((wave, attempt))
        if wave == 0 and attempt == 0:
            raise RuntimeError("injected chip fault")

    raw = TEXT_20K
    comp = dist.compress_distributed(raw, mesh, shard_size=SHARD,
                                     _fault_hook=hook)
    assert zlib.decompress(comp) == raw
    assert (0, 0) in calls and (0, 1) in calls
    # retried output equals an unfaulted run byte-for-byte
    comp2 = dist.compress_distributed(raw, mesh, shard_size=SHARD)
    assert comp == comp2


def test_fault_exhausted_raises(mesh):
    from deflate_compression_tpu.utils.errors import DistError

    def hook(wave, attempt):
        raise RuntimeError("permanent fault")

    with pytest.raises(DistError):
        dist.compress_distributed(b"data" * 10000, mesh, shard_size=SHARD,
                                  max_retries=1, _fault_hook=hook)
