"""Tests that need an NVIDIA GPU: the encoder's table operations are exact
at the shapes of a 1 MiB shard, and one shard round-trips through the zlib
oracle. They skip elsewhere; see tests/conftest.py for the command."""
import zlib

import numpy as np
import jax
import pytest

from deflate_compression_tpu.core import huffman
from deflate_compression_tpu.models.codec import ZlibCodec
from deflate_compression_tpu.utils import corpus
from deflate_compression_tpu.utils.config import CodecConfig

NB, L = 32, 32768                # a 1 MiB shard: 32 tiles of 32 KiB


def _symbols(n_cls):
    rng = np.random.default_rng(n_cls)
    return rng.integers(0, n_cls + 1, (NB, L)).astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("n_cls", [286, 30])
def test_rows_lookup_exact_on_gpu(gpu, n_cls):
    sym = _symbols(n_cls)
    tab = np.random.default_rng(1).integers(
        (1 << 20) - 65536, 1 << 20, (NB, n_cls)).astype(np.uint32)
    want = np.where(sym < n_cls, np.take_along_axis(
        tab, np.minimum(sym, n_cls - 1), axis=1), 0)
    got = huffman.rows_lookup(jax.device_put(sym, gpu),
                              jax.device_put(tab, gpu))
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n_cls", [286, 30])
def test_histogram_rows_matmul_exact_on_gpu(gpu, n_cls):
    sym = _symbols(n_cls)
    want = np.stack([np.bincount(r[r < n_cls], minlength=n_cls)
                     for r in sym])
    got = huffman.histogram_rows_matmul(jax.device_put(sym, gpu), n_cls)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.gpu
def test_one_shard_encode_oracle_on_gpu(gpu):
    raw = corpus.mixed(1 << 20, seed=11)
    with jax.default_device(gpu):
        out = ZlibCodec(CodecConfig()).compress(raw)
    assert zlib.decompress(out) == raw
