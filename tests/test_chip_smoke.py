"""chip_smoke.py rehearsed on the CPU, and the compile-cache helper.

Each smoke phase runs here at a tiny size; on a GPU the script runs them at
full size. Without a GPU the script must fail and print no result."""
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke
from deflate_compression_tpu.utils import compile_cache, corpus

S = 32768
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def raw():
    return corpus.mixed(5 * S + 1234, seed=3)


@pytest.fixture(scope="module")
def ours(raw):
    from deflate_compression_tpu.models.codec import ZlibCodec
    from deflate_compression_tpu.utils.config import CodecConfig
    return ZlibCodec(CodecConfig(shard_size=S)).compress(raw)


def _run_script(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_main_fails_without_gpu(capsys):
    with pytest.raises(chip_smoke.SmokeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok": true' not in capsys.readouterr().out


def test_script_exits_nonzero_without_gpu():
    r = _run_script(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_script(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_phase_encode(raw, ours, capsys):
    assert chip_smoke.phase_encode(raw, S) == ours
    assert "oracle=ok" in capsys.readouterr().out


def test_phase_encode_fails_on_corrupt_stream(raw, monkeypatch):
    from deflate_compression_tpu.models.codec import ZlibCodec
    real = ZlibCodec.compress

    def corrupt(self, data, return_stats=False):
        out = real(self, data)
        return out[:-1] + bytes([out[-1] ^ 1])      # break the adler32
    monkeypatch.setattr(ZlibCodec, "compress", corrupt)
    with pytest.raises(chip_smoke.SmokeError, match="zlib oracle"):
        chip_smoke.phase_encode(raw, S)


def test_phase_cpu_compare(raw, capsys):
    chip_smoke.phase_cpu_compare(raw, S, 2)
    out = capsys.readouterr().out
    assert out.count("identical=True") == 2


def test_phase_tables(capsys):
    chip_smoke.phase_tables(nb=2, length=4096)
    assert capsys.readouterr().out.count("lookup_mismatches=0 "
                                         "histogram_mismatches=0") == 2


def test_phase_decode(raw, ours, capsys):
    chip_smoke.phase_decode(raw, ours, 3 * S, S)
    out = capsys.readouterr().out
    assert "stream=ours" in out and "stream=zlib6" in out


def test_phase_cli(capsys):
    chip_smoke.phase_cli(corpus.mixed(3 * S, seed=4), S)
    assert "roundtrip=ok" in capsys.readouterr().out


def test_phase_four(capsys):
    chip_smoke.phase_four(corpus.mixed(9 * S, seed=5), jax.devices()[:4], S)
    out = capsys.readouterr().out
    assert "equals_one_card=ok" in out and "stream=mesh" in out


def test_phase_decode_fails_on_wrong_bytes(raw, ours, monkeypatch):
    from deflate_compression_tpu.decode import index
    real = index.decompress_indexed
    monkeypatch.setattr(index, "decompress_indexed",
                        lambda *a, **k: real(*a, **k)[:-1] + b"?")
    with pytest.raises(chip_smoke.SmokeError, match="differs"):
        chip_smoke.phase_decode(raw, ours, 3 * S, S)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    old = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_fixed_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    assert compile_cache.cache_dir() == compile_cache.cache_dir()
