"""Robustness fuzzing: mutated/garbage streams must raise DeflateError (or
EOFError at worst) — never crash, hang, or return silently-wrong data.

The reference's decoder relies on longjmp error unwind for malformed input
(SURVEY §5.3); this suite is the equivalent negative-path coverage for all
three decode paths.
"""
import zlib

import numpy as np
import pytest

from deflate_compression_tpu import native_bridge as nb
from deflate_compression_tpu.decode.inflate import (_inflate_raw_py,
                                                    zlib_decompress)
from deflate_compression_tpu.utils.errors import DeflateError
from corpora import TEXT_20K

RAW = TEXT_20K
GOOD = zlib.compress(RAW, 6)


def _mutations(rng, n=60):
    for _ in range(n):
        buf = bytearray(GOOD)
        kind = rng.integers(0, 4)
        if kind == 0:      # flip bits in the deflate body
            for _ in range(rng.integers(1, 8)):
                buf[rng.integers(2, len(buf) - 4)] ^= 1 << rng.integers(0, 8)
        elif kind == 1:    # truncate
            del buf[rng.integers(3, len(buf)):]
        elif kind == 2:    # splice random bytes
            at = rng.integers(2, len(buf) - 4)
            buf[at:at] = bytes(rng.integers(0, 256, rng.integers(1, 32),
                                            dtype=np.uint8))
        else:              # random garbage with zlib-ish header
            buf = bytearray(b"\x78\x9c" + bytes(
                rng.integers(0, 256, rng.integers(8, 200), dtype=np.uint8)))
        yield bytes(buf)


def test_python_inflater_never_crashes():
    rng = np.random.default_rng(1)
    errors = 0
    for data in _mutations(rng):
        try:
            out = _inflate_raw_py(data, 16)[0]
            # survivors must at least be self-consistent length-wise
            assert isinstance(out, bytes)
        except (DeflateError, EOFError):
            errors += 1
    assert errors > 10          # most mutations must be detected


@pytest.mark.skipif(not nb.available(), reason="no native runtime")
def test_native_inflater_never_crashes():
    rng = np.random.default_rng(2)
    errors = 0
    for data in _mutations(rng):
        try:
            nb.zlib_decompress_native(data)
        except DeflateError:
            errors += 1
    assert errors > 10


def test_adler_catches_payload_corruption():
    """Bit flips that decode 'successfully' must still fail the container
    checksum — end-to-end integrity."""
    rng = np.random.default_rng(3)
    silent = 0
    for data in _mutations(rng, n=40):
        try:
            out = zlib_decompress(data)
            if out != RAW:
                silent += 1    # decoded + checksum passed + wrong data
        except (DeflateError, EOFError):
            pass
    assert silent == 0


# ---------------------------------------------------------------------------
# device indexed decoder (decode/tpu_inflate.py): mutations of the compressed
# words AND of index entries must yield ok=False or visibly-wrong output —
# never a hang (the decoder's loops are step/bit-budget bounded) and never a
# silent identity.
# ---------------------------------------------------------------------------

def _device_setup():
    import jax.numpy as jnp
    from deflate_compression_tpu.format.deflate import encode_shard_jit
    S = 1 << 16
    raw = RAW[:S - 5000] + bytes(5000)
    vl = len(raw)
    buf = np.zeros(S, np.uint8)
    buf[:vl] = np.frombuffer(raw, np.uint8)
    r = encode_shard_jit(jnp.asarray(buf), jnp.int32(vl), jnp.asarray(True))
    return S, raw, vl, r


def test_device_decoder_word_mutations():
    import jax.numpy as jnp
    from deflate_compression_tpu.decode.tpu_inflate import decode_shard_indexed
    S, raw, vl, r = _device_setup()
    words = np.asarray(r["words"]).copy()
    nw = max(2, int(r["total_bits"]) // 32 - 1)
    rng = np.random.default_rng(11)
    flagged = 0
    for _ in range(10):
        w = words.copy()
        for _ in range(rng.integers(1, 4)):
            w[rng.integers(0, nw)] ^= np.uint32(1) << rng.integers(0, 32)
        res = decode_shard_indexed(jnp.asarray(w), r["block_bit_base"],
                                   r["block_out_start"], r["btype"],
                                   r["n_blocks"], jnp.int32(vl), S)
        ok = bool(res["ok"])
        out = np.asarray(res["out"])[:vl].tobytes()
        if not ok:
            flagged += 1
        else:
            assert out != raw, "silent identity on corrupted stream"
    assert flagged >= 3


def test_device_decoder_index_mutations():
    import jax.numpy as jnp
    from deflate_compression_tpu.decode.tpu_inflate import decode_shard_indexed
    S, raw, vl, r = _device_setup()
    bb = np.asarray(r["block_bit_base"]).copy()
    os_ = np.asarray(r["block_out_start"]).copy()
    bt = np.asarray(r["btype"]).copy()
    nb = int(r["n_blocks"])
    rng = np.random.default_rng(12)
    cases = []
    for _ in range(6):
        b2 = bb.copy()
        b2[rng.integers(0, nb)] += int(rng.integers(1, 2000))
        cases.append((b2, os_, bt))
    t2 = bt.copy()
    t2[0] = 3                                   # reserved BTYPE
    cases.append((bb, os_, t2))
    o2 = os_.copy()
    if nb > 1:
        o2[1] = max(0, o2[1] - 777)             # wrong output offset
        cases.append((bb, o2, bt))
    for b2, o3, t3 in cases:
        res = decode_shard_indexed(r["words"],
                                   jnp.asarray(b2.astype(np.int32)),
                                   jnp.asarray(o3.astype(np.int32)),
                                   jnp.asarray(t3.astype(np.int32)),
                                   jnp.int32(nb), jnp.int32(vl), S)
        ok = bool(res["ok"])
        out = np.asarray(res["out"])[:vl].tobytes()
        assert (not ok) or out != raw


def test_device_decoder_garbage_words_terminate():
    """Pure garbage never hangs: loops are bounded by bit budget + steps."""
    import jax.numpy as jnp
    from deflate_compression_tpu.decode.tpu_inflate import decode_shard_indexed
    rng = np.random.default_rng(13)
    S = 1 << 14
    words = rng.integers(0, 2**32, 512, dtype=np.uint32)
    NB = 4
    bb = np.array([0, 100, 1000, 4000], np.int32)
    os_ = np.array([0, 4096, 8192, 12288], np.int32)
    bt = np.array([2, 2, 1, 2], np.int32)
    res = decode_shard_indexed(jnp.asarray(words), jnp.asarray(bb),
                               jnp.asarray(os_), jnp.asarray(bt),
                               jnp.int32(NB), jnp.int32(S), S)
    assert not bool(res["ok"])


def test_device_verified_path_no_mutation_survives():
    """End-to-end guarantee on the user-facing indexed path (cli --index /
    decompress_indexed): with adler verification on, NO word mutation may
    come back as valid-and-wrong — it must either raise or return the exact
    original (VERDICT r3 item 2; reference verify
    src/deflate_decompress.c:402-404)."""
    from deflate_compression_tpu.core.checksum import adler32_np
    from deflate_compression_tpu.decode.index import (build_index,
                                                      decompress_indexed)
    from deflate_compression_tpu.format.deflate import deflate_compress_bytes

    raw = RAW[:50000]
    comp = bytearray(deflate_compress_bytes(raw, shard_size=1 << 16))
    idx = build_index(bytes(comp))
    good = adler32_np(np.frombuffer(raw, np.uint8))
    rng = np.random.default_rng(21)
    survivors = 0
    for _ in range(12):
        m = bytearray(comp)
        for _ in range(int(rng.integers(1, 4))):
            m[int(rng.integers(0, len(m)))] ^= 1 << int(rng.integers(0, 8))
        try:
            out = decompress_indexed(bytes(m), idx, expected_adler=good)
            if out != raw:
                survivors += 1
        except Exception:
            pass    # any structured failure is acceptable; silence is not
    assert survivors == 0
