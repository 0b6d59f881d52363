"""Device-parallel indexed decoder tests (decode/tpu_inflate.py).

The decode index comes straight from the encoder's stats; the decoded bytes
must be bit-exact with the original for every block-type mix.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from deflate_compression_tpu.format.deflate import encode_shard_jit
from deflate_compression_tpu.decode.tpu_inflate import decode_shard_indexed
from corpora import TEXT_37K, TEXT_57K

S = 1 << 17


def roundtrip(raw: bytes):
    vl = len(raw)
    buf = np.zeros(S, np.uint8)
    buf[:vl] = np.frombuffer(raw, np.uint8)
    r = encode_shard_jit(jnp.asarray(buf), jnp.int32(vl), jnp.asarray(True))
    res = decode_shard_indexed(r["words"], r["block_bit_base"],
                               r["block_out_start"], r["btype"],
                               r["n_blocks"], jnp.int32(vl), S)
    assert bool(res["ok"])
    assert np.asarray(res["out"])[:vl].tobytes() == raw
    return np.asarray(r["btype"])


def test_dynamic_text():
    bt = roundtrip(TEXT_37K[:S])
    assert (bt[bt >= 0] == 2).all()


def test_multiblock_mixed():
    raw = (TEXT_57K[:60000]
           + np.random.default_rng(0).integers(0, 256, 40000,
                                               dtype=np.uint8).tobytes()
           + b"\0" * 10000)
    roundtrip(raw)


def test_fixed_block():
    bt = roundtrip(b"hello world")
    assert bt[0] == 1


def test_stored_blocks():
    bt = roundtrip(np.random.default_rng(5).integers(
        0, 256, S, dtype=np.uint8).tobytes())
    assert (bt[bt >= 0] == 0).all()


def test_stored_then_dynamic():
    raw = (np.random.default_rng(6).integers(0, 256, S // 2,
                                             dtype=np.uint8).tobytes()
           + b"A" * (S // 2))
    roundtrip(raw)


def test_long_overlapping_matches():
    roundtrip(b"ab" * 40000)


def test_matches_looking_back_across_blocks():
    # dist reaches into the previous block's output (window semantics)
    rng = np.random.default_rng(2)
    blockish = rng.integers(0, 256, 32768 - 100, dtype=np.uint8).tobytes()
    pat = b"0123456789abcdef" * 8
    raw = blockish + pat + pat + blockish[:5000]
    roundtrip(raw)


def test_sub_entry_decode_blocks():
    """Encoder-emitted sub-block entries: decode with lanes = sub entries
    (the throughput path) and verify bit-exactness + entry invariants."""
    from deflate_compression_tpu.decode.tpu_inflate import decode_blocks

    raw = (TEXT_57K[:80000]
           + np.random.default_rng(3).integers(0, 256, 40000,
                                               dtype=np.uint8).tobytes())
    vl = len(raw)
    buf = np.zeros(S, np.uint8)
    buf[:vl] = np.frombuffer(raw, np.uint8)
    r = encode_shard_jit(jnp.asarray(buf), jnp.int32(vl), jnp.asarray(True))

    sb = np.asarray(r["sub_bit"])
    so = np.asarray(r["sub_out"])
    sk = np.asarray(r["sub_blk"])
    live = sk >= 0
    assert live.any()
    # every huffman block's start appears as a sub entry
    bt = np.asarray(r["btype"])
    bos = np.asarray(r["block_out_start"])
    nb = int(r["n_blocks"])
    for b in range(nb):
        if bt[b] in (1, 2):
            assert (so[live][sk[live] == b].min() == bos[b])
    res = decode_blocks(r["words"], r["block_bit_base"],
                        r["block_out_start"], r["btype"], r["n_blocks"],
                        jnp.asarray(sb), jnp.asarray(so), jnp.asarray(sk),
                        jnp.int32(len(sb)), jnp.int32(vl), S)
    assert bool(res["ok"])
    assert np.asarray(res["out"])[:vl].tobytes() == raw


def test_foreign_fixed_strategy_stream():
    """zlib Z_FIXED streams exercise the FULL 288/32-symbol fixed tables
    (lengths for 286/287 and dist 30/31 shape the canonical counts)."""
    import zlib
    from deflate_compression_tpu.decode.index import (build_index,
                                                      decompress_indexed)
    raw = TEXT_37K
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    comp = co.compress(raw) + co.flush()
    idx = build_index(comp)
    assert (np.asarray(idx.btype) == 1).any()
    assert decompress_indexed(comp, idx) == raw


def test_corrupt_symbol_flags_bad_lane():
    """A stream whose token area is corrupted must yield ok=False (never
    silently-wrong output) — VERDICT r2 weak #5."""
    raw = TEXT_37K[:S]
    vl = len(raw)
    buf = np.frombuffer(raw, np.uint8).copy()
    pad = np.zeros(S, np.uint8)
    pad[:vl] = buf
    r = encode_shard_jit(jnp.asarray(pad), jnp.int32(vl), jnp.asarray(True))
    words = np.asarray(r["words"]).copy()
    rng = np.random.default_rng(7)
    bad = 0
    for trial in range(8):
        w = words.copy()
        k = rng.integers(10, (int(r["total_bits"]) // 32) - 1)
        w[k] ^= np.uint32(1) << rng.integers(0, 32)
        res = decode_shard_indexed(jnp.asarray(w), r["block_bit_base"],
                                   r["block_out_start"], r["btype"],
                                   r["n_blocks"], jnp.int32(vl), S)
        got = np.asarray(res["out"])[:vl].tobytes()
        if not bool(res["ok"]):
            bad += 1
        else:
            # decoded "ok" — the corruption must still be visible in output
            # (adler would catch it); silent identity is the failure mode
            assert got != raw
    assert bad >= 1


def test_periodic_same_dist_runs():
    """Deep same-distance LZ chains (periodic tilings) must decode exactly:
    the phase-C run collapse resolves them analytically, and mixed periods
    exercise the cross-distance doubling that remains."""
    rng = np.random.default_rng(11)
    p64 = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    p7 = bytes(range(7))
    raw = (np.tile(np.frombuffer(p64, np.uint8), 600).tobytes()
           + p7 * 4000
           + b"x" * 5000
           + np.tile(np.frombuffer(p64, np.uint8), 100).tobytes())
    roundtrip(raw)


def test_lut11_decodes_our_streams():
    """Our encoder caps code lengths at TREE_LIMIT=11, so an 11-bit decode
    LUT must decode everything it emits (16x cheaper table build)."""
    from deflate_compression_tpu.format.deflate import TREE_LIMIT
    from deflate_compression_tpu.decode.tpu_inflate import decode_blocks
    assert TREE_LIMIT <= 11
    raw = (TEXT_37K[:S - 40000]
           + b"\x07" * 20000
           + np.random.default_rng(3).integers(0, 256, 20000,
                                               dtype=np.uint8).tobytes())
    vl = len(raw)
    buf = np.zeros(S, np.uint8)
    buf[:vl] = np.frombuffer(raw, np.uint8)
    r = encode_shard_jit(jnp.asarray(buf), jnp.int32(vl), jnp.asarray(True))
    res = decode_blocks(r["words"], r["block_bit_base"],
                        r["block_out_start"], r["btype"], r["n_blocks"],
                        r["sub_bit"], r["sub_out"], r["sub_blk"],
                        jnp.int32(r["sub_bit"].shape[0]), jnp.int32(vl), S,
                        lut_bits=11)
    assert bool(res["ok"])
    assert np.asarray(res["out"])[:vl].tobytes() == raw


def test_decode_blocks_batch_flat():
    """decode_blocks_batch (one flat dispatch over B shards) must agree
    byte-exactly with per-shard decode_blocks on a mixed batch."""
    import jax.numpy as jnp
    from deflate_compression_tpu.decode.tpu_inflate import decode_blocks_batch

    SS = 1 << 16
    rng = np.random.default_rng(17)
    bee = TEXT_57K
    raws = [bee[:SS],
            rng.integers(0, 256, SS, dtype=np.uint8).tobytes(),   # stored
            (b"xy" * 1000 + bee[:30000] + b"\0" * 20000)[:SS],
            bee[30000:30000 + SS - 7777]]                         # ragged last
    B = len(raws)
    outs = []
    fields = {k: [] for k in ("words", "block_bit_base", "block_out_start",
                              "btype", "n_blocks", "sub_bit", "sub_out",
                              "sub_blk")}
    for i, raw in enumerate(raws):
        buf = np.zeros(SS, np.uint8)
        buf[:len(raw)] = np.frombuffer(raw, np.uint8)
        r = encode_shard_jit(jnp.asarray(buf), jnp.int32(len(raw)),
                             jnp.asarray(i == B - 1))
        for k in fields:
            fields[k].append(np.asarray(r[k]))
        outs.append(raw)
    batch = {k: jnp.asarray(np.stack(v)) for k, v in fields.items()}
    res = decode_blocks_batch(batch["words"], batch["block_bit_base"],
                              batch["block_out_start"], batch["btype"],
                              batch["n_blocks"], batch["sub_bit"],
                              batch["sub_out"], batch["sub_blk"],
                              jnp.asarray([len(r) for r in raws],
                                          jnp.int32), SS, lut_bits=11)
    assert bool(res["ok"])
    got = np.asarray(res["out"])
    for i, raw in enumerate(outs):
        assert got[i, :len(raw)].tobytes() == raw, f"shard {i} mismatch"


def test_decode_blocks_batch_flags_corruption():
    """A corrupted shard inside a flat batch must flag ok=False (bit flips
    in one shard's words; the batch shares one dispatch)."""
    import jax.numpy as jnp
    from deflate_compression_tpu.decode.tpu_inflate import decode_blocks_batch

    SS = 1 << 16
    bee = TEXT_57K
    raws = [(bee * 3)[:SS], (bee * 3)[1000:1000 + SS]]
    fields = {k: [] for k in ("words", "block_bit_base", "block_out_start",
                              "btype", "n_blocks", "sub_bit", "sub_out",
                              "sub_blk")}
    for i, raw in enumerate(raws):
        buf = np.frombuffer(raw, np.uint8)
        r = encode_shard_jit(jnp.asarray(buf), jnp.int32(SS),
                             jnp.asarray(i == 1))
        for k in fields:
            fields[k].append(np.asarray(r[k]))
    rng = np.random.default_rng(23)
    flagged = 0
    for trial in range(6):
        w = np.stack(fields["words"]).copy()
        nw = w.shape[1]
        for _ in range(3):
            w[1, rng.integers(0, nw // 2)] ^= np.uint32(1) << rng.integers(0, 32)
        res = decode_blocks_batch(
            jnp.asarray(w), jnp.asarray(np.stack(fields["block_bit_base"])),
            jnp.asarray(np.stack(fields["block_out_start"])),
            jnp.asarray(np.stack(fields["btype"])),
            jnp.asarray(np.stack(fields["n_blocks"])),
            jnp.asarray(np.stack(fields["sub_bit"])),
            jnp.asarray(np.stack(fields["sub_out"])),
            jnp.asarray(np.stack(fields["sub_blk"])),
            jnp.asarray([SS, SS], jnp.int32), SS, lut_bits=11)
        out = np.asarray(res["out"])
        if not bool(res["ok"]):
            flagged += 1
        else:
            # ok => shard 0 must still be intact, shard 1 visibly wrong
            assert out[0].tobytes() == raws[0]
            assert out[1].tobytes() != raws[1]
    assert flagged >= 2


def test_compact_tail_chase_256k():
    """S >= 1<<18 activates the scatter-free compact-tail chase
    (tpu_inflate._compact): the result must be bit-exact AND identical to
    the plain full-round loop (_ablate='nocmp')."""
    from deflate_compression_tpu.decode.tpu_inflate import decode_blocks

    SB = 1 << 18
    base = (TEXT_37K
            + TEXT_57K)
    raw = (base * (SB // len(base) + 1))[:SB]
    vl = len(raw)
    assert vl == SB
    buf = np.frombuffer(raw, np.uint8)
    r = encode_shard_jit(jnp.asarray(buf), jnp.int32(vl), jnp.asarray(True))
    args = (r["words"], r["block_bit_base"], r["block_out_start"],
            r["btype"], r["n_blocks"], r["sub_bit"], r["sub_out"],
            r["sub_blk"], jnp.int32(r["sub_bit"].shape[0]), jnp.int32(vl))
    res = decode_blocks(*args, SB)
    assert bool(res["ok"])
    assert np.asarray(res["out"])[:vl].tobytes() == raw
    ref = decode_blocks(*args, SB, _ablate="nocmp")
    assert bool(ref["ok"])
    assert np.array_equal(np.asarray(ref["out"]), np.asarray(res["out"]))
