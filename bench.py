"""Benchmark harness: DEFLATE encode throughput on one GPU vs CPython zlib
level 6 — the reference's own interop oracle (util/bin/zlib_encode.py); the
C reference never emits a bitstream (SURVEY §0), so zlib is the baseline
encoder. A device-decode figure of the same corpus goes to stderr.

The corpus is BASELINE config 4's mixed text+binary shape, generated from a
seed (utils/corpus.py). Every timed output is fingerprinted, so XLA cannot
drop the work that produces it. Fails when JAX finds no GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
"""
import json
import subprocess
import sys
import time
import zlib

import numpy as np

SHARD = 1 << 18          # 256 KB shards
N_SHARDS = 8             # 2 MB corpus
REPS = 3


def best_time(fn, *args):
    """Best wall time of REPS calls, each ended by block_until_ready."""
    import jax
    best, out = None, None
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best, out


def main():
    import jax
    import jax.numpy as jnp
    from deflate_compression_tpu.core import bits as bits_mod
    from deflate_compression_tpu.core.checksum import adler32_jax
    from deflate_compression_tpu.decode.tpu_inflate import decode_blocks_batch
    from deflate_compression_tpu.format.deflate import encode_shard
    from deflate_compression_tpu.utils import compile_cache, corpus

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX's default device is "
                 f"{dev.platform}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"# device: {dev.device_kind} x{len(jax.devices())} | {smi}",
          file=sys.stderr)
    print(f"# compile cache: {compile_cache.enable()}", file=sys.stderr)

    n = SHARD * N_SHARDS
    raw = corpus.mixed(n, seed=1234)
    shards = np.frombuffer(raw, np.uint8).reshape(N_SHARDS, SHARD)
    dbatch = jax.device_put(jnp.asarray(shards), dev)
    fins = jnp.arange(N_SHARDS) == N_SHARDS - 1

    @jax.jit
    def encode_all(batch):
        def one(row, fin):
            r = encode_shard(row, jnp.int32(SHARD), fin)
            return (r["words"], r["total_bits"], r["block_bit_base"],
                    r["block_out_start"], r["btype"], r["n_blocks"],
                    r["sub_bit"], r["sub_out"], r["sub_blk"],
                    r["sub_overflow"])
        return jax.vmap(one)(batch, fins)

    @jax.jit
    def encode_fp(batch):
        words, total_bits = encode_all(batch)[:2]
        return total_bits, jnp.sum(words, dtype=jnp.uint32)

    t0 = time.perf_counter()
    jax.block_until_ready(encode_fp(dbatch))
    print(f"# encode compile + first run: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    enc_s, (bits, _) = best_time(encode_fp, dbatch)
    ours_mbps = n / enc_s / 1e6
    comp_bytes = int(np.sum((np.asarray(bits) + 7) // 8))
    ratio = comp_bytes / n

    enc = encode_all(dbatch)
    words, total_bits = np.asarray(enc[0]), np.asarray(enc[1])
    body = b"".join(bits_mod.words_to_bytes(words[i], int(total_bits[i]))
                    for i in range(N_SHARDS))
    if zlib.decompress(body, wbits=-15) != raw:
        sys.exit("benched stream failed oracle verification")
    if bool(np.asarray(enc[9]).any()):
        sys.exit("sub-entry overflow: the decode index would be incomplete")

    @jax.jit
    def decode_all(words, bb, bo, bt, nb, sb, so, sk):
        valid = jnp.full((words.shape[0],), SHARD, jnp.int32)
        r = decode_blocks_batch(words, bb, bo, bt, nb, sb, so, sk, valid,
                                SHARD)
        ad = jax.vmap(lambda o: adler32_jax(o, jnp.int32(SHARD)))(r["out"])
        return r["ok"], ad

    dec_args = (enc[0],) + tuple(enc[2:9])
    jax.block_until_ready(decode_all(*dec_args))
    dec_s, (ok, adlers) = best_time(decode_all, *dec_args)
    want = np.array([zlib.adler32(shards[i].tobytes())
                     for i in range(N_SHARDS)], np.uint32)
    dec_ok = bool(np.asarray(ok)) and bool((np.asarray(adlers) == want).all())
    dec_mbps = n / dec_s / 1e6

    # baseline: zlib level 6 on this host (+ level 9 ratio), best of 3
    zdt = None
    for _ in range(REPS):
        t0 = time.perf_counter()
        zcomp = zlib.compress(raw, 6)
        dt = time.perf_counter() - t0
        zdt = dt if zdt is None else min(zdt, dt)
    z_mbps = n / zdt / 1e6
    z_ratio = (len(zcomp) - 6) / n
    z9_ratio = (len(zlib.compress(raw, 9)) - 6) / n
    t0 = time.perf_counter()
    zlib.decompress(zcomp)
    zd_mbps = n / (time.perf_counter() - t0) / 1e6

    print(f"# ours: {ours_mbps:.2f} MB/s ratio {ratio:.4f}; "
          f"zlib-6: {z_mbps:.1f} MB/s ratio {z_ratio:.4f}; "
          f"zlib-9 ratio {z9_ratio:.4f}", file=sys.stderr)
    print("# decode " + json.dumps({
        "metric": "decode_throughput", "value": round(dec_mbps, 2),
        "unit": "MB/s", "verified": dec_ok,
        "vs_baseline": round(dec_mbps / zd_mbps, 3)}), file=sys.stderr)
    if not dec_ok:
        sys.exit("device decode failed adler32 verification")
    print(json.dumps({
        "metric": "encode_throughput",
        "value": round(ours_mbps, 2),
        "unit": "MB/s",
        "vs_baseline": round(ours_mbps / z_mbps, 3),
    }))


if __name__ == "__main__":
    main()
