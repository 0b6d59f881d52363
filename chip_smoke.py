"""Smoke test of the codec's main path on NVIDIA GPUs.

    python chip_smoke.py          one card: encode, table exactness,
                                  indexed decode, CLI round trip
    python chip_smoke.py --four   four cards: the distributed encode and
                                  what it is compared with, nothing else

Every phase drives the entry points a user calls at a size users call real
and checks what comes out against an independent reference (CPython zlib,
numpy). Each phase prints what it found; any failure raises and the script
exits non-zero. With no GPU it fails before any phase runs. The last line
of standard output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

from deflate_compression_tpu.utils import corpus

MIB = 1 << 20
ENCODE_BYTES = 128 * MIB        # above the H100's 50 MB L2
FOREIGN_BYTES = 32 * MIB
CLI_BYTES = 16 * MIB
FOUR_BYTES = 256 * MIB


class SmokeError(RuntimeError):
    pass


def report(phase: str, **found) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in found.items()),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def zlib_ok(stream: bytes, raw: bytes) -> bool:
    """Does CPython zlib (the oracle) decode `stream` to `raw`?"""
    try:
        return zlib.decompress(stream) == raw
    except zlib.error:
        return False


def gpu_names() -> str:
    """The cards' names and power limits, one card per line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# --------------------------------------------------------------- phases
def phase_device(n_cards: int):
    """Require GPUs, set up the compile cache, build the native library."""
    import jax
    from deflate_compression_tpu import native_bridge
    from deflate_compression_tpu.utils import compile_cache
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeError(f"no GPU: JAX's default backend is "
                         f"{devs[0].platform}")
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, found {len(devs)}")
    report("device", kind=repr(devs[0].device_kind), count=len(devs))
    print(gpu_names(), flush=True)
    report("device", compile_cache=compile_cache.enable())
    t0 = time.perf_counter()
    path = native_bridge.build()
    check(native_bridge.available(), "native library built but not loaded")
    report("device", native_built=os.path.basename(path),
           build_s=f"{time.perf_counter() - t0:.2f}")
    return devs[:n_cards]


def phase_encode(raw: bytes, shard_size: int = MIB):
    """ZlibCodec with the default config; CPython zlib is the oracle."""
    import jax
    import jax.numpy as jnp
    from deflate_compression_tpu.format.deflate import encode_shard_jit
    from deflate_compression_tpu.models.codec import ZlibCodec
    from deflate_compression_tpu.utils.config import CodecConfig
    cfg = CodecConfig(shard_size=shard_size)
    args = (jnp.zeros(shard_size, jnp.uint8), jnp.int32(shard_size),
            jnp.asarray(False))
    t0 = time.perf_counter()
    compiled = encode_shard_jit.lower(
        *args, num_candidates=cfg.num_candidates, lazy=cfg.lazy,
        force_btype=cfg.force_btype).compile()
    report("encode", compile_s=f"{time.perf_counter() - t0:.2f}",
           memory=compiled.memory_analysis())
    t0 = time.perf_counter()
    ZlibCodec(cfg).compress(raw[:shard_size])     # first call: set-up
    setup_s = time.perf_counter() - t0
    n_compiled = encode_shard_jit._cache_size()
    t0 = time.perf_counter()
    out = ZlibCodec(cfg).compress(raw)
    wall = time.perf_counter() - t0
    check(encode_shard_jit._cache_size() == n_compiled,
          "the timed encode compiled again")
    check(zlib_ok(out, raw), "zlib oracle rejects the stream")
    z6 = len(zlib.compress(raw, 6)) / len(raw)
    z9 = len(zlib.compress(raw, 9)) / len(raw)
    report("encode", bytes=len(raw), out=len(out),
           ratio=f"{len(out) / len(raw):.5f}", zlib6=f"{z6:.5f}",
           zlib9=f"{z9:.5f}", wall_s=f"{wall:.2f}",
           MBps=f"{len(raw) / wall / 1e6:.2f}", setup_s=f"{setup_s:.2f}",
           device=jax.devices()[0].device_kind, oracle="ok")
    return out


def _shard_streams(raw: bytes, shard_size: int, n: int, device):
    """Encode the first n shards (each non-final) on `device`."""
    import jax
    import jax.numpy as jnp
    from deflate_compression_tpu.core import bits
    from deflate_compression_tpu.format.deflate import encode_shard_jit
    res = []
    for s in range(n):
        part = np.frombuffer(raw[s * shard_size:(s + 1) * shard_size],
                             np.uint8)
        buf = np.zeros(shard_size, np.uint8)
        buf[:len(part)] = part
        args = jax.device_put((jnp.asarray(buf), jnp.int32(len(part)),
                               jnp.asarray(False)), device)
        r = {k: np.asarray(v) for k, v in encode_shard_jit(*args).items()}
        r["bytes"] = bits.words_to_bytes(r["words"], int(r["total_bits"]))
        res.append(r)
    return res


def phase_cpu_compare(raw: bytes, shard_size: int = MIB, n: int = 2):
    """Are the card's bytes the CPU backend's bytes? Reported, not gated:
    the correctness gate is the oracle round trip."""
    import jax
    gpu = _shard_streams(raw, shard_size, n, jax.devices()[0])
    cpu = _shard_streams(raw, shard_size, n, jax.devices("cpu")[0])
    for s, (g, c) in enumerate(zip(gpu, cpu)):
        same = g["bytes"] == c["bytes"]
        found = {"shard": s, "identical": same}
        if not same:
            nb = int(g["n_blocks"])
            for field, key in (("split", "block_out_start"),
                               ("BTYPE", "btype"),
                               ("code_lengths", "tree_bits"),
                               ("block_bits", "block_bits")):
                if int(c["n_blocks"]) != nb or not np.array_equal(
                        g[key][:nb], c[key][:nb]):
                    found["first_diff"] = field
                    break
            found["size_diff"] = len(g["bytes"]) - len(c["bytes"])
        report("cpu_compare", **found)


def phase_tables(nb: int = 32, length: int = 32768, seed: int = 0):
    """rows_lookup and histogram_rows_matmul at the encoder's
    shapes against numpy; exact integer equality."""
    import jax.numpy as jnp
    from deflate_compression_tpu.core import huffman
    rng = np.random.default_rng(seed)
    for n_cls in (286, 30):
        sym = rng.integers(0, n_cls + 1, (nb, length)).astype(np.int32)
        tab = rng.integers(0, 1 << 20, (nb, n_cls)).astype(np.uint32)
        tab[:, :4] = [(1 << 20) - 1, (1 << 20) - 2, (1 << 19) + 1, 0xF7FFF]
        want = np.where(sym < n_cls, np.take_along_axis(
            tab, np.minimum(sym, n_cls - 1), axis=1), 0)
        got = np.asarray(huffman.rows_lookup(jnp.asarray(sym),
                                             jnp.asarray(tab)))
        bad_lk = int(np.sum(got != want))
        want_h = np.stack([np.bincount(r[r < n_cls], minlength=n_cls)
                           for r in sym])
        got_h = np.asarray(huffman.histogram_rows_matmul(jnp.asarray(sym),
                                                         n_cls))
        bad_h = int(np.sum(got_h != want_h))
        report("tables", classes=n_cls, shape=(nb, length),
               lookup_mismatches=bad_lk, histogram_mismatches=bad_h)
        check(bad_lk == 0, f"rows_lookup inexact ({n_cls} classes)")
        check(bad_h == 0, f"histogram_rows_matmul inexact ({n_cls} classes)")


def _decode(stream: bytes, idx, expected_adler: int, raw: bytes,
            what: str):
    from deflate_compression_tpu.decode.index import decompress_indexed
    from deflate_compression_tpu.decode.tpu_inflate import decode_blocks
    n0 = decode_blocks._cache_size()
    t0 = time.perf_counter()
    got = decompress_indexed(stream, idx, expected_adler=expected_adler)
    wall = time.perf_counter() - t0
    check(got == raw, f"indexed decode of {what} differs from the input")
    report("decode", stream=what, bytes=len(raw), blocks=idx.n_blocks,
           wall_s=f"{wall:.2f}", compiles=decode_blocks._cache_size() - n0,
           adler="ok", equal="ok")


def phase_decode(raw: bytes, ours: bytes, foreign_bytes: int,
                 shard_size: int = MIB):
    """Indexed device decode of our stream (index from the encoder's
    per-shard stats) and of a CPython zlib-6 stream (index from one host
    pass)."""
    from deflate_compression_tpu.decode.index import (build_index,
                                                      index_from_shards)
    from deflate_compression_tpu.models.codec import compress_stream
    from deflate_compression_tpu.utils.config import CodecConfig
    sink = []
    streamed = b"".join(compress_stream(io.BytesIO(raw),
                                        CodecConfig(shard_size=shard_size),
                                        index_sink=sink))
    check(streamed == ours, "compress_stream bytes differ from ZlibCodec's")
    idx = index_from_shards([t[0] for t in sink], [t[1] for t in sink],
                            [t[2] for t in sink])
    _decode(ours[2:], idx, int.from_bytes(ours[-4:], "big"), raw, "ours")
    part = raw[:foreign_bytes]
    z = zlib.compress(part, 6)
    t0 = time.perf_counter()
    fidx = build_index(z[2:])
    report("decode", foreign_index_s=f"{time.perf_counter() - t0:.2f}")
    _decode(z[2:], fidx, int.from_bytes(z[-4:], "big"), part, "zlib6")


def phase_cli(raw: bytes, shard_size: int = MIB):
    """compress --index, then decompress --index, in this process."""
    from deflate_compression_tpu.cli import main
    with tempfile.TemporaryDirectory() as d:
        src, zz, dcx, rt = (os.path.join(d, n)
                            for n in ("in.bin", "out.zz", "out.dcx", "rt"))
        with open(src, "wb") as f:
            f.write(raw)
        t0 = time.perf_counter()
        check(main(["compress", src, "-o", zz, "--index", dcx,
                    "--shard-size", str(shard_size)]) == 0,
              "CLI compress failed")
        t1 = time.perf_counter()
        check(main(["decompress", zz, "--index", dcx, "-o", rt]) == 0,
              "CLI decompress failed")
        t2 = time.perf_counter()
        with open(zz, "rb") as f:
            check(zlib_ok(f.read(), raw), "zlib oracle rejects the CLI stream")
        with open(rt, "rb") as f:
            check(f.read() == raw, "CLI --index round trip differs")
        report("cli", bytes=len(raw), compress_s=f"{t1 - t0:.2f}",
               decompress_s=f"{t2 - t1:.2f}", oracle="ok", roundtrip="ok")


def phase_four(raw: bytes, devices, shard_size: int = MIB):
    """compress_distributed over a mesh of the given devices: zlib oracle,
    equality with the one-card encode, indexed decode of its index."""
    from deflate_compression_tpu.models.codec import ZlibCodec
    from deflate_compression_tpu.parallel.dist import (compress_distributed,
                                                       make_mesh)
    from deflate_compression_tpu.utils.config import CodecConfig
    mesh = make_mesh(devices)
    compress_distributed(raw[:len(devices) * shard_size], mesh,
                         shard_size=shard_size)       # first call: set-up
    t0 = time.perf_counter()
    out, idx = compress_distributed(raw, mesh, shard_size=shard_size,
                                    return_index=True)
    wall = time.perf_counter() - t0
    check(zlib_ok(out, raw), "zlib oracle rejects the mesh stream")
    report("four", cards=len(devices), bytes=len(raw), out=len(out),
           ratio=f"{len(out) / len(raw):.5f}", wall_s=f"{wall:.2f}",
           MBps=f"{len(raw) / wall / 1e6:.2f}", oracle="ok")
    t0 = time.perf_counter()
    single = ZlibCodec(CodecConfig(shard_size=shard_size)).compress(raw)
    report("four", one_card_wall_s=f"{time.perf_counter() - t0:.2f}")
    check(out == single, "mesh bytes differ from the one-card bytes")
    report("four", equals_one_card="ok")
    _decode(out[2:], idx, int.from_bytes(out[-4:], "big"), raw, "mesh")


# ----------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card distributed encode only")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    devices = phase_device(4 if args.four else 1)
    if args.four:
        phase_four(corpus.mixed(FOUR_BYTES, args.seed), devices)
    else:
        raw = corpus.mixed(ENCODE_BYTES, args.seed)
        ours = phase_encode(raw)
        phase_cpu_compare(raw)
        phase_tables()
        phase_decode(raw, ours, FOREIGN_BYTES)
        phase_cli(corpus.mixed(CLI_BYTES, args.seed + 1))
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
