"""Measure the C++ native runtime paths (host-side only) on a seeded corpus.

Paths measured (native/deflate_native.cpp via ctypes):
  * dct_inflate_raw  — two-level 10-bit-root LUT inflater
  * dct_build_index  — foreign-stream indexing pass (counts output only)
  * zlib_decompress_native — inflate + slice-by-8 CRC/adler verify

Corpus: 2 MB of BASELINE config 4's mixed shape (utils/corpus.py),
compressed with CPython zlib-6 (the baseline encoder). Prints one JSON
record; give the host's CPU model beside any number you keep.

Usage: python tools/native_bench.py
"""
import json
import os
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deflate_compression_tpu import native_bridge  # noqa: E402
from deflate_compression_tpu.utils import corpus  # noqa: E402


def timed(fn, *args, reps=5):
    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        best = min(best, time.perf_counter() - t0)
    return out, best


def main():
    if not native_bridge.available():
        print("native library unavailable; nothing to measure",
              file=sys.stderr)
        return 1
    n = 2 << 20
    raw = corpus.mixed(n, seed=1234)
    zbody = zlib.compress(raw, 6)[2:-4]          # raw DEFLATE stream

    (out, _), t_inf = timed(native_bridge.inflate_raw_native, zbody, 0)
    assert out == raw, "native inflate mismatch"
    idx, t_idx = timed(native_bridge.build_index_native, zbody, 0, 1024)
    assert idx[-1] == n, "native index out_len mismatch"
    zfull = zlib.compress(raw, 6)
    outz, t_z = timed(native_bridge.zlib_decompress_native, zfull, True)
    assert outz == raw

    print(json.dumps({
        "corpus_bytes": n,
        "inflate_raw_MBps": round(n / t_inf / 1e6, 1),
        "build_index_MBps": round(n / t_idx / 1e6, 1),
        "zlib_decompress_verified_MBps": round(n / t_z / 1e6, 1),
        "note": "host C++ (native/deflate_native.cpp), input = zlib-6 "
                "stream of the seeded 2 MB mixed corpus, best of 5",
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
