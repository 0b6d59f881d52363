"""Localize the ratio gap vs zlib-6 by corpus component.

Encodes each component of BASELINE config 4's mixed shape (utils/corpus.py)
separately with our encoder and with zlib-6 and prints the compressed sizes,
so ratio work targets the part that actually loses. Ratios do not depend on
the backend, so the CPU is enough:

    JAX_PLATFORMS=cpu python tools/ratio_probe.py
"""
import os
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deflate_compression_tpu.utils import corpus  # noqa: E402


def comp_ours(raw: bytes, **kw) -> int:
    from deflate_compression_tpu.format.deflate import deflate_compress_bytes
    blob = deflate_compress_bytes(raw, shard_size=1 << 18, **kw)
    assert zlib.decompress(blob, wbits=-15) == raw
    return len(blob)


def main():
    text = corpus.text(57344, seed=1234)
    parts = {"text_56k": text,
             "rand_64k": corpus.random(65536, seed=1234),
             "tiled64_16k": corpus.repeated(64 * 256, seed=1234),
             "text_x4_224k": text * 4}
    for name, raw in parts.items():
        z = len(zlib.compress(raw, 6)) - 6
        o = comp_ours(raw)
        print(f"{name:14s} n={len(raw):7d} zlib6={z:7d} ours={o:7d} "
              f"delta={(o - z) / max(z, 1) * 100:+.2f}%")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
