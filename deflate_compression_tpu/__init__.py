"""deflate-compression-tpu: a data-parallel DEFLATE codec in JAX.

Public API:

    from deflate_compression_tpu import ZlibCodec, CodecConfig
    blob = ZlibCodec(CodecConfig()).compress(data)

    from deflate_compression_tpu import compress_distributed   # multi-chip
    from deflate_compression_tpu import png_decode             # PNG ingestion

See README.md for the architecture and PARITY.md for the reference map.
Heavy imports (jax) happen lazily on first use.
"""

__version__ = "0.1.0"

__all__ = [
    "CodecConfig", "DeflateCodec", "ZlibCodec", "GzipCodec", "make_codec",
    "compress_distributed", "png_decode", "CompressStats",
    "DecodeIndex", "build_index", "decompress_indexed",
    "compress_file_resumable", "compress_stream", "compress_file",
]


def __getattr__(name):
    if name in ("CodecConfig",):
        from .utils.config import CodecConfig
        return CodecConfig
    if name in ("DeflateCodec", "ZlibCodec", "GzipCodec", "make_codec",
                "CompressStats", "compress_stream", "compress_file"):
        from .models import codec
        return getattr(codec, name)
    if name == "compress_distributed":
        from .parallel.dist import compress_distributed
        return compress_distributed
    if name == "png_decode":
        from .png.decoder import png_decode
        return png_decode
    if name in ("DecodeIndex", "build_index", "decompress_indexed"):
        from .decode import index
        return getattr(index, name)
    if name == "compress_file_resumable":
        from .parallel.checkpoint import compress_file_resumable
        return compress_file_resumable
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
