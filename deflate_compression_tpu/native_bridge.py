"""ctypes bridge to the C++ native host runtime (native/deflate_native.cpp).

Builds the shared library on first use (g++ via native/Makefile) and falls
back to the pure-Python paths when a toolchain is unavailable, so the
framework works everywhere and is fast where it can be.

The library's file name carries the host's machine type and a hash of the
source, so a library built from another `deflate_native.cpp`, or for
another kind of CPU, is never loaded: the matching one is built instead.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading

log = logging.getLogger("deflate_compression_tpu.native")

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SRC_PATH = os.path.join(_NATIVE_DIR, "deflate_native.cpp")

_lock = threading.Lock()
_lib = None
_tried = False

_ERRNAMES = {
    -1: "E_TRUNC", -2: "E_BTYPE", -3: "E_STORED", -4: "E_TREE",
    -5: "E_BADCODE", -6: "E_SYM", -7: "E_DIST", -8: "E_SIZE",
    -9: "E_HDR", -10: "E_ADLER",
}


def so_path() -> str:
    """Library path keyed on the host's machine type and the source hash."""
    with open(_SRC_PATH, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_NATIVE_DIR, f"libdeflate_native-"
                                     f"{platform.machine()}-{digest}.so")


def build() -> str:
    """Compile the library from the committed source and return its path.
    Builds into a private file and renames it into place, so concurrent
    builders never load a half-written library. Raises OSError (with the
    compiler's output) or subprocess.TimeoutExpired on failure."""
    path = so_path()
    tmp = f"{path[:-3]}.{os.getpid()}.tmp.so"
    r = subprocess.run(["make", "-B", "-C", _NATIVE_DIR,
                        f"SO={os.path.basename(tmp)}"],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise OSError(f"native build failed ({r.returncode}): "
                      f"{r.stderr.strip() or r.stdout.strip()}")
    os.replace(tmp, path)
    return path


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = so_path()
        if not os.path.exists(path):
            try:
                build()
            except (OSError, subprocess.SubprocessError) as e:
                log.info("native build unavailable: %s", e)
                return None
        try:
            lib = ctypes.CDLL(path)
            lib.dct_inflate.restype = ctypes.c_int64
            lib.dct_inflate.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.dct_inflate2.restype = ctypes.c_int64
            lib.dct_inflate2.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
            lib.dct_png_defilter.restype = ctypes.c_int64
            lib.dct_png_defilter.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64]
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.dct_build_index.restype = ctypes.c_int64
            lib.dct_build_index.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, i64p, i64p, ctypes.c_void_p,
                ctypes.c_int64, i64p, i64p, ctypes.c_void_p,
                ctypes.c_int64, i64p, i64p, i64p]
            lib.dct_zlib_decompress.restype = ctypes.c_int64
            lib.dct_zlib_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int]
            lib.dct_crc32.restype = ctypes.c_uint32
            lib.dct_crc32.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_uint32]
            lib.dct_adler32.restype = ctypes.c_uint32
            lib.dct_adler32.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_uint32]
            if lib.dct_abi_version() != 2:  # pragma: no cover
                return None
            _lib = lib
        except OSError as e:  # pragma: no cover
            log.info("native load failed: %s", e)
        return _lib


def available() -> bool:
    return get_lib() is not None


def _grow_call(fn, data: bytes, *args, initial_cap: int | None = None):
    from .utils.errors import DeflateError
    cap = initial_cap or max(4 * len(data), 1 << 16)
    while True:
        out = ctypes.create_string_buffer(cap)
        r = fn(data, len(data), *args, out, cap)
        if r >= 0:
            return out.raw[:r], r
        if r == -8:  # E_SIZE: grow and retry
            cap *= 4
            if cap > (1 << 33):
                raise DeflateError("E_SIZE", "output exceeds 8 GiB cap")
            continue
        raise DeflateError(_ERRNAMES.get(int(r), "E_HDR"),
                           f"native inflate error {int(r)}")


def inflate_raw_native(data: bytes, bit_pos: int = 0,
                       max_dist: int = 32768):
    """Native inflate_raw; returns (bytes, end_bit_pos) like the Python one."""
    lib = get_lib()
    from .utils.errors import DeflateError
    cap = max(4 * len(data), 1 << 16)
    end = ctypes.c_int64(0)
    while True:
        out = ctypes.create_string_buffer(cap)
        r = lib.dct_inflate2(data, len(data), bit_pos, out, cap,
                             ctypes.byref(end), max_dist)
        if r >= 0:
            return out.raw[:r], int(end.value)
        if r == -8:
            cap *= 4
            if cap > (1 << 33):
                raise DeflateError("E_SIZE", "output exceeds 8 GiB cap")
            continue
        raise DeflateError(_ERRNAMES.get(int(r), "E_HDR"),
                           f"native inflate error {int(r)}")


def build_index_native(data: bytes, bit_pos: int = 0, sub_size: int = 1024):
    """Native one-pass decode-index construction. Returns (blk_bits,
    blk_outs, blk_types, sub_bits, sub_outs, sub_blks, out_len) numpy
    arrays, or raises DeflateError on malformed streams."""
    import numpy as np
    lib = get_lib()
    from .utils.errors import DeflateError
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    blk_cap = 256
    sub_cap = max(4096, 2 * (4 * len(data) // max(sub_size, 1) + 2))
    while True:
        bb = np.zeros(blk_cap, np.int64)
        bo = np.zeros(blk_cap, np.int64)
        bt = np.zeros(blk_cap, np.uint8)
        sb = np.zeros(sub_cap, np.int64)
        so = np.zeros(sub_cap, np.int64)
        sk = np.zeros(sub_cap, np.int32)
        nb = ctypes.c_int64(0)
        ns = ctypes.c_int64(0)
        end = ctypes.c_int64(0)
        r = lib.dct_build_index(
            data, len(data), bit_pos, sub_size,
            bb.ctypes.data_as(i64p), bo.ctypes.data_as(i64p),
            bt.ctypes.data_as(ctypes.c_void_p), blk_cap,
            sb.ctypes.data_as(i64p), so.ctypes.data_as(i64p),
            sk.ctypes.data_as(ctypes.c_void_p), sub_cap,
            ctypes.byref(nb), ctypes.byref(ns), ctypes.byref(end))
        if r >= 0:
            n, m = int(nb.value), int(ns.value)
            return (bb[:n], bo[:n], bt[:n], sb[:m], so[:m], sk[:m], int(r))
        if r == -8:  # E_SIZE: grow both tables and retry
            blk_cap *= 8
            sub_cap *= 4
            if blk_cap > (1 << 28):
                raise DeflateError("E_SIZE", "index table cap exceeded")
            continue
        raise DeflateError(_ERRNAMES.get(int(r), "E_HDR"),
                           f"native index error {int(r)}")


def zlib_decompress_native(data: bytes, verify: bool = True) -> bytes:
    lib = get_lib()
    from .utils.errors import DeflateError
    cap = max(4 * len(data), 1 << 16)
    while True:
        out = ctypes.create_string_buffer(cap)
        r = lib.dct_zlib_decompress(data, len(data), out, cap,
                                    1 if verify else 0)
        if r >= 0:
            return out.raw[:r]
        if r == -8:
            cap *= 4
            if cap > (1 << 33):
                raise DeflateError("E_SIZE", "output exceeds 8 GiB cap")
            continue
        raise DeflateError(_ERRNAMES.get(int(r), "E_HDR"),
                           f"native zlib error {int(r)}")


def png_defilter_native(rows, filters, bpp: int):
    """In-place PNG scanline defilter over (H, rb) u8 rows. Returns the
    reconstructed array (same buffer)."""
    import numpy as np
    from .utils.errors import PngError
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    H, rb = rows.shape
    r = get_lib().dct_png_defilter(
        rows.ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(filters, dtype=np.uint8).tobytes(),
        H, rb, bpp)
    if r != 0:
        raise PngError("E_FILTER", "unknown filter type")
    return rows


def crc32_native(data: bytes, crc: int = 0) -> int:
    return int(get_lib().dct_crc32(data, len(data), crc & 0xFFFFFFFF))


def adler32_native(data: bytes, adler: int = 1) -> int:
    return int(get_lib().dct_adler32(data, len(data), adler & 0xFFFFFFFF))
