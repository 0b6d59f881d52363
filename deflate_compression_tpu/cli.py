"""Command-line interface — the `zencode` the reference never finished (its
main() is commented out, src/deflate_compress.c:349-353) plus the util/
tooling (print_bits inspector util/src/print_bits.c, read_img/conv_img pixel
dumpers util/bin/read_img.py + util/src/conv_img.c).

Subcommands:
  compress    file -> zlib/gzip/raw DEFLATE (device encoder)
  decompress  container-sniffing inflate
  inspect     structural dump of a DEFLATE stream (blocks, types, sizes)
  verify      token-replay verification against a 32 KB ring buffer +
              inflater/zlib cross-checks (the reference's check_lld
              strategy, tests/check_lld.c:1-6, as a user tool)
  png         decode a PNG; print info or dump raw pixels ("R G B" lines,
              the read_img.py format, or raw bytes, the conv_img format)
  trace       per-block cost-model trace CSV (the fd_stats channel,
              reference src/include/deflate_ext.h:19-31)
"""
from __future__ import annotations

import argparse
import sys
import time


def _read(path: str) -> bytes:
    if path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write(path: str, data: bytes) -> None:
    if path == "-":
        sys.stdout.buffer.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


def cmd_compress(args) -> int:
    from .models.codec import make_codec
    from .utils.config import CodecConfig
    cfg = CodecConfig(shard_size=args.shard_size,
                      num_candidates=args.candidates,
                      lazy=not args.greedy, container=args.container,
                      block_type=args.btype, self_check=args.self_check)
    if args.stream:
        # O(shard) memory end to end: never buffers the input or output
        # (the reference's unbounded-fd capability,
        # src/deflate_compress.c:14-37); incompatible with --distributed
        # and with --stats (per-block stats would grow with the input).
        if args.distributed:
            print("--stream and --distributed are exclusive", file=sys.stderr)
            return 2
        if args.stats:
            print("--stream does not support --stats", file=sys.stderr)
            return 2
        t0 = time.perf_counter()
        if args.input != "-" and args.output != "-":
            from .models.codec import compress_file
            n_out = compress_file(args.input, args.output, cfg,
                                  index_path=args.index)
        else:
            from .models.codec import compress_stream
            from .decode.index import index_from_shards
            sink = [] if args.index else None
            n_out = 0
            fin = (sys.stdin.buffer if args.input == "-"
                   else open(args.input, "rb"))
            fout = (sys.stdout.buffer if args.output == "-"
                    else open(args.output, "wb"))
            try:
                for piece in compress_stream(fin, cfg, index_sink=sink):
                    fout.write(piece)
                    n_out += len(piece)
            finally:
                if fin is not sys.stdin.buffer:
                    fin.close()
                if fout is not sys.stdout.buffer:
                    fout.close()
            if args.index:
                idx = index_from_shards([t[0] for t in sink],
                                        [t[1] for t in sink],
                                        [t[2] for t in sink])
                with open(args.index, "wb") as f:
                    f.write(idx.to_bytes())
        if args.verbose:
            dt = time.perf_counter() - t0
            print(f"streamed -> {n_out} bytes ({dt:.2f}s)", file=sys.stderr)
        return 0
    raw = _read(args.input)
    t0 = time.perf_counter()
    idx = None
    if args.distributed:
        from .parallel.dist import compress_distributed
        r = compress_distributed(raw, shard_size=cfg.shard_size,
                                 num_candidates=cfg.num_candidates,
                                 lazy=cfg.lazy, container=cfg.container,
                                 force_btype=cfg.force_btype,
                                 return_index=bool(args.index))
        out, idx = r if args.index else (r, None)
        stats = None
        if cfg.self_check:
            # distributed self-check: full-stream ring replay vs the input
            # (per-shard interleaving belongs to the single-process path)
            from .decode.verify import replay_stream
            from .format.containers import container_header
            hdr = len(container_header(cfg.container))
            got, _, _ = replay_stream(out[hdr:], 0)
            if got != raw:
                print("self-check FAILED: distributed stream does not "
                      "replay to the input", file=sys.stderr)
                return 1
    else:
        out, stats = make_codec(cfg).compress(raw, return_stats=True)
    dt = time.perf_counter() - t0
    _write(args.output, out)
    if args.index:
        if idx is None:
            from .decode.index import build_index
            body = out
            if cfg.container == "zlib":
                body = out[2:]
            elif cfg.container == "gzip":
                from .format.containers import gzip_parse_header
                body = out[gzip_parse_header(out):]
            idx = build_index(body)
        with open(args.index, "wb") as f:
            f.write(idx.to_bytes())
        if args.verbose:
            print(f"index: {idx.n_blocks} blocks -> {args.index}",
                  file=sys.stderr)
    if args.verbose:
        rate = len(raw) / dt / 1e6 if dt > 0 else 0
        print(f"{len(raw)} -> {len(out)} bytes "
              f"({8 * len(out) / max(1, len(raw)):.3f} bits/byte, "
              f"{rate:.1f} MB/s)", file=sys.stderr)
        if stats:
            s, f, d = stats.btype_counts
            print(f"blocks: {stats.n_blocks} (stored {s}, fixed {f}, "
                  f"dynamic {d}); tokens {stats.n_tokens} "
                  f"(matches {stats.n_matches})", file=sys.stderr)
    if args.stats and stats:
        with open(args.stats, "w") as f:
            f.write(stats.to_csv())
    return 0


def cmd_decompress(args) -> int:
    from .format import constants as C
    from .models.codec import DeflateCodec, GzipCodec, ZlibCodec
    from .utils.config import CodecConfig
    data = _read(args.input)
    if args.index:
        # device-parallel decode via the sidecar (decode/tpu_inflate.py);
        # container checksums are verified — the parallel path carries the
        # same guarantee as the sequential one (reference adler verify:
        # src/deflate_decompress.c:402-404)
        from .decode.index import DecodeIndex, decompress_indexed
        from .utils.errors import DeflateError
        with open(args.index, "rb") as f:
            idx = DecodeIndex.from_bytes(f.read())
        body = data
        expected_adler = None
        max_dist = C.WINDOW_SIZE
        container = "raw"
        if data[:2] == C.GZIP_MAGIC:
            from .format.containers import gzip_parse_header
            body = data[gzip_parse_header(data):]
            container = "gzip"
        elif (data[0] & 0x0F) == 8 and ((data[0] << 8) | data[1]) % 31 == 0:
            cinfo = data[0] >> 4
            if cinfo > 7:
                raise DeflateError("E_HDR", f"bad CINFO {cinfo}")
            max_dist = 1 << (cinfo + 8)
            if not args.no_verify and len(data) >= 6:
                expected_adler = int.from_bytes(data[-4:], "big")
            body = data[2:]
        out = decompress_indexed(body, idx, expected_adler=expected_adler,
                                 max_dist=max_dist)
        if container == "gzip" and not args.no_verify and len(data) >= 8:
            from .core.checksum import crc32_np
            want_crc = int.from_bytes(data[-8:-4], "little")
            want_isize = int.from_bytes(data[-4:], "little")
            if crc32_np(out) != want_crc or \
                    (len(out) & 0xFFFFFFFF) != want_isize:
                raise DeflateError("E_ADLER", "gzip CRC/ISIZE mismatch")
        _write(args.output, out)
        return 0
    cfg = CodecConfig(verify_checksums=not args.no_verify)
    if data[:2] == C.GZIP_MAGIC:
        codec = GzipCodec(cfg)
    elif len(data) >= 2 and (data[0] & 0x0F) == 8 and \
            ((data[0] << 8) | data[1]) % 31 == 0:
        codec = ZlibCodec(cfg)
    else:
        codec = DeflateCodec(cfg)
    _write(args.output, codec.decompress(data))
    return 0


def cmd_inspect(args) -> int:
    """Structural stream dump (bit-level tooling analogue of
    util/src/print_bits.c)."""
    from .core.bits import BitReader
    from .decode.inflate import _read_dynamic_tables, _FIXED_LL_LUT, \
        _FIXED_D_LUT, _read_symbol
    from .format import constants as C
    data = _read(args.input)
    if args.bits:
        # raw LSB-first bit dump, N bytes per line — the exact format of the
        # reference's print_bits tool (util/src/print_bits.c:22-37), used to
        # build its golden bit traces (png/pngtest.png.txt).
        n = args.bits_per_line
        for i in range(0, len(data), n):
            line = " ".join(
                format(b, "08b")[::-1] for b in data[i:i + n])
            print(line)
        return 0
    pos = 0
    if data[:2] == C.GZIP_MAGIC:
        from .format.containers import gzip_parse_header
        pos = 8 * gzip_parse_header(data)
        print(f"gzip container, deflate at byte {pos // 8}")
    elif (data[0] & 0x0F) == 8 and ((data[0] << 8) | data[1]) % 31 == 0:
        pos = 16
        print(f"zlib container: CMF={data[0]:#04x} FLG={data[1]:#04x} "
              f"window={1 << ((data[0] >> 4) + 8)}")
    r = BitReader(data, pos)
    bi = 0
    total_out = 0
    while True:
        start = r.pos
        bfinal = r.read(1)
        btype = r.read(2)
        tname = {0: "stored", 1: "fixed", 2: "dynamic"}.get(btype, "BAD")
        nsyms = 0
        if btype == 0:
            r.align_byte()
            ln = r.read(16)
            r.read(16)
            r.read_bytes(ln)
            out_bytes = ln
        else:
            if btype == 1:
                ll, dd = _FIXED_LL_LUT, _FIXED_D_LUT
            else:
                ll, dd = _read_dynamic_tables(r)
            out_bytes = 0
            while True:
                s = _read_symbol(r, *ll)
                nsyms += 1
                if s == 256:
                    break
                if s < 256:
                    out_bytes += 1
                else:
                    li = s - 257
                    length = int(C.LENGTH_BASE[li]) + r.read(int(C.LENGTH_EXTRA[li]))
                    ds = _read_symbol(r, *dd)
                    r.read(int(C.DIST_EXTRA[ds]))
                    out_bytes += length
        total_out += out_bytes
        print(f"block {bi}: {tname:8s} bfinal={bfinal} "
              f"bits={r.pos - start:8d} out={out_bytes:6d} syms={nsyms}")
        bi += 1
        if bfinal:
            break
    print(f"total: {bi} blocks, {total_out} bytes out, "
          f"{(r.pos - pos + 7) // 8} compressed payload bytes")
    return 0


def cmd_verify(args) -> int:
    """Decode-as-you-encode verifier as a user tool — the reference ships
    this strategy as the buildable check_lld harness (tests/check_lld.c:1-6,
    Makefile:26-27): every token replayed against an independent 32 KB ring
    buffer, cross-checked against our own inflater and the CPython zlib
    oracle, with per-block stats."""
    from .decode.verify import verify_stream
    from .utils.errors import CodecError
    data = _read(args.input)
    original = _read(args.original) if args.original else None
    try:
        reports, checks = verify_stream(data, original)
    except CodecError as e:
        print(f"FAIL structure: {e}", file=sys.stderr)
        return 1
    tname = {0: "stored", 1: "fixed", 2: "dynamic"}
    if args.verbose:
        for i, b in enumerate(reports):
            print(f"block {i}: {tname.get(b.btype, '?'):8s} "
                  f"bits={b.bits:8d} out={b.out_bytes:6d} "
                  f"tokens={b.n_tokens:6d} (lit {b.n_lits}, "
                  f"match {b.n_matches}, maxdist {b.max_dist})",
                  file=sys.stderr)
    ok_all = True
    for name, ok, detail in checks:
        print(f"{'PASS' if ok else 'FAIL'} {name}: {detail}",
              file=sys.stderr)
        ok_all &= ok
    n_out = sum(b.out_bytes for b in reports)
    print(f"{'OK' if ok_all else 'CORRUPT'}: {len(reports)} blocks, "
          f"{n_out} bytes", file=sys.stderr)
    return 0 if ok_all else 1


def cmd_png(args) -> int:
    from .png.decoder import png_decode
    img = png_decode(_read(args.input))
    ct_names = {0: "grayscale", 2: "truecolor", 3: "palette",
                4: "gray+alpha", 6: "RGBA"}
    print(f"{img.width}x{img.height} {ct_names[img.color_type]} "
          f"{img.bit_depth}-bit interlace={img.interlace}", file=sys.stderr)
    for k, v in img.metadata.items():
        print(f"  {k}: {str(v)[:80]}", file=sys.stderr)
    for w in img.warnings:
        print(f"  warning: {w}", file=sys.stderr)
    if args.rgb_text:
        # read_img.py format: one "R G B" line per pixel (util/bin/read_img.py:15-19)
        rgba = img.to_rgba()
        out = []
        for row in rgba.reshape(-1, rgba.shape[-1]):
            out.append(f"{row[0]} {row[1]} {row[2]}")
        _write(args.output, ("\n".join(out) + "\n").encode())
    elif args.raw:
        # conv_img format: raw RGB bytes (util/src/conv_img.c:6-18)
        _write(args.output, img.to_rgba()[..., :3].astype("uint8").tobytes())
    return 0


def cmd_trace(args) -> int:
    raw = _read(args.input)
    if args.per_symbol:
        # format A: one record per emitted symbol from the real token
        # stream (reference deflate_ext.h:19-31, results/results.txt)
        from .utils.trace import per_symbol_trace_csv
        out = per_symbol_trace_csv(raw, stride=args.stride,
                                   header_stride=args.header_stride)
    else:
        # format B: cumulative per-block (results/results_.txt)
        from .models.codec import ZlibCodec
        from .utils.config import CodecConfig
        _, stats = ZlibCodec(CodecConfig()).compress(raw, return_stats=True)
        out = stats.to_csv()
    _write(args.output, out.encode())
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="deflate_compression_tpu",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    from .utils.config import DEFAULT_CONFIG
    c = sub.add_parser("compress")
    c.add_argument("input")
    c.add_argument("-o", "--output", default="-")
    c.add_argument("--container", default=DEFAULT_CONFIG.container,
                   choices=["raw", "zlib", "gzip"])
    c.add_argument("--shard-size", type=int, default=DEFAULT_CONFIG.shard_size)
    c.add_argument("--candidates", type=int,
                   default=DEFAULT_CONFIG.num_candidates)
    c.add_argument("--greedy", action="store_true",
                   help="disable lazy matching")
    c.add_argument("--btype", default="auto",
                   choices=["auto", "stored", "fixed", "dynamic"],
                   help="force a DEFLATE block type")
    c.add_argument("--distributed", action="store_true",
                   help="use all devices in a data-parallel mesh")
    c.add_argument("--stream", action="store_true",
                   help="stream shard-by-shard with O(shard) memory "
                        "(unbounded input)")
    c.add_argument("--self-check", action="store_true",
                   help="online token verification: ring-replay each "
                        "shard before committing it (check_lld)")
    c.add_argument("--stats", help="write per-block cost CSV here")
    c.add_argument("--index", help="write a .dcx decode index sidecar here")
    c.add_argument("-v", "--verbose", action="store_true")
    c.set_defaults(fn=cmd_compress)

    d = sub.add_parser("decompress")
    d.add_argument("input")
    d.add_argument("-o", "--output", default="-")
    d.add_argument("--no-verify", action="store_true")
    d.add_argument("--index",
                   help="use a .dcx sidecar for device-parallel decode")
    d.set_defaults(fn=cmd_decompress)

    i = sub.add_parser("inspect")
    i.add_argument("input")
    i.add_argument("--bits", action="store_true",
                   help="raw LSB-first bit dump (print_bits format)")
    i.add_argument("--bits-per-line", type=int, default=8,
                   help="bytes per line for --bits")
    i.set_defaults(fn=cmd_inspect)

    v = sub.add_parser("verify")
    v.add_argument("input")
    v.add_argument("--original", help="compare decoded output to this file")
    v.add_argument("-v", "--verbose", action="store_true",
                   help="print per-block replay stats")
    v.set_defaults(fn=cmd_verify)

    g = sub.add_parser("png")
    g.add_argument("input")
    g.add_argument("-o", "--output", default="-")
    g.add_argument("--rgb-text", action="store_true",
                   help="dump 'R G B' lines (read_img.py format)")
    g.add_argument("--raw", action="store_true",
                   help="dump raw RGB bytes (conv_img format)")
    g.set_defaults(fn=cmd_png)

    t = sub.add_parser("trace")
    t.add_argument("input")
    t.add_argument("-o", "--output", default="-")
    t.add_argument("--per-symbol", action="store_true",
                   help="format-A per-symbol records (results/results.txt)")
    t.add_argument("--stride", type=int, default=1,
                   help="emit every Nth per-symbol record")
    t.add_argument("--header-stride", type=int, default=1,
                   help="recompute tree-header cost every Nth record")
    t.set_defaults(fn=cmd_trace)

    args = p.parse_args(argv)
    from .utils import compile_cache
    compile_cache.enable()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
