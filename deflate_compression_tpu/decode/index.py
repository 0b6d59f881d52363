"""Decode-index sidecar: random access + device-parallel decode.

A DEFLATE stream is bit-serial; the index records, per coding block, its bit
offset, output byte offset and type, making decoding embarrassingly parallel
(decode/tpu_inflate.py) and giving O(1) random access into the stream — the
deliberate trade described in SURVEY §7.3 item 4 and PAPERS.md (rapidgzip
builds the same index at first decode; gzip's zran does it offline).

Version 2 adds SUB-BLOCK entries: a (bit_offset, out_offset, block) triple at
the first token on/after every SUB_SIZE output bytes. They cost 20 bytes per
4 KB of output and multiply the device decoder's parallel lanes (phase B of
decode/tpu_inflate.py) — the step count becomes tokens-per-sub-block instead
of tokens-per-block.

Sources of an index:
  * free from our encoder (format/deflate.py stats), via `index_from_shards`;
  * one host pass over any foreign zlib/DEFLATE stream (`build_index`) —
    block boundaries require decoding symbols, but only COUNTING output, so
    the pass needs no window buffer.

Sidecar format (.dcx): magic 'DCXI', u32 version, u32 n_blocks, u64 out_len,
then per block u64 bit_base, u64 out_start, u8 btype; version 2 appends
u32 n_subs then per sub u64 bit, u64 out, u32 block.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..core.bits import BitReader
from ..core.huffman import decode_lut_np
from ..format import constants as C
from ..utils.errors import DeflateError

_MAGIC = b"DCXI"
_VERSION = 2
SUB_SIZE = 1024

# The per-shard encoder stats that index_from_shards consumes — the ONE
# canonical field list (parallel/dist.py and models/codec.py both ship
# these from device to host; a drifting copy would silently desynchronize
# the distributed and single-process .dcx sidecars).
INDEX_STAT_FIELDS = ("block_bit_base", "block_out_start", "btype",
                     "n_blocks", "sub_bit", "sub_out", "sub_blk",
                     "sub_overflow")


@dataclasses.dataclass
class DecodeIndex:
    bit_base: np.ndarray      # i64[n] bit offset of each block header
    out_start: np.ndarray     # i64[n] output byte offset of each block
    btype: np.ndarray         # u8[n]
    out_len: int              # total decompressed bytes
    sub_bit: np.ndarray | None = None    # i64[m] first-token bit offsets
    sub_out: np.ndarray | None = None    # i64[m] output offsets
    sub_blk: np.ndarray | None = None    # i32[m] owning block ids

    @property
    def n_blocks(self) -> int:
        return len(self.bit_base)

    @property
    def n_subs(self) -> int:
        return 0 if self.sub_bit is None else len(self.sub_bit)

    def to_bytes(self) -> bytes:
        head = _MAGIC + struct.pack("<IIQ", _VERSION, self.n_blocks,
                                    self.out_len)
        body = b"".join(
            struct.pack("<QQB", int(b), int(o), int(t))
            for b, o, t in zip(self.bit_base, self.out_start, self.btype))
        subs = struct.pack("<I", self.n_subs)
        if self.n_subs:
            subs += b"".join(
                struct.pack("<QQI", int(b), int(o), int(k))
                for b, o, k in zip(self.sub_bit, self.sub_out, self.sub_blk))
        return head + body + subs

    @classmethod
    def from_bytes(cls, data: bytes) -> "DecodeIndex":
        if data[:4] != _MAGIC:
            raise DeflateError("E_HDR", "bad index magic")
        ver, n, out_len = struct.unpack("<IIQ", data[4:20])
        if ver not in (1, 2):
            raise DeflateError("E_HDR", f"unsupported index version {ver}")
        bb = np.zeros(n, np.int64)
        os_ = np.zeros(n, np.int64)
        bt = np.zeros(n, np.uint8)
        off = 20
        for i in range(n):
            bb[i], os_[i], bt[i] = struct.unpack("<QQB", data[off:off + 17])
            off += 17
        sb = so = sk = None
        if ver >= 2:
            (m,) = struct.unpack("<I", data[off:off + 4])
            off += 4
            sb = np.zeros(m, np.int64)
            so = np.zeros(m, np.int64)
            sk = np.zeros(m, np.int32)
            for i in range(m):
                sb[i], so[i], sk[i] = struct.unpack("<QQI",
                                                    data[off:off + 20])
                off += 20
        return cls(bb, os_, bt, out_len, sb, so, sk)

    def block_for_offset(self, byte_off: int) -> int:
        """Random access: which block contains output byte `byte_off`."""
        return int(np.searchsorted(self.out_start, byte_off, "right") - 1)


def build_index(stream: bytes, bit_pos: int = 0,
                sub_size: int = SUB_SIZE,
                prefer_native: bool = True) -> DecodeIndex:
    """One host pass over a raw DEFLATE stream: records block boundaries (and
    sub-entries every `sub_size` output bytes) by decoding symbols but only
    COUNTING output bytes (no window needed).

    Dispatches to the C++ native pass (native/deflate_native.cpp
    dct_build_index) when available; the Python loop below is the
    oracle path. The block loop replayed is the reference's
    src/deflate_decompress.c:291-345."""
    if prefer_native:
        from .. import native_bridge
        if native_bridge.available():
            bb, bo, bt, sb, so, sk, out_len = native_bridge.build_index_native(
                bytes(stream), bit_pos, sub_size)
            return DecodeIndex(bb, bo, bt.astype(np.uint8), out_len,
                               sb, so, sk)
    r = BitReader(stream, bit_pos)
    bit_base, out_start, btypes = [], [], []
    sub_bit, sub_out, sub_blk = [], [], []
    out = 0
    while True:
        blk_i = len(bit_base)
        bit_base.append(r.pos)
        out_start.append(out)
        bfinal = r.read(1)
        btype = r.read(2)
        btypes.append(btype)
        if btype == C.BTYPE_STORED:
            r.align_byte()
            ln = r.read(16)
            nlen = r.read(16)
            if ln != (~nlen & 0xFFFF):
                raise DeflateError("E_STORED", "LEN != ~NLEN")
            r.skip(8 * ln)
            out += ln
        elif btype in (C.BTYPE_FIXED, C.BTYPE_DYNAMIC):
            if btype == C.BTYPE_FIXED:
                ll = decode_lut_np(C.FIXED_LITLEN_LENGTHS, 15)
                dd = decode_lut_np(C.FIXED_DIST_LENGTHS, 15)
            else:
                from .inflate import _read_dynamic_tables
                ll, dd = _read_dynamic_tables(r)
            ll_sym, ll_len = ll
            d_sym, d_len = dd
            next_mark = out      # block start always gets a sub-entry
            while True:
                if out >= next_mark:
                    sub_bit.append(r.pos)
                    sub_out.append(out)
                    sub_blk.append(blk_i)
                    next_mark = (out // sub_size + 1) * sub_size
                idx = r.peek(15)
                l = ll_len[idx]
                if l == 0:
                    raise DeflateError("E_BADCODE", "invalid code")
                r.skip(int(l))
                s = int(ll_sym[idx])
                if s < 256:
                    out += 1
                elif s == 256:
                    break
                else:
                    li = s - 257
                    out += int(C.LENGTH_BASE[li]) + r.read(int(C.LENGTH_EXTRA[li]))
                    didx = r.peek(15)
                    dl = d_len[didx]
                    if dl == 0:
                        raise DeflateError("E_BADCODE", "invalid dist code")
                    r.skip(int(dl))
                    r.skip(int(C.DIST_EXTRA[int(d_sym[didx])]))
        else:
            raise DeflateError("E_BTYPE", "reserved BTYPE=3")
        if bfinal:
            break
    return DecodeIndex(np.array(bit_base, np.int64),
                       np.array(out_start, np.int64),
                       np.array(btypes, np.uint8), out,
                       np.array(sub_bit, np.int64),
                       np.array(sub_out, np.int64),
                       np.array(sub_blk, np.int32))


def index_from_shards(shard_results, shard_comp_bits, shard_out_lens,
                      sub_spacing: int = SUB_SIZE) -> DecodeIndex:
    """Assemble a stream-level index from per-shard encoder stats
    (format/deflate.py returns block_bit_base/block_out_start/btype/n_blocks
    and sub_bit/sub_out/sub_blk relative to each shard).

    The encoder emits dense sub-entries (one per ~64 output bytes — sized
    for on-device decode lanes); the sidecar THINS them to ~one per
    `sub_spacing` output bytes (block-first entries always kept — a decoder
    lane set is correct for any entry subset that includes block starts)."""
    bit_base, out_start, btypes = [], [], []
    sub_bit, sub_out, sub_blk = [], [], []
    bit_off = 0
    out_off = 0
    blk_off = 0
    for si, (r, nbits, out_len) in enumerate(zip(shard_results,
                                                 shard_comp_bits,
                                                 shard_out_lens)):
        # a dropped block-first sub-entry would leave that block's range
        # undecodable while decode still reports ok=True — the encoder's
        # stride arithmetic makes this unreachable, so treat it as loud
        # corruption, never a warning (VERDICT r4 weak #4)
        if "sub_overflow" in r and bool(np.asarray(r["sub_overflow"])):
            raise DeflateError(
                "E_INDEX", f"shard {si}: sub-entry capacity overflow — "
                "index would be silently incomplete")
        n = int(r["n_blocks"])
        bb = np.asarray(r["block_bit_base"])[:n]
        os_ = np.asarray(r["block_out_start"])[:n]
        bt = np.asarray(r["btype"])[:n]
        bit_base += list(bb + bit_off)
        out_start += list(os_ + out_off)
        btypes += list(bt)
        if "sub_bit" in r:
            sb = np.asarray(r["sub_bit"])
            so = np.asarray(r["sub_out"])
            sk = np.asarray(r["sub_blk"])
            live = (sk >= 0) & (so < out_len)
            sb, so, sk = sb[live], so[live], sk[live]
            if sub_spacing > 1 and len(so):
                first = np.concatenate([[True], sk[1:] != sk[:-1]])
                keep = first | (so // sub_spacing
                                != np.concatenate([[-1], so[:-1]])
                                // sub_spacing)
                sb, so, sk = sb[keep], so[keep], sk[keep]
            sub_bit += list(sb + bit_off)
            sub_out += list(so + out_off)
            sub_blk += list(sk + blk_off)
        bit_off += int(np.ceil(nbits / 8)) * 8   # shards are byte-aligned
        out_off += out_len
        blk_off += n
    subs = (np.array(sub_bit, np.int64), np.array(sub_out, np.int64),
            np.array(sub_blk, np.int32)) if sub_bit else (None, None, None)
    return DecodeIndex(np.array(bit_base, np.int64),
                       np.array(out_start, np.int64),
                       np.array(btypes, np.uint8), out_off, *subs)


def decompress_indexed(stream: bytes, index: DecodeIndex,
                       shard_out: int = 1 << 20,
                       expected_adler: int | None = None,
                       max_dist: int = C.WINDOW_SIZE) -> bytes:
    """Decode a raw DEFLATE stream with the device-parallel decoder, batching
    blocks into device groups of ~shard_out output bytes. The previous
    group's last 32 KB rides along as window context so match distances may
    cross group boundaries (general streams have no window resets).

    `expected_adler` (the zlib footer) is verified over the decoded bytes —
    the parallel path carries the same never-silently-wrong guarantee as the
    sequential one (reference verify: src/deflate_decompress.c:402-404).
    `max_dist` bounds match distances to the container's declared window."""
    import jax.numpy as jnp
    from ..core.checksum import adler32_combine, adler32_np
    from .tpu_inflate import decode_blocks

    W = C.WINDOW_SIZE
    n = index.n_blocks
    have_subs = index.n_subs > 0
    out_parts = []
    prev_tail = np.zeros(W, np.uint8)
    plen = 0
    adler = 1
    i = 0
    while i < n:
        j = i
        start = int(index.out_start[i])
        while j < n and (int(index.out_start[j]) - start) < shard_out:
            j += 1
        end_out = int(index.out_start[j]) if j < n else index.out_len
        span = end_out - start
        nb = j - i
        NBP = max(1, 1 << int(np.ceil(np.log2(max(nb, 1)))))
        S = 1 << int(np.ceil(np.log2(max(plen + span, 2))))

        # upload only the group's own bytes (plus the peek rows' reach past
        # its last token), rebased to a word-aligned start; the word count
        # is rounded up to a power of two so groups share compiled shapes
        first_byte = int(index.bit_base[i]) // 8 // 4 * 4   # u32-word align
        end_byte = ((int(index.bit_base[j]) + 7) // 8 if j < n
                    else len(stream))
        cw = 1 << int(np.ceil(np.log2((end_byte - first_byte + 64) // 4 + 1)))
        words = np.zeros(4 * cw, np.uint8)
        chunk = np.frombuffer(stream[first_byte:first_byte + 4 * cw],
                              np.uint8)
        words[:len(chunk)] = chunk
        comp_words = words.view(np.uint32)

        bb = np.full(NBP, 0, np.int32)
        os_ = np.full(NBP, 0, np.int32)
        bt = np.full(NBP, -1, np.int32)
        bb[:nb] = (index.bit_base[i:j] - first_byte * 8).astype(np.int32)
        os_[:nb] = (index.out_start[i:j] - start + plen).astype(np.int32)
        bt[:nb] = index.btype[i:j]

        if have_subs:
            si = int(np.searchsorted(index.sub_blk, i, "left"))
            sj = int(np.searchsorted(index.sub_blk, j, "left"))
            ns = sj - si
            NLP = max(1, 1 << int(np.ceil(np.log2(max(ns, 1)))))
            sb = np.full(NLP, -1, np.int32)
            so = np.full(NLP, 1 << 30, np.int32)
            sk = np.full(NLP, -1, np.int32)
            sb[:ns] = (index.sub_bit[si:sj] - first_byte * 8).astype(np.int32)
            so[:ns] = (index.sub_out[si:sj] - start + plen).astype(np.int32)
            sk[:ns] = (index.sub_blk[si:sj] - i).astype(np.int32)
        else:
            ns = nb
            NLP = NBP
            sb = np.full(NLP, -1, np.int32)
            so = os_.copy()
            hufft = (bt == C.BTYPE_FIXED) | (bt == C.BTYPE_DYNAMIC)
            sk = np.where(hufft, np.arange(NLP, dtype=np.int32), -1)

        res = decode_blocks(jnp.asarray(comp_words), jnp.asarray(bb),
                            jnp.asarray(os_), jnp.asarray(bt),
                            jnp.int32(nb), jnp.asarray(sb), jnp.asarray(so),
                            jnp.asarray(sk), jnp.int32(ns),
                            jnp.int32(plen + span), S,
                            prefix=jnp.asarray(prev_tail),
                            prefix_len=jnp.int32(plen),
                            max_dist=jnp.int32(max_dist))
        if not bool(res["ok"]):
            raise DeflateError("E_BADCODE", "indexed decode failed")
        full = np.asarray(res["out"])[:plen + span]
        new = full[plen:]
        out_parts.append(new.tobytes())
        if expected_adler is not None:
            adler = adler32_combine(adler, adler32_np(new), len(new))
        tail = full[max(0, plen + span - W):]
        prev_tail = np.zeros(W, np.uint8)
        prev_tail[:len(tail)] = tail
        plen = len(tail)
        i = j
    if expected_adler is not None and adler != (expected_adler & 0xFFFFFFFF):
        raise DeflateError("E_ADLER",
                           f"adler mismatch {expected_adler:#x} != {adler:#x}")
    return b"".join(out_parts)
