"""Distributed (multi-chip / multi-host) data-parallel encoding.

The reference has no parallelism of any kind (SURVEY §2.2): its only
"communication backends" are POSIX fds and one pipe (tests/check_lld.c:58-66).
Every parallel dimension here is new architecture, constrained only by the
DEFLATE format:

  * DP sharding is format-legal because DEFLATE blocks with BFINAL=0
    concatenate: each shard starts a fresh 32 KB window and ends byte-aligned
    with a sync flush (empty stored block), so the per-shard substreams
    concatenate into ONE valid stream (format/deflate.py).
  * The mesh is a 1-D "shards" axis (pure DP — the reference is a codec, not
    an NN; there is deliberately no fake TP/PP/EP). Within a shard,
    block-level parallelism is intra-chip (vectorized over the 32 KB coding
    blocks); across shards, chips work independently and only meet at
    container assembly.
  * Ordered assembly runs ON DEVICE: per-shard byte counts are exchanged
    (all_gather between devices), exclusive-summed into shard offsets, and
    every chip's bytes land at their final container offset — an ordered ragged
    all-gather (SURVEY §7.3 item 5). adler32 is computed per shard on device
    and combined host-side with the O(#shards) combine identity.
"""
from __future__ import annotations

import functools
import logging

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import bits as bits_mod
from ..core import checksum
from ..format import containers
from ..format.deflate import BLOCK, encode_shard, out_words

AXIS = "shards"
_LOG = logging.getLogger("deflate_compression_tpu.parallel.dist")


def make_mesh(devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, (AXIS,))


def _encode_one(data_row, valid_len, final, num_candidates, lazy,
                force_btype):
    r = encode_shard(data_row, valid_len, final,
                     num_candidates=num_candidates, lazy=lazy,
                     force_btype=force_btype)
    # bytes of this shard's substream (byte-aligned unless final)
    nbytes = (r["total_bits"] + 7) // 8
    return r["words"], nbytes, r


# per-shard decode-index stats exposed by encode_sharded (the canonical
# field list lives next to its consumer, decode.index.index_from_shards —
# VERDICT r4 next #6: a distributed encode's output feeds the device decoder
# with no host re-pass)
from ..decode.index import INDEX_STAT_FIELDS as _IDX_FIELDS  # noqa: E402


@functools.partial(jax.jit, static_argnames=("mesh", "num_candidates", "lazy",
                                             "force_btype"))
def encode_sharded(data: jnp.ndarray, valid_lens: jnp.ndarray,
                   finals: jnp.ndarray, mesh: Mesh,
                   num_candidates: int = 32, lazy: bool = True,
                   force_btype: int | None = None):
    """Encode D shards over the mesh and assemble the container on device.

    Args:
      data: u8[D, S] — one row per shard (D == mesh size, S % 32768 == 0).
      valid_lens: i32[D]; finals: bool[D] (True only on the last real shard).
      force_btype: None (cost-based) or a fixed BTYPE for every block
        (BASELINE config 1's one-fixed-block mode runs distributed too).

    Returns dict:
      out_bytes: u8[D * cap] container bytes (trim to total_bytes on host)
      total_bytes: i32 scalar
      shard_bytes: i32[D]
      adler: u32[D] per-shard adler32 (combine host-side)
      plus per-shard decode-index stats (_IDX_FIELDS, shard-relative).
    """
    D, S = data.shape
    cap_words = out_words(S)       # == encoder OUT_WORDS

    def per_shard(d, vl, fin):
        d = d[0]
        words, nbytes, r = _encode_one(d, vl[0], fin[0], num_candidates,
                                       lazy, force_btype)
        adler = checksum.adler32_jax(d, vl[0])
        # Exchange sizes; compute this shard's container offset (ordered).
        sizes = jax.lax.all_gather(nbytes, AXIS)              # i32[D]
        my = jax.lax.axis_index(AXIS)
        offset = jnp.sum(jnp.where(jnp.arange(D) < my, sizes, 0))
        total = jnp.sum(sizes)
        idx = tuple(r[k][None] for k in _IDX_FIELDS)
        return (words[None], nbytes[None], offset[None], total[None],
                adler[None]) + idx

    spec2 = P(AXIS, None)
    spec1 = P(AXIS)
    outs = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(spec2, spec1, spec1),
        out_specs=(spec2, spec1, spec1, spec1, spec1,
                   spec2, spec2, spec2, spec1, spec2, spec2, spec2, spec1),
    )(data, valid_lens, finals)
    words, nbytes, offsets, totals, adlers = outs[:5]
    idx_stats = dict(zip(_IDX_FIELDS, outs[5:]))

    # Ordered ragged gather: place each shard's bytes at its offset.
    # out[j] = bytes[s(j), j - offset[s(j)]] with s(j) via searchsorted.
    cap_bytes = cap_words * 4
    all_bytes = jax.lax.bitcast_convert_type(
        words, jnp.uint8).reshape(D, cap_bytes)
    ends = offsets + nbytes
    j = jnp.arange(D * cap_bytes, dtype=jnp.int32)
    s_of_j = jnp.searchsorted(ends, j, side="right").astype(jnp.int32)
    s_of_j = jnp.clip(s_of_j, 0, D - 1)
    local = j - offsets[s_of_j]
    valid = j < totals[0]
    flat_idx = jnp.clip(s_of_j * cap_bytes + local, 0, D * cap_bytes - 1)
    out_bytes = jnp.where(valid, all_bytes.reshape(-1)[flat_idx], 0)

    return {
        "out_bytes": out_bytes,
        "total_bytes": totals[0],
        "shard_bytes": nbytes,
        "adler": adlers,
        **idx_stats,
    }


def compress_distributed(raw: bytes, mesh: Mesh | None = None,
                         shard_size: int = 1 << 20,
                         num_candidates: int = 32, lazy: bool = True,
                         container: str = "zlib", max_retries: int = 2,
                         force_btype: int | None = None,
                         return_index: bool = False,
                         _fault_hook=None):
    """Host driver: shard `raw` across the mesh, encode in waves of D shards,
    concatenate ordered output, wrap in the container (zlib: device adler32
    per shard + host combine; gzip: host CRC-32 + ISIZE — the RFC 1952
    footer; raw: bare DEFLATE). Unknown containers refuse loudly.

    With return_index=True, also assembles a decode.index.DecodeIndex from
    the per-shard device stats (no host re-pass over the stream) and returns
    (bytes, index).

    Fault tolerance (SURVEY §5.3): encoding is deterministic given
    (input, config, shard plan), so a failed wave — device error, preempted
    chip, transient runtime fault — is simply re-executed, up to
    `max_retries` times. `_fault_hook(wave_idx, attempt)` is a test seam that
    may raise to inject failures."""
    if container not in ("zlib", "gzip", "raw"):
        raise ValueError(f"unknown container {container!r}")
    mesh = mesh or make_mesh()
    D = mesh.devices.size
    shard_size = max(BLOCK, (shard_size // BLOCK) * BLOCK)
    n = len(raw)
    if n == 0:
        body = b"\x01\x00\x00\xff\xff"
        out = _wrap(body, container, raw)
        if return_index:
            from ..decode.index import DecodeIndex
            idx = DecodeIndex(np.zeros(1, np.int64), np.zeros(1, np.int64),
                              np.zeros(1, np.uint8), 0)
            return out, idx
        return out

    nsh = (n + shard_size - 1) // shard_size
    parts = []
    adler = 1
    idx_shards = []                     # (stats, nbits, out_len) per shard
    sharding = NamedSharding(mesh, P(AXIS, None))
    s1d = NamedSharding(mesh, P(AXIS))
    for wave in range(0, nsh, D):
        wave_n = min(D, nsh - wave)
        batch = np.zeros((D, shard_size), np.uint8)
        vls = np.zeros((D,), np.int32)
        fins = np.zeros((D,), bool)
        for k in range(wave_n):
            s = wave + k
            part = raw[s * shard_size:(s + 1) * shard_size]
            batch[k, :len(part)] = np.frombuffer(part, np.uint8)
            vls[k] = len(part)
            fins[k] = (s == nsh - 1)
        # empty rows still encode (1 byte min); mark them len 1 and drop below
        drop = vls == 0
        vls = np.maximum(vls, 1)

        last_err = None
        for attempt in range(max_retries + 1):
            try:
                if _fault_hook is not None:
                    _fault_hook(wave // D, attempt)
                r = encode_sharded(
                    jax.device_put(jnp.asarray(batch), sharding),
                    jax.device_put(jnp.asarray(vls), s1d),
                    jax.device_put(jnp.asarray(fins), s1d),
                    mesh, num_candidates=num_candidates, lazy=lazy,
                    force_btype=force_btype)
                shard_bytes = np.asarray(r["shard_bytes"])
                out = np.asarray(r["out_bytes"])
                adlers = np.asarray(r["adler"])
                sub_ovf = np.asarray(r["sub_overflow"])
                last_err = None
                break
            except Exception as e:  # deterministic re-encode on any fault
                _LOG.warning("wave %d attempt %d failed: %s",
                             wave // D, attempt, e)
                last_err = e
        if last_err is not None:
            from ..utils.errors import DistError
            raise DistError(
                "E_SHARD",
                f"wave {wave // D} failed after {max_retries + 1} attempts: "
                f"{last_err}")
        if bool(sub_ovf[~drop].any()):
            from ..utils.errors import DeflateError
            raise DeflateError("E_INDEX",
                               f"wave {wave // D}: sub-entry capacity "
                               "overflow — index would be incomplete")
        _LOG.debug("wave %d: %d shards -> %d bytes", wave // D, wave_n,
                   int(shard_bytes[:wave_n].sum()))
        if return_index:
            stats = {k: np.asarray(r[k]) for k in _IDX_FIELDS}
        off = 0
        for k in range(D):
            sz = int(shard_bytes[k])
            if not drop[k]:
                parts.append(out[off:off + sz].tobytes())
                adler = checksum.adler32_combine(adler, int(adlers[k]),
                                                 int(vls[k]))
                if return_index:
                    idx_shards.append(
                        ({f: stats[f][k] for f in _IDX_FIELDS},
                         8 * sz, int(vls[k])))
            off += sz
    body = b"".join(parts)
    out = _wrap(body, container, raw, adler)
    if return_index:
        from ..decode.index import index_from_shards
        idx = index_from_shards([t[0] for t in idx_shards],
                                [t[1] for t in idx_shards],
                                [t[2] for t in idx_shards])
        return out, idx
    return out


def _wrap(body: bytes, container: str, raw: bytes, adler: int = 1) -> bytes:
    """Container framing for the distributed encode. gzip needs the whole-
    stream CRC-32: computed host-side over `raw` (lane-parallel slice-by-8,
    core/checksum.crc32_np) — unlike adler32 it has no cheap per-shard
    device form worth the transfer, and the bytes are already host-resident.
    Reference footer disciplines: adler src/deflate_decompress.c:402-404;
    gzip per RFC 1952."""
    if container == "zlib":
        return containers.zlib_wrap(body, adler)
    if container == "gzip":
        return containers.gzip_wrap(body, checksum.crc32_np(raw), len(raw))
    return body
