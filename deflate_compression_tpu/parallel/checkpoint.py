"""Checkpoint / resume for long-running compression jobs.

The reference persists nothing mid-stream (SURVEY §5.4: compression state is
in-memory only, freed on exit — deflate_compr_deinit
src/deflate_compress.c:106-112). This framework makes resume cheap BY
DESIGN: shards are independent DEFLATE block runs joined at byte boundaries
(format/deflate.py sync flush), so a checkpoint is just
(next shard index, container bytes written, running adler32) — exactly the
"(input offset, emitted-block index)" plan of SURVEY §5.4.

The manifest is written atomically (tmp + rename) after every completed
shard; resume validates the config fingerprint and the input identity, then
truncates the partial output to the last durable byte and continues.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import jax.numpy as jnp

from ..core import bits as bits_mod
from ..core import checksum
from ..format import containers
from ..format.deflate import BLOCK, encode_shard_jit
from ..utils.config import CodecConfig, DEFAULT_CONFIG
from ..utils.errors import DistError

MANIFEST_VERSION = 1


def _config_fingerprint(cfg: CodecConfig) -> str:
    return hashlib.sha256(repr(dataclasses.astuple(cfg)).encode()).hexdigest()[:16]


def _input_fingerprint(path: str) -> dict:
    st = os.stat(path)
    with open(path, "rb") as f:
        head = f.read(65536)
    return {"size": st.st_size,
            "head_sha": hashlib.sha256(head).hexdigest()[:16]}


class CheckpointManager:
    """Atomic JSON manifest beside the output file."""

    def __init__(self, path: str):
        self.path = path

    def save(self, state: dict) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def load(self) -> dict | None:
        if not os.path.exists(self.path):
            return None
        try:
            with open(self.path) as f:
                state = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if state.get("version") != MANIFEST_VERSION:
            return None
        return state

    def clear(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)


def compress_file_resumable(src_path: str, dst_path: str,
                            config: CodecConfig = DEFAULT_CONFIG,
                            checkpoint_path: str | None = None,
                            progress_cb=None) -> dict:
    """Compress src -> dst (zlib or raw container), checkpointing after every
    shard. Re-invoking after a crash resumes at the last completed shard.

    progress_cb(shard_idx, n_shards) is called after each shard (tests use it
    to inject failures).

    Returns summary dict.
    """
    if config.container == "gzip":
        raise DistError("E_RESUME", "resumable gzip not yet supported")
    cp = CheckpointManager(checkpoint_path or dst_path + ".ckpt")
    fp_in = _input_fingerprint(src_path)
    fp_cfg = _config_fingerprint(config)

    total = fp_in["size"]
    shard_size = config.shard_size
    n_shards = max(1, (total + shard_size - 1) // shard_size)

    state = cp.load()
    if state is not None and (state["input"] != fp_in
                              or state["config"] != fp_cfg
                              or state["n_shards"] != n_shards):
        state = None                   # stale checkpoint: restart
    header = containers.zlib_header() if config.container == "zlib" else b""

    if state is None:
        state = {"version": MANIFEST_VERSION, "input": fp_in,
                 "config": fp_cfg, "n_shards": n_shards,
                 "next_shard": 0, "bytes_written": len(header),
                 "adler": 1}
        with open(dst_path, "wb") as f:
            f.write(header)
        cp.save(state)
    else:
        # truncate any bytes past the last durable checkpoint
        with open(dst_path, "ab") as f:
            pass
        if os.path.getsize(dst_path) < state["bytes_written"]:
            raise DistError("E_RESUME", "output shorter than checkpoint")
        os.truncate(dst_path, state["bytes_written"])

    resumed_at = state["next_shard"]
    with open(src_path, "rb") as src, open(dst_path, "r+b") as dst:
        dst.seek(state["bytes_written"])
        for s in range(state["next_shard"], n_shards):
            src.seek(s * shard_size)
            part = src.read(shard_size)
            if len(part) == 0:
                # 0-byte input (only possible when total == 0): one empty
                # final stored block, same bytes as deflate_compress_bytes.
                blob = b"\x01\x00\x00\xff\xff"
            else:
                buf = np.zeros(shard_size, np.uint8)
                buf[:len(part)] = np.frombuffer(part, np.uint8)
                r = encode_shard_jit(jnp.asarray(buf), jnp.int32(len(part)),
                                     jnp.asarray(s == n_shards - 1),
                                     num_candidates=config.num_candidates,
                                     lazy=config.lazy)
                blob = bits_mod.words_to_bytes(np.asarray(r["words"]),
                                               int(r["total_bits"]))
            dst.write(blob)
            dst.flush()
            os.fsync(dst.fileno())
            state["adler"] = checksum.adler32_combine(
                state["adler"],
                checksum.adler32_np(np.frombuffer(part, np.uint8)),
                len(part))
            state["next_shard"] = s + 1
            state["bytes_written"] += len(blob)
            cp.save(state)
            if progress_cb:
                progress_cb(s, n_shards)
        if config.container == "zlib":
            dst.write(int(state["adler"]).to_bytes(4, "big"))
    cp.clear()
    return {"input_bytes": total,
            "output_bytes": state["bytes_written"]
            + (4 if config.container == "zlib" else 0),
            "n_shards": n_shards, "resumed_at_shard": resumed_at}
