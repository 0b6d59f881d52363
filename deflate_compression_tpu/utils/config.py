"""Codec configuration.

The reference has no config system — compile-time macros plus call-time
arguments (SURVEY §5.6: sliding window `sw`, `ops` bitfield with
DEFLATE_NULLTERM, src/include/deflate_ext.h:6-8). This framework owns its
config design: one frozen dataclass threaded through all entry points that,
with the input and the shard plan, fixes the emitted bitstream on a given
backend (SURVEY §7.3 item 6).
"""
from __future__ import annotations

import dataclasses

BLOCK_SIZE = 32768


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    # shard = unit of jit/device-parallel work; must be a multiple of 32768
    shard_size: int = 1 << 20
    # LZ77 search effort: nearest same-hash candidates scored per position
    num_candidates: int = 32
    # one-step lazy matching (zlib-style)
    lazy: bool = True
    # container: "raw" | "zlib" | "gzip"
    container: str = "zlib"
    # block type: "auto" (cost-based selection) | "stored" | "fixed" | "dynamic"
    block_type: str = "auto"
    # verify checksums on decode
    verify_checksums: bool = True
    # online encode verification: ring-replay each shard's emitted tokens
    # (the reference's check_lld interleaving, tests/check_lld.c:41-66)
    # before its bytes are committed to output
    self_check: bool = False

    def __post_init__(self):
        if self.shard_size % BLOCK_SIZE or self.shard_size <= 0:
            raise ValueError("shard_size must be a positive multiple of 32768")
        if self.container not in ("raw", "zlib", "gzip"):
            raise ValueError(f"unknown container {self.container!r}")
        if not 1 <= self.num_candidates <= 64:
            raise ValueError("num_candidates must be in [1, 64]")
        if self.block_type not in ("auto", "stored", "fixed", "dynamic"):
            raise ValueError(f"unknown block_type {self.block_type!r}")


    @property
    def force_btype(self):
        return {"auto": None, "stored": 0, "fixed": 1,
                "dynamic": 2}[self.block_type]


DEFAULT_CONFIG = CodecConfig()
