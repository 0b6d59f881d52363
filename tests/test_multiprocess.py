"""Two-process jax.distributed smoke (multi-host path, SURVEY §2.2/§5.8).

Spawns two CPU-backend processes that initialize the distributed runtime
through parallel/launcher.py, build the global mesh, and each encode their
round-robin shards (host_shard_indices); process 0 assembles and verifies
the container. This validates the multi-host wiring on one machine.
"""
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys, pickle
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")

from deflate_compression_tpu.parallel.launcher import (init_distributed,
                                                       host_shard_indices)
from deflate_compression_tpu.format.deflate import encode_shard_jit
from deflate_compression_tpu.core.bits import words_to_bytes
import numpy as np, jax.numpy as jnp, zlib

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
share = sys.argv[4]
info = init_distributed(coordinator_address=f"127.0.0.1:{port}",
                        num_processes=nproc, process_id=pid)
assert info["process_count"] == nproc, info
assert info["global_devices"] == 2 * nproc, info

SHARD = 32768
from deflate_compression_tpu.utils import corpus
raw = corpus.text(57_000, seed=1)
nsh = (len(raw) + SHARD - 1) // SHARD
parts = {}
for s in host_shard_indices(nsh):
    chunk = raw[s * SHARD:(s + 1) * SHARD]
    buf = np.zeros(SHARD, np.uint8)
    buf[:len(chunk)] = np.frombuffer(chunk, np.uint8)
    r = encode_shard_jit(jnp.asarray(buf), jnp.int32(len(chunk)),
                         jnp.asarray(s == nsh - 1))
    parts[s] = words_to_bytes(np.asarray(r["words"]), int(r["total_bits"]))

with open(f"{share}/mp_shards_{pid}.tmp", "wb") as f:
    pickle.dump(parts, f)
os.replace(f"{share}/mp_shards_{pid}.tmp", f"{share}/mp_shards_{pid}.pkl")

# barrier-ish: wait for the other process's file, then process 0 verifies
import time
for other in range(nproc):
    for _ in range(600):
        if os.path.exists(f"{share}/mp_shards_{other}.pkl"):
            break
        time.sleep(0.1)
if pid == 0:
    allp = {}
    for other in range(nproc):
        with open(f"{share}/mp_shards_{other}.pkl", "rb") as f:
            allp.update(pickle.load(f))
    body = b"".join(allp[s] for s in range(nsh))
    assert zlib.decompress(body, wbits=-15) == raw
    print("MULTIPROC_OK", flush=True)
"""


def _run_distributed(nproc: int, share):
    import socket
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = str(sock.getsockname()[1])
    sock.close()

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(p), str(nproc), port, str(share)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        cwd=_REPO) for p in range(nproc)]
    outs = []
    try:
        for pr in procs:
            out, err = pr.communicate(timeout=360)
            outs.append((pr.returncode, out.decode(), err.decode()))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed: {err[-2000:]}"
    assert "MULTIPROC_OK" in outs[0][1]


def test_two_process_distributed(tmp_path):
    _run_distributed(2, tmp_path)


def test_four_process_distributed(tmp_path):
    """BASELINE config 5 shape: >= 2 hosts -> 4 coordinator-connected
    processes x 2 virtual devices, round-robin shard ownership, process 0
    assembles the container and the zlib oracle verifies it."""
    _run_distributed(4, tmp_path)


def test_eight_process_distributed(tmp_path):
    """8 coordinator-connected processes (VERDICT r3 item 7): the largest
    CPU-simulated multi-host configuration; same round-robin ownership +
    oracle-verified assembly."""
    _run_distributed(8, tmp_path)
