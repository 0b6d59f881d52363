"""Multi-host launcher: jax.distributed initialization + the global mesh.

The reference has no multi-node story (SURVEY §2.2/§5.8: POSIX fds and one
pipe are its only "communication backends"). Here:

  * one controller process per host, or one per GPU; the
    `jax.distributed.initialize` handshake takes the coordinator address
    from the arguments or the environment;
  * where several processes share a host, each passes `local_device_ids`
    so that it opens only its own cards (a JAX process reserves most of the
    memory of every card it opens);
  * the global mesh is 1-D over ALL devices: shards meet only at container
    assembly, where the ordered all-gather exchanges per-shard SIZES first,
    so the traffic between processes is the compressed bytes;
  * per-host input slicing: host h reads shards h, h+H, h+2H, ... so reading
    is embarrassingly parallel across hosts too.

On a single-process run this degrades to the local mesh transparently.
"""
from __future__ import annotations

import logging
import os

import jax

from .dist import make_mesh

log = logging.getLogger("deflate_compression_tpu.launcher")


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids: list[int] | None = None) -> dict:
    """Initialize the multi-host runtime (no-op for single process).

    Resolution order: explicit args > JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID env > single-process fallback.
    `local_device_ids` names the cards of this host that this process
    opens (all of them when None).
    """
    coord = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "0"))
    pid = process_id if process_id is not None else \
        int(os.environ.get("JAX_PROCESS_ID", "-1"))

    if coord and nproc > 1 and pid >= 0:
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=nproc, process_id=pid,
                                   local_device_ids=local_device_ids)
        log.info("distributed runtime up: process %d/%d via %s",
                 pid, nproc, coord)
    mesh = make_mesh(jax.devices())
    return {
        "mesh": mesh,
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": jax.local_device_count(),
        "global_devices": jax.device_count(),
    }


def host_shard_indices(n_shards: int, process_index: int | None = None,
                       process_count: int | None = None) -> range:
    """Round-robin shard ownership for per-host input reading."""
    p = jax.process_index() if process_index is None else process_index
    n = jax.process_count() if process_count is None else process_count
    return range(p, n_shards, n)
