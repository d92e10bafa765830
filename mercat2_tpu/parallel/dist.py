"""Multi-host runtime: process-group init + host-level work sharding.

The reference's "cluster" story is a single-node Ray object store
(/root/reference/bin/mercat2.py:217). The equivalent here is a JAX
multi-host process group: every host runs the same program, owns its local
devices, and claims a deterministic slice of the input files; each host
counts its own files on its own devices (mercat2_tpu.parallel.count).
There is no driver process and no object store — the filesystem
(or a shared mount) holds inputs, each host writes only the outputs it
owns, and process 0 writes the combined artifacts.
"""

from __future__ import annotations

import os

__all__ = ["init_distributed", "host_shard", "is_coordinator", "barrier"]


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize jax.distributed when running multi-host; no-op otherwise.

    Arguments default to the standard JAX env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) or a
    cluster environment JAX detects itself. Returns True if a multi-process group was
    initialized.
    """
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None
    if coordinator is None and num_processes is None:
        # single-host run (or a cluster JAX detected by itself)
        try:
            if jax.process_count() > 1:
                return True
        except Exception:
            pass
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def is_coordinator() -> bool:
    import jax

    return jax.process_index() == 0


def host_shard(items: list, process_id: int | None = None,
               num_processes: int | None = None) -> list:
    """Deterministic round-robin slice of ``items`` owned by this host.

    Replaces Ray's dynamic task queue (the reference's per-sample
    ``run_mercat2.remote`` fan-out, /root/reference/bin/mercat2.py:336-339)
    with static ownership: host p takes items p, p+P, p+2P, ... of the
    sorted list, so every host computes the same assignment without
    communication.
    """
    import jax

    p = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    ordered = sorted(items, key=str)
    return ordered[p::n]


def barrier(name: str = "mercat2") -> None:
    """Cross-host sync point (no-op single-host)."""
    import jax

    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
