"""Multi-process / multi-host initialization (SURVEY §5.8).

The reference is strictly single-process; the scaling story here adds
(a) in-process data parallelism across devices via parallel/sharded.py and (b)
multi-host execution over DCN via jax.distributed. This module is the thin
entry point for (b): call `initialize()` once per process before any jax
computation, then build meshes over `jax.devices()` (which then spans all
hosts' chips) with parallel.sharded.device_mesh.

All cmtci collectives are plain psum/all_gather reductions inside shard_map,
so they ride ICI within a slice and DCN across slices without code changes.
"""

from __future__ import annotations


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               require: bool = False) -> bool:
    """Initialize jax.distributed; returns True if multi-process init ran.

    With no arguments, jax's own autodetection runs (cloud metadata,
    JAX_COORDINATOR_ADDRESS, Slurm/MPI launchers, ...). On a plain
    single-host machine autodetection fails — that is swallowed and False is
    returned unless `require=True` or any argument was passed explicitly.
    """
    import jax

    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return True
    except Exception:
        if require or explicit:
            raise
        return False  # single-host run


def process_info() -> dict:
    """Current process/device topology summary."""
    import jax

    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
