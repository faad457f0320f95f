"""Multi-host process-group initialization (SURVEY.md §5.8).

The reference's only "distributed backend" is the ROS graph on one machine.
Here, a multi-process run needs exactly one extra call per process:

    from apf_quadruped.parallel import distributed
    distributed.ensure_initialized()        # no-op single-process
    mesh = mesh_mod.scenario_mesh()         # spans ALL processes' devices

after which runtime.sweep.run_sharded shards the global scenario batch
across every device of every process; pmean reductions ride NVLink
within a host and the network across hosts (XLA and NCCL choose — no
hand-rolled transport).

The coordinator address, process count and process id come from the
arguments or from JAX_COORDINATOR_ADDRESS / COORDINATOR_ADDRESS in the
launcher's environment; nothing is detected.  A single process needs no
call at all (one process drives every card of a host).
"""

from __future__ import annotations

import os

import jax

_initialized = False


def ensure_initialized(coordinator: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None) -> bool:
    """Initialize jax.distributed exactly once.  Returns True if a
    multi-process group is active, False for the single-process case."""
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    multi = (coordinator is not None
             or os.environ.get("JAX_COORDINATOR_ADDRESS")
             or os.environ.get("COORDINATOR_ADDRESS"))
    if multi:
        kwargs = {}
        if coordinator is not None:
            kwargs["coordinator_address"] = coordinator
        if num_processes is not None:
            kwargs["num_processes"] = num_processes
        if process_id is not None:
            kwargs["process_id"] = process_id
        jax.distributed.initialize(**kwargs)
    _initialized = True
    return jax.process_count() > 1


def process_info() -> dict:
    return {"process_index": jax.process_index(),
            "process_count": jax.process_count(),
            "local_devices": len(jax.local_devices()),
            "global_devices": len(jax.devices())}
