"""Multi-process (multi-host) initialization.

The replacement for MPI_Init + per-rank topology discovery (reference
src/main.cpp:10, src/dimensions.cpp): pass coordinator ("host:port"),
num_processes and process_id; with no arguments JAX tries to discover the
cluster from its environment, which works only where a cluster manager
describes one.

After initialization, ``jax.devices()`` is the global device list and
``gmrm_tpu.parallel.runner.run_training_sharded`` automatically loads,
computes, and writes only each process's own marker shards.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Join this process into the global JAX runtime.

    Pass coordinator ("host:port"), num_processes, and process_id for
    manual clusters, several processes on one host, or CPU simulation;
    pass nothing only where a cluster manager lets JAX discover them.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(**kwargs)


def is_coordinator() -> bool:
    return jax.process_index() == 0
