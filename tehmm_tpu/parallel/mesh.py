"""Device mesh construction and multi-host initialization.

SURVEY.md §2c: the rebuild's data-parallel axis is a 1-D ``data`` mesh of
all devices (optionally 2-D ``data × state`` for very large state
counts).  XLA hands the collectives to NCCL, over NVLink between the
cards of one host and the network across hosts, with no code change.
The cards of a host are joined all to all, so the mesh follows the
algorithm alone.  The reference has no counterpart (single process,
SURVEY.md §5 "Distributed comm backend").
"""

from __future__ import annotations

import jax
import numpy as np

from tehmm_tpu.utils.common import logger

DATA_AXIS = "data"
STATE_AXIS = "state"


def device_count() -> int:
    return jax.device_count()


def make_data_mesh(n_devices: int | None = None) -> jax.sharding.Mesh:
    """1-D mesh over all (or the first n) devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return jax.sharding.Mesh(np.array(devs), (DATA_AXIS,))


def make_data_state_mesh(
    n_state_shards: int,
) -> jax.sharding.Mesh:
    """2-D ``data × state`` mesh: shards the S dimension of the S×S
    transition contraction for very large state counts (SURVEY.md §2c TP
    row; usually unnecessary — parameters replicate)."""
    devs = np.array(jax.devices())
    n = len(devs)
    if n % n_state_shards != 0:
        raise ValueError(
            f"device count {n} not divisible by state shards "
            f"{n_state_shards}"
        )
    grid = devs.reshape(n // n_state_shards, n_state_shards)
    return jax.sharding.Mesh(grid, (DATA_AXIS, STATE_AXIS))


def is_multiprocess(mesh: jax.sharding.Mesh) -> bool:
    """True when the mesh spans devices of more than one JAX process
    (multi-host training)."""
    return any(
        d.process_index != jax.process_index()
        for d in mesh.devices.flat
    )


def stage_batch(arr, mesh: jax.sharding.Mesh | None):
    """Host array -> device array ready for ``shard_map`` over the data
    axis.

    Single process: each device receives its row shard directly, so
    the data never passes through one device and shard_map finds it
    already in place on every call.  Multi-process: every process holds
    the full host array (genome data is on shared storage, like the
    reference's single-host load) and materializes ONLY its addressable
    shards via ``jax.make_array_from_callback`` — the global array is
    assembled without any cross-host data movement (SURVEY.md §7
    layer 6)."""
    if mesh is None:
        return jax.device_put(arr)
    arr = np.asarray(arr)
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(DATA_AXIS)
    )
    if not is_multiprocess(mesh):
        return jax.device_put(arr, sharding)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx]
    )


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host entry point (SURVEY.md §2c comm backend row):
    ``jax.distributed.initialize`` + XLA collectives replace any
    NCCL/MPI-style backend.  No-op when no coordinator address is given
    and no cluster environment is detectable (a bare
    ``jax.distributed.initialize()`` on a plain machine raises
    ``ValueError('coordinator_address should be defined.')`` — verified
    against the installed JAX — rather than no-opping).

    Must run before the JAX backend initializes (CLI mains call it
    right after ``setup_jax``).  On the CPU backend cross-process
    collectives need the gloo transport — selecting it is harmless on
    the GPU (the option only affects CPU executables), so it is always
    set."""
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return
    try:
        jax.distributed.initialize()
    except ValueError:
        # no cluster env (SLURM, ...) detected:
        # single-process run, nothing to initialize
        logger.debug("no distributed environment detected; single host")
