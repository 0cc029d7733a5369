"""
Multi-host scaling: process initialisation and host-spanning meshes.

The geometry pipeline's parallel axes map onto hardware like this:

- **pixel rows** shard over the devices of one host (the forward
  geometry pass is communication-free, so this is pure weak scaling);
- **frames / ephemeris times** (JWST-cube style batches) shard across
  hosts - each frame is independent, so cross-host traffic is limited to
  result gathering;
- reductions (gradient disc fitting's loss ``psum``, map assembly) cross
  the intra-host links first and the network once per step. XLA hands
  the collectives to the backend's library (NCCL between GPUs).

On a single host everything below degrades gracefully to the local
devices (including the virtual CPU mesh used in tests), so the same code
runs from a laptop to a multi-host cluster.
"""

from __future__ import annotations

import os

import numpy as np


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """
    Initialise JAX's distributed runtime (no-op when single-process).

    Arguments left as None are read from ``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``. Without a coordinator
    address and with at most one process, nothing is initialised.
    """
    import jax

    if num_processes is None:
        num_processes = int(os.environ.get('JAX_NUM_PROCESSES', '0')) or None
    if coordinator_address is None:
        coordinator_address = os.environ.get('JAX_COORDINATOR_ADDRESS')
    if process_id is None:
        pid = os.environ.get('JAX_PROCESS_ID')
        process_id = int(pid) if pid is not None else None
    if num_processes in (None, 1) and coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_multihost_mesh(
    axis_names: tuple[str, str] = ('frames', 'px'),
):
    """
    A 2D mesh with the host axis first and the intra-host devices
    second: frames/time batches shard across hosts, pixel rows across
    each host's devices. Single-host processes get a ``1 x
    local_device_count`` mesh with the same axis names, so calling code
    is identical either way.
    """
    import jax
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices())
    n_hosts = max(1, jax.process_count())
    per_host = devices.size // n_hosts
    return Mesh(devices.reshape(n_hosts, per_host), axis_names)


def frame_sharding(mesh):
    """Sharding placing the leading (frame/time) axis on the host axis."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P(mesh.axis_names[0]))


def pixel_row_sharding(mesh):
    """Sharding placing image rows on the intra-host device axis."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P(None, mesh.axis_names[1]))
