#!/usr/bin/env python3
"""
Scaling the geometry pipeline over a device mesh.

Demonstrates the three parallel axes (SURVEY.md §2.4):

- pixel rows sharded over devices (communication-free forward pass),
- ephemeris times batched/sharded (cube observations),
- gradient-descent disc fitting with a psum-reduced loss.

Runs on every device JAX finds (for example the four GPUs of one host),
or without accelerators on a virtual CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    JAX_PLATFORMS=cpu python examples/multi_device.py

Kernels: ``PLANETMAPPER_KERNEL_PATH`` if set, otherwise the seeded
synthetic kernel set generated into ``build/kernels``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import planetmapper_tpu as pm  # noqa: E402
from planetmapper_tpu.kernels.synthetic import ensure_kernel_set  # noqa: E402
from planetmapper_tpu.parallel import (  # noqa: E402
    backplane_time_series,
    make_mesh,
    sharded_backplanes,
    sharded_map_img,
)

if not os.environ.get('PLANETMAPPER_KERNEL_PATH'):
    pm.set_kernel_path(ensure_kernel_set())


def sharded_pixels():
    """Shard the pixel grid of one large frame across all devices."""
    mesh = make_mesh()
    print('mesh:', mesh)
    body = pm.BodyXY('Jupiter', observer='EARTH', utc='2005-01-01', sz=256)
    body.set_disc_params(128, 128, 100, 0)
    out = sharded_backplanes(body, mesh=mesh)
    print('sharded EMISSION shape:', out['EMISSION'].shape)


def sharded_map():
    """Reproject one frame onto a map with the row axis sharded."""
    body = pm.BodyXY('Jupiter', observer='EARTH', utc='2005-01-01', sz=64)
    body.set_disc_params(32, 32, 25, 0)
    img = np.random.default_rng(0).normal(size=(64, 64))
    mapped = sharded_map_img(
        body, img, make_mesh(), interpolation='cubic',
        projection='rectangular', degree_interval=2,
    )
    print('sharded map shape:', mapped.shape)


def sharded_times():
    """Shard a time batch across devices (one frame per device group)."""
    body = pm.BodyXY('Jupiter', observer='EARTH', utc='2005-01-01', sz=64)
    body.set_disc_params(32, 32, 25, 0)
    ets = body.et + 300.0 * np.arange(64)
    out = backplane_time_series(
        body, ets, names=['EMISSION'], mesh=make_mesh(axis_names=('data',))
    )
    print('time-sharded EMISSION shape:', out['EMISSION'].shape)


def multihost_note():
    """
    On several hosts, call
    ``planetmapper_tpu.parallel.initialize_distributed(...)`` first (or
    set ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``); ``make_multihost_mesh()`` then returns a
    host-spanning mesh where the time axis crosses hosts and the pixel
    axis stays on each host's devices.
    """
    print('devices:', jax.device_count(), 'processes:', jax.process_count())


if __name__ == '__main__':
    sharded_pixels()
    sharded_map()
    sharded_times()
    multihost_note()
