"""
Multi-device scaling: device meshes and sharded execution of the geometry
pipelines.

The reference is a single-process, single-thread library (SURVEY §2.4); its
implicit parallelism axes are pixels, map cells, cube wavelengths, and
ephemeris times. Here those become real sharding axes over a
``jax.sharding.Mesh``:

- ``px``: the pixel-row axis of backplane images (spatial parallelism).
  The geometry pass is embarrassingly parallel, so sharded execution needs
  no communication; XLA partitions the fused pipeline via GSPMD from the
  output sharding alone.
- ``data``: the frame/time axis of observation cubes and time batches
  (data parallelism). Reductions (e.g. the disc-fit loss) cross this axis
  with ``psum``, which XLA hands to the backend's collectives (NCCL
  between GPUs).

Use :func:`make_mesh` to build a mesh over the available devices and
:func:`sharded_backplanes` / :func:`planetmapper_tpu.parallel.fit` for the
sharded compute paths.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def make_mesh(n_devices: int | None = None, axis_names=('px',)):
    """
    Build a 1D (or reshaped) device mesh. With the default single axis the
    mesh spans all (or the first ``n_devices``) devices on the ``px`` axis.
    """
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    arr = np.array(devices)
    if len(axis_names) > 1:
        # Put all devices on the first axis by default
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
        arr = arr.reshape(shape)
    return Mesh(arr, axis_names)


#: jitted row-sharded programs, keyed by pipeline configuration, block
#: shape and mesh: a fresh jax.jit per call would re-trace every time
_SHARDED_CACHE: dict[tuple, Any] = {}


def _pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def sharded_backplanes(body, mesh=None) -> dict[str, Any]:
    """
    Compute all default backplanes with the pixel-row axis sharded across
    the mesh. The forward geometry pass is communication-free: each
    device runs the SAME per-pixel pipeline the single-device path uses
    (:func:`planetmapper_tpu.pipeline.select_pipeline_impl`) on its block
    of rows via ``shard_map``, offset to absolute row coordinates with
    ``row0 = axis_index * block``. Results are returned as
    globally-sharded arrays (an ``all_gather`` happens only if the
    caller converts to a single host array, mirroring the reference's
    backplane-assembly step in FITS export).
    """
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..pipeline import (
        _bucket_size,
        pipeline_config_key,
        select_pipeline_impl,
    )

    if mesh is None:
        mesh = make_mesh()
    axis = mesh.axis_names[0]
    n_shard = mesh.shape[axis]
    nx, ny = body.get_img_size()
    nx_b = _bucket_size(nx)
    ny_blk = -(-ny // n_shard)
    ny_padded = ny_blk * n_shard

    anchors = body._get_pipeline_anchors()

    key = (pipeline_config_key(body), nx_b, ny_blk, mesh)
    fn = _SHARDED_CACHE.get(key)
    if fn is None:
        impl = select_pipeline_impl(body)

        def block_fn(xy2angular, disc, radii, anchors):
            row0 = (jax.lax.axis_index(axis) * ny_blk).astype(jnp.float64)
            return impl(
                nx_b, ny_blk, xy2angular, disc, radii, anchors, row0=row0
            )

        fn = jax.jit(shard_map(
            block_fn, mesh=mesh,
            in_specs=(P(), P(), P(), P()),
            out_specs=P(axis, None),
        ))
        _SHARDED_CACHE[key] = fn

    args = (
        np.asarray(body._get_xy2angular_matrix()),
        np.asarray(body.get_disc_params(), dtype=np.float64),
        np.asarray(body.radii, dtype=np.float64),
        anchors,
    )
    out = fn(*args)
    if ny_padded != ny or nx_b != nx:
        out = {k: v[:ny, :nx] for k, v in out.items()}
    return out


def sharded_map_img(
    body, img, mesh=None, *, interpolation='linear',
    propagate_nan: bool = True, warn_nan: bool = False,
    as_numpy: bool = True, **map_kwargs,
):
    """
    Map-project an image with the MAP ROW axis sharded across the mesh.

    The reprojection is embarrassingly parallel over map cells: each
    device solves the (small, replicated) spline coefficient system for
    the frame and evaluates its block of map rows against it with the
    gather-free one-hot contraction - no collectives on the compute
    path. Matches :meth:`BodyXY.map_img` for the spline interpolation
    modes (``'linear'``/``'quadratic'``/``'cubic'`` or an
    ``(order_y, order_x)`` tuple, reference body_xy.py:1651-1702).

    Intended for large maps (e.g. 8192x4096 global mosaics) and cube
    streaming on multi-chip hosts; for single-chip use
    :meth:`BodyXY.map_img` directly.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..ops import interp_device as idev

    aliases = {'linear': 1, 'quadratic': 2, 'cubic': 3}
    if isinstance(interpolation, str):
        interpolation = aliases[interpolation]
    if isinstance(interpolation, int):
        kx = ky = interpolation
    else:
        ky, kx = interpolation  # reference tuple order: rows first

    if mesh is None:
        mesh = make_mesh()
    axis = mesh.axis_names[0]
    n_shard = mesh.shape[axis]

    x_map = np.asarray(body.get_x_map(**map_kwargs), dtype=np.float64)
    y_map = np.asarray(body.get_y_map(**map_kwargs), dtype=np.float64)
    my, mx = x_map.shape
    my_pad = _pad_to_multiple(my, n_shard)
    if my_pad != my:
        fill = np.full((my_pad - my, mx), np.nan)
        x_map = np.concatenate([x_map, fill], axis=0)
        y_map = np.concatenate([y_map, fill], axis=0)
    my_blk = my_pad // n_shard

    img = np.asarray(img, dtype=np.float64)
    ny_i, nx_i = img.shape
    ty, tx, ainv_y, ainv_x = idev._grid_spline_solver(ny_i, nx_i, kx, ky)
    eval_all = idev._make_onehot_eval(
        kx, ky, batched=False, propagate_nan=propagate_nan,
        out_shape=(my_blk, mx),
    )

    def block_fn(ty, tx, ay, ax, frame, y, x, valid):
        # replicated per-device: NaN infill + the two small collocation
        # matmuls (trivial next to the per-block evaluation)
        cleaned, nans = idev._infill_device(jnp, frame)
        c2 = jnp.matmul(
            ay,
            jnp.matmul(cleaned, ax.T, precision=lax.Precision.HIGHEST),
            precision=lax.Precision.HIGHEST,
        )
        return eval_all(
            ty, tx, c2.astype(jnp.float32), nans.astype(jnp.float32),
            y, x, valid,
        )

    fn = jax.jit(shard_map(
        block_fn, mesh=mesh,
        in_specs=(None, None, None, None, None, P(axis), P(axis),
                  P(axis)),
        out_specs=P(axis),
    ))
    valid = np.isfinite(x_map) & np.isfinite(y_map)
    out = fn(
        ty, tx, ainv_y, ainv_x, jnp.asarray(img),
        jnp.asarray(np.where(valid, y_map, 0.0).ravel()),
        jnp.asarray(np.where(valid, x_map, 0.0).ravel()),
        jnp.asarray(valid.ravel()),
    )
    out = out.reshape(my_pad, mx)[:my]
    if as_numpy:
        return np.asarray(out, dtype=np.float64)
    return out
