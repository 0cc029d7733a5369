"""
Gradient-based disc fitting: differentiable rendering + optimisation.

The reference fits the disc with threshold/centre-of-mass and annular
photometry heuristics (observation.py:762-823). Because this framework's
entire geometry pipeline is differentiable JAX, the disc parameters
``(x0, y0, r0, rotation)`` can instead be fit by gradient descent against
the observed image: a smooth differentiable disc render (sigmoid of the
ray-ellipsoid discriminant, optionally Lambert-shaded) is compared to the
normalised data and optimised with Adam. This is the framework's "training
step": loss and gradients are computed with the frame axis data-parallel
and the pixel-row axis spatially sharded across the device mesh, with the
loss reduction crossing shards (``psum`` under GSPMD).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np

from ..core import geometry as geom

DEG = math.pi / 180.0


def _disc_render_fn(anchors, target_diameter_arcsec: float, nx: int, ny: int):
    """
    Build a differentiable renderer ``render(params, radii) -> (ny, nx)``
    producing a smooth synthetic disc image from disc parameters
    ``params = (x0, y0, log_r0, rotation_rad)``.
    """
    import jax.numpy as jnp
    from jax import lax

    m_ang = anchors['obsvec2angular']
    tau0 = anchors['tau0']
    et = anchors['et']
    obs_pos = anchors['obs_pos']
    targ_rel0 = anchors['targ_pos0'] - obs_pos
    targ_vel0 = anchors['targ_vel0']
    rot0 = anchors['rot0']
    rot1 = anchors['rot1']

    def render(params, radii, sharpness=2.0):
        x0, y0, log_r0, rotation = params
        r0 = jnp.exp(log_r0)
        plate_scale = target_diameter_arcsec / (2.0 * r0)  # arcsec/px
        c = jnp.cos(-rotation)
        s = jnp.sin(-rotation)

        xg = lax.broadcasted_iota(jnp.float64, (ny, nx), 1)
        yg = lax.broadcasted_iota(jnp.float64, (ny, nx), 0)
        dx = xg - x0
        dy = yg - y0
        ang_x = plate_scale * (c * dx + s * dy)
        ang_y = plate_scale * (-s * dx + c * dy)

        vec = geom.radec_to_rect(
            jnp.ones_like(ang_x),
            -ang_x / 3600.0 * DEG,
            ang_y / 3600.0 * DEG,
        )
        d = vec @ m_ang

        # Single light-time pass is ample for a smooth fitting target
        dtau = (et - anchors['target_lt']) - tau0
        targ_rel = targ_rel0 + targ_vel0 * dtau
        rot = rot0 + rot1 * dtau
        o_bf = -(rot @ targ_rel)
        d_bf = jnp.einsum('ij,...j->...i', rot, d)

        # Impact parameter of the ray in spheroid-scaled space: the ray
        # hits the surface iff p < 1, and (1 - p) ~ (r_disc - r_px)/r_disc
        # so scaling by r0 gives a smooth pixel-space signed limb distance.
        o = o_bf / radii
        dd = d_bf / radii
        dd_norm = dd / jnp.linalg.norm(dd, axis=-1, keepdims=True)
        p = jnp.linalg.norm(jnp.cross(o, dd_norm), axis=-1)
        signed_px = (1.0 - p) * r0
        return 1.0 / (1.0 + jnp.exp(-signed_px * sharpness))

    return render


def make_training_step(
    body, data: np.ndarray, *, mesh=None, learning_rate: float = 0.05,
) -> tuple[Callable, Any, Any]:
    """
    Build the jitted, mesh-sharded disc-fit training step.

    Returns ``(step, params0, opt_state0)`` where
    ``step(params, opt_state, data) -> (params, opt_state, loss)`` performs
    one Adam update. ``data`` is a (nframes, ny, nx) cube: the frame axis is
    sharded data-parallel and the row axis spatially, so the loss mean is a
    cross-shard reduction (psum) over the mesh.
    """
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    data = np.asarray(data, dtype=np.float64)
    if data.ndim == 2:
        data = data[None]
    nf, ny, nx = data.shape

    anchors = body._get_pipeline_anchors()
    render = _disc_render_fn(anchors, body.target_diameter_arcsec, nx, ny)
    radii = np.asarray(body.radii, dtype=np.float64)

    # Normalise data to [0, 1] for comparison with the smooth disc render
    finite = np.isfinite(data)
    lo = np.percentile(data[finite], 5) if finite.any() else 0.0
    hi = np.percentile(data[finite], 95) if finite.any() else 1.0
    data_norm = np.clip(
        np.nan_to_num((data - lo) / max(hi - lo, 1e-12), nan=0.0), 0.0, 1.0
    )

    optimizer = optax.adam(learning_rate)

    def loss_fn(params, batch):
        model = render(params, radii)
        err = (model[None, :, :] - batch) ** 2
        return jnp.mean(err)

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    params0 = jnp.array(
        [
            body.get_x0(),
            body.get_y0(),
            float(np.log(body.get_r0())),
            float(np.deg2rad(body.get_rotation())),
        ],
        dtype=jnp.float64,
    )
    opt_state0 = optimizer.init(params0)

    if mesh is not None:
        data_axis, px_axis = (
            (mesh.axis_names[0], mesh.axis_names[1])
            if len(mesh.axis_names) > 1
            else (mesh.axis_names[0], None)
        )
        batch_sharding = NamedSharding(mesh, P(data_axis, px_axis, None))
        replicated = NamedSharding(mesh, P())
        step = jax.jit(
            step,
            in_shardings=(replicated, replicated, batch_sharding),
            out_shardings=(replicated, replicated, replicated),
        )
        data_norm = jax.device_put(data_norm, batch_sharding)
    else:
        step = jax.jit(step)

    def run_step(params, opt_state, batch=None):
        if batch is None:
            batch = data_norm
        return step(params, opt_state, batch)

    run_step.data = data_norm  # type: ignore[attr-defined]
    return run_step, params0, opt_state0


def fit_disc_gradient(
    body, data: np.ndarray | None = None, *, n_steps: int = 150,
    learning_rate: float = 0.05, mesh=None, set_params: bool = True,
) -> tuple[float, float, float, float]:
    """
    Fit the disc parameters by gradient descent on a differentiable disc
    render. For :class:`Observation` instances ``data`` defaults to the
    summed observed cube. Returns the fitted ``(x0, y0, r0, rotation)`` and
    (by default) applies them to the body.
    """
    if data is None:
        data = np.nansum(body.data, axis=0)
    step, params, opt_state = make_training_step(
        body, np.asarray(data), mesh=mesh, learning_rate=learning_rate
    )
    loss = None
    for _ in range(n_steps):
        params, opt_state, loss = step(params, opt_state)
    x0, y0, log_r0, rotation = (float(v) for v in np.asarray(params))
    r0 = float(np.exp(log_r0))
    rotation_deg = float(np.rad2deg(rotation) % 360.0)
    if set_params:
        body.set_disc_params(x0, y0, r0, rotation_deg)
        body.set_disc_method('fit_gradient')
    del loss
    return x0, y0, r0, rotation_deg
