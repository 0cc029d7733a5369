"""
Batched ephemeris-time evaluation: backplanes for many observation epochs
in one vmapped device program (the "JWST IFU cube" use case - per-frame or
per-wavelength observation times).

The reference creates one ``Body`` object per time and loops the scalar
pipeline (SURVEY §2.4); here the per-time scene anchors are computed with
the shared jitted engine programs (one compile, reused across all epochs)
and the fused backplane pipeline is vmapped over the stacked anchors -
optionally sharded over the mesh 'data' axis for multi-chip scaling.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np


def backplane_time_series(
    body,
    times: Iterable,
    names: Sequence[str] | None = None,
    *,
    mesh=None,
    as_numpy: bool = True,
) -> dict[str, Any]:
    """
    Compute backplane images for a sequence of observation times.

    Args:
        body: Template :class:`BodyXY` (or Observation): target/observer
            configuration, image size and disc parameters are taken from it.
        times: Sequence of UTC strings / datetimes / MJD floats, or float
            TDB seconds (``et`` values).
        names: Backplane names to return (default: all default backplanes).
        mesh: Optional :func:`planetmapper_tpu.parallel.make_mesh` mesh; the
            time axis is sharded across its first axis.
        as_numpy: Fetch results to host numpy (default). Pass False to
            keep the cube device-resident: the device->host copy of a
            large cube can dwarf the compute, so pipelines that keep
            consuming on device (mapping, reductions) should leave it
            there.

    Returns:
        Dict of ``(n_times, ny, nx)`` arrays keyed by backplane name.
    """
    import jax
    import jax.numpy as jnp

    from ..pipeline import (
        DEFAULT_PRECISION,
        _robust_geodetic,
        fused_backplanes_fn,
    )

    nx, ny = body.get_img_size()
    if nx <= 0 or ny <= 0:
        raise ValueError('Template body must have a valid image size')

    ets = _ets_from_times(body, times)
    anchors, xy2angular = _batched_pipeline_inputs(body, ets)
    n_times = len(ets)
    anchors = jax.device_put(anchors)
    xy2angular = jax.device_put(xy2angular)
    disc = np.asarray(body.get_disc_params(), dtype=np.float64)
    radii = np.asarray(body.radii, dtype=np.float64)

    wanted = (
        None
        if names is None
        else tuple(sorted(body.standardise_backplane_name(n) for n in names))
    )
    precision = getattr(body, '_pipeline_precision', DEFAULT_PRECISION)
    key = (
        body.target_body_id, body._observer_body_id,
        body.aberration_correction, body.positive_longitude_direction,
        body.prograde, body._engine._pos_s is not None,
        bool(body._optimize_speed), nx, ny, n_times, precision,
        wanted, None if mesh is None else tuple(mesh.axis_names),
    )
    batched = _BATCHED_CACHE.get(key)
    if batched is None:
        impl = fused_backplanes_fn(
            positive_west=body.positive_longitude_direction == 'W',
            prograde=body.prograde,
            have_sun=body._engine._pos_s is not None,
            optimize_speed=bool(body._optimize_speed),
            precision=precision,
            robust_geodetic=_robust_geodetic(body),
        )

        def single(xy2ang_t, anchors_t, disc, radii):
            out = impl(nx, ny, xy2ang_t, disc, radii, anchors_t)
            if wanted is not None:
                # Selecting at trace time lets XLA drop unused planes
                out = {k: out[k] for k in wanted}
            return out

        batched = jax.vmap(single, in_axes=(0, 0, None, None))
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            batched = jax.jit(
                batched,
                out_shardings=NamedSharding(
                    mesh, P(mesh.axis_names[0], None, None)
                ),
            )
        else:
            batched = jax.jit(batched)
        _BATCHED_CACHE[key] = batched

    out = batched(xy2angular, anchors, disc, radii)
    if as_numpy:
        return jax.device_get(out)
    return out


_BATCHED_CACHE: dict = {}


def _ets_from_times(body, times) -> np.ndarray:
    """Normalise mixed time inputs (et floats / UTC strings / MJD) to et."""
    from ..core.time import utc_string_to_et

    lsk = body._lsk()
    ets = []
    for t in times:
        if isinstance(t, (int, float)) and abs(float(t)) > 1e6:
            ets.append(float(t))  # TDB seconds past J2000
        else:
            # UTC strings / datetimes / MJD floats, like Body(utc=...)
            utc = body._standardise_utc_to_string(t)
            ets.append(utc_string_to_et(utc, lsk))
    return np.asarray(ets, dtype=np.float64)


def _batched_pipeline_inputs(body, ets: np.ndarray):
    """
    All per-time fused-pipeline anchors and camera matrices from ONE
    jitted, vmapped device program (the "vmapped SPK eval" path): no
    per-time Body construction, so a 1000-frame cube batch costs
    milliseconds per frame instead of the ~50 ms of host round trips a
    Body takes to build.

    Verified against the per-Body path in tests/test_parallel.py.
    """
    import jax
    import jax.numpy as jnp

    from ..core import geometry as geom
    from ..core.ephemeris import CLIGHT
    from ..core.frames import _rotmat_jnp
    from ..core.scene import _host_device

    engine = body._engine
    radii = np.asarray(body.radii, dtype=np.float64)
    disc = np.asarray(body.get_disc_params(), dtype=np.float64)

    def per_time(et, disc, radii):
        x0, y0, r0, rotation_deg = disc
        r_eq = radii[0]
        scene = engine._scene_constants_impl(et, radii)
        tau0 = scene['subpoint_et']
        target_lt = scene['target_lt']

        rot_fn = engine.frame_model.j2000_to_bodyfixed_matrix
        rot0 = rot_fn(tau0)
        rot1 = jax.jacfwd(rot_fn)(tau0)
        rot2 = jax.jacfwd(jax.jacfwd(rot_fn))(tau0)
        targ_state = engine._pos_t(tau0)
        obs_state = engine._pos_o(et)
        if engine._pos_s is not None:
            lt_s = jnp.zeros_like(tau0)
            for _ in range(4):
                sun_state = engine._pos_s(tau0 - lt_s)
                lt_s = jnp.linalg.norm(
                    sun_state[..., :3] - targ_state[..., :3], axis=-1
                ) / CLIGHT
            sun_epoch = tau0 - lt_s
            sun_state = engine._pos_s(sun_epoch)
        else:
            sun_epoch = tau0
            sun_state = jnp.full(6, jnp.nan, dtype=jnp.float64)
        solar_lon = engine.solar_longitude(et - target_lt)

        # Camera: obsvec->angular matrix centred on the apparent target
        # (Body._get_obsvec2angular_matrix equivalent, in-graph)
        t_obsvec = scene['target_obsvec']
        t_norm = t_obsvec / jnp.linalg.norm(t_obsvec)
        _r1, ra_angle, _d1 = geom.rect_to_radec(t_norm)
        m_ra = _rotmat_jnp(jnp, ra_angle, 3)
        _r2, _a2, dec_angle = geom.rect_to_radec(m_ra @ t_norm)
        m_ang = _rotmat_jnp(jnp, -dec_angle, 2) @ m_ra

        def obsvec2angular(v):
            vec = m_ang @ v
            _rr, xr, yr = geom.rect_to_radec(vec)
            x = jnp.mod(-jnp.rad2deg(xr), 360.0)
            x = jnp.where(x > 180.0, x - 360.0, x)
            return x * 3600.0, jnp.rad2deg(yr) * 3600.0

        target_distance = target_lt * CLIGHT
        diameter_as = (
            2.0 * 3600.0 * jnp.rad2deg(jnp.arcsin(r_eq / target_distance))
        )
        km_per_arcsec = 2.0 * r_eq / diameter_as

        # North pole angle (Body.north_pole_angle equivalent, in-graph)
        np_targvec = jnp.array([0.0, 0.0, 1.0]) * radii[2]
        np_obsvec = engine._targvec2obsvec_core(np_targvec, scene)
        np_x, np_y = obsvec2angular(
            np_obsvec / jnp.linalg.norm(np_obsvec)
        )
        t_x, t_y = obsvec2angular(t_norm)
        theta = -jnp.arctan2(t_x - np_x, np_y - t_y)

        # angular->km and xy->angular affines (body_xy equivalents).
        # NOTE the rotation convention: SpiceBase._rotation_matrix_radians
        # is [[cos, sin], [-sin, cos]] (SPICE 'rotate'), NOT the usual
        # counterclockwise matrix
        c_t = jnp.cos(theta)
        s_t = jnp.sin(theta)
        km2angular = jnp.array(
            [[c_t, s_t], [-s_t, c_t]]
        ) / km_per_arcsec
        angular2km = km2angular.T * (km_per_arcsec * km_per_arcsec)

        plate_scale = diameter_as / (2.0 * r0)
        rot_rad = -jnp.deg2rad(rotation_deg)
        c_r = jnp.cos(rot_rad)
        s_r = jnp.sin(rot_rad)
        m2 = plate_scale * jnp.array([[c_r, s_r], [-s_r, c_r]])
        offset = -m2 @ jnp.array([x0, y0])
        xy2angular = jnp.concatenate(
            [
                jnp.concatenate([m2, offset[:, None]], axis=1),
                jnp.array([[0.0, 0.0, 1.0]]),
            ],
            axis=0,
        )

        anchors = dict(
            et=et,
            tau0=tau0,
            rot0=rot0, rot1=rot1, rot2=rot2,
            targ_pos0=targ_state[..., :3],
            targ_vel0=targ_state[..., 3:],
            obs_pos=obs_state[..., :3],
            obs_vel=obs_state[..., 3:],
            sun_pos0=sun_state[..., :3],
            sun_vel0=sun_state[..., 3:],
            sun_epoch0=sun_epoch,
            target_lt=target_lt,
            target_obsvec=t_obsvec,
            subpoint_targvec=scene['subpoint_targvec'],
            subpoint_rayvec=scene['subpoint_rayvec'],
            subpoint_obsvec=scene['subpoint_obsvec'],
            subpoint_distance=scene['subpoint_distance'],
            ring_plane_normal=scene['ring_plane_normal'],
            ring_plane_constant=scene['ring_plane_constant'],
            solar_lon_e=solar_lon,
            obsvec2angular=m_ang,
            angular2km=angular2km,
        )
        return anchors, xy2angular

    fn = getattr(engine, '_batched_inputs_jit', None)
    if fn is None:
        fn = jax.jit(jax.vmap(per_time, in_axes=(0, None, None)))
        engine._batched_inputs_jit = fn
    with _host_device():
        anchors, xy2angular = jax.device_get(
            fn(jnp.asarray(ets), jnp.asarray(disc), jnp.asarray(radii))
        )
    return anchors, xy2angular


def _body_at_time(body, t):
    if isinstance(t, (int, float)) and abs(float(t)) > 1e6:
        # Treat large floats as TDB seconds past J2000 (et); reference-style
        # MJD floats are far smaller
        from ..core.time import et_to_utc_string

        t = et_to_utc_string(float(t), body._lsk())
    new = body.replace(utc=t) if not _same_time(body, t) else body
    if hasattr(new, 'set_disc_params'):
        try:
            new.set_disc_params(*body.get_disc_params())
        except Exception:
            pass
    return new


def _same_time(body, t) -> bool:
    return isinstance(t, str) and t == body.utc
