"""
Fused backplane pipeline: every default backplane computed in ONE jitted
XLA program over the full pixel grid.

This is the performance core of the framework - the accelerator redesign of
the reference's hot path (body_xy.py:3195-3225: two scalar CSPICE calls per
on-disc pixel, ~10 s for a 500x500 frame). Design:

- **Anchor + derivative linearisation**: per-pixel light-time retargeting
  needs the target position, sun position and frame rotation at a slightly
  different epoch for every pixel (spread ~ +/- r/c ~ 0.25 s). Instead of
  evaluating Chebyshev series and IAU Euler-angle trigonometry per pixel,
  the scene anchors (positions, velocities, rotation matrix and its first
  two time derivatives at the sub-observer epoch) are computed once on the
  host, and per-pixel values come from Taylor expansion. The truncation
  errors are ~1e-9 rad in orientation and sub-metre in position - orders of
  magnitude below the sub-millidegree requirement, and validated against
  the exact per-plane pipeline in the test suite.
- **Everything fused**: the ray generation, ellipsoid intercepts, geodetic
  conversions, illumination angles, states, limb and ring-plane coordinates
  share intermediates inside one XLA computation, so device-memory
  traffic is a handful of (ny, nx) arrays instead of dozens of kernel
  round trips.
- **Shape-stable jit**: disc parameters, time and radii are traced inputs;
  one compilation serves every disc fit iteration and observation epoch of
  a configuration.

The pipeline is differentiable end-to-end (JAX), which also enables
gradient-based disc fitting (see :mod:`planetmapper_tpu.parallel.fit`).
"""

from __future__ import annotations

import math
import os
from typing import Any

import numpy as np

from .core.ephemeris import CLIGHT
from .core import geometry as geom

DEG = math.pi / 180.0

#: Default numeric mode for the fused pipeline: ``'double'``, the
#: straightforward float64 pipeline, which matches the exact per-plane
#: getters to ~1e-7 deg at every frame size. ``'mixed'`` (selected with
#: ``PLANETMAPPER_TPU_PRECISION=mixed``) runs the per-pixel inner math in
#: float32 on recentred coordinates with float64 polishes - written for an
#: accelerator without float64. Its f32 light-time fixed point
#: under-converges on rays that graze the limb (within ~1 km): at 2048^2
#: a few such pixels miss the 5e-5 deg budget by up to ~3e-4 deg.
DEFAULT_PRECISION = os.environ.get('PLANETMAPPER_TPU_PRECISION', 'double')


def _anchor_core_fn(engine):
    """
    Jitted device program computing the time-dependent anchor values in
    ONE dispatch (instead of many eager jacfwd/fixed-point dispatches).
    Cached per engine; batched epochs vmap cleanly.
    """
    import jax
    import jax.numpy as jnp

    def core(et, tau0, target_lt):
        rot_fn = engine.frame_model.j2000_to_bodyfixed_matrix
        r0 = rot_fn(tau0)
        r1 = jax.jacfwd(rot_fn)(tau0)
        r2 = jax.jacfwd(jax.jacfwd(rot_fn))(tau0)
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
            sun_state = jnp.full(
                jnp.shape(tau0) + (6,), jnp.nan, dtype=jnp.float64
            )
        solar_lon = engine.solar_longitude(et - target_lt)
        return dict(
            rot0=r0, rot1=r1, rot2=r2,
            targ_state=targ_state, obs_state=obs_state,
            sun_state=sun_state, sun_epoch=sun_epoch, solar_lon=solar_lon,
        )

    return jax.jit(core)


def _get_anchor_core(engine):
    fn = getattr(engine, '_anchor_core_jit', None)
    if fn is None:
        fn = _anchor_core_fn(engine)
        engine._anchor_core_jit = fn
    return fn


def compute_scene_anchors(body) -> dict[str, np.ndarray]:
    """
    Host-side anchor computation for a Body's scene: positions/velocities
    and frame rotation derivatives at the sub-observer epoch. One-time cost
    per (body, time); all values become device constants for the pipeline.
    """
    import jax

    from .core.scene import _host_device

    engine = body._engine
    et = body.et
    tau0 = body._subpoint_et

    with _host_device():
        # Scalar program + a dict of small outputs: the host CPU avoids a
        # device round trip per fetched leaf
        core = jax.device_get(
            _get_anchor_core(engine)(
                np.float64(et), np.float64(tau0),
                np.float64(body.target_light_time),
            )
        )
    targ_state = core['targ_state']
    obs_state = core['obs_state']
    sun_state = core['sun_state']

    sub = body._sub_consts()
    anchors = dict(
        et=np.float64(et),
        tau0=np.float64(tau0),
        rot0=np.asarray(core['rot0']),
        rot1=np.asarray(core['rot1']),
        rot2=np.asarray(core['rot2']),
        targ_pos0=targ_state[..., :3],  # target SSB position at tau0
        targ_vel0=targ_state[..., 3:],
        obs_pos=obs_state[..., :3],  # observer SSB position at et
        obs_vel=obs_state[..., 3:],
        sun_pos0=sun_state[..., :3],
        sun_vel0=sun_state[..., 3:],
        sun_epoch0=np.float64(core['sun_epoch']),
        target_lt=np.float64(body.target_light_time),
        target_obsvec=np.asarray(body._target_obsvec),
        subpoint_targvec=np.asarray(sub['subpoint_targvec']),
        subpoint_rayvec=np.asarray(sub['subpoint_rayvec']),
        subpoint_obsvec=np.asarray(sub['subpoint_obsvec']),
        subpoint_distance=np.float64(sub['subpoint_distance']),
        ring_plane_normal=np.asarray(body._ring_plane[0]),
        ring_plane_constant=np.float64(body._ring_plane[1]),
        solar_lon_e=np.float64(core['solar_lon']),
        obsvec2angular=np.asarray(body._get_obsvec2angular_matrix()),
        angular2km=np.asarray(body._get_angular2km_matrix()),
    )
    return anchors


def _anchor_abstract_spec():
    """
    ShapeDtypeStruct tree matching :func:`compute_scene_anchors`'s
    output exactly (keys, shapes, dtypes). Lets the fused pipeline be
    AOT-compiled before any anchor VALUES exist, overlapping the
    pipeline compile with the scene-anchor computation on cold start.
    Pinned against the real tree by a unit test; drift is safe (the
    AOT call raises and the jit path re-traces) but wastes the warmup.
    """
    import jax
    import jax.numpy as jnp

    s = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float64)
    return dict(
        et=s(), tau0=s(),
        rot0=s(3, 3), rot1=s(3, 3), rot2=s(3, 3),
        targ_pos0=s(3), targ_vel0=s(3),
        obs_pos=s(3), obs_vel=s(3),
        sun_pos0=s(3), sun_vel0=s(3), sun_epoch0=s(),
        target_lt=s(), target_obsvec=s(3),
        subpoint_targvec=s(3), subpoint_rayvec=s(3),
        subpoint_obsvec=s(3), subpoint_distance=s(),
        ring_plane_normal=s(3), ring_plane_constant=s(),
        solar_lon_e=s(),
        obsvec2angular=s(3, 3), angular2km=s(2, 2),
    )


def _rot_at(anchors, dtau):
    """Frame rotation J2000->body-fixed at tau0 + dtau (2nd order Taylor)."""
    return (
        anchors['rot0']
        + anchors['rot1'] * dtau[..., None, None]
        + 0.5 * anchors['rot2'] * dtau[..., None, None] ** 2
    )


def _rot_dot_at(anchors, dtau):
    return anchors['rot1'] + anchors['rot2'] * dtau[..., None, None]


def _matvec(m, v):
    import jax.numpy as jnp
    from jax import lax

    # precision=HIGHEST: an accelerator's *default* f32 dot precision may
    # contract in bfloat16 or TF32 (~1e-3 relative), which silently
    # corrupts the f32 rotation corrections; HIGHEST keeps true f32 (f64
    # inputs are unaffected either way)
    return jnp.einsum(
        '...ij,...j->...i', m, v, precision=lax.Precision.HIGHEST
    )


def _const_matvec(m, v):
    """
    (3,3) constant matrix times (..., 3) vectors as explicit FMA chains:
    spelled-out mul/adds fuse into the surrounding elementwise graph
    instead of becoming a separate tiny matmul.
    """
    import jax.numpy as jnp

    return jnp.stack(
        [
            m[0, 0] * v[..., 0] + m[0, 1] * v[..., 1] + m[0, 2] * v[..., 2],
            m[1, 0] * v[..., 0] + m[1, 1] * v[..., 1] + m[1, 2] * v[..., 2],
            m[2, 0] * v[..., 0] + m[2, 1] * v[..., 1] + m[2, 2] * v[..., 2],
        ],
        axis=-1,
    )


def _mm33(a, b):
    """
    (3,3) @ (3,3) as explicit scalar mul/adds. The band ``lax.map``
    re-executes scene-constant products per band (XLA does not hoist
    loop-invariant calls out of the while body); unrolled they fuse into
    the elementwise graph instead of being separate tiny matmuls.
    """
    import jax.numpy as jnp

    return jnp.stack(
        [
            jnp.stack(
                [
                    a[i, 0] * b[0, j] + a[i, 1] * b[1, j]
                    + a[i, 2] * b[2, j]
                    for j in range(3)
                ]
            )
            for i in range(3)
        ]
    )


def _mv3(m, v):
    """(3,3) @ (3,) unrolled; see :func:`_mm33` for why."""
    import jax.numpy as jnp

    return jnp.stack(
        [
            m[i, 0] * v[0] + m[i, 1] * v[1] + m[i, 2] * v[2]
            for i in range(3)
        ]
    )


def _vdot3(a, b):
    """(3,) . (3,) unrolled; see :func:`_mm33` for why."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def pick_ds():
    """
    Select the extended-precision backend for the pipeline's cancelling
    chains: native float64 with the double-single call surface
    (:mod:`.ops.ds64`) on every backend. Genuine double-single f32-pair
    arithmetic (:mod:`.ops.ds`) is kept for platforms without native
    float64 and selected with ``PLANETMAPPER_TPU_DS=ds``. On native-f64
    XLA backends it is not only pointless but unsafe: excess-precision
    and fast-math passes may evaluate f32 chains with f64 intermediates
    or reassociate them, nulling the error-free transformation terms.
    """
    from .ops import ds, ds64

    return ds if os.environ.get('PLANETMAPPER_TPU_DS', '') == 'ds' else ds64


def _ds_dot3(ds, a, b):
    """Dot of two ds 3-vectors (length-3 lists of (hi, lo) pairs)."""
    return ds.add(
        ds.add(ds.mul(a[0], b[0]), ds.mul(a[1], b[1])),
        ds.mul(a[2], b[2]),
    )


def _ds_split3(ds, v):
    """(..., 3) f64 field -> list of 3 per-component ds pairs."""
    return [ds.from_f64(v[..., i]) for i in range(3)]


def rect_to_geodetic_surface(v, re, f, n_iter: int = 1):
    """
    Geodetic conversion for points on (or very near) the spheroid surface.

    For a point exactly on the spheroid the geodetic latitude is closed
    form - it is the direction of the surface normal ``(x/a^2, y/a^2,
    z/b^2)`` - so ``lat = arctan2(z, rho (1-f)^2)`` with no iteration. One
    Bowring iteration absorbs the tiny off-surface offsets that occur for
    triaxial bodies (where the intercept ellipsoid differs from the
    biaxial spheroid used for planetographic coordinates). Far cheaper
    than the exact bisection solve in :func:`geometry.rect_to_geodetic`
    (the general-purpose path, valid deep inside the body).
    """
    import jax.numpy as jnp

    x = v[..., 0]
    y = v[..., 1]
    z = v[..., 2]
    rp = re * (1.0 - f)
    e2 = f * (2.0 - f)
    ep2 = e2 / (1.0 - e2)
    lon = jnp.arctan2(y, x)
    rho = jnp.hypot(x, y)
    omf2 = (1.0 - f) * (1.0 - f)
    lat = jnp.arctan2(z, rho * omf2)  # exact for on-surface points
    for _ in range(n_iter):
        beta = jnp.arctan2((1.0 - f) * jnp.sin(lat), jnp.cos(lat))
        sb = jnp.sin(beta)
        cb = jnp.cos(beta)
        lat = jnp.arctan2(z + ep2 * rp * sb**3, rho - e2 * re * cb**3)
    sin_lat = jnp.sin(lat)
    cos_lat = jnp.cos(lat)
    n = re / jnp.sqrt(1.0 - e2 * sin_lat * sin_lat)
    alt = rho * cos_lat + z * sin_lat - n * (1.0 - e2 * sin_lat * sin_lat)
    return lon, lat, alt


def fused_backplanes_fn(
    *, positive_west: bool, prograde: bool, have_sun: bool,
    optimize_speed: bool = True, precision: str = 'double',
    robust_geodetic: bool = False,
):
    """
    Build the traced implementation computing all default backplanes.
    Returns ``impl(params, xy2angular, disc, radii, anchors)`` where
    ``params['nx']/['ny']`` are static grid dimensions baked at trace time
    via closure; call through :func:`get_fused_pipeline` which jits and
    caches per static configuration.

    ``precision='double'`` is the straightforward all-float64 pipeline;
    ``'mixed'`` is the mixed-precision variant (see :func:`_mixed_impl_fn`).

    ``robust_geodetic``: the fast on-surface geodetic conversions assume
    the intercept point lies on the biaxial (re, rp) spheroid. For
    TRIAXIAL bodies (middle axis != re, e.g. Amalthea) the point can sit
    deep inside that spheroid where Bowring-style iterations diverge -
    set True (``get_fused_pipeline`` does this automatically from the
    radii) to use the exact nearest-point bisection solve instead.
    """
    if precision == 'mixed':
        return _mixed_impl_fn(
            positive_west=positive_west, prograde=prograde,
            have_sun=have_sun, optimize_speed=optimize_speed,
            robust_geodetic=robust_geodetic,
        )
    if precision != 'double':
        raise ValueError(f'unknown pipeline precision {precision!r}')

    import jax.numpy as jnp
    from jax import lax

    def impl(nx, ny, xy2angular, disc, radii, anchors, row0=0.0):
        et = anchors['et']
        tau0 = anchors['tau0']
        re = radii[0]
        rp = radii[2]
        flattening = (re - rp) / re
        lon_sign = -1.0 if positive_west else 1.0

        # -- pixel grid -> angular -> obsvec_norm rays ---------------------
        xg = lax.broadcasted_iota(jnp.float64, (ny, nx), 1)
        yg = lax.broadcasted_iota(jnp.float64, (ny, nx), 0) + row0
        ang_x = (
            xy2angular[0, 0] * xg + xy2angular[0, 1] * yg + xy2angular[0, 2]
        )
        ang_y = (
            xy2angular[1, 0] * xg + xy2angular[1, 1] * yg + xy2angular[1, 2]
        )
        m_ang = anchors['obsvec2angular']
        vec = geom.radec_to_rect(
            jnp.ones_like(ang_x),
            -ang_x / 3600.0 * DEG,
            ang_y / 3600.0 * DEG,
        )
        d = vec @ m_ang  # (ny, nx, 3) unit rays in J2000 (obsvec frame)

        # -- ray-ellipsoid intercept with linearised retargeting -----------
        obs_pos = anchors['obs_pos']
        targ_rel0 = anchors['targ_pos0'] - obs_pos  # target centre at tau0
        targ_vel0 = anchors['targ_vel0']
        lt = jnp.full((ny, nx), anchors['target_lt'])
        spoint = None
        found = None
        s = None
        for _ in range(4):
            tau = et - lt
            dtau = tau - tau0
            targ_rel = targ_rel0 + targ_vel0 * dtau[..., None]
            rot = _rot_at(anchors, dtau)
            o_bf = -_matvec(rot, targ_rel)
            d_bf = _matvec(rot, d)
            s, found = geom.ray_ellipsoid_intercept(o_bf, d_bf, radii)
            spoint = o_bf + s[..., None] * d_bf
            dist = jnp.where(found, s, anchors['target_lt'] * CLIGHT)
            lt = dist / CLIGHT
        tau = et - lt
        dtau = tau - tau0
        spoint = jnp.where(found[..., None], spoint, jnp.nan)

        if optimize_speed:
            # Behaviour parity with the reference's off-disc short circuit
            x0 = disc[0]
            y0 = disc[1]
            r0 = disc[2]
            r_cutoff = r0 * jnp.max(radii) / re * 1.05 + 1.0
            r2_px = (xg - x0) ** 2 + (yg - y0) ** 2
            off = r2_px > r_cutoff**2
            spoint = jnp.where(off[..., None], jnp.nan, spoint)
            found = found & ~off

        out: dict[str, Any] = {}

        # -- lon/lat (graphic + centric) -----------------------------------
        if robust_geodetic:
            lon_e, lat_gd, _alt = geom.rect_to_geodetic(
                spoint, re, flattening
            )
        else:
            lon_e, lat_gd, _alt = rect_to_geodetic_surface(
                spoint, re, flattening
            )
        lon_graphic = jnp.mod(lon_sign * lon_e / DEG, 360.0)
        out['LON-GRAPHIC'] = jnp.where(found, lon_graphic, jnp.nan)
        out['LAT-GRAPHIC'] = jnp.where(found, lat_gd / DEG, jnp.nan)
        _r, lon_c, lat_c = geom.rect_to_latlon_centric(spoint)
        out['LON-CENTRIC'] = jnp.where(found, lon_c / DEG, jnp.nan)
        out['LAT-CENTRIC'] = jnp.where(found, lat_c / DEG, jnp.nan)

        # -- RA/Dec --------------------------------------------------------
        _rr, ra, dec = geom.rect_to_radec(d)
        out['RA'] = ra / DEG
        out['DEC'] = dec / DEG

        # -- pixel coords --------------------------------------------------
        out['PIXEL-X'] = xg
        out['PIXEL-Y'] = yg

        # -- km / angular target plane coords ------------------------------
        m2 = anchors['angular2km']
        km_x = m2[0, 0] * ang_x + m2[0, 1] * ang_y
        km_y = m2[1, 0] * ang_x + m2[1, 1] * ang_y
        out['KM-X'] = km_x
        out['KM-Y'] = km_y
        # ANGULAR backplanes are the KM coordinates scaled to arcsec (same
        # origin/rotation as KM, not the raw camera angular coordinates) -
        # matching the reference (body_xy.py:3610-3656)
        km_per_arcsec = 2.0 * re / (
            2.0 * 60.0 * 60.0 / DEG * jnp.arcsin(
                re / (anchors['target_lt'] * CLIGHT)
            )
        )
        out['ANGULAR-X'] = km_x / km_per_arcsec
        out['ANGULAR-Y'] = km_y / km_per_arcsec

        # -- illumination (phase/incidence/emission + visibl/lit) ----------
        rot_tau = _rot_at(anchors, dtau)
        m_bf2j = jnp.swapaxes(rot_tau, -1, -2)
        srfvec_j2000 = targ_rel0 + targ_vel0 * dtau[..., None] + _matvec(
            m_bf2j, spoint
        )
        srfvec_bf = _matvec(rot_tau, srfvec_j2000)
        if have_sun:
            point_ssb = (
                anchors['targ_pos0'] + targ_vel0 * dtau[..., None]
                + _matvec(m_bf2j, spoint)
            )
            # Apparent sun: anchor epoch already includes the mean light
            # time; refine per-pixel with the linearised sun state
            lt_s = jnp.linalg.norm(
                anchors['sun_pos0'] - point_ssb, axis=-1
            ) / CLIGHT
            sun_dtau = (tau - lt_s) - anchors['sun_epoch0']
            sun_pos = anchors['sun_pos0'] + anchors['sun_vel0'] * (
                sun_dtau[..., None]
            )
            sun_dir_j2000 = sun_pos - point_ssb
            sun_bf = _matvec(rot_tau, sun_dir_j2000)
        else:
            sun_bf = jnp.full_like(spoint, jnp.nan)

        normal = geom.surface_normal(spoint, radii)
        phase = geom.vector_separation(sun_bf, -srfvec_bf) / DEG
        incidence = geom.vector_separation(normal, sun_bf) / DEG
        emission = geom.vector_separation(normal, -srfvec_bf) / DEG
        out['PHASE'] = phase
        out['INCIDENCE'] = incidence
        out['EMISSION'] = emission

        # -- azimuth -------------------------------------------------------
        cp = jnp.cos(phase * DEG)
        ce = jnp.cos(emission * DEG)
        ci = jnp.cos(incidence * DEG)
        azimuth = (
            jnp.pi - jnp.arccos(
                jnp.clip(
                    (cp - ce * ci)
                    / (jnp.sqrt(1 - ce * ce) * jnp.sqrt(1 - ci * ci)),
                    -1.0, 1.0,
                )
            )
        ) / DEG
        out['AZIMUTH'] = azimuth

        # -- local solar time ---------------------------------------------
        spin_sign = 1.0 if prograde else -1.0
        lst = jnp.mod(
            12.0 + spin_sign * (lon_e - anchors['solar_lon_e']) * 12.0 / jnp.pi,
            24.0,
        )
        from .body import lst_quantization_enabled

        if lst_quantization_enabled():
            lst = jnp.floor(lst * 3600.0) / 3600.0
        out['LOCAL-SOLAR-TIME'] = jnp.where(found, lst, jnp.nan)

        # -- state: distance / radial velocity / doppler -------------------
        dist_surface = jnp.where(found, lt * CLIGHT, jnp.nan)
        out['DISTANCE'] = dist_surface
        rot_dot = _rot_dot_at(anchors, dtau)
        m_bf2j_dot = jnp.swapaxes(rot_dot, -1, -2)
        p_vel = targ_vel0 + _matvec(m_bf2j_dot, spoint)  # point SSB velocity
        rel = srfvec_j2000
        rhat = rel / jnp.linalg.norm(rel, axis=-1, keepdims=True)
        obs_vel = anchors['obs_vel']
        rv_t = jnp.sum(rhat * p_vel, axis=-1)
        rv_o = jnp.sum(rhat * obs_vel, axis=-1)
        dltdt = (rv_t - rv_o) / (CLIGHT + rv_t)
        vel = p_vel * (1.0 - dltdt)[..., None] - obs_vel
        radial_velocity = jnp.where(
            found, jnp.sum(rhat * vel, axis=-1), jnp.nan
        )
        out['RADIAL-VELOCITY'] = radial_velocity
        beta = radial_velocity / CLIGHT
        out['DOPPLER'] = jnp.sqrt((1.0 + beta) / (1.0 - beta))

        # -- limb coordinates ----------------------------------------------
        target_obsvec = anchors['target_obsvec']
        near, near_dist = geom.nearest_point_on_line(
            jnp.zeros(3), d, target_obsvec
        )
        near_targvec = _obsvec2targvec_lin(anchors, near)
        limb_surface = geom.radial_surface_point(near_targvec, radii)
        if robust_geodetic:
            limb_lon_e, limb_lat, _ = geom.rect_to_geodetic(
                limb_surface, re, flattening
            )
        else:
            limb_lon_e, limb_lat, _ = rect_to_geodetic_surface(
                limb_surface, re, flattening
            )
        out['LIMB-LON-GRAPHIC'] = jnp.mod(lon_sign * limb_lon_e / DEG, 360.0)
        out['LIMB-LAT-GRAPHIC'] = limb_lat / DEG
        out['LIMB-DISTANCE'] = near_dist - jnp.linalg.norm(
            limb_surface, axis=-1
        )

        # -- ring plane ----------------------------------------------------
        intercept, nxpts = geom.ray_plane_intercept(
            jnp.zeros(3), d,
            anchors['ring_plane_normal'], anchors['ring_plane_constant'],
        )
        ring_ok = nxpts == 1
        ring_targvec = _obsvec2targvec_lin(anchors, intercept)
        # Ring intercepts are exterior (interior ones are always occluded by
        # the surface hit and masked below), so the fast Bowring solve
        # matches CSPICE recpgr to machine precision here.
        ring_lon_e, _ring_lat, ring_alt = geom.rect_to_geodetic_exterior(
            ring_targvec, re, flattening
        )
        ring_distance = jnp.linalg.norm(intercept, axis=-1)
        ring_radius = ring_alt + re
        ring_lon = jnp.mod(lon_sign * ring_lon_e / DEG, 360.0)
        hidden = found & (dist_surface < ring_distance)
        ring_invalid = (~ring_ok) | hidden
        out['RING-RADIUS'] = jnp.where(ring_invalid, jnp.nan, ring_radius)
        out['RING-LON-GRAPHIC'] = jnp.where(ring_invalid, jnp.nan, ring_lon)
        out['RING-DISTANCE'] = jnp.where(ring_invalid, jnp.nan, ring_distance)

        # float32 outputs, as in 'mixed': half the device-memory traffic,
        # and the 6e-8 relative rounding sits below every plane's budget
        return {k: v.astype(jnp.float32) for k, v in out.items()}

    return impl


def _mixed_impl_fn(
    *, positive_west: bool, prograde: bool, have_sun: bool,
    optimize_speed: bool = True, robust_geodetic: bool = False,
):
    """
    Mixed-precision pipeline.

    Written for an accelerator without native float64, where f64
    transcendentals/div/sqrt cost ~10-40x an f64 multiply and float32 is
    nearly free. It produces float64-grade backplanes while paying for
    only ~9 f64 transcendentals per pixel (the parity-critical angle
    outputs) plus a few hundred f64 multiplies. On an H100 it is ~1.4x
    faster than ``'double'`` at 2048^2, but less accurate on rays that
    graze the limb (see :data:`DEFAULT_PRECISION`). Its design:

    - **Recentring (f64 preamble, polynomial only)**: all per-pixel
      positions are expressed relative to per-scene anchors (the target
      centre and the ray closest-approach point), so magnitudes drop from
      ~1e9 km to ~1e5 km and no catastrophic cancellation remains. The ray
      direction is built as ``boresight + delta`` with small-angle series
      (exact to ~1e-15 for any realistic field of view), so the whole
      preamble is f64 mul/add.
    - **f32 light-time fixed point**: the per-pixel epoch offset ``dtau``
      (range +-seconds) converges in 2 float32 iterations to ~2e-8 s -
      far below what any output can resolve.
    - **f64-by-Newton arithmetic**: divisions, square roots and norms use
      float32 seeds refined by Newton-Raphson in f64 *multiplies*
      (:mod:`..ops.fastmath`), never f64 div/sqrt.
    - **f64 transcendentals only where parity demands**: longitude (also
      feeding LOCAL-SOLAR-TIME, whose 1-second quantisation boundaries
      need f64-exact longitude), latitudes, RA/Dec, azimuth's arccos and
      the limb/ring angles. Phase/incidence/emission use the stable
      half-angle form on f64-normalised-then-cast unit vectors in f32
      (error ~5e-6 deg, well inside the 2e-5 deg regression tolerance).
    """
    import jax.numpy as jnp
    from jax import lax

    ds = pick_ds()
    from .ops import fastmath as fm

    def impl(nx, ny, xy2angular, disc, radii, anchors, row0=0.0):
        tau0 = anchors['tau0']
        re = radii[0]
        rp = radii[2]
        flattening = (re - rp) / re
        lon_sign = -1.0 if positive_west else 1.0

        # ------- scene scalars (f64, negligible: not per-pixel) ----------
        m_ang = anchors['obsvec2angular']
        m0 = m_ang[0, :]  # boresight direction: e_x @ m_ang
        targ_rel0 = anchors['targ_pos0'] - anchors['obs_pos']
        targ_vel0 = anchors['targ_vel0']
        o_j = -targ_rel0  # ray origin (observer) relative to target centre
        t_ca0 = _vdot3(targ_rel0, m0)  # closest-approach dist, boresight
        q0 = o_j + t_ca0 * m0  # closest-approach offset, boresight
        inv_radii = 1.0 / radii
        sp_dist = anchors['subpoint_distance']
        delta0 = sp_dist - t_ca0  # for dtau = (delta0 - t' - sigma)/c
        sigma_nf = (
            anchors['target_lt'] * CLIGHT - t_ca0
        )  # effective sigma for off-disc pixels (lt := target_lt)
        rot0 = anchors['rot0']
        rot1 = anchors['rot1']
        rot2h = 0.5 * anchors['rot2']
        f32 = jnp.float32

        # ------- f64 preamble: rays + recentred geometry (mul/add only) --
        # The pixel->angular affine, the arcsec->rad scaling and the
        # km-plane affine below are all SEPARABLE in x and y, so each 2D
        # f64 field collapses to one f64 broadcast add per pixel over
        # precomputed 1D row/column terms. Reassociating the affine
        # changes results by <=1 ulp.
        xg32 = lax.broadcasted_iota(jnp.float32, (ny, nx), 1)
        yg32 = lax.broadcasted_iota(jnp.float32, (ny, nx), 0) + jnp.asarray(
            row0, jnp.float32
        )  # rows/cols are < 2^24: exact in f32
        x1 = lax.iota(jnp.float64, nx)
        y1 = lax.iota(jnp.float64, ny) + row0
        angx_col = xy2angular[0, 0] * x1 + xy2angular[0, 2]  # (nx,)
        angx_row = xy2angular[0, 1] * y1  # (ny,)
        angy_col = xy2angular[1, 0] * x1 + xy2angular[1, 2]
        angy_row = xy2angular[1, 1] * y1
        k_rad = DEG / 3600.0
        # The ray angles are separable (a = row-term + col-term), so the
        # f64 trig collapses to exact sin/cos on the four 1D vectors plus
        # angle-addition per pixel: sin(ar+ac) = sr*cc + cr*sc etc. -
        # ~10 emulated-f64 multiplies per pixel where the small-angle
        # Horner series paid ~20, and exact for any field of view.
        # cos(a)cos(b) - 1 is assembled cancellation-free from the 1D
        # (cos - 1) deltas: each |dc| < ~1e-3, so the sum of four
        # products below loses nothing to rounding.
        ar = -k_rad * angx_row
        ac = -k_rad * angx_col
        br = k_rad * angy_row
        bc = k_rad * angy_col
        sar, car1 = jnp.sin(ar), jnp.cos(ar) - 1.0  # 1D: negligible
        sac, cac1 = jnp.sin(ac), jnp.cos(ac) - 1.0
        sbr, cbr1 = jnp.sin(br), jnp.cos(br) - 1.0
        sbc, cbc1 = jnp.sin(bc), jnp.cos(bc) - 1.0
        # sin(ar+ac) = sar*cac + car*sac, with cac = 1 + cac1:
        sa = (sar[:, None] * cac1[None, :] + car1[:, None] * sac[None, :]
              + sar[:, None] + sac[None, :])
        sb = (sbr[:, None] * cbc1[None, :] + cbr1[:, None] * sbc[None, :]
              + sbr[:, None] + sbc[None, :])
        # cos(a) - 1 = car*cac - sar*sac - 1 = car1 + cac1 + car1*cac1
        #              - sar*sac
        dca = (car1[:, None] * cac1[None, :] - sar[:, None] * sac[None, :]
               + car1[:, None] + cac1[None, :])
        dcb = (cbr1[:, None] * cbc1[None, :] - sbr[:, None] * sbc[None, :]
               + cbr1[:, None] + cbc1[None, :])
        dvx = dca + dcb + dca * dcb  # cos(a)cos(b) - 1
        dvy = sa * (1.0 + dcb)
        dvz = sb
        # The f64 per-pixel core lives ENTIRELY in the rot0 (body-fixed,
        # epoch tau0) frame: rotations preserve dots/norms and every
        # downstream f64 consumer (intercept, lon/lat, limb, ring) wants
        # body-frame vectors, so building the delta-ray directly as
        # rot0 @ (dvec @ m_ang) against three precomputed constant
        # columns removes the two per-pixel f64 constant-matrix matvecs
        # (rot0 @ q_j, rot0 @ d_j) the J2000 formulation paid. J2000
        # quantities (RA/Dec rays, illumination vectors) tolerate f32
        # and are rebuilt cheaply below.
        rc = _mm33(rot0, m_ang.T)  # columns: rot0 @ m_ang[i, :]
        rdd = jnp.stack(
            [
                dvx * rc[0, 0] + dvy * rc[0, 1] + dvz * rc[0, 2],
                dvx * rc[1, 0] + dvy * rc[1, 1] + dvz * rc[1, 2],
                dvx * rc[2, 0] + dvy * rc[2, 1] + dvz * rc[2, 2],
            ],
            axis=-1,
        )  # rot0 @ dd (f64)
        rm0 = _mv3(rot0, m0)  # rot0 @ boresight
        rrel0 = _mv3(rot0, targ_rel0)
        tp = fm.dot3(jnp.broadcast_to(rrel0, rdd.shape), rdd)  # t_ca - t0
        # delta-ray in J2000, f32 (feeds RA/Dec and the f32 sun/observer
        # direction algebra only)
        dvx32 = dvx.astype(jnp.float32)
        dvy32 = dvy.astype(jnp.float32)
        dvz32 = dvz.astype(jnp.float32)
        m_ang32 = m_ang.astype(jnp.float32)
        dd32 = jnp.stack(
            [
                dvx32 * m_ang32[0, 0] + dvy32 * m_ang32[1, 0]
                + dvz32 * m_ang32[2, 0],
                dvx32 * m_ang32[0, 1] + dvy32 * m_ang32[1, 1]
                + dvz32 * m_ang32[2, 1],
                dvx32 * m_ang32[0, 2] + dvy32 * m_ang32[1, 2]
                + dvz32 * m_ang32[2, 2],
            ],
            axis=-1,
        )

        # ------- factored rotation ingredients -----------------------------
        # rot(dtau) @ (q - v dtau) expands exactly (for the quadratic rot
        # model) into rot0 @ q  +  dtau (rot1@q - rot0@v) + dtau^2 (rot2h@q
        # - rot1@v) - dtau^3 rot2h@v. The constant-matrix f64 base matvec
        # is computed ONCE (explicit FMA chains, see _const_matvec); the
        # dtau-scaled correction terms are a few km
        # (q) / ~4e-5 rad (d), so their *relative* f32 rounding leaves
        # sub-mm / 1e-12 rad errors - no per-pixel (3,3) rotation build or
        # varying-matrix matvec is needed anywhere, including inside the
        # fixed-point loop below.
        rot0_32 = rot0.astype(f32)
        rot1_32 = rot1.astype(f32)
        rot2h_32 = rot2h.astype(f32)
        v32 = targ_vel0.astype(f32)
        inv_r32 = inv_radii.astype(f32)
        re32 = re.astype(f32)
        # Body-frame assembly, no per-pixel matvec: rot0 @ q_j expands
        # over the q_j = q0 + (t_ca0 + tp) dd + tp m0 decomposition into
        # precomputed rotated constants and the rdd field built above
        q_bf0 = (
            _mv3(rot0, q0)
            + (t_ca0 + tp)[..., None] * rdd
            + tp[..., None] * rm0
        )
        d_bf0 = rm0 + rdd
        # rot1/rot2h act on J2000 vectors; against body-frame operands
        # they become the constant products rot_k @ rot0^T
        r1r0t_32 = _mm33(rot1, rot0.T).astype(f32)
        r2hr0t_32 = _mm33(rot2h, rot0.T).astype(f32)
        q_b32 = q_bf0.astype(f32)
        d_b32 = d_bf0.astype(f32)
        r1q = _matvec(r1r0t_32, q_b32)  # f32 correction ingredients, once
        r2q = _matvec(r2hr0t_32, q_b32)
        r1d = _matvec(r1r0t_32, d_b32)
        r2d = _matvec(r2hr0t_32, d_b32)
        rv0_32 = _mv3(rot0, targ_vel0).astype(f32)  # epoch-rate constants
        rv1_32 = _mv3(rot1, targ_vel0).astype(f32)
        rv2h_32 = _mv3(rot2h, targ_vel0).astype(f32)

        def _corrs(dt32):
            dt2 = dt32 * dt32
            cq = (
                dt32[..., None] * (r1q - rv0_32)
                + dt2[..., None] * (r2q - rv1_32)
                - (dt2 * dt32)[..., None] * rv2h_32
            )
            cd = dt32[..., None] * r1d + dt2[..., None] * r2d
            return cq, cd

        # ------- f32 fixed point for the light-time epoch offset ---------
        dtau_base = ((delta0 - tp) * (1.0 / CLIGHT)).astype(f32)
        sigma_nf32 = (sigma_nf - tp).astype(f32)
        dtau = dtau_base
        # 2 f32 iterations + the f64 evaluation below: measured against
        # the 3-iteration fixed point on a 512^2 grazing-heavy disc the
        # worst plane moves 7.6e-6 deg (LON-CENTRIC) - 6x inside the
        # 5e-5 deg contract. (Near the limb the contraction factor is
        # amplified, v/c -> v/(c cos e), so dropping to 1 DOES visibly
        # under-converge.)
        n_lt_iters = int(os.environ.get('PLANETMAPPER_TPU_LT_ITERS', '2'))
        for _ in range(n_lt_iters):
            cq, cd = _corrs(dtau)
            u = (q_b32 + cq) * inv_r32
            v = (d_b32 + cd) * (re32 * inv_r32)
            qa = fm.dot3(v, v)
            qb = fm.dot3(u, v)
            qc = fm.dot3(u, u) - 1.0
            dsc = qb * qb - qa * qc
            ok = dsc >= 0.0
            sig = (
                (-qb - jnp.sqrt(jnp.where(ok, dsc, 0.0))) / qa * re32
            )
            sig = jnp.where(ok, sig, sigma_nf32)
            dtau = dtau_base - sig * f32(1.0 / CLIGHT)

        dtau = dtau.astype(jnp.float64)

        # ------- f64 intercept via Newton-refined arithmetic --------------
        corr_q, corr_d = _corrs(dtau.astype(f32))
        q_bf = q_bf0 + corr_q.astype(jnp.float64)
        d_bf = d_bf0 + corr_d.astype(jnp.float64)
        u = q_bf * inv_radii
        v = d_bf * (re * inv_radii)
        qa = fm.dot3(v, v)
        qb = fm.dot3(u, v)
        qc = fm.dot3(u, u) - 1.0
        dsc = qb * qb - qa * qc
        found = dsc >= 0.0
        sigma = (-qb - fm.sqrt64(jnp.where(found, dsc, 0.0))) * fm.recip64(
            qa
        ) * re
        dist = t_ca0 + tp + sigma  # observer -> surface distance
        found = found & (dist >= 0.0)
        sigma = jnp.where(found, sigma, jnp.nan)
        spoint = q_bf + sigma[..., None] * d_bf  # body-fixed, on surface
        dist = jnp.where(found, dist, anchors['target_lt'] * CLIGHT)

        if optimize_speed:
            # f32 mask arithmetic: the cutoff carries a 1.05x + 1 px
            # margin, far beyond f32 rounding of pixel distances
            x0 = disc[0].astype(f32)
            y0 = disc[1].astype(f32)
            r0 = disc[2].astype(f32)
            r_cutoff = r0 * (jnp.max(radii) / re).astype(f32) * f32(
                1.05
            ) + f32(1.0)
            r2_px = (xg32 - x0) ** 2 + (yg32 - y0) ** 2
            off = r2_px > r_cutoff * r_cutoff
            spoint = jnp.where(off[..., None], jnp.nan, spoint)
            found = found & ~off

        spoint = jnp.where(found[..., None], spoint, jnp.nan)

        # Post-loop epoch update, exactly like the 'double' pipeline: the
        # illumination/state sections evaluate at dtau_4 = f(sigma) while
        # the intercept itself used rot(dtau_3)
        dtau = (sp_dist - dist) * (1.0 / CLIGHT)

        out: dict[str, Any] = {}

        # ------- lon/lat (1 arctan2 each; Bowring step is trig-free) ------
        px = spoint[..., 0]
        py = spoint[..., 1]
        pz = spoint[..., 2]
        # Longitude stays f64 [T1]: LOCAL-SOLAR-TIME's 1-second
        # quantization boundaries resolve 1/240 deg exactly, so boundary
        # pixels need the longitude far below f32 rounding.
        lon_e = jnp.arctan2(py, px)
        e2 = flattening * (2.0 - flattening)
        ep2 = e2 / (1.0 - e2)
        omf = 1.0 - flattening
        # Latitudes in f32 on the f64 intercept point: ~2e-7 relative
        # rounding of the atan2 arguments moves the angle by ~1e-5 deg,
        # 4x inside the 5e-5 deg contract. Reduced latitude trig-free
        # (tan(beta) =
        # z / (rho (1-f))); one Bowring step absorbs rounding-level
        # off-spheroid offsets. Strongly triaxial bodies put the surface
        # point deep inside the biaxial spheroid where this diverges -
        # they take the exact nearest-point solve instead (f64, rare).
        px32 = px.astype(f32)
        py32 = py.astype(f32)
        pz32 = pz.astype(f32)
        rho32 = jnp.sqrt(px32 * px32 + py32 * py32)
        omf_l = omf.astype(f32)
        if robust_geodetic:
            _lon_unused, lat_gd, _alt_unused = geom.rect_to_geodetic(
                spoint, re, flattening
            )
        else:
            w32 = rho32 * omf_l
            rb32 = lax.rsqrt(pz32 * pz32 + w32 * w32)
            sin_b = pz32 * rb32
            cos_b = w32 * rb32
            lat_gd = jnp.arctan2(
                pz32 + ep2.astype(f32) * (re.astype(f32) * omf_l)
                * sin_b * sin_b * sin_b,
                rho32 - e2.astype(f32) * re.astype(f32)
                * cos_b * cos_b * cos_b,
            ).astype(jnp.float64)
        lon_graphic = _mod360(lon_sign * lon_e * (1.0 / DEG))
        out['LON-GRAPHIC'] = jnp.where(found, lon_graphic, jnp.nan)
        out['LAT-GRAPHIC'] = jnp.where(found, lat_gd * (1.0 / DEG), jnp.nan)
        lat_c = jnp.arctan2(pz32, rho32).astype(jnp.float64)
        out['LON-CENTRIC'] = jnp.where(
            found, _mod360(lon_e * (1.0 / DEG)), jnp.nan
        )
        out['LAT-CENTRIC'] = jnp.where(found, lat_c * (1.0 / DEG), jnp.nan)

        # ------- RA/Dec of the rays (f32 atan2: one ulp at ra ~ 2 pi is
        # 2.8e-5 deg, inside the contract; outputs are written f32 anyway)
        dj32 = m0.astype(f32) + dd32
        ra = jnp.arctan2(dj32[..., 1], dj32[..., 0]).astype(jnp.float64)
        ra = jnp.where(ra < 0.0, ra + 2.0 * jnp.pi, ra)
        dec = jnp.arctan2(
            dj32[..., 2],
            jnp.sqrt(
                dj32[..., 0] * dj32[..., 0] + dj32[..., 1] * dj32[..., 1]
            ),
        ).astype(jnp.float64)
        out['RA'] = ra * (1.0 / DEG)
        out['DEC'] = dec * (1.0 / DEG)

        # ------- pixel / km / angular (f64 affine: the rotation mixes two
        # ~1e5 km terms that cancel along the axes, so f32 would leave
        # ~8e-3 km absolute errors exactly where KM-X/Y pass through 0).
        # Separable like the angular affine: 1D row/column terms combined
        # with one f64 broadcast add per pixel --
        out['PIXEL-X'] = xg32
        out['PIXEL-Y'] = yg32
        m2 = anchors['angular2km']
        km_x = (m2[0, 0] * angx_row + m2[0, 1] * angy_row)[:, None] + (
            m2[0, 0] * angx_col + m2[0, 1] * angy_col
        )[None, :]
        km_y = (m2[1, 0] * angx_row + m2[1, 1] * angy_row)[:, None] + (
            m2[1, 0] * angx_col + m2[1, 1] * angy_col
        )[None, :]
        out['KM-X'] = km_x
        out['KM-Y'] = km_y
        km_per_arcsec = 2.0 * re / (
            2.0 * 60.0 * 60.0 / DEG * jnp.arcsin(
                re / (anchors['target_lt'] * CLIGHT)
            )
        )  # scalar
        # f32 scaling: the error is relative (6e-8 of the value), outputs
        # are written f32 anyway, and the zero crossing stays exact
        inv_kpa32 = (1.0 / km_per_arcsec).astype(f32)
        out['ANGULAR-X'] = km_x.astype(f32) * inv_kpa32
        out['ANGULAR-Y'] = km_y.astype(f32) * inv_kpa32

        # ------- illumination (f32 direction algebra) ----------------------
        # Direction vectors tolerate f32 throughout: component rounding is
        # *relative* (~6e-8), so even the ~1e9 km magnitudes perturb the
        # resulting directions by only ~6e-8 rad (~4e-6 deg) per operation -
        # an order of magnitude inside the 5e-5 deg contract (validated by
        # tests/test_pipeline.py). Only AZIMUTH is ill-conditioned (where
        # sin(incidence) or sin(emission) -> 0); those pixels get an exact
        # f64 repair pass below.
        dtau32 = dtau.astype(f32)
        rot4_32 = (
            rot0_32
            + rot1_32 * dtau32[..., None, None]
            + rot2h_32 * (dtau32 * dtau32)[..., None, None]
        )
        bf2j32 = jnp.swapaxes(rot4_32, -1, -2)
        sp32 = spoint.astype(f32)
        point_j32 = _matvec(bf2j32, sp32)
        targ_rel0_32 = targ_rel0.astype(f32)
        srfvec32 = targ_rel0_32 + v32 * dtau32[..., None] + point_j32
        u_obs = -srfvec32 * lax.rsqrt(fm.dot3(srfvec32, srfvec32))[
            ..., None
        ]
        if have_sun:
            point_ssb32 = (
                anchors['targ_pos0'].astype(f32)
                + v32 * dtau32[..., None]
                + point_j32
            )
            # f32 ample for the sun epoch: a ~1e-4 s epoch error moves the
            # sun direction by ~3e-12 rad
            sun_off32 = anchors['sun_pos0'].astype(f32) - point_ssb32
            lt_s32 = jnp.sqrt(fm.dot3(sun_off32, sun_off32)) * f32(
                1.0 / CLIGHT
            )
            sun_dtau32 = (
                (tau0 - anchors['sun_epoch0']).astype(f32) + dtau32 - lt_s32
            )
            sun_pos32 = anchors['sun_pos0'].astype(f32) + anchors[
                'sun_vel0'
            ].astype(f32) * sun_dtau32[..., None]
            sun_dir32 = sun_pos32 - point_ssb32
            u_sun = sun_dir32 * lax.rsqrt(
                fm.dot3(sun_dir32, sun_dir32)
            )[..., None]
        else:
            u_sun = jnp.full_like(sp32, jnp.nan)
        n_bf32 = sp32 * (inv_radii * inv_radii).astype(f32)
        n_bf32 = n_bf32 * lax.rsqrt(fm.dot3(n_bf32, n_bf32))[..., None]
        n_j = _matvec(bf2j32, n_bf32)  # unit surface normal, J2000 (f32)

        # angle outputs: stable half-angle form (f32)
        phase = geom.vector_separation(u_sun, u_obs).astype(
            jnp.float64
        ) * (1.0 / DEG)
        incidence = geom.vector_separation(n_j, u_sun).astype(
            jnp.float64
        ) * (1.0 / DEG)
        emission = geom.vector_separation(n_j, u_obs).astype(
            jnp.float64
        ) * (1.0 / DEG)
        out['PHASE'] = phase
        out['INCIDENCE'] = incidence
        out['EMISSION'] = emission

        # Azimuth: dihedral angle between the tangent-plane projections of
        # the sun and observer directions. The atan2 form is well
        # conditioned in the angle itself (unlike arccos near 0/180), but
        # forming the projections cancels catastrophically where sin(i)
        # or sin(e) -> 0 (the sub-solar/sub-observer caps): a relative
        # input error eps becomes eps/sin in the projection. So the
        # scaled projections A = s(n.n) - n(n.s), B = o(n.n) - n(n.o)
        # (positive multiples of the unit-vector projections, so the
        # dihedral is unchanged) are formed with :func:`pick_ds`'s
        # extended precision (native f64, or ~2^-49 relative f32 pairs),
        # after which the f32 cross/dot/atan2 tail only adds a
        # well-conditioned ~6e-8 rad absolute angle error.
        #
        # All vectors live in the body-fixed (rot0) frame where spoint
        # already is: the J2000 scene constants rotate ONCE per call
        # (ds-exact), and the per-pixel epoch corrections are a few 1e-4
        # relative - their f32 rounding perturbs the directions at
        # ~1e-11, far below the dihedral's needs (same argument as the
        # intercept's factored rotation above).
        if have_sun:
            c_s_j = anchors['sun_pos0'] - anchors['targ_pos0']
            c_o_j = -targ_rel0
            cs_bf = _mv3(rot0, c_s_j)
            co_bf = _mv3(rot0, c_o_j)
            r1_s = _mv3(rot1, c_s_j).astype(f32)
            r2_s = _mv3(rot2h, c_s_j).astype(f32)
            r1_o = _mv3(rot1, c_o_j).astype(f32)
            r2_o = _mv3(rot2h, c_o_j).astype(f32)
            rsv0_32 = _mv3(rot0, anchors['sun_vel0']).astype(f32)
            dt2_32 = dtau32 * dtau32
            s_v, o_v, n_v = [], [], []
            for i in range(3):
                sp_i = ds.from_f64(spoint[..., i])
                corr_s = (
                    r1_s[i] * dtau32 + r2_s[i] * dt2_32
                    + rsv0_32[i] * sun_dtau32
                    - rv0_32[i] * dtau32 - rv1_32[i] * dt2_32
                )
                corr_o = (
                    r1_o[i] * dtau32 + r2_o[i] * dt2_32
                    - rv0_32[i] * dtau32 - rv1_32[i] * dt2_32
                )
                s_v.append(ds.add_f(ds.sub(ds.from_f64(cs_bf[i]), sp_i),
                                    corr_s))
                o_v.append(ds.add_f(ds.sub(ds.from_f64(co_bf[i]), sp_i),
                                    corr_o))
                # n scaled by re so |n| ~ 1 (scale-invariant dihedral)
                n_v.append(ds.mul(
                    sp_i, ds.from_f64(inv_radii[i] * inv_radii[i] * re)
                ))

            nn_d = _ds_dot3(ds, n_v, n_v)
            ns_d = _ds_dot3(ds, n_v, s_v)
            no_d = _ds_dot3(ds, n_v, o_v)
            a_v = [
                ds.hi(ds.sub(ds.mul(s_v[i], nn_d), ds.mul(n_v[i], ns_d)))
                for i in range(3)
            ]
            b_v = [
                ds.hi(ds.sub(ds.mul(o_v[i], nn_d), ds.mul(n_v[i], no_d)))
                for i in range(3)
            ]
            crx = a_v[1] * b_v[2] - a_v[2] * b_v[1]
            cry = a_v[2] * b_v[0] - a_v[0] * b_v[2]
            crz = a_v[0] * b_v[1] - a_v[1] * b_v[0]
            saz = jnp.sqrt(crx * crx + cry * cry + crz * crz)
            caz = a_v[0] * b_v[0] + a_v[1] * b_v[1] + a_v[2] * b_v[2]
            azimuth = (
                (jnp.float32(jnp.pi) - jnp.arctan2(saz, caz))
                * f32(1.0 / DEG)
            ).astype(jnp.float64)
        else:
            a_p = u_sun - n_j * fm.dot3(n_j, u_sun)[..., None]
            b_p = u_obs - n_j * fm.dot3(n_j, u_obs)[..., None]
            cr_p = jnp.cross(a_p, b_p)
            saz = jnp.sqrt(fm.dot3(cr_p, cr_p))
            caz = fm.dot3(a_p, b_p)
            azimuth = (
                (jnp.float32(jnp.pi) - jnp.arctan2(saz, caz))
                * f32(1.0 / DEG)
            ).astype(jnp.float64)
        out['AZIMUTH'] = azimuth

        # ------- local solar time (from the f64 longitude) ----------------
        spin_sign = 1.0 if prograde else -1.0
        lst = 12.0 + spin_sign * (lon_e - anchors['solar_lon_e']) * (
            12.0 / jnp.pi
        )
        lst = jnp.where(lst < 0.0, lst + 24.0, lst)
        lst = jnp.where(lst < 0.0, lst + 24.0, lst)
        lst = jnp.where(lst >= 24.0, lst - 24.0, lst)
        lst = jnp.where(lst >= 24.0, lst - 24.0, lst)
        from .body import lst_quantization_enabled

        if lst_quantization_enabled():
            lst = jnp.floor(lst * 3600.0) / 3600.0
        out['LOCAL-SOLAR-TIME'] = jnp.where(found, lst, jnp.nan)

        # ------- state: distance / radial velocity / doppler ---------------
        dist_surface = jnp.where(found, dist, jnp.nan)
        out['DISTANCE'] = dist_surface
        # f64 velocity algebra: in f32, the rounding of ~30 km/s
        # magnitudes over ~10 operations (each up to 2 ulp on GPUs) comes
        # within reach of the 1e-5 km/s budget; DISTANCE keeps the f64
        # intercept value
        def bf2j_mv(m, v):  # m^T @ v per pixel, unrolled (elementwise)
            return jnp.stack(
                [
                    m[..., 0, i] * v[..., 0] + m[..., 1, i] * v[..., 1]
                    + m[..., 2, i] * v[..., 2]
                    for i in range(3)
                ],
                axis=-1,
            )

        dtau_m = dtau[..., None, None]
        rot_t = rot0 + rot1 * dtau_m + rot2h * (dtau_m * dtau_m)
        rot_dot = rot1 + (rot2h + rot2h) * dtau_m
        srfvec = (
            targ_rel0 + targ_vel0 * dtau[..., None] + bf2j_mv(rot_t, spoint)
        )
        rhat = srfvec * fm.rsqrt64(fm.dot3(srfvec, srfvec))[..., None]
        p_vel = targ_vel0 + bf2j_mv(rot_dot, spoint)
        obs_vel = anchors['obs_vel']
        rv_t = fm.dot3(rhat, p_vel)
        rv_o = fm.dot3(rhat, jnp.broadcast_to(obs_vel, rhat.shape))
        dltdt = (rv_t - rv_o) / (CLIGHT + rv_t)
        vel = p_vel * (1.0 - dltdt)[..., None] - obs_vel
        rv = fm.dot3(rhat, vel)
        out['RADIAL-VELOCITY'] = jnp.where(found, rv, jnp.nan)
        beta = (rv * (1.0 / CLIGHT)).astype(f32)
        out['DOPPLER'] = jnp.sqrt((1.0 + beta) / (1.0 - beta))

        # ------- limb coordinates (double-single; LIMB-DISTANCE is
        # cm-level). Assembled directly in the rot0 frame (dots/norms
        # invariant), which also turns the rot0 @ off matvec below into a
        # plain add. All the precision-critical per-pixel arithmetic goes
        # through :func:`pick_ds`'s extended precision.
        o_t = anchors['target_obsvec']
        rot_o_t = _mv3(rot0, o_t)
        rdd_d = _ds_split3(ds, rdd)
        dbf0_d = _ds_split3(ds, d_bf0)
        rot_ot_d = [ds.from_f64(rot_o_t[i]) for i in range(3)]
        a_dot_d = _ds_dot3(ds, rot_ot_d, rdd_d)
        a0 = _vdot3(o_t, m0)  # scalar (rotation-invariant)
        # near - o_t, assembled from small recentred terms (~1e5 km).
        # a0*rm0 + a0*rdd + a_dot*rm0 + a_dot*rdd factors exactly as
        # (a0 + a_dot) * (rm0 + rdd) = (a0 + a_dot) * d_bf0 - three ds
        # multiplies per pixel instead of nine. The 1e9 - 1e9 -> 1e5 km
        # cancellation rounds at ~2^-49 of the large terms (~2e-6 km),
        # inside both the 0.1 km LIMB-DISTANCE atol and the 61 m lon/lat
        # lateral budget.
        t_d = ds.add(a_dot_d, ds.from_f64(a0))
        p_off_d = [
            ds.sub(ds.mul(t_d, dbf0_d[i]), rot_ot_d[i]) for i in range(3)
        ]
        dot_a_d = _ds_dot3(ds, p_off_d, p_off_d)
        c_off = rot_o_t - _mv3(rot0, anchors['subpoint_obsvec'])
        off_d = [
            ds.add(p_off_d[i], ds.from_f64(c_off[i])) for i in range(3)
        ]
        # |(-subpoint_rayvec) + off| - subpoint_distance, cancellation-free:
        # (2 A.off + |off|^2) / (|A + off| + |A|) with |A| = sp_dist
        # Light-time retiming (dtau_l) only rotates the ~1e5 km offset by
        # ~ omega * dtau_l ~ 5 km, so the whole retiming chain and the
        # rotation *correction* need ~1% relative accuracy for the 61 m
        # limb lon/lat budget: f32 (the ds hi words) carries both.
        off32 = jnp.stack([ds.hi(v) for v in off_d], axis=-1)
        spr32 = _mv3(rot0, -anchors['subpoint_rayvec']).astype(f32)
        amo32 = fm.dot3(jnp.broadcast_to(spr32, off32.shape), off32)
        num_l32 = 2.0 * amo32 + fm.dot3(off32, off32)
        spd32 = sp_dist.astype(f32)
        r1_32 = num_l32 / (2.0 * spd32)
        dtau_l32 = -(num_l32 / (2.0 * spd32 + r1_32)) * f32(1.0 / CLIGHT)
        corr_l = (
            dtau_l32[..., None] * _matvec(r1r0t_32, off32)
            + (dtau_l32 * dtau_l32)[..., None] * _matvec(r2hr0t_32, off32)
        )
        spt_c = anchors['subpoint_targvec']
        near_d = [
            ds.add_f(
                ds.add(off_d[i], ds.from_f64(spt_c[i])), corr_l[..., i]
            )
            for i in range(3)
        ]
        nt_d = [
            ds.mul(near_d[i], ds.from_f64(inv_radii[i])) for i in range(3)
        ]
        ss_d = _ds_dot3(ds, nt_d, nt_d)
        # dot_b = |near|^2 / |near scaled|^2: one ds Newton reciprocal
        dot_b_d = ds.mul(_ds_dot3(ds, near_d, near_d), ds.recip(ss_d))
        # geodetic conversion in f32 (direction only: ~4e-3 km lateral
        # rounding of the ~7e4 km point is ~4e-6 deg, well inside the
        # 5e-5 deg contract); LIMB-DISTANCE below keeps the ds chain
        scale32 = lax.rsqrt(ds.hi(ss_d))
        lx = ds.hi(near_d[0]) * scale32
        ly = ds.hi(near_d[1]) * scale32
        lz = ds.hi(near_d[2]) * scale32
        lrho = jnp.sqrt(lx * lx + ly * ly)
        # f64 longitude: near the disc centre the limb direction is
        # ill-conditioned, and f32 rounding there exceeds the budget
        limb_lon_e = jnp.arctan2(ds.to_f64(near_d[1]), ds.to_f64(near_d[0]))
        if robust_geodetic:
            near_targvec = jnp.stack(
                [ds.to_f64(near_d[i]) for i in range(3)], axis=-1
            )
            _lon_u, limb_lat, _alt_u = geom.rect_to_geodetic(
                near_targvec * fm.rsqrt64(ds.to_f64(ss_d))[..., None],
                re, flattening,
            )
        else:
            lw = lrho * omf_l
            lrb = lax.rsqrt(lz * lz + lw * lw)
            lsb = lz * lrb
            lcb = lw * lrb
            limb_lat = jnp.arctan2(
                lz + ep2.astype(f32) * (re.astype(f32) * omf_l)
                * lsb * lsb * lsb,
                lrho - e2.astype(f32) * re.astype(f32) * lcb * lcb * lcb,
            ).astype(jnp.float64)
        out['LIMB-LON-GRAPHIC'] = _mod360(lon_sign * limb_lon_e * (1.0 / DEG))
        out['LIMB-LAT-GRAPHIC'] = limb_lat * (1.0 / DEG)
        # |A| - |B| as (|A|^2 - |B|^2)/(|A| + |B|), all in ds: the
        # cancellation sits in the exact ds subtract, and keeping the
        # sqrt/recip tail in ds leaves the f32 output cast as the only
        # rounding of the result (a chain of separate f32 steps here
        # accumulated past the 2e-7 relative contract)
        den_d = ds.add(ds.sqrt(dot_a_d), ds.sqrt(dot_b_d))
        out['LIMB-DISTANCE'] = ds.to_f64(
            ds.mul(ds.sub(dot_a_d, dot_b_d), ds.recip(den_d))
        )

        # ------- ring plane (double-single for the cancelling chains) ------
        rn = anchors['ring_plane_normal']
        rot_rn = _mv3(rot0, rn)
        rot_rn_d = [ds.from_f64(rot_rn[i]) for i in range(3)]
        denom_d = ds.add(
            _ds_dot3(ds, rot_rn_d, rdd_d), ds.from_f64(_vdot3(rn, m0))
        )
        denom_r = ds.to_f64(denom_d)
        in_plane = (jnp.abs(denom_r) == 0.0) & (
            jnp.abs(anchors['ring_plane_constant']) == 0.0
        )
        parallel = (jnp.abs(denom_r) == 0.0) & ~in_plane
        safe = jnp.abs(denom_r) > 1e-30
        denom_safe_d = (
            jnp.where(
                safe, denom_d[0],
                jnp.where(denom_r < 0.0, f32(-1e-30), f32(1e-30)),
            ),
            jnp.where(safe, denom_d[1], f32(0.0)),
        )
        s_r_d = ds.mul(
            ds.from_f64(anchors['ring_plane_constant']),
            ds.recip(denom_safe_d),
        )
        s_r = ds.to_f64(s_r_d)
        ring_ok = (~parallel) & (~in_plane) & (s_r >= 0.0)
        # intercept relative to the subpoint, in the rot0 frame: rot0 @
        # d_j is d_bf0, so the body-frame form costs the same mults and
        # drops the per-pixel (3,3) retargeting-rotation build below to
        # two constant matvecs. ``off_r`` is formed in ds (the
        # 1e9 - 1e9 -> 1e5 km cancellation demands better than f32); the
        # retiming chain, rotation retargeting and geodetic conversion of
        # the ~1e5 km recentred values round at ~0.01 km - well under the
        # 0.11 km RING-LON angle budget - so they run on the f32 hi words
        rso_c = _mv3(rot0, anchors['subpoint_obsvec'])
        off_r32 = jnp.stack(
            [
                ds.hi(ds.sub(ds.mul(s_r_d, dbf0_d[i]), ds.from_f64(rso_c[i])))
                for i in range(3)
            ],
            axis=-1,
        )
        amo_r = fm.dot3(jnp.broadcast_to(spr32, off_r32.shape), off_r32)
        num_r = 2.0 * amo_r + fm.dot3(off_r32, off_r32)
        r1_r = num_r / (2.0 * spd32)
        dtau_r32 = -(num_r / (2.0 * spd32 + r1_r)) * f32(1.0 / CLIGHT)
        ring_targvec = (
            anchors['subpoint_targvec'].astype(f32)
            + off_r32
            + dtau_r32[..., None] * _matvec(r1r0t_32, off_r32)
            + (dtau_r32 * dtau_r32)[..., None]
            * _matvec(r2hr0t_32, off_r32)
        )
        if os.environ.get('PLANETMAPPER_TPU_DSDBG') == '1':
            out['__DBG_RTV0__'] = ring_targvec[..., 0].astype(jnp.float64)
            out['__DBG_RTV1__'] = ring_targvec[..., 1].astype(jnp.float64)
            out['__DBG_RTV2__'] = ring_targvec[..., 2].astype(jnp.float64)
            out['__DBG_OFFR0__'] = off_r32[..., 0].astype(jnp.float64)
            out['__DBG_OFFR1__'] = off_r32[..., 1].astype(jnp.float64)
            out['__DBG_OFFR2__'] = off_r32[..., 2].astype(jnp.float64)
            out['__DBG_SR__'] = s_r
            out['__DBG_DTAUR__'] = dtau_r32.astype(jnp.float64)
        rx32 = ring_targvec[..., 0]
        ry32 = ring_targvec[..., 1]
        rz32 = ring_targvec[..., 2]
        ring_lon_e = jnp.arctan2(ry32, rx32).astype(jnp.float64)
        # Bowring (trig-free, geocentric init + 2 steps) for the exterior
        # ring points, in f32: the RING-RADIUS tolerance is relative
        # (rtol 1e-5 of ~1e5+ km values), far above f32 rounding
        rrho = jnp.sqrt(rx32 * rx32 + ry32 * ry32)
        omf32 = omf.astype(f32)
        e2_32 = e2.astype(f32)
        ep2_32 = ep2.astype(f32)
        re32_ = re.astype(f32)
        rw = rrho * omf32
        rrb = lax.rsqrt(rz32 * rz32 + rw * rw)
        rsb = rz32 * rrb
        rcb = rw * rrb
        for _ in range(2):
            rnum = rz32 + ep2_32 * (re32_ * omf32) * rsb * rsb * rsb
            rden = rrho - e2_32 * re32_ * rcb * rcb * rcb
            rr2 = lax.rsqrt(rnum * rnum + rden * rden)
            rsl = rnum * rr2  # sin(lat)
            rcl = rden * rr2  # cos(lat)
            rb2 = lax.rsqrt(omf32 * omf32 * rsl * rsl + rcl * rcl)
            rsb = omf32 * rsl * rb2
            rcb = rcl * rb2
        rnum = rz32 + ep2_32 * (re32_ * omf32) * rsb * rsb * rsb
        rden = rrho - e2_32 * re32_ * rcb * rcb * rcb
        rr2 = lax.rsqrt(rnum * rnum + rden * rden)
        rsl = rnum * rr2
        rcl = rden * rr2
        n_r = re32_ * lax.rsqrt(1.0 - e2_32 * rsl * rsl)
        ring_alt = (
            rrho * rcl + rz32 * rsl - n_r * (1.0 - e2_32 * rsl * rsl)
        ).astype(jnp.float64)
        ring_distance = s_r  # |s * d| with |d| = 1
        ring_radius = ring_alt + re
        ring_lon = _mod360(lon_sign * ring_lon_e * (1.0 / DEG))
        hidden = found & (dist_surface < ring_distance)
        ring_invalid = (~ring_ok) | hidden
        out['RING-RADIUS'] = jnp.where(ring_invalid, jnp.nan, ring_radius)
        out['RING-LON-GRAPHIC'] = jnp.where(ring_invalid, jnp.nan, ring_lon)
        out['RING-DISTANCE'] = jnp.where(ring_invalid, jnp.nan, ring_distance)

        # Write float32 outputs: halves the device-memory traffic of the
        # 26 planes, and the 6e-8 relative rounding sits below every
        # output tolerance (RADIAL-VELOCITY: ~2e-6 of its 1e-5 km/s).
        return {k: v.astype(jnp.float32) for k, v in out.items()}

    return impl


def _mod360(x):
    """x mod 360 for x in (-720, 720), branch-free (f64 mod is emulated)."""
    import jax.numpy as jnp

    x = jnp.where(x < 0.0, x + 360.0, x)
    x = jnp.where(x < 0.0, x + 360.0, x)
    return jnp.where(x >= 360.0, x - 360.0, x)


def _obsvec2targvec_lin(anchors, obsvec):
    """Model-A obsvec->targvec transform with linearised rotation."""
    import jax.numpy as jnp

    off = obsvec - anchors['subpoint_obsvec']
    dist_offset = (
        jnp.linalg.norm(-anchors['subpoint_rayvec'] + off, axis=-1)
        - anchors['subpoint_distance']
    )
    dtau = (anchors['tau0'] - dist_offset / CLIGHT) - anchors['tau0']
    rot = _rot_at(anchors, dtau)
    return anchors['subpoint_targvec'] + _matvec(rot, off)


_PIPELINE_CACHE: dict[tuple, Any] = {}


def _lst_quantization() -> bool:
    from .body import lst_quantization_enabled

    return lst_quantization_enabled()


#: Shape buckets: the compiled program computes the bucketed grid and the
#: caller slices the true (ny, nx) out, so ONE compilation serves every
#: image size in a bucket (per-pixel values are independent, so padding
#: changes nothing numerically). Cold-start compiles would otherwise
#: dominate first use at every new shape.
_NX_BUCKETS = (
    16, 32, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048,
    3072, 4096,
)


def _bucket_size(n: int) -> int:
    for b in _NX_BUCKETS:
        if n <= b:
            return b
    return -(-n // 1024) * 1024


def _robust_geodetic(body) -> bool:
    """
    True when the body is triaxial (middle axis != re): surface points of
    the triaxial intercept ellipsoid then sit deep inside the biaxial
    (re, rp) geodetic spheroid, where the fast on-surface conversions
    diverge and the exact nearest-point solve must be used.
    """
    radii_host = np.asarray(body.radii, dtype=float)
    return bool(abs(radii_host[0] - radii_host[1]) > 1e-9 * radii_host[0])


def pipeline_config_key(body) -> tuple:
    """Everything about a body that changes the compiled per-pixel program."""
    return (
        body.target_body_id, body._observer_body_id,
        body.aberration_correction, body.positive_longitude_direction,
        body.prograde, body._engine._pos_s is not None,
        bool(body._optimize_speed),
        getattr(body, '_pipeline_precision', DEFAULT_PRECISION),
        _lst_quantization(), _robust_geodetic(body),
        os.environ.get('PLANETMAPPER_TPU_LT_ITERS', '2'),
    )


def select_pipeline_impl(body):
    """
    The per-pixel pipeline impl for a body's configuration:
    ``impl(nx, ny, xy2angular, disc, radii, anchors, row0=...)`` computes
    all 26 planes for rows ``[row0, row0 + ny)``. Shared by
    :func:`get_fused_pipeline` and the row-sharded multi-device path
    (:mod:`.parallel.sharding`).
    """
    return fused_backplanes_fn(
        positive_west=body.positive_longitude_direction == 'W',
        prograde=body.prograde,
        have_sun=body._engine._pos_s is not None,
        optimize_speed=bool(body._optimize_speed),
        precision=getattr(body, '_pipeline_precision', DEFAULT_PRECISION),
        robust_geodetic=_robust_geodetic(body),
    )


#: Output order of the default planes; a ``planes`` subset is canonicalised
#: to it so that each subset compiles once whatever order it is given in.
PLANE_ORDER = (
    'LON-GRAPHIC', 'LAT-GRAPHIC', 'LON-CENTRIC', 'LAT-CENTRIC',
    'RA', 'DEC', 'PIXEL-X', 'PIXEL-Y', 'KM-X', 'KM-Y',
    'ANGULAR-X', 'ANGULAR-Y', 'PHASE', 'INCIDENCE', 'EMISSION',
    'AZIMUTH', 'LOCAL-SOLAR-TIME', 'DISTANCE', 'RADIAL-VELOCITY',
    'DOPPLER', 'LIMB-DISTANCE', 'LIMB-LON-GRAPHIC', 'LIMB-LAT-GRAPHIC',
    'RING-RADIUS', 'RING-LON-GRAPHIC', 'RING-DISTANCE',
)


def get_fused_pipeline(body, nx: int, ny: int,
                       planes: tuple[str, ...] | None = None):
    """
    Jitted fused pipeline for a body's configuration and image size.
    Returns ``fn(xy2angular, disc, radii, anchors) -> dict of backplanes``,
    with ``fn.precompile()`` to compile it ahead of the first call.

    ``planes`` restricts the program to a subset of the default planes
    (XLA's dead-code elimination drops the rest). Each distinct subset is
    a separate compile - worth it for hot loops that stream a few planes,
    not for one-off requests (the full set is already compiled).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    precision = getattr(body, '_pipeline_precision', DEFAULT_PRECISION)
    # Frames taller than four bands run as a lax.map over row bands,
    # which bounds the live per-pixel temporaries to one band. 256 rows
    # was tuned on the previous accelerator; not measured on the H100.
    band_rows = int(os.environ.get('PLANETMAPPER_TPU_BAND_ROWS', '256'))
    nx_b = _bucket_size(nx)
    tiled = ny > 4 * band_rows
    ny_b = -(-ny // band_rows) * band_rows if tiled else _bucket_size(ny)
    if planes is not None:
        unknown = set(planes) - set(PLANE_ORDER)
        if unknown:
            raise ValueError(f'unknown planes: {sorted(unknown)}')
        planes = tuple(n for n in PLANE_ORDER if n in planes)
    key = (pipeline_config_key(body), nx_b, ny_b, band_rows, planes)
    fn = _PIPELINE_CACHE.get(key)
    if fn is None:
        impl = select_pipeline_impl(body)

        def keep(out):
            # filtering before the jitted return lets dead-code
            # elimination drop the unrequested planes' compute
            if planes is None:
                return out
            return {k: out[k] for k in planes if k in out}

        if tiled:
            n_bands = ny_b // band_rows

            def wrapped(xy2angular, disc, radii, anchors):
                def band(i):
                    row0 = (i * band_rows).astype(jnp.float64)
                    return keep(impl(
                        nx_b, band_rows, xy2angular, disc, radii, anchors,
                        row0=row0,
                    ))

                outs = lax.map(band, jnp.arange(n_bands))
                return {k: v.reshape(ny_b, nx_b) for k, v in outs.items()}
        else:
            def wrapped(xy2angular, disc, radii, anchors):
                return keep(
                    impl(nx_b, ny_b, xy2angular, disc, radii, anchors)
                )

        jfn = jax.jit(wrapped)
        state: dict[str, Any] = {'compiled': None}

        def fn(xy2angular, disc, radii, anchors):
            if isinstance(xy2angular, jax.core.Tracer):
                # inside another trace (compute_backplanes_batch's
                # lax.map): inline the program; executables take no tracers
                return wrapped(xy2angular, disc, radii, anchors)
            compiled = state['compiled']
            if compiled is not None:
                return compiled(xy2angular, disc, radii, anchors)
            return jfn(xy2angular, disc, radii, anchors)

        def precompile():
            # AOT trace+compile against the static anchor spec - no anchor
            # VALUES needed, so cold-start callers overlap this with the
            # scene-anchor computation (compute_backplanes)
            if state['compiled'] is None:
                state['compiled'] = jfn.lower(
                    jax.ShapeDtypeStruct((3, 3), jnp.float64),
                    jax.ShapeDtypeStruct((4,), jnp.float64),
                    jax.ShapeDtypeStruct((3,), jnp.float64),
                    _anchor_abstract_spec(),
                ).compile()

        fn.precompile = precompile
        _PIPELINE_CACHE[key] = fn

    if nx_b == nx and ny_b == ny:
        return fn

    def sliced(xy2angular, disc, radii, anchors):
        out = fn(xy2angular, disc, radii, anchors)
        return {k: v[:ny, :nx] for k, v in out.items()}

    sliced.precompile = fn.precompile
    return sliced


def compute_backplanes_batch(
    body, xy2angulars, discs, *, as_numpy: bool = True
) -> dict[str, Any]:
    """
    All default backplanes for N disc-parameter sets in ONE device
    dispatch: ``out[name]`` has shape ``(N, ny, nx)``. The frames run
    sequentially on device (keeping the single-frame pipeline's per-band
    working set) and share one dispatch. This is the natural shape for
    disc-fit parameter sweeps and GUI scrubbing.

    ``xy2angulars``: (N, 3, 3) pixel->angular affines (one per disc
    parameter set, see :meth:`BodyXY._get_xy2angular_matrix`);
    ``discs``: (N, 4) arrays of (x0, y0, r0, rotation).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    nx, ny = body.get_img_size()
    if nx <= 0 or ny <= 0:
        raise ValueError('nx and ny must be positive to generate backplanes')
    anchors = body._stable_cache.get('pipeline anchors (device)')
    if anchors is None:
        anchors = jax.device_put(body._get_pipeline_anchors())
        body._stable_cache['pipeline anchors (device)'] = anchors
    fn = get_fused_pipeline(body, nx, ny)

    cache_key = (
        'pipeline batch fn', nx, ny,
        getattr(body, '_pipeline_precision', DEFAULT_PRECISION),
        _robust_geodetic(body), _lst_quantization(),
        bool(body._optimize_speed),
        os.environ.get('PLANETMAPPER_TPU_LT_ITERS', '2'),
        os.environ.get('PLANETMAPPER_TPU_BAND_ROWS', '256'),
    )
    batch_fn = body._stable_cache.get(cache_key)
    if batch_fn is None:
        def run_batch(xy2a_b, disc_b, radii, anchors):
            return lax.map(
                lambda ab: fn(ab[0], ab[1], radii, anchors),
                (xy2a_b, disc_b),
            )

        batch_fn = jax.jit(run_batch)
        body._stable_cache[cache_key] = batch_fn

    out = batch_fn(
        jnp.asarray(xy2angulars, dtype=jnp.float64),
        jnp.asarray(discs, dtype=jnp.float64),
        np.asarray(body.radii, dtype=np.float64),
        anchors,
    )
    out = dict(out)
    if as_numpy:
        return {k: np.asarray(v) for k, v in out.items()}
    return out


def compute_backplanes(
    body, *, as_numpy: bool = True,
    names: tuple[str, ...] | list[str] | None = None,
):
    """
    Compute all default backplane images for a BodyXY in one fused device
    program. Returns a dict keyed by backplane name (same keys and value
    conventions as :attr:`BodyXY.backplanes` image getters).

    ``names`` restricts the program to a subset of the default planes
    (a separate, smaller compile: XLA drops the unused planes' compute).
    Use it for hot loops that stream a few planes; one-off requests
    should take the already-compiled full set.

    With ``as_numpy=False`` the planes stay on the device (call
    ``jax.block_until_ready`` on the dict to wait for them).
    """
    import jax

    nx, ny = body.get_img_size()
    if nx <= 0 or ny <= 0:
        raise ValueError('nx and ny must be positive to generate backplanes')
    fn = get_fused_pipeline(
        body, nx, ny,
        planes=None if names is None else tuple(names),
    )
    anchors = body._stable_cache.get('pipeline anchors (device)')
    if anchors is None:
        # Cold start: the scene-anchor programs and the fused pipeline's
        # trace+compile are independent, so run them concurrently - the
        # anchors in a thread (mostly GIL-free XLA compiles and
        # execution), the AOT pipeline compile here.
        import threading

        holder: dict[str, Any] = {}

        def _compute_anchors():
            try:
                holder['anchors'] = jax.device_put(
                    body._get_pipeline_anchors()
                )
            except BaseException as exc:  # re-raised on the caller
                holder['error'] = exc

        th = threading.Thread(
            target=_compute_anchors, name='planetmapper-anchors',
            daemon=True,
        )
        th.start()
        try:
            fn.precompile()
        finally:
            th.join()
        if 'error' in holder:
            raise holder['error']
        anchors = holder['anchors']
        body._stable_cache['pipeline anchors (device)'] = anchors
    out = fn(
        np.asarray(body._get_xy2angular_matrix()),
        np.asarray(body.get_disc_params(), dtype=np.float64),
        np.asarray(body.radii, dtype=np.float64),
        anchors,
    )
    if as_numpy:
        return {k: np.asarray(v) for k, v in out.items()}
    return dict(out)
