"""
Scene engine: per-(target, observer, time) precomputation and the batched
geometry functions that feed the device pixel pipeline.

This module replaces the CSPICE calls made throughout ``Body`` in the
reference (``subpnt`` body.py:538, ``subslr`` body.py:559, ``sincpt``
body.py:1010, ``illumf`` body.py:1925, ``spkcpt`` body.py:2833, ``et2lst``
body.py:2369, and the per-point ``pxfrm2`` light-time retargeting at
body.py:917-1006). Design inversion vs the reference: instead of one scalar
FFI call per point, a :class:`SceneEngine` exposes *batched* jitted JAX
functions over arrays of points; engines are cached per configuration so
compiled programs are reused across Body instances and times.

Internally everything works in:

- "obsvec": J2000 rectangular coordinates centred on the observer (the
  reference's canonical internal representation, body.py:876-887)
- "targvec": body-fixed rectangular coordinates centred on the target

with east-positive longitudes in radians (API layers apply planetographic
sign conventions).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np

from .ephemeris import (
    CLIGHT,
    SSB,
    Ephemeris,
    _host_device,
    _SMALL_CALL_ELEMENTS,
    parse_abcorr,
    stelab,
)
from .frames import BodyFrameModel
from . import geometry as geom


class SceneEngine:
    """
    Batched geometry engine for one (target, observer, frames, abcorr,
    illumination source) configuration. ``et`` is always an argument of the
    compiled functions, so one engine (and its compiled XLA programs)
    serves every observation epoch of that configuration.
    """

    def __init__(
        self,
        ephemeris: Ephemeris,
        *,
        target_id: int,
        observer_id: int,
        illumination_source_id: int,
        radii: tuple[float, float, float],
        frame_model: BodyFrameModel,
        abcorr: str = 'CN',
        et_ref: float = 0.0,
    ) -> None:
        self.ephemeris = ephemeris
        self.target_id = target_id
        self.observer_id = observer_id
        self.illumination_source_id = illumination_source_id
        self.radii = tuple(float(r) for r in radii)
        self.r_eq = self.radii[0]
        self.r_polar = self.radii[2]
        self.flattening = (self.r_eq - self.r_polar) / self.r_eq
        self.frame_model = frame_model
        self.abcorr = str(abcorr).strip().upper()
        self.corr = parse_abcorr(self.abcorr)
        # Epoch retargeting sign: reception corrections evaluate the
        # target at et - lt, transmission ('X*') at et + lt, geometric
        # ('NONE') at et itself (light times are still computed and
        # returned). Stellar aberration rotates by +v/c for reception
        # (stelab) and -v/c for transmission (stlabx).
        self._tau_scale = 0.0 if self.corr.geometric else (
            1.0 if self.corr.reception else -1.0
        )
        self._stelab_vsign = 1.0 if self.corr.reception else -1.0
        self.et_ref = float(et_ref)
        self._jit_cache: dict[str, Callable] = {}
        self._scene_spec: list[tuple[str, tuple, int]] | None = None

        # Chain-frozen SSB position functions (pure JAX in et)
        self._pos_t = ephemeris.position_fn(target_id, SSB, et_ref)
        self._pos_o = ephemeris.position_fn(observer_id, SSB, et_ref)
        if ephemeris.has_data_for(illumination_source_id, et_ref):
            self._pos_s = ephemeris.position_fn(
                illumination_source_id, SSB, et_ref
            )
        else:
            self._pos_s = None

    # ------------------------------------------------------------------
    # jit helper
    # ------------------------------------------------------------------
    def _jitted(self, name: str, fn: Callable) -> Callable:
        import jax

        cached = self._jit_cache.get(name)
        if cached is None:
            jitted = jax.jit(fn)

            def dispatch(*args, **kwargs):
                # Small (scalar-API) calls run on the host CPU backend:
                # a device dispatch plus result fetch costs more than the
                # few scalar operations themselves. Whether this still
                # pays for a local H100 is not measured. Bulk calls
                # (pixel/map grids) keep the accelerator; inputs already
                # committed to an accelerator stay there.
                leaves = jax.tree_util.tree_leaves((args, kwargs))
                if any(isinstance(a, jax.core.Tracer) for a in leaves):
                    # Called inside another traced program: inline as-is
                    return jitted(*args, **kwargs)
                small = all(np.size(a) <= _SMALL_CALL_ELEMENTS for a in leaves)
                if small and not any(
                    isinstance(a, jax.Array)
                    and next(iter(a.devices())).platform != 'cpu'
                    for a in leaves
                ):
                    with _host_device():
                        return jitted(*args, **kwargs)
                return jitted(*args, **kwargs)

            cached = dispatch
            self._jit_cache[name] = cached
        return cached

    # ------------------------------------------------------------------
    # Core building blocks (traced code - not public API)
    # ------------------------------------------------------------------
    def _apparent_target_center(self, et):
        """Apparent position of target centre from observer + light time."""
        import jax.numpy as jnp

        obs = self._pos_o(et)
        obs_pos, obs_vel = obs[..., :3], obs[..., 3:]
        lt = jnp.zeros(jnp.shape(et), dtype=jnp.float64)
        n_iter = 3 if self.corr.converged else 1
        if self.corr.geometric:
            n_iter = 0
        targ = None
        for _ in range(n_iter + 1):
            targ = self._pos_t(et - self._tau_scale * lt)
            r = targ[..., :3] - obs_pos
            lt = jnp.linalg.norm(r, axis=-1) / CLIGHT
        pos = targ[..., :3] - obs_pos
        if self.corr.stellar:
            pos = stelab(pos, self._stelab_vsign * obs_vel / CLIGHT)
        return pos, lt, obs_pos, obs_vel

    def _ray_to_geometric(self, d, obs_vel):
        """
        Convert an apparent ray direction to the geometric direction by
        removing stellar aberration (no-op unless '+S' is active).
        """
        if not self.corr.stellar:
            return d
        return stelab(d, -self._stelab_vsign * obs_vel / CLIGHT)

    def _sincpt_core(self, et, radii, obsvec_norm, lt0):
        """
        Surface intercept of rays from the observer (``sincpt`` equivalent):
        per-ray converged-Newtonian light time, target position and frame
        orientation re-evaluated at each ray's emission epoch.

        Returns ``(targvec, trgepc, found)``; targvec is NaN where the ray
        misses the ellipsoid.
        """
        import jax.numpy as jnp

        radii = jnp.asarray(radii)
        obs = self._pos_o(et)
        obs_pos, obs_vel = obs[..., :3], obs[..., 3:]
        d = self._ray_to_geometric(obsvec_norm, obs_vel)

        lt = jnp.broadcast_to(lt0, d.shape[:-1])
        n_iter = 1 if self.corr.geometric else (4 if self.corr.converged else 1)
        spoint = None
        found = None
        s = None
        for _ in range(n_iter):
            tau = et - self._tau_scale * lt
            targ_pos = self._pos_t(tau)[..., :3] - obs_pos
            o_bf = -self.frame_model.rotate_j2000_to_bodyfixed(tau, targ_pos)
            d_bf = self.frame_model.rotate_j2000_to_bodyfixed(
                tau, jnp.broadcast_to(d, targ_pos.shape)
            )
            s, found = geom.ray_ellipsoid_intercept(o_bf, d_bf, radii)
            spoint = o_bf + s[..., None] * d_bf
            dist = jnp.where(found, s, lt0 * CLIGHT)
            lt = dist / CLIGHT
        trgepc = et - self._tau_scale * lt
        spoint = jnp.where(found[..., None], spoint, jnp.nan)
        return spoint, trgepc, found

    def _illumf_core(self, et, radii, targvec):
        """
        Illumination angles + visibility/lit flags for body-fixed surface
        points (``illumf`` equivalent). Per-point light time epochs for the
        observer ray and for the sun direction.
        """
        import jax.numpy as jnp

        radii = jnp.asarray(radii)
        obs = self._pos_o(et)
        obs_pos = obs[..., :3]
        # 'LT' needs TWO passes here: the first computes the point light
        # time at tau = et (the loop seeds lt = 0), the second evaluates
        # the geometry at the corrected epoch - one correction, matching
        # CSPICE illumf 'LT'. (A single pass applied no correction.)
        n_iter = 4 if self.corr.converged else 2
        if self.corr.geometric:
            n_iter = 1

        # Light time observer -> surface point
        lt = jnp.zeros(targvec.shape[:-1], dtype=jnp.float64)
        srfvec_j2000 = None
        tau = None
        for _ in range(n_iter):
            tau = et - self._tau_scale * lt
            targ_pos = self._pos_t(tau)[..., :3] - obs_pos
            point_j2000 = targ_pos + self.frame_model.rotate_bodyfixed_to_j2000(
                tau, targvec
            )
            srfvec_j2000 = point_j2000
            lt = jnp.linalg.norm(point_j2000, axis=-1) / CLIGHT

        srfvec_bf = self.frame_model.rotate_j2000_to_bodyfixed(
            tau, srfvec_j2000
        )

        # Apparent sun direction from the surface point at epoch tau
        if self._pos_s is not None:
            point_ssb = self._pos_t(tau)[
                ..., :3
            ] + self.frame_model.rotate_bodyfixed_to_j2000(tau, targvec)
            lt_s = jnp.zeros(targvec.shape[:-1], dtype=jnp.float64)
            sun_dir_j2000 = None
            for _ in range(n_iter):
                sun_pos = self._pos_s(tau - self._tau_scale * lt_s)[..., :3]
                sun_dir_j2000 = sun_pos - point_ssb
                lt_s = jnp.linalg.norm(sun_dir_j2000, axis=-1) / CLIGHT
            sun_dir_bf = self.frame_model.rotate_j2000_to_bodyfixed(
                tau, sun_dir_j2000
            )
        else:
            sun_dir_bf = jnp.full_like(targvec, jnp.nan)

        normal = geom.surface_normal(targvec, radii)
        phase = geom.vector_separation(sun_dir_bf, -srfvec_bf)
        incidence = geom.vector_separation(normal, sun_dir_bf)
        emission = geom.vector_separation(normal, -srfvec_bf)
        visibl = jnp.sum(normal * (-srfvec_bf), axis=-1) > 0.0
        lit = jnp.sum(normal * sun_dir_bf, axis=-1) > 0.0
        return phase, incidence, emission, visibl, lit

    # NOTE: _pos_t/_pos_o/_pos_s are SSB-relative position functions
    # (observer argument SSB), so the arithmetic above is consistent.

    def _spkcpt_core(self, et, targvec):
        """
        State of constant body-fixed points relative to the observer
        (``spkcpt`` with refloc='OBSERVER'): per-point light-time corrected
        position and velocity (including the frame-rotation contribution and
        the d(lt)/d(et) factor), plus light time.
        """
        import jax

        import jax.numpy as jnp

        obs = self._pos_o(et)
        obs_pos, obs_vel = obs[..., :3], obs[..., 3:]
        n_iter = 4 if self.corr.converged else 1
        if self.corr.geometric:
            n_iter = 1

        def point_state_ssb(tau):
            """Inertial (SSB) state of the body-fixed points at time tau."""
            targ = self._pos_t(tau)

            def pos_of(t):
                return self.frame_model.rotate_bodyfixed_to_j2000(t, targvec)

            off, doff = jax.jvp(pos_of, (tau,), (jnp.ones_like(tau),))
            pos = targ[..., :3] + off
            vel = targ[..., 3:] + doff
            return pos, vel

        lt = jnp.zeros(targvec.shape[:-1], dtype=jnp.float64)
        for _ in range(n_iter):
            tau = et - self._tau_scale * lt
            p_pos, p_vel = point_state_ssb(tau)
            rel = p_pos - obs_pos
            lt = jnp.linalg.norm(rel, axis=-1) / CLIGHT
        tau = et - self._tau_scale * lt
        p_pos, p_vel = point_state_ssb(tau)
        rel = p_pos - obs_pos
        dist = jnp.linalg.norm(rel, axis=-1)
        rhat = rel / dist[..., None]
        if self.corr.geometric:
            vel = p_vel - obs_vel
        else:
            rv_t = jnp.sum(rhat * p_vel, axis=-1)
            rv_o = jnp.sum(rhat * obs_vel, axis=-1)
            dltdt = (rv_t - rv_o) / (CLIGHT + rv_t)
            vel = p_vel * (1.0 - dltdt)[..., None] - obs_vel
        if self.corr.stellar:
            # NOTE the returned velocity omits the (tiny, ~|a_obs| lt/c)
            # derivative of the stellar correction itself
            rel = stelab(rel, self._stelab_vsign * obs_vel / CLIGHT)
        return jnp.concatenate([rel, vel], axis=-1), dist / CLIGHT

    # ------------------------------------------------------------------
    # Reference "model A" transforms: anchored at the sub-observer point
    # (exact mirrors of body.py:917-1006)
    # ------------------------------------------------------------------
    def _targvec2obsvec_core(self, targvec, sub):
        import jax.numpy as jnp

        off = targvec - sub['subpoint_targvec']
        dist_offset = (
            jnp.linalg.norm(sub['subpoint_rayvec'] + off, axis=-1)
            - sub['subpoint_distance']
        )
        tau = sub['subpoint_et'] - dist_offset / CLIGHT
        rot = self.frame_model.rotate_bodyfixed_to_j2000(tau, off)
        return sub['subpoint_obsvec'] + rot

    def _obsvec2targvec_core(self, obsvec, sub):
        import jax.numpy as jnp

        off = obsvec - sub['subpoint_obsvec']
        dist_offset = (
            jnp.linalg.norm(-sub['subpoint_rayvec'] + off, axis=-1)
            - sub['subpoint_distance']
        )
        tau = sub['subpoint_et'] - dist_offset / CLIGHT
        rot = self.frame_model.rotate_j2000_to_bodyfixed(tau, off)
        return sub['subpoint_targvec'] + rot

    # ------------------------------------------------------------------
    # Scene constants (Body.__init__ equivalent, one jitted program)
    # ------------------------------------------------------------------
    def scene_constants(self, et: float, radii=None) -> dict:
        """
        All per-scene device constants: apparent target centre, sub-observer
        and sub-solar points. One jitted program per engine; ``radii`` is a
        traced argument so altitude-adjusted surfaces (reference
        body.py:172-230) reuse the compiled program.
        """
        if radii is None:
            radii = self.radii
        import jax

        radii = np.asarray(radii, dtype=np.float64)
        # ONE packed transfer: jax.device_get on the output dict costs a
        # device round trip PER LEAF (19 fields here), so the jitted
        # program concatenates every field into a single flat f64 vector
        # that is fetched with one sync.
        spec = self._scene_spec
        if spec is None:
            shapes = jax.eval_shape(
                self._scene_constants_impl,
                jax.ShapeDtypeStruct((), np.float64),
                jax.ShapeDtypeStruct((3,), np.float64),
            )
            spec = [
                (key, shapes[key].shape, int(np.prod(shapes[key].shape, dtype=int)))
                for key in sorted(shapes)
            ]
            self._scene_spec = spec
        fn = self._jitted('scene_constants_packed', self._scene_constants_packed)
        flat = np.asarray(fn(et, radii))
        out = {}
        i = 0
        for key, shape, size in spec:
            out[key] = flat[i : i + size].reshape(shape)
            i += size
        return out

    def _scene_constants_packed(self, et, radii):
        import jax.numpy as jnp

        out = self._scene_constants_impl(et, radii)
        return jnp.concatenate(
            [jnp.ravel(out[key]).astype(jnp.float64) for key in sorted(out)]
        )

    def _scene_constants_impl(self, et, radii):
        import jax.numpy as jnp

        radii = jnp.asarray(radii)
        target_obsvec, target_lt, obs_pos, obs_vel = (
            self._apparent_target_center(et)
        )

        # Sub-observer point (method INTERCEPT/ELLIPSOID): the ray is
        # re-aimed at the target centre's position at each refined epoch
        # (this is CSPICE subpnt's convention - it differs from holding the
        # apparent-centre ray fixed by ~the target's transverse motion over
        # r/c, i.e. a few km on the surface).
        n_iter = 1 if self.corr.geometric else (4 if self.corr.converged else 1)
        lt = target_lt
        sub_targvec = None
        o_bf = None
        for _ in range(n_iter):
            tau = et - self._tau_scale * lt
            targ_pos = self._pos_t(tau)[..., :3] - obs_pos
            if self.corr.stellar:
                # subpnt works entirely in apparent geometry: the target is
                # placed at its stellar-aberration-corrected position and
                # the ray aims at that apparent centre.
                targ_pos = stelab(
                    targ_pos, self._stelab_vsign * obs_vel / CLIGHT
                )
            d = targ_pos / jnp.linalg.norm(targ_pos, axis=-1, keepdims=True)
            rot = self.frame_model.j2000_to_bodyfixed_matrix(tau)
            o_bf = -jnp.einsum('...ij,...j->...i', rot, targ_pos)
            d_bf = jnp.einsum('...ij,...j->...i', rot, d)
            s, _found = geom.ray_ellipsoid_intercept(o_bf, d_bf, radii)
            sub_targvec = o_bf + s[..., None] * d_bf
            lt = s / CLIGHT
        sub_et = et - self._tau_scale * lt
        subpoint_rayvec = sub_targvec - o_bf  # observer -> subpoint, bf frame
        subpoint_distance = jnp.linalg.norm(subpoint_rayvec, axis=-1)
        m_sub = self.frame_model.bodyfixed_to_j2000_matrix(sub_et)
        subpoint_obsvec = jnp.einsum('...ij,...j->...i', m_sub, subpoint_rayvec)

        out = dict(
            target_obsvec=target_obsvec,
            target_lt=target_lt,
            obs_pos_ssb=obs_pos,
            obs_vel_ssb=obs_vel,
            subpoint_targvec=sub_targvec,
            subpoint_et=sub_et,
            subpoint_rayvec=subpoint_rayvec,
            subpoint_distance=subpoint_distance,
            subpoint_obsvec=subpoint_obsvec,
        )

        # Sub-solar point: intercept towards the apparent sun direction
        # seen from the observer... per SPICE subslr: the point where the
        # ray from the sun to the target centre intercepts the surface.
        if self._pos_s is not None and self.illumination_source_id != self.target_id:
            subsol = self._subslr_impl(et, radii, out)
            out.update(subsol)
        else:
            out['subsol_targvec'] = jnp.full(3, jnp.nan)
            out['subsol_et'] = jnp.full((), jnp.nan)

        # Derived scene values folded into the same program: each separate
        # eager call costs a full device round trip at Body construction
        # (east-positive radians here; the Body layer applies the W/E sign)
        re = radii[0]
        f = (radii[0] - radii[2]) / radii[0]
        lon_sp, lat_sp, _ = geom.rect_to_geodetic(sub_targvec, re, f)
        out['subpoint_lon_e_rad'] = lon_sp
        out['subpoint_lat_rad'] = lat_sp
        _r, ra_sp, dec_sp = geom.rect_to_radec(subpoint_obsvec)
        out['subpoint_ra_rad'] = ra_sp
        out['subpoint_dec_rad'] = dec_sp
        lon_ss, lat_ss, _ = geom.rect_to_geodetic(out['subsol_targvec'], re, f)
        out['subsol_lon_e_rad'] = lon_ss
        out['subsol_lat_rad'] = lat_ss
        # Equatorial (ring) plane in obsvec space (reference body.py:582-588)
        np_obsvec = self._targvec2obsvec_core(
            jnp.array([0.0, 0.0, 1.0]) * radii[2], out
        )
        normal, constant = geom.plane_from_normal_point(
            np_obsvec - target_obsvec, target_obsvec
        )
        out['ring_plane_normal'] = normal
        out['ring_plane_constant'] = constant
        return out

    def _subslr_impl(self, et, radii, consts):
        """
        Sub-solar point, method INTERCEPT/ELLIPSOID (``subslr``): intercept
        on the target of the ray from the sun towards the target's centre,
        with the target epoch matching ``subpnt``'s (et - lt to subpoint).
        """
        import jax.numpy as jnp

        radii = jnp.asarray(radii)
        n_iter = 4 if self.corr.converged else 1
        obs_pos = consts['obs_pos_ssb']

        # Epoch iteration: trgepc = et - (light time observer -> sub-solar
        # point), exactly as CSPICE subslr converges it.
        tau = consts['subpoint_et']
        spoint = None
        for _ in range(n_iter):
            targ_pos_ssb = self._pos_t(tau)[..., :3]
            # Apparent sun as seen from the target centre at tau
            lt_s = jnp.zeros((), dtype=jnp.float64)
            sun_vec = None
            for _ in range(n_iter):
                sun_pos = self._pos_s(tau - lt_s)[..., :3]
                sun_vec = sun_pos - targ_pos_ssb
                lt_s = jnp.linalg.norm(sun_vec, axis=-1) / CLIGHT
            rot = self.frame_model.j2000_to_bodyfixed_matrix(tau)
            sun_bf = jnp.einsum('...ij,...j->...i', rot, sun_vec)
            d_bf = -sun_bf / jnp.linalg.norm(sun_bf, axis=-1, keepdims=True)
            s, found = geom.ray_ellipsoid_intercept(sun_bf, d_bf, radii)
            spoint = jnp.where(found, sun_bf + s[..., None] * d_bf, jnp.nan)
            # Distance observer -> sub-solar point sets the next epoch
            m_bf2j = self.frame_model.bodyfixed_to_j2000_matrix(tau)
            spoint_ssb = targ_pos_ssb + jnp.einsum(
                '...ij,...j->...i', m_bf2j, spoint
            )
            dist = jnp.linalg.norm(spoint_ssb - obs_pos, axis=-1)
            tau = et - dist / CLIGHT
        return dict(subsol_targvec=spoint, subsol_et=tau)

    # ------------------------------------------------------------------
    # Public batched functions (jitted, cached per engine)
    # ------------------------------------------------------------------
    def sincpt(self, et, radii, obsvec_norm, lt0):
        fn = self._jitted('sincpt', self._sincpt_core)
        return fn(et, np.asarray(radii, dtype=np.float64), obsvec_norm, lt0)

    def illumf(self, et, radii, targvec):
        fn = self._jitted('illumf', self._illumf_core)
        return fn(et, np.asarray(radii, dtype=np.float64), targvec)

    def spkcpt(self, et, targvec):
        fn = self._jitted('spkcpt', self._spkcpt_core)
        return fn(et, targvec)

    def targvec2obsvec(self, targvec, sub):
        fn = self._jitted('targvec2obsvec', self._targvec2obsvec_core)
        return fn(targvec, sub)

    def obsvec2targvec(self, obsvec, sub):
        fn = self._jitted('obsvec2targvec', self._obsvec2targvec_core)
        return fn(obsvec, sub)

    # -- limb (limbpt equivalent) ------------------------------------------
    def limbpt(self, et, radii, rolls, sub):
        fn = self._jitted('limbpt', self._limbpt_core)
        return fn(
            et, np.asarray(radii, dtype=np.float64),
            np.asarray(rolls, dtype=np.float64), sub,
        )

    def _limbpt_core(self, et, radii, rolls, sub):
        """
        Limb points (``limbpt`` with method TANGENT/ELLIPSOID and
        corloc='ELLIPSOID LIMB'): one point per cutting half-plane. The
        half-planes contain the observer-target axis; roll=0 contains the
        reference vector [0,0,1] and roll increases right-handed about the
        axis. Per-point light-time epochs are converged iteratively.

        For an ellipsoid the tangent points are exactly the limb ellipse
        (``edlimb``), so each point is the intersection of that ellipse
        with its half-plane - closed form per iteration, fully batched.
        """
        import jax.numpy as jnp

        radii = jnp.asarray(radii)
        target_obsvec, target_lt, obs_pos, obs_vel = (
            self._apparent_target_center(et)
        )
        axis = target_obsvec / jnp.linalg.norm(target_obsvec, axis=-1)
        # CSPICE limbpt expresses refvec in the fixref (body-fixed) frame
        # (reference body.py:1938-1964 passes refvec=[0,0,1] with
        # fixref=target_frame): [0,0,1] is the spin axis, expressed here
        # in J2000 via the frame rotation at the center's corrected epoch
        rot_c = self.frame_model.j2000_to_bodyfixed_matrix(
            sub['subpoint_et']
        )
        refvec = rot_c[2, :]  # = rot_c^T @ [0,0,1]
        e1 = refvec - jnp.sum(refvec * axis) * axis
        e1 = e1 / jnp.linalg.norm(e1)
        # CSPICE's half-plane axis points target->observer (opposite of
        # ``axis`` here), so positive roll is LEFT-handed about our axis
        e2 = -jnp.cross(axis, e1)
        # Half-plane directions for each roll angle (J2000)
        v_roll = (
            e1 * jnp.cos(rolls)[..., None] + e2 * jnp.sin(rolls)[..., None]
        )
        plane_normal = jnp.cross(axis, v_roll)  # (npts, 3)

        tau = jnp.full(rolls.shape, sub['subpoint_et'], dtype=jnp.float64)
        points = None
        for _ in range(3):
            targ_pos = self._pos_t(tau)[..., :3] - obs_pos  # (npts, 3)
            rot = self.frame_model.j2000_to_bodyfixed_matrix(tau)
            o_bf = -jnp.einsum('...ij,...j->...i', rot, targ_pos)
            n_bf = jnp.einsum('...ij,...j->...i', rot, plane_normal)
            v_bf = jnp.einsum('...ij,...j->...i', rot, v_roll)
            center, u, v = geom.limb_ellipse(o_bf, radii)
            # Solve n . (center + u cos t + v sin t - o_bf) = 0
            a_c = jnp.sum(n_bf * u, axis=-1)
            b_c = jnp.sum(n_bf * v, axis=-1)
            c_c = jnp.sum(n_bf * (o_bf - center), axis=-1)
            amp = jnp.hypot(a_c, b_c)
            phase0 = jnp.arctan2(b_c, a_c)
            delta = jnp.arccos(jnp.clip(c_c / amp, -1.0, 1.0))
            t1 = phase0 + delta
            t2 = phase0 - delta
            q1 = center + u * jnp.cos(t1)[..., None] + v * jnp.sin(t1)[..., None]
            q2 = center + u * jnp.cos(t2)[..., None] + v * jnp.sin(t2)[..., None]
            side1 = jnp.sum((q1 - o_bf) * v_bf, axis=-1)
            points = jnp.where(side1[..., None] >= 0.0, q1, q2)
            dist = jnp.linalg.norm(points - o_bf, axis=-1)
            tau = et - dist / CLIGHT
        return points

    # -- terminator (termpt equivalent) ------------------------------------
    def termpt(self, et, radii, rolls, sub, umbral: bool = True,
               source_radius: float | None = None):
        if source_radius is None:
            source_radius = self._source_radius()
        fn = self._jitted(
            f'termpt_{umbral}', partial(self._termpt_core, umbral=umbral)
        )
        return fn(
            et, np.asarray(radii, dtype=np.float64),
            np.asarray(rolls, dtype=np.float64), sub,
            float(source_radius),
        )

    def _source_radius(self) -> float:
        try:
            return float(
                self.ephemeris._pool.bodvar(self.illumination_source_id, 'RADII')[0]
            )
        except Exception:
            return 0.0

    def _termpt_core(self, et, radii, rolls, sub, source_radius, *, umbral):
        """
        Terminator points (``termpt`` with method UMBRAL/TANGENT/ELLIPSOID
        or PENUMBRAL/..., corloc='ELLIPSOID TERMINATOR'): the cutting
        half-planes contain the target-source axis. Each point satisfies
        the grazing-ray condition n.s_hat = -/+ sin(angular radius of the
        source), solved by vectorised bisection along each half-plane's
        surface arc, with per-point light-time epochs.
        """
        import jax.numpy as jnp

        radii = jnp.asarray(radii)
        _, _, obs_pos, _ = self._apparent_target_center(et)

        tau = jnp.full(rolls.shape, sub['subpoint_et'], dtype=jnp.float64)
        points = None
        for _ in range(3):
            targ_ssb = self._pos_t(tau)[..., :3]
            # Apparent sun from target centre at tau (per point)
            lt_s = jnp.zeros(rolls.shape, dtype=jnp.float64)
            sun_vec = None
            for _ in range(3):
                sun_pos = self._pos_s(tau - lt_s)[..., :3]
                sun_vec = sun_pos - targ_ssb
                lt_s = jnp.linalg.norm(sun_vec, axis=-1) / CLIGHT
            rot = self.frame_model.j2000_to_bodyfixed_matrix(tau)
            sun_bf = jnp.einsum('...ij,...j->...i', rot, sun_vec)

            axis = sun_bf / jnp.linalg.norm(sun_bf, axis=-1, keepdims=True)
            # CSPICE termpt expresses refvec in the fixref (body-fixed)
            # frame: [0,0,1] IS the spin axis - no frame conversion
            # (reference body.py:2510-2527 passes refvec=[0,0,1] with
            # fixref=target_frame)
            ref_bf = jnp.broadcast_to(
                jnp.array([0.0, 0.0, 1.0]), sun_bf.shape
            )
            e1 = ref_bf - jnp.sum(ref_bf * axis, axis=-1, keepdims=True) * axis
            e1 = e1 / jnp.linalg.norm(e1, axis=-1, keepdims=True)
            e2 = jnp.cross(axis, e1)
            v_roll = (
                e1 * jnp.cos(rolls)[..., None] + e2 * jnp.sin(rolls)[..., None]
            )

            def surface_point(psi):
                w = axis * jnp.cos(psi)[..., None] + v_roll * jnp.sin(psi)[..., None]
                return geom.radial_surface_point(w, radii)

            def g(psi):
                q = surface_point(psi)
                n = geom.surface_normal(q, radii)
                to_sun = sun_bf - q
                dist_sun = jnp.linalg.norm(to_sun, axis=-1)
                s_hat = to_sun / dist_sun[..., None]
                sin_alpha = jnp.clip(source_radius / dist_sun, 0.0, 1.0)
                target = -sin_alpha if umbral else sin_alpha
                return jnp.sum(n * s_hat, axis=-1) - target

            # Bisection: g decreases from ~+1 at psi=0 (subsolar) to ~-1 at
            # psi=pi (antisolar); exactly one root in between.
            lo = jnp.zeros(rolls.shape, dtype=jnp.float64)
            hi = jnp.full(rolls.shape, jnp.pi, dtype=jnp.float64)
            for _ in range(55):
                mid = 0.5 * (lo + hi)
                gm = g(mid)
                lo = jnp.where(gm > 0.0, mid, lo)
                hi = jnp.where(gm > 0.0, hi, mid)
            psi = 0.5 * (lo + hi)
            points = surface_point(psi)

            # Light time epoch from the observer to each point
            m_bf2j = jnp.swapaxes(rot, -1, -2)
            point_j2000 = (targ_ssb - obs_pos) + jnp.einsum(
                '...ij,...j->...i', m_bf2j, points
            )
            dist = jnp.linalg.norm(point_j2000, axis=-1)
            tau = et - dist / CLIGHT
        return points

    # -- local solar time --------------------------------------------------
    def solar_longitude(self, et):
        """
        Planetocentric east longitude of the apparent sun (the sub-solar
        meridian used for local solar time, ``et2lst`` equivalent).
        """
        fn = self._jitted('solar_longitude', self._solar_longitude_impl)
        return fn(et)

    def _solar_longitude_impl(self, et):
        import jax.numpy as jnp

        # Apparent sun from target centre with LT+S (CSPICE et2lst uses the
        # apparent solar position)
        targ_pos_ssb = self._pos_t(et)[..., :3]
        lt_s = jnp.zeros(jnp.shape(et), dtype=jnp.float64)
        sun_vec = None
        for _ in range(4):
            sun_pos = self._pos_s(et - lt_s)[..., :3]
            sun_vec = sun_pos - targ_pos_ssb
            lt_s = jnp.linalg.norm(sun_vec, axis=-1) / CLIGHT
        # stellar aberration for an observer at the target centre
        targ_vel_ssb = self._pos_t(et)[..., 3:]
        sun_vec = stelab(sun_vec, targ_vel_ssb / CLIGHT)
        rot = self.frame_model.j2000_to_bodyfixed_matrix(et)
        sun_bf = jnp.einsum('...ij,...j->...i', rot, sun_vec)
        return jnp.arctan2(sun_bf[..., 1], sun_bf[..., 0])
