"""
Ephemeris engine: SPK chain resolution and aberration-corrected states.

JAX replacement for ``spice.spkezr``/``spkpos``/``spkcpt`` (reference
call sites: planetmapper/base.py:828, body.py:2830-2856). Segment *selection*
(which kernels cover which body at which epoch) happens on the host when a
scene is built; state *evaluation* is pure JAX - batched Chebyshev / SGP4 /
equinoctial evaluation that runs on device and is differentiable in time.

Conventions match SPICE:

- States are (..., 6) arrays [km, km/s] in the J2000 inertial frame.
- Reception-case light time: target evaluated at ``et - lt`` with ``lt``
  converged by fixed-point iteration ('LT' = 1 pass, 'CN' = converged).
- Velocity of a light-time corrected state is the derivative of the
  corrected position with respect to observation time (d lt/d et term).
- Stellar aberration ('+S') rotates the position toward the observer's
  SSB-relative velocity by the standard ``stelab`` construction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..kernels import sgp4 as sgp4_mod
from ..kernels.pool import KernelPool
from ..kernels.spk import (
    ChebyshevData,
    EquinoctialData,
    LagrangeData,
    SpkSegment,
    TleData,
    TwoBodyData,
    chebyshev_state,
    equinoctial_position,
    lagrange_state,
)
from .inertial import frame_id_to_j2000_matrix
from .timebase import SPEED_OF_LIGHT_KM_S as CLIGHT

SSB = 0

#: Concrete (non-traced) calls whose largest input is at most this many
#: elements run on the host CPU backend: a scalar device dispatch plus
#: fetch costs far more than the compute (the first execution also
#: uploads the program and its embedded ephemeris constants).
_SMALL_CALL_ELEMENTS = 4096


def _host_device():
    """Context manager selecting the local CPU backend (no-op without one)."""
    import contextlib

    import jax

    try:
        cpu = jax.devices('cpu')[0]
    except RuntimeError:  # pragma: no cover - CPU backend always exists
        return contextlib.nullcontext()
    return jax.default_device(cpu)


class InsufficientDataError(Exception):
    """No SPK segment covers the requested body/time (SpiceSPKINSUFFDATA)."""


class Ephemeris:
    """Chain-resolving state evaluator over a kernel pool's SPK segments."""

    def __init__(self, pool: KernelPool) -> None:
        self._pool = pool
        self._n_segments_seen = 0
        self._by_target: dict[int, list[SpkSegment]] = {}
        self._state_fn_cache: dict[tuple, Callable] = {}
        self._chain_cache: dict[tuple, tuple] = {}
        self._refresh()

    def _refresh(self) -> None:
        segments = self._pool.spk_segments
        if len(segments) == self._n_segments_seen:
            return
        self._by_target.clear()
        self._state_fn_cache.clear()
        self._chain_cache.clear()
        # Precedence: later-loaded files first; later segments within a file
        # first (matching the SPICE segment search order).
        for seg in reversed(segments):
            self._by_target.setdefault(seg.target, []).append(seg)
        self._n_segments_seen = len(segments)

    def segment_covering(self, body: int, et: float) -> SpkSegment:
        self._refresh()
        for seg in self._by_target.get(body, ()):  # precedence order
            if seg.covers(et):
                return seg
        raise InsufficientDataError(
            f'Insufficient ephemeris data for body {body} at et={et}. '
            'Check that suitable SPK kernels are loaded.'
        )

    def has_data_for(self, body: int, et: float) -> bool:
        try:
            self.segment_covering(body, et)
            return True
        except InsufficientDataError:
            return False

    def chain(self, body: int, et: float) -> list[SpkSegment]:
        """Segments linking ``body`` up towards the root of its center tree."""
        chain: list[SpkSegment] = []
        current = body
        while current != SSB:
            try:
                seg = self.segment_covering(current, et)
            except InsufficientDataError:
                if chain:
                    break  # partial chain; common-ancestor logic may succeed
                raise
            chain.append(seg)
            current = seg.center
        return chain

    # -- single-segment evaluation (pure JAX in et) -------------------------
    def segment_state(self, seg: SpkSegment, et):
        """State (..., 6) of seg.target relative to seg.center in J2000."""
        import jax
        import jax.numpy as jnp

        data = seg.data
        if isinstance(data, ChebyshevData):
            state = chebyshev_state(data, et)
        elif isinstance(data, EquinoctialData):
            pos_fn = lambda t: equinoctial_position(data, t)
            et_arr = jnp.asarray(et, dtype=jnp.float64)
            pos, vel = jax.jvp(pos_fn, (et_arr,), (jnp.ones_like(et_arr),))
            state = jnp.concatenate([pos, vel], axis=-1)
        elif isinstance(data, TleData):
            state = self._tle_state(data, et)
        elif isinstance(data, LagrangeData):
            if data.hermite:
                # type 13: velocity is the Hermite interpolant's exact
                # derivative (spke13 semantics)
                pos_fn = lambda t: lagrange_state(data, t)
                et_arr = jnp.asarray(et, dtype=jnp.float64)
                pos, vel = jax.jvp(
                    pos_fn, (et_arr,), (jnp.ones_like(et_arr),)
                )
                state = jnp.concatenate([pos, vel], axis=-1)
            else:
                # type 9: the segment's stored velocity knots are
                # Lagrange-interpolated directly (spke09 semantics)
                state = lagrange_state(data, et)
        elif isinstance(data, TwoBodyData):
            state = self._two_body_state(data, et)
        else:
            raise InsufficientDataError(
                f'SPK data type {seg.data_type} (segment for body '
                f'{seg.target} in {seg.source!r}) is not supported'
            )
        if seg.frame_id != 1:
            rot = jnp.asarray(frame_id_to_j2000_matrix(seg.frame_id))
            pos = state[..., :3] @ rot.T
            vel = state[..., 3:] @ rot.T
            state = jnp.concatenate([pos, vel], axis=-1)
        return state

    def _tle_state(self, data: TleData, et):
        """
        Type 10: propagate the bracketing element sets with SGP4 and blend
        linearly between their epochs (single set outside the covered span).
        Packet selection is a device-side searchsorted, so this is jit/vmap
        compatible with traced times.
        """
        import jax.numpy as jnp

        params = getattr(data, '_sgp4_params', None)
        if params is None:
            params = sgp4_mod.sgp4_init_packets(data.constants, data.packets)
            data._sgp4_params = params  # type: ignore[attr-defined]

        et_arr = jnp.asarray(et, dtype=jnp.float64)
        epochs = jnp.asarray(data.epochs)
        n = len(data.epochs)
        hi = jnp.clip(jnp.searchsorted(epochs, et_arr), 0, n - 1)
        lo = jnp.clip(hi - 1, 0, n - 1)
        state_lo = sgp4_mod.tle_state_j2000_at_index(
            data.constants, params, lo, et_arr
        )
        state_hi = sgp4_mod.tle_state_j2000_at_index(
            data.constants, params, hi, et_arr
        )
        e_lo = epochs[lo]
        e_hi = epochs[hi]
        gap = jnp.where(e_hi > e_lo, e_hi - e_lo, 1.0)
        w = jnp.clip((et_arr - e_lo) / gap, 0.0, 1.0)[..., None]
        return state_lo * (1.0 - w) + state_hi * w

    def _two_body_state(self, data: TwoBodyData, et):
        """
        Type 5: two-body propagation of the bracketing discrete states,
        blended linearly in time (SPICE type 5 weighting). Device-side
        bracketing.
        """
        import jax.numpy as jnp

        et_arr = jnp.asarray(et, dtype=jnp.float64)
        epochs = jnp.asarray(data.epochs)
        states = jnp.asarray(data.states)
        n = len(data.epochs)
        hi = jnp.clip(jnp.searchsorted(epochs, et_arr), 0, n - 1)
        lo = jnp.clip(hi - 1, 0, n - 1)
        s_lo = _propagate_two_body(data.gm, states[lo], epochs[lo], et_arr)
        s_hi = _propagate_two_body(data.gm, states[hi], epochs[hi], et_arr)
        e_lo = epochs[lo]
        e_hi = epochs[hi]
        gap = jnp.where(e_hi > e_lo, e_hi - e_lo, 1.0)
        w = jnp.clip((et_arr - e_lo) / gap, 0.0, 1.0)[..., None]
        return s_lo * (1.0 - w) + s_hi * w

    # -- chain evaluation ----------------------------------------------------
    def rel_state_geometric(self, target: int, observer: int, et):
        """Geometric state of target relative to observer at et (J2000)."""
        et0 = float(np.asarray(et, dtype=np.float64).reshape(-1)[0])
        return self.position_fn(target, observer, et0)(et)

    def position_fn(self, target: int, observer: int, et_ref: float) -> Callable:
        """
        A pure function ``et -> geometric position`` with the chain frozen at
        ``et_ref`` (traceable under jit/vmap; valid while ``et`` stays within
        the covering segments, i.e. for light-time-scale offsets).
        """
        segs_t, segs_o = self._relative_chains(target, observer, et_ref)

        def fn(et):
            import jax.numpy as jnp

            state = jnp.zeros(np.shape(et) + (6,), dtype=jnp.float64)
            for seg in segs_t:
                state = state + self.segment_state(seg, et)
            for seg in segs_o:
                state = state - self.segment_state(seg, et)
            return state

        return fn

    def _relative_chains(self, target: int, observer: int, et0: float):
        # Cache keyed on a coarse time bucket (chains are stable over spans
        # far longer than a day), but resolved at the *actual* epoch so
        # segment-boundary epochs are handled exactly.
        self._refresh()
        key = (target, observer, round(et0 / 86400.0))
        cached = self._chain_cache.get(key)
        if cached is None:
            cached = self._relative_chains_impl(target, observer, et0)
            self._chain_cache[key] = cached
        return cached

    def _relative_chains_impl(self, target: int, observer: int, et0: float):
        chain_t = self.chain(target, et0) if target != SSB else []
        chain_o = self.chain(observer, et0) if observer != SSB else []
        nodes_t = [target] + [s.center for s in chain_t]
        nodes_o = [observer] + [s.center for s in chain_o]
        common = None
        for node in nodes_t:
            if node in nodes_o:
                common = node
                break
        if common is None:
            raise InsufficientDataError(
                f'No common ephemeris node links bodies {target} and '
                f'{observer} (chains end at {nodes_t[-1]} and {nodes_o[-1]})'
            )
        segs_t = tuple(chain_t[: nodes_t.index(common)])
        segs_o = tuple(chain_o[: nodes_o.index(common)])
        return segs_t, segs_o

    # -- aberration-corrected states ------------------------------------------
    def state_function(
        self, target: int, observer: int, abcorr: str, et_ref: float
    ) -> Callable:
        """
        Cached jitted function ``et -> (state6, light_time)`` implementing
        the apparent-state computation. The SPK chain is resolved once at
        ``et_ref`` (bucketed by day); everything else is pure traced JAX,
        so repeated calls cost microseconds after the first compile.
        """
        key = (target, observer, str(abcorr).strip().upper(),
               round(float(et_ref) / 86400.0))
        fn = self._state_fn_cache.get(key)
        if fn is None:
            fn = self._build_state_function(target, observer, abcorr, et_ref)
            self._state_fn_cache[key] = fn
        return fn

    def _build_state_function(
        self, target: int, observer: int, abcorr: str, et_ref: float
    ) -> Callable:
        import jax
        import jax.numpy as jnp

        corr = parse_abcorr(abcorr)
        pos_rel = self.position_fn(target, observer, et_ref)
        if corr.geometric:
            def geometric_impl(et):
                state = pos_rel(et)
                lt = jnp.linalg.norm(state[..., :3], axis=-1) / CLIGHT
                return state, lt

            return jax.jit(geometric_impl)

        pos_t = self.position_fn(target, SSB, et_ref)
        pos_o = self.position_fn(observer, SSB, et_ref)
        sign = -1.0 if corr.reception else 1.0
        n_iter = 3 if corr.converged else 1

        def corrected(et):
            et = jnp.asarray(et, dtype=jnp.float64)
            obs_state = pos_o(et)
            obs_pos, obs_vel = obs_state[..., :3], obs_state[..., 3:]
            lt = jnp.zeros(et.shape, dtype=jnp.float64)
            targ_state = None
            for _ in range(n_iter + 1):
                targ_state = pos_t(et + sign * lt)
                r = targ_state[..., :3] - obs_pos
                lt = jnp.linalg.norm(r, axis=-1) / CLIGHT
            pos = targ_state[..., :3] - obs_pos
            dist = jnp.linalg.norm(pos, axis=-1)
            rhat = pos / dist[..., None]

            # d(lt)/d(et) from the implicit definition lt = |r(et)|/c
            targ_vel = targ_state[..., 3:]
            rv_t = jnp.sum(rhat * targ_vel, axis=-1)
            rv_o = jnp.sum(rhat * obs_vel, axis=-1)
            if corr.reception:
                dltdt = (rv_t - rv_o) / (CLIGHT + rv_t)
                vel = targ_vel * (1.0 - dltdt)[..., None] - obs_vel
            else:
                dltdt = (rv_t - rv_o) / (CLIGHT - rv_t)
                vel = targ_vel * (1.0 + dltdt)[..., None] - obs_vel
            return pos, vel, lt, obs_vel

        def impl(et):
            et = jnp.asarray(et, dtype=jnp.float64)
            pos, vel, lt, obs_vel = corrected(et)
            if corr.stellar:
                vbyc = obs_vel / CLIGHT * (1.0 if corr.reception else -1.0)
                pos_corrected = stelab(pos, vbyc)

                # Velocity = d/d(et) of the stellar-corrected position
                # (SPICE's definition), via forward-mode autodiff.
                def stellar_pos(t):
                    p, _, _, ov = corrected(t)
                    vb = ov / CLIGHT * (1.0 if corr.reception else -1.0)
                    return stelab(p, vb)

                _, vel = jax.jvp(stellar_pos, (et,), (jnp.ones_like(et),))
                pos = pos_corrected
            state = jnp.concatenate([pos, vel], axis=-1)
            return state, lt

        return jax.jit(impl)

    def spkezr(self, target: int, observer: int, et, abcorr: str = 'CN'):
        """
        Apparent state of target as seen by observer (``spice.spkezr``
        equivalent). Returns ``(state6, light_time)``. ``et`` must be
        concrete (not traced); use :func:`state_function` inside jit.
        """
        et_arr = np.asarray(et, dtype=np.float64)
        et_ref = float(et_arr.reshape(-1)[0])
        fn = self.state_function(target, observer, abcorr, et_ref)
        import jax.numpy as jnp

        if et_arr.size <= _SMALL_CALL_ELEMENTS:
            # Scalar/navigation-scale call: keep it on the local CPU
            # backend (see _SMALL_CALL_ELEMENTS note above)
            with _host_device():
                return fn(jnp.asarray(et_arr))
        return fn(jnp.asarray(et_arr))

    def spkpos(self, target: int, observer: int, et, abcorr: str = 'CN'):
        state, lt = self.spkezr(target, observer, et, abcorr)
        return state[..., :3], lt


@dataclass(frozen=True)
class AbcorrFlags:
    geometric: bool
    converged: bool
    stellar: bool
    reception: bool


def parse_abcorr(abcorr: str) -> AbcorrFlags:
    s = (
        abcorr.decode() if isinstance(abcorr, bytes) else str(abcorr)
    ).strip().upper().replace(' ', '')
    if s in ('NONE', ''):
        return AbcorrFlags(True, False, False, True)
    reception = not s.startswith('X')
    s2 = s[1:] if s.startswith('X') else s
    stellar = s2.endswith('+S')
    s3 = s2[:-2] if stellar else s2
    if s3 == 'LT':
        return AbcorrFlags(False, False, stellar, reception)
    if s3 == 'CN':
        return AbcorrFlags(False, True, stellar, reception)
    raise ValueError(f'Unrecognised aberration correction {abcorr!r}')


def stelab(pos, vbyc):
    """
    Stellar aberration correction: rotate ``pos`` towards the observer
    velocity direction by the aberration angle (CSPICE ``stelab`` algorithm).
    """
    import jax.numpy as jnp

    u = pos / jnp.linalg.norm(pos, axis=-1, keepdims=True)
    h = jnp.cross(u, vbyc)
    sinphi = jnp.linalg.norm(h, axis=-1, keepdims=True)
    phi = jnp.arcsin(jnp.clip(sinphi, -1.0, 1.0))
    # Rodrigues rotation of pos about axis h by angle phi
    safe = jnp.where(sinphi > 0.0, sinphi, 1.0)
    axis = h / safe
    cosphi = jnp.cos(phi)
    rotated = (
        pos * cosphi
        + jnp.cross(axis, pos) * jnp.sin(phi)
        + axis * jnp.sum(axis * pos, axis=-1, keepdims=True) * (1.0 - cosphi)
    )
    return jnp.where(sinphi > 0.0, rotated, pos)


_EPHEMERIS_SINGLETON: Ephemeris | None = None


def get_ephemeris() -> Ephemeris:
    """The ephemeris engine bound to the default (module-level) kernel pool."""
    global _EPHEMERIS_SINGLETON
    if _EPHEMERIS_SINGLETON is None:
        from ..kernels.pool import get_pool

        _EPHEMERIS_SINGLETON = Ephemeris(get_pool())
    return _EPHEMERIS_SINGLETON


def _propagate_two_body(gm: float, state0, epoch0, et):
    """
    Universal-variables two-body propagation (SPK type 5). Batched over
    leading axes; fixed-iteration Newton solve of the universal Kepler
    equation (converges quadratically; 25 iterations is far past machine
    precision for bound orbits).
    """
    import jax.numpy as jnp

    state0 = jnp.asarray(state0, dtype=jnp.float64)
    r0 = state0[..., :3]
    v0 = state0[..., 3:]
    dt = jnp.asarray(et, dtype=jnp.float64) - epoch0

    r0n = jnp.linalg.norm(r0, axis=-1)
    v0n2 = jnp.sum(v0 * v0, axis=-1)
    rv = jnp.sum(r0 * v0, axis=-1)
    alpha = 2.0 / r0n - v0n2 / gm  # 1/a
    sqrt_gm = math.sqrt(gm)

    chi = sqrt_gm * jnp.abs(alpha) * dt
    for _ in range(25):
        z = alpha * chi * chi
        c2, c3 = _stumpff(z)
        r = (
            chi * chi * c2
            + rv / sqrt_gm * chi * (1.0 - z * c3)
            + r0n * (1.0 - z * c2)
        )
        f_val = (
            chi**3 * c3
            + rv / sqrt_gm * chi * chi * c2
            + r0n * chi * (1.0 - z * c3)
            - sqrt_gm * dt
        )
        chi = chi - f_val / r
    z = alpha * chi * chi
    c2, c3 = _stumpff(z)
    f = 1.0 - chi * chi * c2 / r0n
    g = dt - chi**3 * c3 / sqrt_gm
    r_vec = f[..., None] * r0 + g[..., None] * v0
    rn = jnp.linalg.norm(r_vec, axis=-1)
    fdot = sqrt_gm / (rn * r0n) * chi * (z * c3 - 1.0)
    gdot = 1.0 - chi * chi * c2 / rn
    v_vec = fdot[..., None] * r0 + gdot[..., None] * v0
    return jnp.concatenate([r_vec, v_vec], axis=-1)


def _stumpff(z):
    import jax.numpy as jnp

    z = jnp.asarray(z, dtype=jnp.float64)
    sz = jnp.sqrt(jnp.abs(z) + 1e-300)
    c2_pos = (1.0 - jnp.cos(sz)) / jnp.abs(z + _tiny(z))
    c3_pos = (sz - jnp.sin(sz)) / (sz**3)
    c2_neg = (jnp.cosh(sz) - 1.0) / jnp.abs(z + _tiny(z))
    c3_neg = (jnp.sinh(sz) - sz) / (sz**3)
    small = jnp.abs(z) < 1e-8
    c2 = jnp.where(small, 0.5 - z / 24.0, jnp.where(z > 0, c2_pos, c2_neg))
    c3 = jnp.where(
        small, 1.0 / 6.0 - z / 120.0, jnp.where(z > 0, c3_pos, c3_neg)
    )
    return c2, c3


def _tiny(z):
    import jax.numpy as jnp

    return jnp.where(z == 0, 1e-300, 0.0)
