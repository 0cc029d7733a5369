"""
Body-fixed reference frames (IAU rotation models) as closed-form JAX
functions of time.

Replaces CSPICE's ``pxform``/``pxfrm2``/``tisbod`` machinery used throughout
the reference (e.g. per-point light-time retargeting at body.py:917-1006).
The IAU orientation model comes from text PCK constants
(``BODYnnn_POLE_RA/POLE_DEC/PM`` plus the system ``NUT_PREC`` terms):

    ra  = ra0 + ra1*T + ra2*T^2 + sum_i a_i * sin(theta_i(T))      [deg]
    dec = dec0 + dec1*T + dec2*T^2 + sum_i d_i * cos(theta_i(T))   [deg]
    w   = w0 + w1*d + w2*d^2 + sum_i w_i * sin(theta_i(T))         [deg]
    theta_i(T) = theta0_i + theta1_i * T                           [deg]

with T = TDB Julian centuries past J2000 and d = TDB days past J2000.
Coordinates transform to the body-fixed frame via

    r_bf = Rz(w) Rx(pi/2 - dec) Rz(pi/2 + ra) r_J2000

Being closed-form jnp code, the rotation (and its exact time derivative via
``jax.jacfwd``) evaluates per-pixel on the device inside the vmapped backplane
pipeline - the reference instead calls ``spice.pxfrm2`` once per pixel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..kernels.pool import KernelPool, KernelVarNotFoundError

DEG = math.pi / 180.0
DAY = 86400.0
CENTURY = 36525.0 * DAY


@dataclass(frozen=True)
class BodyFrameModel:
    """IAU rotation model constants for one body (all angles in degrees)."""

    body_id: int
    pole_ra: tuple[float, float, float]
    pole_dec: tuple[float, float, float]
    pm: tuple[float, float, float]
    nut_angles: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    nut_ra: np.ndarray = field(default_factory=lambda: np.zeros(0))
    nut_dec: np.ndarray = field(default_factory=lambda: np.zeros(0))
    nut_pm: np.ndarray = field(default_factory=lambda: np.zeros(0))

    @classmethod
    def from_pool(cls, pool: KernelPool, body_id: int) -> 'BodyFrameModel':
        def fetch(item: str, default=None):
            try:
                return pool.bodvar(body_id, item)
            except KernelVarNotFoundError:
                if default is not None:
                    return default
                raise

        def coeffs3(item: str) -> tuple[float, float, float]:
            arr = fetch(item)
            out = [0.0, 0.0, 0.0]
            for i, v in enumerate(arr[:3]):
                out[i] = float(v)
            return tuple(out)  # type: ignore[return-value]

        pole_ra = coeffs3('POLE_RA')
        pole_dec = coeffs3('POLE_DEC')
        pm = coeffs3('PM')

        # Nutation-precession angles live under the system barycenter ID
        # (e.g. BODY5_NUT_PREC_ANGLES for the Jovian system).
        system_id = body_id // 100 if body_id >= 100 else body_id
        angles = None
        try:
            angles = pool.bodvar(system_id, 'NUT_PREC_ANGLES')
        except KernelVarNotFoundError:
            pass
        zero = np.zeros(0)
        nut_ra = fetch('NUT_PREC_RA', zero)
        nut_dec = fetch('NUT_PREC_DEC', zero)
        nut_pm = fetch('NUT_PREC_PM', zero)

        if angles is None or (
            len(nut_ra) == 0 and len(nut_dec) == 0 and len(nut_pm) == 0
        ):
            return cls(body_id, pole_ra, pole_dec, pm)

        nut_angles = np.asarray(angles, dtype=np.float64).reshape(-1, 2)
        n = nut_angles.shape[0]

        def pad(arr) -> np.ndarray:
            arr = np.asarray(arr, dtype=np.float64)
            if arr.size < n:
                arr = np.concatenate([arr, np.zeros(n - arr.size)])
            return arr[:n]

        return cls(
            body_id, pole_ra, pole_dec, pm,
            nut_angles=nut_angles,
            nut_ra=pad(nut_ra), nut_dec=pad(nut_dec), nut_pm=pad(nut_pm),
        )

    # -- evaluation -----------------------------------------------------------
    def euler_angles(self, et):
        """(ra, dec, w) in radians at TDB time(s) ``et`` [s past J2000]."""
        import jax.numpy as jnp

        et = jnp.asarray(et, dtype=jnp.float64)
        T = et / CENTURY
        d = et / DAY
        ra = self.pole_ra[0] + self.pole_ra[1] * T + self.pole_ra[2] * T**2
        dec = self.pole_dec[0] + self.pole_dec[1] * T + self.pole_dec[2] * T**2
        w = self.pm[0] + self.pm[1] * d + self.pm[2] * d**2
        if self.nut_angles.shape[0]:
            theta = (
                jnp.asarray(self.nut_angles[:, 0])
                + jnp.asarray(self.nut_angles[:, 1]) * T[..., None]
            ) * DEG
            ra = ra + jnp.sum(jnp.asarray(self.nut_ra) * jnp.sin(theta), axis=-1)
            dec = dec + jnp.sum(jnp.asarray(self.nut_dec) * jnp.cos(theta), axis=-1)
            w = w + jnp.sum(jnp.asarray(self.nut_pm) * jnp.sin(theta), axis=-1)
        return ra * DEG, dec * DEG, w * DEG

    def j2000_to_bodyfixed_matrix(self, et):
        """Rotation matrix: r_bodyfixed = M @ r_J2000. Shape (..., 3, 3)."""
        import jax.numpy as jnp

        ra, dec, w = self.euler_angles(et)
        return (
            _rotmat_jnp(jnp, w, 3)
            @ _rotmat_jnp(jnp, math.pi / 2.0 - dec, 1)
            @ _rotmat_jnp(jnp, math.pi / 2.0 + ra, 3)
        )

    def bodyfixed_to_j2000_matrix(self, et):
        import jax.numpy as jnp

        return jnp.swapaxes(self.j2000_to_bodyfixed_matrix(et), -1, -2)

    def rotate_j2000_to_bodyfixed(self, et, v):
        """
        Apply the J2000 -> body-fixed rotation to vectors ``v`` (..., 3)
        at per-element epochs ``et`` (...) WITHOUT materialising
        ``(..., 3, 3)`` matrices: three successive axis rotations on the
        vector components keep every temporary a (...,) array, where
        batched matrix temporaries can be padded to far more than 9
        elements each by an accelerator's tiled layouts.
        """
        ra, dec, w = self.euler_angles(et)
        return _apply_euler_313(ra, dec, w, v, inverse=False)

    def rotate_bodyfixed_to_j2000(self, et, v):
        """Inverse of :func:`rotate_j2000_to_bodyfixed` (same rationale)."""
        ra, dec, w = self.euler_angles(et)
        return _apply_euler_313(ra, dec, w, v, inverse=True)

    def bodyfixed_to_j2000_matrix_deriv(self, et):
        """d/dt of :func:`bodyfixed_to_j2000_matrix` (exact, via jacfwd)."""
        import jax

        return jax.jacfwd(self.bodyfixed_to_j2000_matrix)(et)


def _apply_euler_313(ra, dec, w, v, *, inverse: bool):
    """
    Apply ``R3(w) R1(pi/2 - dec) R3(pi/2 + ra)`` (the IAU body-frame
    rotation, SPICE rotation convention) - or its transpose - to vectors
    ``v`` componentwise. Equivalent to composing the :func:`_rotmat_jnp`
    matrices, but with no (..., 3, 3) temporaries.
    """
    import jax.numpy as jnp

    vx = v[..., 0]
    vy = v[..., 1]
    vz = v[..., 2]
    sra = jnp.sin(ra)
    cra = jnp.cos(ra)
    sdec = jnp.sin(dec)
    cdec = jnp.cos(dec)
    sw = jnp.sin(w)
    cw = jnp.cos(w)
    if not inverse:
        # R3(pi/2 + ra): cos -> -sin(ra), sin -> cos(ra)
        x1 = -sra * vx + cra * vy
        y1 = -cra * vx - sra * vy
        # R1(pi/2 - dec): cos -> sin(dec), sin -> cos(dec)
        y2 = sdec * y1 + cdec * vz
        z2 = -cdec * y1 + sdec * vz
        # R3(w)
        out_x = cw * x1 + sw * y2
        out_y = -sw * x1 + cw * y2
        out_z = z2
    else:
        # Transpose: R3(-(pi/2 + ra)) R1(-(pi/2 - dec)) R3(-w)
        x1 = cw * vx - sw * vy
        y1 = sw * vx + cw * vy
        y2 = sdec * y1 - cdec * vz
        z2 = cdec * y1 + sdec * vz
        out_x = -sra * x1 - cra * y2
        out_y = cra * x1 - sra * y2
        out_z = z2
    return jnp.stack([out_x, out_y, out_z], axis=-1)


def _rotmat_jnp(jnp, angle, axis: int):
    """SPICE-convention coordinate rotation matrix (batched)."""
    angle = jnp.asarray(angle, dtype=jnp.float64)
    c = jnp.cos(angle)
    s = jnp.sin(angle)
    one = jnp.ones_like(c)
    zero = jnp.zeros_like(c)
    if axis == 1:
        rows = [[one, zero, zero], [zero, c, s], [zero, -s, c]]
    elif axis == 2:
        rows = [[c, zero, -s], [zero, one, zero], [s, zero, c]]
    else:
        rows = [[c, s, zero], [-s, c, zero], [zero, zero, one]]
    return jnp.stack([jnp.stack(r, axis=-1) for r in rows], axis=-2)


def pxfrm2(model: BodyFrameModel, et_from, et_to):
    """
    Position transformation from the body-fixed frame at ``et_from`` to
    J2000 at ``et_to``... J2000 is inertial, so this is simply the
    body-fixed->J2000 matrix at ``et_from``; the two-epoch form mirrors the
    CSPICE call signature used by the reference (body.py:940-946) where the
    'to' frame is the (inertial) observer frame.
    """
    del et_to
    return model.bodyfixed_to_j2000_matrix(et_from)
