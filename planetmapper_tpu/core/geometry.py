"""
Closed-form ellipsoid geometry (the "ops layer" of the framework).

These are the device-side replacements for the scalar CSPICE geometry
routines the reference calls once per pixel / per point:

- ``pgrrec``/``recpgr`` (body.py:903, 1030): geodetic (planetographic)
  coordinate conversions, here as fixed-iteration Bowring solves
- ``reclat``/``latrec`` (body.py:2912): planetocentric conversions
- ``sincpt`` (body.py:1010): ray-ellipsoid intercept as a quadratic root
  (ellipsoids need no iterative intercept search)
- ``surfpt``/``nplnpt``/``npedln``-style helpers (body.py:2093-2107)
- ``nvp2pl``/``inrypl`` (body.py:585, 2586): plane construction/intersection
- ``edlimb`` equivalents: the limb of an ellipsoid as an exact ellipse

All functions are elementwise jnp code over arbitrary batch shapes: they
vmap/jit cleanly and form the body of the fused per-pixel device pipeline.
Angles are radians, longitudes are *east-positive* internally (the
planetographic W/E sign convention is applied by the API layer, matching
``Body.positive_longitude_direction``).
"""

from __future__ import annotations

import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Geodetic (planetographic) <-> rectangular
# ---------------------------------------------------------------------------

def geodetic_to_rect(lon_e, lat, alt, re, f):
    """
    ``pgrrec`` equivalent (east-positive longitude): geodetic coordinates on
    a spheroid with equatorial radius ``re`` and flattening ``f`` to
    body-fixed rectangular coordinates.
    """
    e2 = f * (2.0 - f)
    sin_lat = jnp.sin(lat)
    cos_lat = jnp.cos(lat)
    n = re / jnp.sqrt(1.0 - e2 * sin_lat * sin_lat)
    x = (n + alt) * cos_lat * jnp.cos(lon_e)
    y = (n + alt) * cos_lat * jnp.sin(lon_e)
    z = (n * (1.0 - e2) + alt) * sin_lat
    return jnp.stack([x, y, z], axis=-1)


def rect_to_geodetic(v, re, f):
    """
    ``recpgr``/``recgeo`` equivalent (east-positive longitude): body-fixed
    rectangular coordinates to geodetic ``(lon_e, lat, alt)``.

    Uses the exact nearest-point-on-spheroid construction (like CSPICE
    ``recgeo``): the geodetic latitude is defined by the surface normal at
    the closest point on the spheroid, which remains well-defined for
    points deep inside the body (e.g. ``(1, 2, 3)`` km from the centre maps
    to a near-polar latitude for an oblate spheroid). Solved by vectorised
    bisection + Newton polish on the standard nearest-point parameter
    equation  (a rho/(t+a^2))^2 + (b z/(t+b^2))^2 = 1.
    """
    x = v[..., 0]
    y = v[..., 1]
    z = v[..., 2]
    a = re
    b = re * (1.0 - f)

    lon = jnp.arctan2(y, x)
    rho = jnp.hypot(x, y)
    az = jnp.abs(z)

    a2 = a * a
    b2 = b * b

    def f_of_t(t):
        return (
            (a * rho / (t + a2)) ** 2 + (b * az / (t + b2)) ** 2 - 1.0
        )

    # Root bracket: F is monotonically decreasing for t > -b^2.
    r = jnp.sqrt(rho * rho + az * az)
    t_lo = -b2 + 1e-12 * b2 + jnp.zeros_like(rho)
    t_hi = jnp.maximum(r, a) * a + a2  # F(t_hi) < 0 always
    for _ in range(52):
        t_mid = 0.5 * (t_lo + t_hi)
        pos = f_of_t(t_mid) > 0.0
        t_lo = jnp.where(pos, t_mid, t_lo)
        t_hi = jnp.where(pos, t_hi, t_mid)
    t = 0.5 * (t_lo + t_hi)
    for _ in range(3):  # Newton polish to machine precision
        ft = f_of_t(t)
        dft = (
            -2.0 * (a * rho) ** 2 / (t + a2) ** 3
            - 2.0 * (b * az) ** 2 / (t + b2) ** 3
        )
        t = t - ft / jnp.where(dft != 0.0, dft, 1.0)

    # Nearest surface point (in the rho-z plane)
    rho_s = a2 * rho / (t + a2)
    z_s = b2 * az / (t + b2)
    # Geodetic latitude from the surface normal at the nearest point
    lat = jnp.arctan2(z_s / b2, rho_s / a2)
    dist = jnp.hypot(rho - rho_s, az - z_s)

    # Equatorial-plane points inside the evolute (rho < a e^2, z ~ 0):
    # the parameter equation degenerates (its root lies below -b^2, so
    # the bisection bracket excludes it and Newton diverges), but the
    # nearest point is closed-form: the ellipse parameter beta satisfies
    # cos(beta) = rho / (a e^2), with two symmetric off-equator solutions
    evolute_rho = (a2 - b2) / a
    deg_eq = (az <= 1e-12 * b) & (rho < evolute_rho)
    cosb = jnp.clip(
        rho / jnp.where(evolute_rho > 0.0, evolute_rho, 1.0), 0.0, 1.0
    )
    sinb = jnp.sqrt(1.0 - cosb * cosb)
    rho_sd = a * cosb
    z_sd = b * sinb
    lat = jnp.where(
        deg_eq, jnp.arctan2(z_sd / b2, rho_sd / a2), lat
    )
    dist = jnp.where(deg_eq, jnp.hypot(rho - rho_sd, z_sd), dist)

    # Degenerate axis case (rho == 0): the nearest point is the pole
    on_axis = rho == 0.0
    lat = jnp.where(on_axis, jnp.pi / 2.0, lat)
    alt_axis = az - b
    inside = (rho / a) ** 2 + (az / b) ** 2 < 1.0
    alt = jnp.where(inside, -dist, dist)
    alt = jnp.where(on_axis, alt_axis, alt)
    lat = jnp.where(z < 0.0, -lat, lat)
    return lon, lat, alt


def rect_to_geodetic_exterior(v, re, f, n_iter: int = 3):
    """
    Fast ``recpgr`` equivalent for points *outside* the spheroid (and
    shallow-interior points): Bowring's method with geocentric
    initialisation, which converges to machine precision in 2-3 iterations
    everywhere outside the evolute. Much cheaper than the exact bisection
    in :func:`rect_to_geodetic`, which remains the general-purpose path for
    points deep inside the body.
    """
    x = v[..., 0]
    y = v[..., 1]
    z = v[..., 2]
    rp = re * (1.0 - f)
    e2 = f * (2.0 - f)
    ep2 = e2 / (1.0 - e2)
    lon = jnp.arctan2(y, x)
    rho = jnp.hypot(x, y)
    beta = jnp.arctan2(z, (1.0 - f) * rho)
    lat = beta
    for _ in range(n_iter):
        sb = jnp.sin(beta)
        cb = jnp.cos(beta)
        lat = jnp.arctan2(z + ep2 * rp * sb**3, rho - e2 * re * cb**3)
        beta = jnp.arctan2((1.0 - f) * jnp.sin(lat), jnp.cos(lat))
    sin_lat = jnp.sin(lat)
    cos_lat = jnp.cos(lat)
    n = re / jnp.sqrt(1.0 - e2 * sin_lat * sin_lat)
    alt = rho * cos_lat + z * sin_lat - n * (1.0 - e2 * sin_lat * sin_lat)
    return lon, lat, alt


def rect_to_latlon_centric(v):
    """``reclat`` equivalent: ``(radius, lon_e, lat_centric)``."""
    r = jnp.linalg.norm(v, axis=-1)
    lon = jnp.arctan2(v[..., 1], v[..., 0])
    lat = jnp.arcsin(jnp.clip(v[..., 2] / jnp.where(r > 0, r, 1.0), -1.0, 1.0))
    return r, lon, lat


def rect_to_radec(v):
    """``recrad`` equivalent: ``(range, ra, dec)`` with ra in [0, 2pi)."""
    r = jnp.linalg.norm(v, axis=-1)
    ra = jnp.mod(jnp.arctan2(v[..., 1], v[..., 0]), 2.0 * jnp.pi)
    dec = jnp.arcsin(jnp.clip(v[..., 2] / jnp.where(r > 0, r, 1.0), -1.0, 1.0))
    return r, ra, dec


def radec_to_rect(r, ra, dec):
    """``radrec`` equivalent."""
    cos_dec = jnp.cos(dec)
    return jnp.stack(
        [
            r * jnp.cos(ra) * cos_dec,
            r * jnp.sin(ra) * cos_dec,
            r * jnp.sin(dec),
        ],
        axis=-1,
    )


# ---------------------------------------------------------------------------
# Ray-ellipsoid intersection
# ---------------------------------------------------------------------------

def ray_ellipsoid_intercept(origin, direction, radii):
    """
    ``sincpt``'s geometric core: smallest positive ray parameter ``s`` such
    that ``origin + s*direction`` lies on the ellipsoid with semi-axes
    ``radii``. Returns ``(s, found)`` with ``s`` NaN where no intercept
    exists (discriminant < 0 or intercept behind the ray origin).
    """
    o = origin / radii
    d = direction / radii
    a = jnp.sum(d * d, axis=-1)
    b = jnp.sum(o * d, axis=-1)
    # Recentre on the ray's closest approach to the centre before forming
    # the discriminant: the naive b^2 - a*c cancels ~2*log10(|o|/|q|)
    # digits (over 30 for a 100 km moon seen from Earth - pure noise in
    # f64), while the recentred q = o + t_ca*d only cancels *linearly*,
    # leaving the discriminant exact to ~1e-9 of the body radius.
    t_ca = -b / a
    q = o + t_ca[..., None] * d
    cq = jnp.sum(q * q, axis=-1) - 1.0
    disc = -cq / a  # == (b^2 - a c)/a^2 = (sqrt_disc/a)^2
    found = disc >= 0.0
    sqrt_disc = jnp.sqrt(jnp.where(found, disc, 0.0))
    s_near = t_ca - sqrt_disc
    # smallest POSITIVE parameter: a ray starting inside the ellipsoid
    # exits through the far root (surfpt semantics)
    s = jnp.where(s_near >= 0.0, s_near, t_ca + sqrt_disc)
    found = found & (s >= 0.0)
    s = jnp.where(found, s, jnp.nan)
    return s, found


def surface_normal(point, radii):
    """Outward unit normal of the ellipsoid at a surface point (``surfnm``)."""
    n = point / (radii * radii)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def radial_surface_point(direction, radii):
    """
    ``surfpt`` from the body centre: scale ``direction`` onto the ellipsoid
    surface.
    """
    d = direction / radii
    scale = 1.0 / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return direction * scale


def nearest_point_on_line(line_point, line_dir, point):
    """
    ``nplnpt`` equivalent: nearest point on the line through ``line_point``
    with direction ``line_dir`` to ``point``; returns ``(near, dist)``.
    """
    d = line_dir / jnp.linalg.norm(line_dir, axis=-1, keepdims=True)
    s = jnp.sum((point - line_point) * d, axis=-1, keepdims=True)
    near = line_point + s * d
    dist = jnp.linalg.norm(near - point, axis=-1)
    return near, dist


# ---------------------------------------------------------------------------
# Planes (``nvp2pl`` / ``inrypl``)
# ---------------------------------------------------------------------------

def plane_from_normal_point(normal, point):
    """
    ``nvp2pl`` equivalent: plane as ``(unit_normal, constant)`` with
    ``unit_normal . x = constant`` (constant >= 0, matching SPICE's
    normalised plane representation).
    """
    n = normal / jnp.linalg.norm(normal, axis=-1, keepdims=True)
    c = jnp.sum(n * point, axis=-1)
    flip = jnp.where(c < 0, -1.0, 1.0)
    return n * flip[..., None], jnp.abs(c)


def ray_plane_intercept(origin, direction, plane_normal, plane_constant):
    """
    ``inrypl`` equivalent: intersection of a ray with a plane. Returns
    ``(point, n_intersections)`` where ``n_intersections`` is 0 (parallel,
    misses), 1 (proper intersection ahead of the origin), or -1 (the ray
    lies in the plane; SPICE's "infinite intersections" case).
    """
    denom = jnp.sum(direction * plane_normal, axis=-1)
    num = plane_constant - jnp.sum(origin * plane_normal, axis=-1)
    # Near-parallel rays (relative threshold, not exact zero): the
    # nominal intersection distance is pure rounding noise at ~1e12 km
    # scales, so treat edge-on geometry as parallel like CSPICE's
    # degenerate-case handling rather than returning garbage points
    dn = jnp.linalg.norm(direction, axis=-1)
    degenerate = jnp.abs(denom) <= 1e-12 * dn
    scale = jnp.abs(plane_constant) + jnp.linalg.norm(origin, axis=-1)
    in_plane = degenerate & (jnp.abs(num) <= 1e-9 * scale)
    parallel = degenerate & ~in_plane
    s = num / jnp.where(jnp.abs(denom) > 0.0, denom, 1.0)
    ok = (~parallel) & (~in_plane) & (s >= 0.0)
    point = origin + s[..., None] * direction
    point = jnp.where(ok[..., None], point, jnp.nan)
    nxpts = jnp.where(in_plane, -1, jnp.where(ok, 1, 0))
    return point, nxpts


# ---------------------------------------------------------------------------
# Limb of an ellipsoid (``edlimb`` equivalent)
# ---------------------------------------------------------------------------

def limb_ellipse(observer_bf, radii):
    """
    The limb of the ellipsoid as seen from ``observer_bf`` (body-fixed
    observer position relative to the body centre), as an exact ellipse:
    returns ``(center, semi_axis_1, semi_axis_2)`` so that limb points are
    ``center + cos(theta)*semi_axis_1 + sin(theta)*semi_axis_2``.

    Derivation: on the unit sphere u = q/radii the limb plane is
    ``m . u = 1`` with ``m = observer_bf/radii``; the limb is the circle cut
    by that plane, mapped back through the ``radii`` scaling.
    """
    m = observer_bf / radii
    m2 = jnp.sum(m * m, axis=-1, keepdims=True)
    mhat = m / jnp.sqrt(m2)
    delta = 1.0 / jnp.sqrt(m2)  # distance of plane from origin (unit sphere)
    rho = jnp.sqrt(jnp.maximum(1.0 - delta * delta, 0.0))

    # Any orthonormal basis of the plane perpendicular to mhat
    e1 = _perpendicular_unit(mhat)
    e2 = jnp.cross(mhat, e1)

    center = mhat * delta * radii
    axis1 = e1 * rho * radii
    axis2 = e2 * rho * radii
    return center, axis1, axis2


def _perpendicular_unit(v):
    """A unit vector perpendicular to v (branch-free)."""
    # Choose the smallest component axis to cross against
    ax = jnp.abs(v)
    use_x = (ax[..., 0] <= ax[..., 1]) & (ax[..., 0] <= ax[..., 2])
    use_y = (~use_x) & (ax[..., 1] <= ax[..., 2])
    basis = jnp.where(
        use_x[..., None],
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), v.shape),
        jnp.where(
            use_y[..., None],
            jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), v.shape),
            jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), v.shape),
        ),
    )
    p = jnp.cross(v, basis)
    return p / jnp.linalg.norm(p, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# Angles
# ---------------------------------------------------------------------------

def vector_separation(a, b):
    """
    ``vsep`` equivalent: angle between vectors, numerically stable near 0
    and pi (uses the half-angle construction like SPICE).
    """
    an = a / jnp.linalg.norm(a, axis=-1, keepdims=True)
    bn = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
    dot = jnp.sum(an * bn, axis=-1)
    near = jnp.linalg.norm(an - bn, axis=-1)
    far = jnp.linalg.norm(an + bn, axis=-1)
    return jnp.where(
        dot >= 0.0,
        2.0 * jnp.arcsin(jnp.clip(0.5 * near, -1.0, 1.0)),
        jnp.pi - 2.0 * jnp.arcsin(jnp.clip(0.5 * far, -1.0, 1.0)),
    )
