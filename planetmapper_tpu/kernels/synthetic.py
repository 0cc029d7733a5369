"""
A seeded, self-contained SPICE kernel set: an SPK of type 2 Chebyshev
segments, a text LSK and a text PCK, written by :func:`write_kernel_set`.

This is a deterministic fixture for the tests, the benchmark and the chip
smoke test. It is **not an ephemeris**: every orbit is an unperturbed
two-body (Keplerian) orbit built from published mean elements, so positions
are right to about a degree on the sky for the planets and only
qualitatively right for the satellites. Use real NAIF kernels for science.

What the set holds:

- ``synthetic_ephemeris.bsp``: type 2 segments (the type real planetary
  ephemerides use) for the Sun, the nine planetary system barycentres and
  the planets, Earth and the Moon, Io, Europa, Ganymede, Callisto and
  Amalthea about Jupiter, Daphnis about Saturn, and an HST-like low Earth
  orbit (NAIF ID -48). The Sun, the barycentres, the planets, Earth, the
  Moon and the Galilean moons cover 1995-2035. To keep the file small, the
  bodies with periods under a day cover less: Amalthea and Daphnis
  2004-2010, and -48 the two months around 2005-01-01 and 2009-01-01.
- ``naif_leapseconds.tls``: the public leap-second table (through the
  2017-01-01 leap second) and the ``DELTET`` constants of NAIF's LSK.
- ``synthetic_constants.tpc``: IAU radii, pole and prime-meridian terms
  (IAU WGCCRE 2009 report, as in NAIF's ``pck00010.tpc``) without the
  nutation-precession series. Like ``pck00010.tpc`` it has no constants
  for Daphnis, which therefore loads as a ``BasicBody``.

Sources of the orbital elements:

- Planets: E. M. Standish, "Keplerian Elements for Approximate Positions of
  the Major Planets" (JPL Solar System Dynamics), Table 1, J2000 elements
  on the mean ecliptic, mean motion from the mean-longitude rate.
- Moon: mean lunar elements at J2000 on the ecliptic.
- Jovian and Saturnian satellites: semi-major axes, eccentricities,
  inclinations and periods rounded from JPL Solar System Dynamics'
  planetary satellite mean elements, on the planet's equator; their
  phases are arbitrary.

Files are written in a fixed order from fixed inputs, so two runs give
byte-identical files. :func:`ensure_kernel_set` generates the set once into
``build/kernels/`` of the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np

from ..core.timebase import calendar_to_j2000_seconds
from .daf import write_daf
from .spk import pack_type_2

#: Bumped whenever the generated content changes, so a stale set is rebuilt.
SET_VERSION = '1'

SPK_NAME = 'synthetic_ephemeris.bsp'
LSK_NAME = 'naif_leapseconds.tls'
PCK_NAME = 'synthetic_constants.tpc'

DEG = math.pi / 180.0
DAY = 86400.0
CENTURY_DAYS = 36525.0
AU_KM = 149597870.7
OBLIQUITY_J2000 = 84381.448 / 3600.0 * DEG
GM_EARTH = 398600.4418
GM_EARTH_MOON = 403503.2355
MOON_EARTH_MASS_RATIO = 0.0123000371

LONG_SPAN = (
    calendar_to_j2000_seconds(1995, 1, 1),
    calendar_to_j2000_seconds(2035, 1, 1),
)
SHORT_SPAN = (
    calendar_to_j2000_seconds(2004, 1, 1),
    calendar_to_j2000_seconds(2010, 1, 1),
)
#: The low Earth orbit needs ~15 records a day, so it covers two months
#: around each of 2005-01-01 and 2009-01-01 only.
HST_SPANS = (
    (calendar_to_j2000_seconds(2004, 12, 1),
     calendar_to_j2000_seconds(2005, 2, 1)),
    (calendar_to_j2000_seconds(2008, 12, 1),
     calendar_to_j2000_seconds(2009, 2, 1)),
)

#: Chebyshev coefficients per component, and the longest record (see
#: :func:`fit_chebyshev` for how a body's record length is chosen).
N_COEF = 32
MAX_RECORD_DAYS = 64.0

# Standish Table 1 (J2000, 1800-2050): a [au], e, I, L, long. peri.,
# long. node [deg], and L's rate [deg / century].
_PLANETS = {
    1: (0.38709927, 0.20563593, 7.00497902, 252.25032350, 77.45779628,
        48.33076593, 149472.67411175),
    2: (0.72333566, 0.00677672, 3.39467605, 181.97909950, 131.60246718,
        76.67984255, 58517.81538729),
    3: (1.00000261, 0.01671123, -0.00001531, 100.46457166, 102.93768193,
        0.0, 35999.37244981),
    4: (1.52371034, 0.09339410, 1.84969142, -4.55343205, -23.94362959,
        49.55953891, 19140.30268499),
    5: (5.20288700, 0.04838624, 1.30439695, 34.39644051, 14.72847983,
        100.47390909, 3034.74612775),
    6: (9.53667594, 0.05386179, 2.48599187, 49.95424423, 92.59887831,
        113.66242448, 1222.49362201),
    7: (19.18916464, 0.04725744, 0.77263783, 313.23810451, 170.95427630,
        74.01692503, 428.48202785),
    8: (30.06992276, 0.00859048, 1.77004347, -55.12002969, 44.96476227,
        131.78422574, 218.45945325),
    9: (39.48211675, 0.24882730, 17.14001206, 238.92903833, 224.06891629,
        110.30393684, 145.20780515),
}

# Satellites: (center, a [km], e, i, node, arg. peri., mean anomaly at
# J2000 [deg], period [days], span). Angles on the planet's equator.
_SATELLITES = {
    501: (5, 421800.0, 0.0041, 0.036, 43.977, 84.129, 342.021, 1.762732,
          LONG_SPAN),
    502: (5, 671100.0, 0.0094, 0.466, 219.106, 88.970, 171.016, 3.525463,
          LONG_SPAN),
    503: (5, 1070400.0, 0.0013, 0.177, 63.552, 192.417, 317.540, 7.155588,
          LONG_SPAN),
    504: (5, 1882700.0, 0.0074, 0.192, 298.848, 52.643, 181.408, 16.690440,
          LONG_SPAN),
    505: (5, 181400.0, 0.0032, 0.380, 108.946, 155.873, 185.194, 0.498179,
          SHORT_SPAN),
    635: (6, 136505.0, 0.0000, 0.000, 0.0, 0.0, 120.0, 0.594080,
          SHORT_SPAN),
}

# IAU rotation models: radii [km], pole RA and Dec [deg, deg/century],
# prime meridian [deg, deg/day].
_PCK = {
    10: ((696000.0, 696000.0, 696000.0), (286.13, 0.0), (63.87, 0.0),
         (84.176, 14.1844000)),
    199: ((2439.7, 2439.7, 2439.7), (281.0097, -0.0328), (61.4143, -0.0049),
          (329.5469, 6.1385025)),
    299: ((6051.8, 6051.8, 6051.8), (272.76, 0.0), (67.16, 0.0),
          (160.20, -1.4813688)),
    399: ((6378.1366, 6378.1366, 6356.7519), (0.0, -0.641), (90.0, -0.557),
          (190.147, 360.9856235)),
    301: ((1737.4, 1737.4, 1737.4), (269.9949, 0.0031), (66.5392, 0.0130),
          (38.3213, 13.17635815)),
    499: ((3396.19, 3396.19, 3376.20), (317.68143, -0.1061),
          (52.88650, -0.0609), (176.630, 350.89198226)),
    599: ((71492.0, 71492.0, 66854.0), (268.056595, -0.006499),
          (64.495303, 0.002413), (284.95, 870.5360000)),
    501: ((1829.4, 1819.4, 1815.7), (268.05, -0.009), (64.50, 0.003),
          (200.39, 203.4889538)),
    502: ((1562.6, 1560.3, 1559.5), (268.08, -0.009), (64.51, 0.003),
          (36.022, 101.3747235)),
    503: ((2631.2, 2631.2, 2631.2), (268.20, -0.009), (64.57, 0.003),
          (44.064, 50.3176081)),
    504: ((2410.3, 2410.3, 2410.3), (268.72, -0.009), (64.83, 0.003),
          (259.51, 21.5710715)),
    505: ((125.0, 73.0, 64.0), (268.05, -0.009), (64.49, 0.003),
          (231.67, 722.6314560)),
    699: ((60268.0, 60268.0, 54364.0), (40.589, -0.036), (83.537, -0.004),
          (38.90, 810.7939024)),
    799: ((25559.0, 25559.0, 24973.0), (257.311, 0.0), (-15.175, 0.0),
          (203.81, -501.1600928)),
    899: ((24764.0, 24764.0, 24341.0), (299.36, 0.0), (43.46, 0.0),
          (253.18, 536.3128492)),
    999: ((1188.3, 1188.3, 1188.3), (132.993, 0.0), (-6.163, 0.0),
          (302.695, 56.3625225)),
}

# HST-like orbit about Earth's centre, on the J2000 equator: 540 km
# altitude, 28.47 deg inclination.
_HST = (-48, 399, 6918.0, 0.0003, 28.47, 121.0, 90.0, 0.0)

_LEAP_SECONDS = (
    (10, '1972-JAN-1'), (11, '1972-JUL-1'), (12, '1973-JAN-1'),
    (13, '1974-JAN-1'), (14, '1975-JAN-1'), (15, '1976-JAN-1'),
    (16, '1977-JAN-1'), (17, '1978-JAN-1'), (18, '1979-JAN-1'),
    (19, '1980-JAN-1'), (20, '1981-JUL-1'), (21, '1982-JUL-1'),
    (22, '1983-JUL-1'), (23, '1985-JUL-1'), (24, '1988-JAN-1'),
    (25, '1990-JAN-1'), (26, '1991-JAN-1'), (27, '1992-JUL-1'),
    (28, '1993-JUL-1'), (29, '1994-JUL-1'), (30, '1996-JAN-1'),
    (31, '1997-JUL-1'), (32, '1999-JAN-1'), (33, '2006-JAN-1'),
    (34, '2009-JAN-1'), (35, '2012-JUL-1'), (36, '2015-JUL-1'),
    (37, '2017-JAN-1'),
)


def _rot_x(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _rot_z(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _equator_frame(body_id: int) -> np.ndarray:
    """Planet equator (x at the ascending node on the J2000 equator) to J2000."""
    _, (ra, _), (dec, _), _ = _PCK[body_id]
    ra, dec = ra * DEG, dec * DEG
    pole = np.array(
        [math.cos(dec) * math.cos(ra), math.cos(dec) * math.sin(ra),
         math.sin(dec)]
    )
    x = np.cross([0.0, 0.0, 1.0], pole)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(pole, x), pole], axis=1)


class KeplerOrbit:
    """Unperturbed two-body orbit; :meth:`position` is in J2000 [km]."""

    def __init__(self, a, e, inc, node, argp, m0, period_s, plane):
        self.a = a
        self.e = e
        self.m0 = m0
        self.n = 2.0 * math.pi / period_s
        self.period_s = period_s
        self.matrix = plane @ _rot_z(node) @ _rot_x(inc) @ _rot_z(argp)

    def position(self, et: np.ndarray) -> np.ndarray:
        m = self.m0 + self.n * np.asarray(et, dtype=np.float64)
        ecc_anom = m + self.e * np.sin(m)
        for _ in range(12):  # Newton; converged to ulp for e < 0.3
            ecc_anom = ecc_anom - (
                ecc_anom - self.e * np.sin(ecc_anom) - m
            ) / (1.0 - self.e * np.cos(ecc_anom))
        p = self.a * (np.cos(ecc_anom) - self.e)
        q = self.a * math.sqrt(1.0 - self.e**2) * np.sin(ecc_anom)
        return (
            p[..., None] * self.matrix[:, 0] + q[..., None] * self.matrix[:, 1]
        )


def planet_orbit(barycenter: int) -> KeplerOrbit:
    a, e, inc, mean_lon, peri, node, rate = _PLANETS[barycenter]
    return KeplerOrbit(
        a * AU_KM, e, inc * DEG, node * DEG, (peri - node) * DEG,
        (mean_lon - peri) * DEG, 360.0 / rate * CENTURY_DAYS * DAY,
        _rot_x(OBLIQUITY_J2000),
    )


def moon_orbit() -> KeplerOrbit:
    """The Moon relative to Earth (relative orbit about the EMB)."""
    a = 384400.0
    return KeplerOrbit(
        a, 0.0549, 5.145 * DEG, 125.08 * DEG, 318.15 * DEG, 135.27 * DEG,
        2.0 * math.pi * math.sqrt(a**3 / GM_EARTH_MOON),
        _rot_x(OBLIQUITY_J2000),
    )


def satellite_orbit(body: int) -> KeplerOrbit:
    center, a, e, inc, node, argp, m0, period, _ = _SATELLITES[body]
    return KeplerOrbit(
        a, e, inc * DEG, node * DEG, argp * DEG, m0 * DEG, period * DAY,
        _equator_frame(center * 100 + 99),
    )


def hst_orbit() -> KeplerOrbit:
    _, _, a, e, inc, node, argp, m0 = _HST
    return KeplerOrbit(
        a, e, inc * DEG, node * DEG, argp * DEG, m0 * DEG,
        2.0 * math.pi * math.sqrt(a**3 / GM_EARTH), np.eye(3),
    )


def _fit_records(position, span, intlen_target: float, n_coef: int):
    start, end = span
    nrec = max(1, math.ceil((end - start) / intlen_target))
    intlen = (end - start) / nrec
    k = np.arange(n_coef)
    theta = math.pi * (k + 0.5) / n_coef
    mids = start + (np.arange(nrec) + 0.5) * intlen
    times = mids[:, None] + 0.5 * intlen * np.cos(theta)[None, :]
    values = position(times)  # (nrec, n_coef, 3)
    basis = np.cos(np.outer(k, theta)) * (2.0 / n_coef)  # (j, node)
    basis[0] *= 0.5
    return start, intlen, np.einsum('rnc,jn->rcj', values, basis)


def fit_chebyshev(position, span, period_s: float, scale_km: float):
    """
    Type 2 records for ``position(et) -> (..., 3)`` over ``span``: the
    Chebyshev interpolant at :data:`N_COEF` nodes of each record. Records
    are as long as possible (at most four orbits and
    :data:`MAX_RECORD_DAYS`) while the interpolant stays within
    :func:`fit_tolerance_km` of ``position`` between its nodes.
    Returns ``(init, intlen, coeffs)`` with coeffs ``(nrec, 3, N_COEF)``.
    """
    from numpy.polynomial import chebyshev

    tol = fit_tolerance_km(scale_km)
    # probe between the nodes of the first, middle and last records
    x = np.cos(math.pi * np.arange(N_COEF) / N_COEF)
    for orbits in (4.0, 2.0, 1.0, 0.5, 0.25, 0.125, 0.0625):
        target = min(orbits * period_s, MAX_RECORD_DAYS * DAY)
        init, intlen, coeffs = _fit_records(position, span, target, N_COEF)
        err = 0.0
        for r in sorted({0, len(coeffs) // 2, len(coeffs) - 1}):
            t = init + intlen * (r + 0.5 + 0.5 * x)
            fit = np.stack(
                [chebyshev.chebval(x, coeffs[r, c]) for c in range(3)], -1
            )
            err = max(err, float(np.abs(fit - position(t)).max()))
        if err <= tol:
            return init, intlen, coeffs
    raise ValueError(f'no record length fits within {tol} km')


def fit_tolerance_km(scale_km: float) -> float:
    """Largest fit error allowed for an orbit of radius ``scale_km``."""
    return max(1e-4, 1e-13 * scale_km)


def _zero_segment(span):
    return span[0], span[1] - span[0], np.zeros((1, 3, 1))


def _orbits():
    """``(target, center, spans, position, period_s, scale_km)``, in order."""
    f_earth = MOON_EARTH_MASS_RATIO / (1.0 + MOON_EARTH_MASS_RATIO)
    moon = moon_orbit()
    out = []
    for bary in range(1, 10):
        orbit = planet_orbit(bary)
        out.append((bary, 0, (LONG_SPAN,), orbit.position, orbit.period_s,
                    orbit.a))
    out.append((301, 3, (LONG_SPAN,),
                lambda t: (1.0 - f_earth) * moon.position(t),
                moon.period_s, moon.a))
    out.append((399, 3, (LONG_SPAN,), lambda t: -f_earth * moon.position(t),
                moon.period_s, moon.a))
    for body, params in _SATELLITES.items():
        orbit = satellite_orbit(body)
        out.append((body, params[0], (params[-1],), orbit.position,
                    orbit.period_s, orbit.a))
    hst = hst_orbit()
    out.append((_HST[0], _HST[1], HST_SPANS, hst.position, hst.period_s,
                hst.a))
    return out


def _segments():
    """``(target, center, span, (init, intlen, coeffs))`` in file order."""
    segs = [(10, 0, LONG_SPAN, _zero_segment(LONG_SPAN))]
    for planet in (199, 299, 499, 599, 699, 799, 899, 999):
        segs.append((planet, planet // 100, LONG_SPAN,
                     _zero_segment(LONG_SPAN)))
    for target, center, spans, position, period_s, scale in _orbits():
        for span in spans:
            segs.append((target, center, span,
                         fit_chebyshev(position, span, period_s, scale)))
    return segs


def analytic_position(target: int, et) -> np.ndarray:
    """The generator's own position of ``target`` about its SPK center."""
    for body, _, _, position, _, _ in _orbits():
        if body == target:
            return position(et)
    return np.zeros(np.shape(et) + (3,))


def _write_spk(path: str) -> None:
    arrays, names = [], []
    for target, center, span, (init, intlen, coeffs) in _segments():
        arrays.append(
            ((span[0], span[1]), (target, center, 1, 2),
             pack_type_2(init, intlen, coeffs))
        )
        names.append(f'SYNTHETIC {target} WRT {center}')
    write_daf(
        path, arrays, ifname='PLANETMAPPER SYNTHETIC TEST EPHEMERIS',
        names=names,
    )


def _lsk_text() -> str:
    table = '\n'.join(
        f'                   {n}, @{date}' for n, date in _LEAP_SECONDS
    )
    return (
        'KPL/LSK\n\n'
        'Leap seconds kernel written by planetmapper_tpu.kernels.synthetic:\n'
        'the public TAI-UTC table and the DELTET constants of NAIF LSKs.\n\n'
        '\\begindata\n\n'
        'DELTET/DELTA_T_A = 32.184\n'
        'DELTET/K = 1.657D-3\n'
        'DELTET/EB = 1.671D-2\n'
        'DELTET/M = ( 6.239996D0 1.99096871D-7 )\n'
        'DELTET/DELTA_AT = (\n'
        f'{table} )\n\n'
        '\\begintext\n'
    )


def _fmt(values) -> str:
    return '( ' + ' '.join(repr(float(v)) for v in values) + ' )'


def _pck_text() -> str:
    lines = [
        'KPL/PCK', '',
        'Planetary constants written by planetmapper_tpu.kernels.synthetic:',
        'IAU radii, pole and prime meridian terms, no nutation series.',
        '', '\\begindata', '',
    ]
    for body, (radii, ra, dec, pm) in _PCK.items():
        lines += [
            f'BODY{body}_RADII = {_fmt(radii)}',
            f'BODY{body}_POLE_RA = {_fmt(ra + (0.0,))}',
            f'BODY{body}_POLE_DEC = {_fmt(dec + (0.0,))}',
            f'BODY{body}_PM = {_fmt(pm + (0.0,))}',
            '',
        ]
    lines += ['\\begintext', '']
    return '\n'.join(lines)


def write_kernel_set(directory) -> str:
    """
    Write the SPK, LSK and PCK of the synthetic set into ``directory``
    (created if needed) and return its path. A deterministic fixture for
    tests, the benchmark and the chip smoke test, not an ephemeris.
    """
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    _write_spk(os.path.join(directory, SPK_NAME))
    for name, text in ((LSK_NAME, _lsk_text()), (PCK_NAME, _pck_text())):
        with open(os.path.join(directory, name), 'w', encoding='ascii') as f:
            f.write(text)
    with open(os.path.join(directory, 'VERSION'), 'w') as f:
        f.write(SET_VERSION)
    return directory


def default_kernel_dir() -> str:
    """``build/kernels`` of the checkout that holds this package."""
    return str(Path(__file__).resolve().parents[2] / 'build' / 'kernels')


def _is_current(directory: str) -> bool:
    try:
        with open(os.path.join(directory, 'VERSION')) as f:
            return f.read() == SET_VERSION
    except OSError:
        return False


def ensure_kernel_set(directory: str | None = None) -> str:
    """
    Return ``directory`` (default :func:`default_kernel_dir`) holding the
    current synthetic set, generating it first if it is missing or stale.
    Safe when several processes race: each writes into a private temporary
    directory and renames it into place.
    """
    directory = directory or default_kernel_dir()
    if _is_current(directory):
        return directory
    parent = os.path.dirname(directory)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix='.kernels-', dir=parent)
    try:
        write_kernel_set(tmp)
        if os.path.isdir(directory) and not _is_current(directory):
            stale = tempfile.mkdtemp(prefix='.stale-', dir=parent)
            try:
                os.replace(directory, os.path.join(stale, 'kernels'))
            except OSError:
                pass  # another process moved it first
            shutil.rmtree(stale, ignore_errors=True)
        try:
            os.rename(tmp, directory)
        except OSError:
            if not _is_current(directory):  # lost the race to a stale set
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return directory
