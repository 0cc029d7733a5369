"""
Body: the geometry engine API (parity with planetmapper/body.py).

Same public interface as the reference's ``Body`` class (coordinate
transforms between lonlat/radec/km/angular and the internal targvec/obsvec
representations, limb and terminator curves, illumination, visibility,
rings, local solar time, radial velocities, planetographic/planetocentric
conversions), implemented on the batched device scene engine: every transform
accepts floats or arbitrarily-shaped numpy arrays, and array inputs run as
one fused device computation instead of the reference's per-element scalar
SPICE loop (reference base.py:718-759).
"""

from __future__ import annotations

import datetime
import functools
import math
import os
from typing import Any, Literal, TypedDict, TypeVar

import numpy as np

from . import data_loader
from .base import (
    BodyBase,
    FloatOrArray,
    NotFoundError,
    Numeric,
    SpiceError,
    _cache_stable_result,
    _replace_np_arr_args_with_tuples,
    get_pool,
)
from .basic_body import BasicBody
from .core import geometry as geom
from .core.ephemeris import InsufficientDataError
from .core.frames import BodyFrameModel
from .core.scene import SceneEngine
from .kernels.pool import KernelVarNotFoundError

T = TypeVar('T')
S = TypeVar('S', bound='Body')

WireframeComponent = Literal[
    'all', 'grid', 'equator', 'prime_meridian', 'limb', 'limb_illuminated',
    'terminator', 'ring', 'pole', 'coordinate_of_interest_lonlat',
    'coordinate_of_interest_radec', 'other_body_of_interest_marker',
    'other_body_of_interest_label', 'hidden_other_body_of_interest_marker',
    'hidden_other_body_of_interest_label', 'map_boundary',
]
_WireframeComponent = WireframeComponent


class WireframeKwargs(TypedDict, total=False):
    """Keyword arguments accepted by the wireframe plotting functions."""

    label_poles: bool
    add_title: bool
    grid_interval: float
    grid_lat_limit: float
    planetocentric_grid: bool
    indicate_equator: bool
    indicate_prime_meridian: bool
    formatting: dict[WireframeComponent, dict[str, Any]] | None
    alt: float
    color: str | tuple[float, float, float]
    alpha: float
    zorder: float


_WireframeKwargs = WireframeKwargs


class AngularCoordinateKwargs(TypedDict, total=False):
    """Customisation of the relative angular coordinate system."""

    origin_ra: float | None
    origin_dec: float | None
    coordinate_rotation: float


class LonLatGridKwargs(TypedDict, total=False):
    """Keyword arguments of the lon/lat grid generators."""

    npts: int
    lat_limit: float
    alt: float
    planetocentric: bool


# Default formatting for wireframe plots (same component set and defaults as
# the reference, body.py:104-137; defined here, used by _body_plotting).
def _host_unit_from_radec(ra, dec):
    """
    Unit vector(s) from RA/Dec radians, in host numpy. The scalar API's
    coordinate transforms must invert each other exactly: accelerator
    f64 transcendentals may round at ~1e-9 rad (~km on the target plane), so
    every host-side radec/rect conversion goes through this pair.
    """
    with np.errstate(invalid='ignore'):  # NaN in == NaN out, silently
        cos_dec = np.cos(dec)
        return np.stack(
            [np.cos(ra) * cos_dec, np.sin(ra) * cos_dec, np.sin(dec)],
            axis=-1,
        )


def _host_radec_from_unit(v):
    """Inverse of :func:`_host_unit_from_radec`: ``(r, ra, dec)`` radians."""
    r = np.linalg.norm(v, axis=-1)
    ra = np.mod(np.arctan2(v[..., 1], v[..., 0]), 2.0 * np.pi)
    with np.errstate(invalid='ignore'):
        dec = np.arcsin(
            np.clip(v[..., 2] / np.where(r > 0, r, 1.0), -1.0, 1.0)
        )
    return r, ra, dec


def _default_wireframe_formatting():
    import matplotlib.patheffects as path_effects

    return {
        'all': dict(color='k'),
        'grid': dict(alpha=0.5, linestyle=':'),
        'equator': dict(linestyle='-'),
        'prime_meridian': dict(linestyle='-'),
        'limb': dict(linewidth=0.5),
        'limb_illuminated': dict(),
        'terminator': dict(linestyle='--'),
        'ring': dict(linewidth=0.5),
        'pole': dict(
            ha='center', va='center', size='small', weight='bold',
            path_effects=[
                path_effects.Stroke(linewidth=3, foreground='w'),
                path_effects.Normal(),
            ],
            clip_on=True,
        ),
        'coordinate_of_interest_lonlat': dict(marker='x'),
        'coordinate_of_interest_radec': dict(marker='+'),
        'other_body_of_interest_marker': dict(marker='+'),
        'other_body_of_interest_label': dict(
            size='small', ha='center', va='center', alpha=0.5, clip_on=True
        ),
        'hidden_other_body_of_interest_marker': dict(alpha=0.333),
        'hidden_other_body_of_interest_label': dict(),
        'map_boundary': dict(),
    }


class _LazyFormattingDict(dict):
    """Defaults are filled on first *read* (not at import: they need
    matplotlib). Every read path must materialise - ``get``/``keys``
    don't call ``__missing__``, and a consumer iterating an
    unmaterialised dict would silently see no formatting (and drop the
    per-plot coordinate transform carried through the same kwargs)."""

    _materialised = False

    def _materialise(self):
        if not self._materialised:
            self._materialised = True
            # setdefault: a user who customised entries before first
            # use keeps their values; only missing components fill in
            for k, v in _default_wireframe_formatting().items():
                self.setdefault(k, v)

    def __missing__(self, key):
        self._materialise()
        if key not in self:
            raise KeyError(key)
        return self[key]

    def get(self, key, default=None):
        self._materialise()
        return dict.get(self, key, default)

    def keys(self):
        self._materialise()
        return dict.keys(self)

    def items(self):
        self._materialise()
        return dict.items(self)

    def values(self):
        self._materialise()
        return dict.values(self)

    def __iter__(self):
        self._materialise()
        return dict.__iter__(self)

    def __contains__(self, key):
        self._materialise()
        return dict.__contains__(self, key)

    def __len__(self):  # also covers bool()
        self._materialise()
        return dict.__len__(self)

    def __eq__(self, other):
        self._materialise()
        return dict.__eq__(self, other)

    __hash__ = None  # type: ignore[assignment]  # dicts are unhashable

    def __repr__(self):
        self._materialise()
        return dict.__repr__(self)

    def copy(self):
        self._materialise()
        return dict(self)


DEFAULT_WIREFRAME_FORMATTING: dict = _LazyFormattingDict()


def lst_quantization_enabled() -> bool:
    """
    Whether LOCAL-SOLAR-TIME values are quantised to whole seconds.

    CSPICE's et2lst returns integer (hr, mn, sc), so the reference's LST
    backplane is inherently quantised; this framework reproduces that by
    default for output parity. Scientific users who want the continuous
    value can set ``PLANETMAPPER_TPU_LST_QUANTIZATION=off`` - the
    quantisation is a formatting convention, not part of the geometry.
    """
    return os.environ.get(
        'PLANETMAPPER_TPU_LST_QUANTIZATION', 'on'
    ).lower() not in ('off', '0', 'false')


class _AdjustedSurfaceAltitude:
    """
    Context manager temporarily raising the target's surface by ``alt`` km
    (parity with the reference's kernel-pool mutation, body.py:172-230; here
    it simply swaps the radii attributes - the geometry engine takes radii
    as a traced argument so no recompilation happens).
    """

    def __init__(self, body: 'Body', alt: float = 0.0, **kwargs) -> None:
        self.do_adjustment = alt != 0.0 and alt != body._alt_adjustment
        if self.do_adjustment:
            self.body = body
            self.alt = float(alt)
            if not math.isfinite(self.alt):
                raise ValueError(
                    'Cannot adjust surface altitude with non-finite alt value'
                )
            if body._alt_adjustment != 0.0:
                raise ValueError(
                    'Cannot nest _AdjustedSurfaceAltitude context managers '
                    'with alt != 0'
                )

    def __enter__(self) -> None:
        if self.do_adjustment:
            self.original_radii = self.body.radii
            self.change_radii(self.original_radii + self.alt)
            self.body._alt_adjustment = self.alt

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        if self.do_adjustment:
            self.change_radii(self.original_radii)
            self.body._alt_adjustment = 0.0

    def change_radii(self, radii: np.ndarray) -> None:
        """
        Apply new radii to the body (API parity with the reference's
        kernel-pool update, body.py:226; here radii are traced pipeline
        arguments so the swap is just attribute assignment).
        """
        self.body._assign_radius_values(np.asarray(radii, dtype=float))


def _adjust_surface_altitude_decorator(fn):
    @functools.wraps(fn)
    def decorated(self, *args, **kwargs):
        with _AdjustedSurfaceAltitude(self, **kwargs):
            return fn(self, *args, **kwargs)

    return decorated


def _cache_clearable_alt_dependent_result(fn):
    @functools.wraps(fn)
    def decorated(self, *args_in, **kwargs_in):
        args, kwargs = _replace_np_arr_args_with_tuples(args_in, kwargs_in)
        key = (fn.__name__, args, frozenset(kwargs.items()), self._alt_adjustment)
        if key not in self._cache:
            self._cache[key] = fn(self, *args, **kwargs)
        return self._cache[key]

    return decorated


_ENGINE_CACHE: dict[tuple, SceneEngine] = {}


def _get_engine(
    *,
    target_id: int,
    observer_id: int,
    illumination_source_id: int,
    radii: tuple[float, float, float],
    abcorr: str,
    et_ref: float,
) -> SceneEngine:
    from .core.ephemeris import get_ephemeris

    eph = get_ephemeris()
    bucket = round(et_ref / (30 * 86400.0))  # chains are stable over months
    key = (
        target_id, observer_id, illumination_source_id,
        str(abcorr).strip().upper(), bucket, id(eph),
        len(eph._pool.spk_segments),
    )
    engine = _ENGINE_CACHE.get(key)
    if engine is None:
        engine = SceneEngine(
            eph,
            target_id=target_id,
            observer_id=observer_id,
            illumination_source_id=illumination_source_id,
            radii=radii,
            frame_model=BodyFrameModel.from_pool(get_pool(), target_id),
            abcorr=abcorr,
            et_ref=et_ref,
        )
        _ENGINE_CACHE[key] = engine
    return engine


class Body(BodyBase):
    """
    An astronomical body observed at a specific time.

    Full API parity with the reference's ``Body`` (body.py:275): see the
    reference documentation for detailed semantics of each method. All
    coordinate transforms accept floats or numpy arrays (arrays are
    processed in one batched device call).
    """

    def __init__(
        self,
        target: str | int,
        utc: str | datetime.datetime | float | None = None,
        observer: str | int = 'EARTH',
        *,
        aberration_correction: str = 'CN',
        observer_frame: str = 'J2000',
        target_frame: str | None = None,
        illumination_source: str = 'SUN',
        subpoint_method: str = 'INTERCEPT/ELLIPSOID',
        surface_method: str = 'ELLIPSOID',
        **kwargs,
    ) -> None:
        super().__init__(
            target=target,
            utc=utc,
            observer=observer,
            aberration_correction=aberration_correction,
            observer_frame=observer_frame,
            **kwargs,
        )
        self._alt_adjustment = 0.0

        self.illumination_source = illumination_source
        self.subpoint_method = subpoint_method
        self.surface_method = surface_method

        self._target_frame_arg = target_frame
        if target_frame is None:
            self.target_frame = 'IAU_' + self.target
        else:
            self.target_frame = target_frame

        pool = get_pool()
        try:
            self._assign_radius_values(
                np.asarray(pool.bodvar(self.target_body_id, 'RADII', 3))
            )
        except KernelVarNotFoundError as exc:
            raise exc

        # Spin sense from the prime meridian rate; positive planetographic
        # longitude direction with the SUN/MOON/EARTH special cases
        # (reference body.py:524-535)
        pm = pool.bodvar(self.target_body_id, 'PM')
        self.prograde = bool(pm[1] >= 0)
        if self.prograde and self.target_body_id not in {10, 301, 399}:
            self.positive_longitude_direction = 'W'
        else:
            self.positive_longitude_direction = 'E'

        from .kernels import naif_ids

        try:
            illum_id = naif_ids.bods2c(
                self.illumination_source, pool.extra_body_names()[0]
            )
        except naif_ids.BodyNotFoundError as exc:
            raise NotFoundError(str(exc)) from exc
        self._illumination_source_id = illum_id

        self._engine = _get_engine(
            target_id=self.target_body_id,
            observer_id=self._observer_body_id,
            illumination_source_id=illum_id,
            radii=tuple(self.radii),
            abcorr=self.aberration_correction,
            et_ref=self.et,
        )
        try:
            self._scene = self._engine.scene_constants(self.et, self.radii)
        except InsufficientDataError as exc:
            from .base import _kernel_error_help_note

            raise SpiceError(
                str(exc) + '\n\n' + _kernel_error_help_note()
            ) from exc

        # Sub-observer point attributes (reference body.py:538-555)
        self._subpoint_targvec = self._scene['subpoint_targvec']
        self._subpoint_et = float(self._scene['subpoint_et'])
        self._subpoint_rayvec = self._scene['subpoint_rayvec']
        self._subpoint_obsvec = self._scene['subpoint_obsvec']
        self.subpoint_distance = float(self._scene['subpoint_distance'])
        self.subpoint_lon, self.subpoint_lat = self._radian_pair2degrees(
            self._lon_east2positive_radians(
                float(self._scene['subpoint_lon_e_rad'])
            ),
            float(self._scene['subpoint_lat_rad']),
        )
        self._subpoint_ra = float(
            np.rad2deg(self._scene['subpoint_ra_rad'])
        )
        self._subpoint_dec = float(
            np.rad2deg(self._scene['subpoint_dec_rad'])
        )

        # Sub-solar point (NaN when the target is the illumination source)
        subsol = self._scene['subsol_targvec']
        if np.all(np.isfinite(subsol)):
            self._subsol_targvec = subsol
            self.subsol_lon, self.subsol_lat = self._radian_pair2degrees(
                self._lon_east2positive_radians(
                    float(self._scene['subsol_lon_e_rad'])
                ),
                float(self._scene['subsol_lat_rad']),
            )
        else:
            self._subsol_targvec = np.full(3, np.nan)
            self.subsol_lon = np.nan
            self.subsol_lat = np.nan

        self.target_diameter_arcsec = float(
            2.0 * 60.0 * 60.0
            * np.rad2deg(np.arcsin(self.r_eq / self.target_distance))
        )
        self.km_per_arcsec = (2.0 * self.r_eq) / self.target_diameter_arcsec

        # Equatorial (ring) plane in obsvec space (reference body.py:582-588;
        # computed inside the scene-constants program)
        self._ring_plane = (
            np.asarray(self._scene['ring_plane_normal'], dtype=float),
            float(self._scene['ring_plane_constant']),
        )

        self.named_ring_data = data_loader.get_ring_radii().get(self.target, {})
        self.ring_radii: set[float] = set()
        self.other_bodies_of_interest: list[Body | BasicBody] = []
        self.coordinates_of_interest_lonlat: list[tuple[float, float]] = []
        self.coordinates_of_interest_radec: list[tuple[float, float]] = []

        self._matrix_km2angular: np.ndarray | None = None
        self._matrix_angular2km: np.ndarray | None = None

        if self.target == 'SATURN':
            for k in ['A', 'B', 'C']:
                for r in self.named_ring_data.get(k, []):
                    self.ring_radii.add(r)

    # ------------------------------------------------------------------
    def _assign_radius_values(self, radii: np.ndarray) -> None:
        self.radii = radii
        self.r_eq = float(radii[0])
        self.r_polar = float(radii[2])
        self.flattening = (self.r_eq - self.r_polar) / self.r_eq

    def __repr__(self) -> str:
        return self._generate_repr('target', 'utc', kwarg_keys=['observer'])

    def _get_equality_tuple(self) -> tuple:
        return (
            self.illumination_source,
            self.subpoint_method,
            self.surface_method,
            self.target_frame,
            super()._get_equality_tuple(),
        )

    def _get_kwargs(self) -> dict[str, Any]:
        return super()._get_kwargs() | dict(
            target_frame=self._target_frame_arg,
            illumination_source=self.illumination_source,
            subpoint_method=self.subpoint_method,
            surface_method=self.surface_method,
        )

    @classmethod
    def _get_default_init_kwargs(cls) -> dict[str, Any]:
        return dict(
            utc=None,
            observer='EARTH',
            aberration_correction='CN',
            observer_frame='J2000',
            target_frame=None,
            illumination_source='SUN',
            subpoint_method='INTERCEPT/ELLIPSOID',
            surface_method='ELLIPSOID',
            **super()._get_default_init_kwargs(),
        )

    def _copy_options_to_other(self, other) -> None:
        super()._copy_options_to_other(other)
        other.other_bodies_of_interest = self.other_bodies_of_interest.copy()
        other.coordinates_of_interest_lonlat = (
            self.coordinates_of_interest_lonlat.copy()
        )
        other.coordinates_of_interest_radec = (
            self.coordinates_of_interest_radec.copy()
        )
        other.ring_radii = self.ring_radii.copy()

    # ------------------------------------------------------------------
    # Other bodies
    # ------------------------------------------------------------------
    def create_other_body(
        self, other_target: str | int, fallback_to_basic_body: bool = True
    ) -> 'Body | BasicBody':
        """Create a Body with identical parameters but a different target."""
        try:
            try:
                return Body(
                    target=other_target,
                    utc=self.utc,
                    observer=self.observer,
                    observer_frame=self.observer_frame,
                    illumination_source=self.illumination_source,
                    aberration_correction=self.aberration_correction,
                    subpoint_method=self.subpoint_method,
                    surface_method=self.surface_method,
                )
            except KernelVarNotFoundError:
                if not fallback_to_basic_body:
                    raise
                return BasicBody(
                    target=other_target,
                    utc=self.utc,
                    observer=self.observer,
                    observer_frame=self.observer_frame,
                    aberration_correction=self.aberration_correction,
                )
        except NotFoundError as e:
            raise NotFoundError(
                f'{e}\n\nBody name: {other_target!r}'
            ) from e

    def add_other_bodies_of_interest(
        self, *other_targets: str | int, only_visible: bool = False
    ) -> None:
        """Add targets to :attr:`other_bodies_of_interest`."""
        for other_target in other_targets:
            body = self.create_other_body(other_target)
            if only_visible and not self.test_if_other_body_visible(body):
                continue
            if body not in self.other_bodies_of_interest:
                self.other_bodies_of_interest.append(body)

    def _get_all_satellite_bodies(
        self, skip_insufficient_data: bool = False, only_visible: bool = False
    ) -> 'list[Body | BasicBody]':
        from .kernels import naif_ids

        out: list[Body | BasicBody] = []
        id_base = (self.target_body_id // 100) * 100
        for other_target_id in range(id_base + 1, id_base + 99):
            try:
                body = self.create_other_body(other_target_id)
                if only_visible and not self.test_if_other_body_visible(body):
                    continue
                out.append(body)
            except (SpiceError, InsufficientDataError) as exc:
                if isinstance(exc, NotFoundError):
                    continue
                if skip_insufficient_data:
                    continue
                try:
                    naif_ids.bodc2n(other_target_id)
                except naif_ids.BodyNotFoundError:
                    continue
                raise
        return out

    def add_satellites_to_bodies_of_interest(
        self, skip_insufficient_data: bool = False, only_visible: bool = False
    ) -> None:
        """Add all satellites in the target's system (by NAIF ID range)."""
        satellites = self._get_all_satellite_bodies(
            skip_insufficient_data=skip_insufficient_data,
            only_visible=only_visible,
        )
        for satellite in satellites:
            if satellite not in self.other_bodies_of_interest:
                self.other_bodies_of_interest.append(satellite)

    # ------------------------------------------------------------------
    # Rings data helpers
    # ------------------------------------------------------------------
    @staticmethod
    def _standardise_ring_name(name: str) -> str:
        name = name.casefold().strip().removesuffix('ring')
        for a, b in data_loader.get_ring_aliases().items():
            name = name.replace(a, b)
        return name.casefold().strip()

    def ring_radii_from_name(self, name: str) -> list[float]:
        """Ring radii in km for a named ring from :attr:`named_ring_data`."""
        name = self._standardise_ring_name(name)
        for n, radii in self.named_ring_data.items():
            if name == self._standardise_ring_name(n):
                return radii
        raise ValueError(
            f'No rings found named {name!r} in named_ring_data.'
            + '\nValid names: {}'.format(
                [self._standardise_ring_name(n) for n in self.named_ring_data]
            )
        )

    def add_named_rings(self, *names: str) -> None:
        """Add named rings (all by default) to :attr:`ring_radii`."""
        if len(names) == 0:
            names = tuple(self.named_ring_data.keys())
        for name in names:
            self.ring_radii.update(self.ring_radii_from_name(name))

    # ------------------------------------------------------------------
    # Core coordinate transformations (all built to/from obsvec)
    # ------------------------------------------------------------------
    def _lonlat_pgr_to_east_radians(self, lon, lat):
        """Planetographic degrees -> east-positive radians."""
        lon = np.deg2rad(lon)
        lat = np.deg2rad(lat)
        if self.positive_longitude_direction == 'W':
            lon = -lon
        return lon, lat

    def _east_radians_to_lonlat_pgr(self, lon_e, lat):
        """East-positive radians -> planetographic degrees in [0, 360)."""
        lon = np.rad2deg(lon_e)
        if self.positive_longitude_direction == 'W':
            lon = -lon
        lon = np.mod(lon, 360.0)
        return lon, np.rad2deg(lat)

    def _lonlat2targvec_radians(
        self, lon, lat, *, alt: float, not_visible_nan: bool
    ) -> np.ndarray:
        """Planetographic radians -> body-fixed vectors (pgrrec equivalent)."""
        lon = np.asarray(lon, dtype=float)
        lat = np.asarray(lat, dtype=float)
        lon_e = -lon if self.positive_longitude_direction == 'W' else lon
        from .core.scene import _host_device

        with _host_device():
            # host CPU: an accelerator's f64 transcendentals may round at
            # ~1e-9, which breaks exact round trips of the scalar API
            targvec = np.asarray(
                geom.geodetic_to_rect(
                    lon_e, lat, np.asarray(alt, dtype=float),
                    self.r_eq, self.flattening,
                )
            )
        bad = ~(np.isfinite(lon) & np.isfinite(lat) & np.isfinite(alt))
        if np.any(bad):
            targvec = np.where(
                np.asarray(bad)[..., None], np.nan, targvec
            )
        if not_visible_nan:
            visible = self._test_if_targvec_visible_batch(
                targvec, on_surface=(alt == 0.0)
            )
            targvec = np.where(np.asarray(visible)[..., None], targvec, np.nan)
        return targvec

    def _lon_east2positive_radians(self, lon_e: float) -> float:
        """East-positive longitude -> the body's positive direction."""
        if self.positive_longitude_direction == 'W':
            return float(np.mod(-lon_e, 2 * np.pi))
        return float(np.mod(lon_e, 2 * np.pi))

    def _targvec2lonlat_radians(self, targvec):
        """Body-fixed vectors -> planetographic radians (recpgr equivalent)."""
        targvec = np.asarray(targvec, dtype=float)
        from .core.scene import _host_device

        with _host_device():  # see _lonlat2targvec_radians
            lon_e, lat, _alt = geom.rect_to_geodetic(
                targvec, self.r_eq, self.flattening
            )
        lon_e = np.asarray(lon_e)
        lat = np.asarray(lat)
        if self.positive_longitude_direction == 'W':
            lon = np.mod(-lon_e, 2 * np.pi)
        else:
            lon = np.mod(lon_e, 2 * np.pi)
        bad = ~np.all(np.isfinite(targvec), axis=-1)
        lon = np.where(bad, np.nan, lon)
        lat = np.where(bad, np.nan, lat)
        if lon.ndim == 0:
            return float(lon), float(lat)
        return lon, lat

    def _sub_consts(self) -> dict:
        return {
            'subpoint_targvec': self._subpoint_targvec,
            'subpoint_rayvec': self._subpoint_rayvec,
            'subpoint_obsvec': self._subpoint_obsvec,
            'subpoint_distance': self.subpoint_distance,
            'subpoint_et': self._subpoint_et,
        }

    def _targvec2obsvec(self, targvec: np.ndarray) -> np.ndarray:
        """
        Body-fixed -> observer-frame vectors with per-point light-time
        retargeting (reference body.py:917-948).
        """
        return np.asarray(
            self._engine.targvec2obsvec(
                np.asarray(targvec, dtype=float), self._sub_consts()
            )
        )

    def _obsvec2targvec(self, obsvec: np.ndarray) -> np.ndarray:
        """Observer-frame -> body-fixed vectors (reference body.py:972-1006)."""
        return np.asarray(
            self._engine.obsvec2targvec(
                np.asarray(obsvec, dtype=float), self._sub_consts()
            )
        )

    def _rayvec2obsvec(self, rayvec: np.ndarray, et: float) -> np.ndarray:
        """Target-frame ray at epoch ``et`` -> observer frame vector."""
        m = np.asarray(
            self._engine.frame_model.bodyfixed_to_j2000_matrix(float(et))
        )
        return m @ np.asarray(rayvec, dtype=float)

    def _radec2obsvec_norm_radians(self, ra, dec) -> np.ndarray:
        ra = np.asarray(ra, dtype=float)
        dec = np.asarray(dec, dtype=float)
        out = _host_unit_from_radec(ra, dec)
        bad = ~(np.isfinite(ra) & np.isfinite(dec))
        if np.any(bad):
            out = np.where(np.asarray(bad)[..., None], np.nan, out)
        return out

    def _radec2obsvec_norm(self, ra, dec) -> np.ndarray:
        return self._radec2obsvec_norm_radians(
            *self._degree_pair2radians(ra, dec)
        )

    def _obsvec_norm2targvec(self, obsvec_norm: np.ndarray) -> np.ndarray:
        """
        Surface intercepts of rays from the observer (sincpt equivalent).
        Scalar input raises NotFoundError when the ray misses; batched
        inputs return NaN rows.
        """
        obsvec_norm = np.asarray(obsvec_norm, dtype=float)
        targvec, trgepc, found = self._engine.sincpt(
            self.et, self.radii, obsvec_norm, self.target_light_time
        )
        targvec = np.asarray(targvec)
        if obsvec_norm.ndim == 1:
            if not bool(np.asarray(found)):
                raise NotFoundError(
                    'No intercept found between the ray and the target body'
                )
        return targvec

    # Useful composite transforms --------------------------------------------
    def _lonlat2obsvec(
        self, lon, lat, *, alt: float, not_visible_nan: bool,
        planetocentric: bool,
    ) -> np.ndarray:
        if planetocentric:
            lon, lat = self.centric2graphic_lonlat(lon, lat, alt=alt)
        return self._targvec2obsvec(
            self._lonlat2targvec_radians(
                *self._degree_pair2radians(
                    np.asarray(lon, dtype=float), np.asarray(lat, dtype=float)
                ),
                alt=alt,
                not_visible_nan=not_visible_nan,
            ),
        )

    def _obsvec_norm2lonlat(
        self, obsvec_norm, *, not_found_nan: bool, alt: float,
        planetocentric: bool,
    ):
        with _AdjustedSurfaceAltitude(self, alt):
            obsvec_norm = np.asarray(obsvec_norm, dtype=float)
            scalar = obsvec_norm.ndim == 1
            if scalar and not not_found_nan:
                targvec = self._obsvec_norm2targvec(obsvec_norm)  # may raise
            else:
                targvec, _, _ = self._engine.sincpt(
                    self.et, self.radii, obsvec_norm, self.target_light_time
                )
                targvec = np.asarray(targvec)
            lon, lat = self._radian_pair2degrees(
                *self._targvec2lonlat_radians(targvec)
            )
            if planetocentric:
                lon, lat = self.graphic2centric_lonlat(lon, lat, alt=alt)
            return lon, lat

    # Public transforms ------------------------------------------------------
    def lonlat2radec(
        self, lon: FloatOrArray, lat: FloatOrArray, *, alt: float = 0.0,
        not_visible_nan: bool = True, planetocentric: bool = False,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Planetographic lonlat -> RA/Dec for the observer."""
        return self._maybe_transform_as_arrays(
            self._lonlat2radec, lon, lat, alt=alt,
            not_visible_nan=not_visible_nan, planetocentric=planetocentric,
        )

    def _lonlat2radec(
        self, lon, lat, *, alt, not_visible_nan, planetocentric
    ):
        return self._obsvec2radec(
            self._lonlat2obsvec(
                lon, lat, alt=alt, not_visible_nan=not_visible_nan,
                planetocentric=planetocentric,
            )
        )

    def radec2lonlat(
        self, ra: FloatOrArray, dec: FloatOrArray, *,
        not_found_nan: bool = True, alt: float = 0.0,
        planetocentric: bool = False,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """RA/Dec -> planetographic lonlat (NaN where missing the disc)."""
        return self._maybe_transform_as_arrays(
            self._radec2lonlat, ra, dec, not_found_nan=not_found_nan,
            alt=alt, planetocentric=planetocentric,
        )

    def _radec2lonlat(
        self, ra, dec, *, not_found_nan, alt, planetocentric
    ):
        return self._obsvec_norm2lonlat(
            self._radec2obsvec_norm(ra, dec),
            not_found_nan=not_found_nan, alt=alt,
            planetocentric=planetocentric,
        )

    def lonlat2targvec(
        self, lon: float, lat: float, *, alt: float = 0.0,
        not_visible_nan: bool = False, planetocentric: bool = False,
    ) -> np.ndarray:
        """Planetographic lonlat -> body-fixed rectangular vector."""
        if planetocentric:
            lon, lat = self.centric2graphic_lonlat(lon, lat, alt=alt)
        return self._lonlat2targvec_radians(
            *self._degree_pair2radians(
                np.asarray(lon, dtype=float), np.asarray(lat, dtype=float)
            ),
            alt=alt, not_visible_nan=not_visible_nan,
        )

    def targvec2lonlat(
        self, targvec: np.ndarray, *, alt: float = 0.0,
        planetocentric: bool = False,
    ) -> tuple[float, float]:
        """Body-fixed rectangular vector -> planetographic lonlat."""
        with _AdjustedSurfaceAltitude(self, alt):
            lon, lat = self._radian_pair2degrees(
                *self._targvec2lonlat_radians(targvec)
            )
            if planetocentric:
                lon, lat = self.graphic2centric_lonlat(lon, lat)
            return lon, lat

    def _targvec_arr2radec_arrs_radians(
        self, targvec_arr, condition_func=None
    ):
        targvec_arr = np.asarray(targvec_arr, dtype=float)
        if condition_func is not None:
            keep = np.array([bool(condition_func(t)) for t in targvec_arr])
            targvec_arr = np.where(keep[..., None], targvec_arr, np.nan)
        obsvec = self._targvec2obsvec(targvec_arr)
        ra, dec = self._obsvec2radec_radians(obsvec)
        return np.asarray(ra), np.asarray(dec)

    def _targvec_arr2radec_arrs(self, targvec_arr, condition_func=None):
        return self._radian_pair2degrees(
            *self._targvec_arr2radec_arrs_radians(targvec_arr, condition_func)
        )

    # Angular coordinates ----------------------------------------------------
    @_cache_stable_result
    def _get_obsvec2angular_matrix(
        self, *, origin_ra: float | None = None,
        origin_dec: float | None = None, coordinate_rotation: float = 0.0,
    ) -> np.ndarray:
        from .core.scene import _host_device

        with _host_device():
            return self._get_obsvec2angular_matrix_impl(
                origin_ra=origin_ra, origin_dec=origin_dec,
                coordinate_rotation=coordinate_rotation,
            )

    def _get_obsvec2angular_matrix_impl(
        self, *, origin_ra, origin_dec, coordinate_rotation,
    ) -> np.ndarray:
        if origin_ra is None:
            origin_ra = self.target_ra
        if origin_dec is None:
            origin_dec = self.target_dec
        origin_obsvec = self._radec2obsvec_norm_radians(
            *self._degree_pair2radians(origin_ra, origin_dec)
        )
        _, ra_angle, _ = _host_radec_from_unit(np.asarray(origin_obsvec))
        ra_matrix = _spice_rotate(float(ra_angle), 3)
        _, _, dec_angle = _host_radec_from_unit(ra_matrix @ origin_obsvec)
        dec_matrix = _spice_rotate(-float(dec_angle), 2)
        rotation_matrix = _spice_rotate(np.deg2rad(coordinate_rotation), 1)
        return rotation_matrix @ dec_matrix @ ra_matrix

    def _obsvec2angular(self, obsvec, **angular_kwargs):
        obsvec = np.asarray(obsvec, dtype=float)
        m = self._get_obsvec2angular_matrix(**angular_kwargs)
        vec = obsvec @ m.T
        _r, x_rad, y_rad = _host_radec_from_unit(vec)
        x = np.mod(-np.rad2deg(np.asarray(x_rad)), 360.0)
        x = np.where(x > 180.0, x - 360.0, x)
        y = np.rad2deg(np.asarray(y_rad))
        bad = ~np.all(np.isfinite(obsvec), axis=-1)
        x = np.where(bad, np.nan, x)
        y = np.where(bad, np.nan, y)
        if x.ndim == 0:
            return float(x) * 3600.0, float(y) * 3600.0
        return x * 3600.0, y * 3600.0

    def _angular2obsvec_norm(self, angular_x, angular_y, **angular_kwargs):
        angular_x = np.asarray(angular_x, dtype=float)
        angular_y = np.asarray(angular_y, dtype=float)
        vec = _host_unit_from_radec(
            -np.deg2rad(angular_x / 3600.0),
            np.deg2rad(angular_y / 3600.0),
        )
        m = self._get_obsvec2angular_matrix(**angular_kwargs)
        return vec @ m  # (M^T @ v)^T = v @ M

    def radec2angular(
        self, ra: FloatOrArray, dec: FloatOrArray, *,
        origin_ra: float | None = None, origin_dec: float | None = None,
        coordinate_rotation: float = 0.0,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """RA/Dec -> relative angular coordinates (arcsec)."""
        return self._maybe_transform_as_arrays(
            self._radec2angular, ra, dec, origin_ra=origin_ra,
            origin_dec=origin_dec, coordinate_rotation=coordinate_rotation,
        )

    def _radec2angular(self, ra, dec, **angular_kwargs):
        return self._obsvec2angular(
            self._radec2obsvec_norm(ra, dec), **angular_kwargs
        )

    def angular2radec(
        self, angular_x: FloatOrArray, angular_y: FloatOrArray,
        **angular_kwargs,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Relative angular coordinates -> RA/Dec."""
        return self._maybe_transform_as_arrays(
            self._angular2radec, angular_x, angular_y, **angular_kwargs
        )

    def _angular2radec(self, angular_x, angular_y, **angular_kwargs):
        return self._obsvec2radec(
            self._angular2obsvec_norm(angular_x, angular_y, **angular_kwargs)
        )

    def angular2lonlat(
        self, angular_x: FloatOrArray, angular_y: FloatOrArray, *,
        not_found_nan: bool = True, alt: float = 0.0,
        planetocentric: bool = False, **angular_kwargs,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Relative angular coordinates -> planetographic lonlat."""
        return self._maybe_transform_as_arrays(
            self._angular2lonlat, angular_x, angular_y,
            not_found_nan=not_found_nan, alt=alt,
            planetocentric=planetocentric, **angular_kwargs,
        )

    def _angular2lonlat(
        self, angular_x, angular_y, *, not_found_nan, alt, planetocentric,
        **angular_kwargs,
    ):
        return self._obsvec_norm2lonlat(
            self._angular2obsvec_norm(angular_x, angular_y, **angular_kwargs),
            not_found_nan=not_found_nan, alt=alt,
            planetocentric=planetocentric,
        )

    def lonlat2angular(
        self, lon: FloatOrArray, lat: FloatOrArray, *, alt: float = 0.0,
        not_visible_nan: bool = True, planetocentric: bool = False,
        **angular_kwargs,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Planetographic lonlat -> relative angular coordinates."""
        return self._maybe_transform_as_arrays(
            self._lonlat2angular, lon, lat, alt=alt,
            not_visible_nan=not_visible_nan, planetocentric=planetocentric,
            **angular_kwargs,
        )

    def _lonlat2angular(
        self, lon, lat, *, alt, not_visible_nan, planetocentric,
        **angular_kwargs,
    ):
        return self._obsvec2angular(
            self._lonlat2obsvec(
                lon, lat, alt=alt, not_visible_nan=not_visible_nan,
                planetocentric=planetocentric,
            ),
            **angular_kwargs,
        )

    # km <-> angular ---------------------------------------------------------
    def _get_km2angular_matrix(self) -> np.ndarray:
        if self._matrix_km2angular is None:
            from .core.scene import _host_device

            s = 1 / self.km_per_arcsec
            with _host_device():
                theta_radians = np.deg2rad(self.north_pole_angle())
            self._matrix_km2angular = s * self._rotation_matrix_radians(
                theta_radians
            )
        return self._matrix_km2angular

    def _get_angular2km_matrix(self) -> np.ndarray:
        if self._matrix_angular2km is None:
            self._matrix_angular2km = np.linalg.inv(
                self._get_km2angular_matrix()
            )
        return self._matrix_angular2km

    def _km2obsvec_norm(self, km_x, km_y) -> np.ndarray:
        km = np.stack(
            np.broadcast_arrays(
                np.asarray(km_x, dtype=float), np.asarray(km_y, dtype=float)
            ),
            axis=-1,
        )
        ang = km @ self._get_km2angular_matrix().T
        return self._angular2obsvec_norm(ang[..., 0], ang[..., 1])

    def _obsvec2km(self, obsvec):
        ax, ay = self._obsvec2angular(obsvec)
        ang = np.stack(np.broadcast_arrays(np.asarray(ax), np.asarray(ay)), axis=-1)
        km = ang @ self._get_angular2km_matrix().T
        if km.ndim == 1:
            return float(km[0]), float(km[1])
        return km[..., 0], km[..., 1]

    def km2radec(
        self, km_x: FloatOrArray, km_y: FloatOrArray
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Target-plane km -> RA/Dec."""
        return self._maybe_transform_as_arrays(self._km2radec, km_x, km_y)

    def _km2radec(self, km_x, km_y):
        return self._obsvec2radec(self._km2obsvec_norm(km_x, km_y))

    def radec2km(
        self, ra: FloatOrArray, dec: FloatOrArray
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """RA/Dec -> target-plane km."""
        return self._maybe_transform_as_arrays(self._radec2km, ra, dec)

    def _radec2km(self, ra, dec):
        return self._obsvec2km(self._radec2obsvec_norm(ra, dec))

    def km2lonlat(
        self, km_x: FloatOrArray, km_y: FloatOrArray, *,
        not_found_nan: bool = True, alt: float = 0.0,
        planetocentric: bool = False,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Target-plane km -> planetographic lonlat."""
        return self._maybe_transform_as_arrays(
            self._km2lonlat, km_x, km_y, not_found_nan=not_found_nan,
            alt=alt, planetocentric=planetocentric,
        )

    def _km2lonlat(self, km_x, km_y, *, not_found_nan, alt, planetocentric):
        return self._obsvec_norm2lonlat(
            self._km2obsvec_norm(km_x, km_y), not_found_nan=not_found_nan,
            alt=alt, planetocentric=planetocentric,
        )

    def lonlat2km(
        self, lon: FloatOrArray, lat: FloatOrArray, *, alt: float = 0.0,
        not_visible_nan: bool = True, planetocentric: bool = False,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Planetographic lonlat -> target-plane km."""
        return self._maybe_transform_as_arrays(
            self._lonlat2km, lon, lat, alt=alt,
            not_visible_nan=not_visible_nan, planetocentric=planetocentric,
        )

    def _lonlat2km(self, lon, lat, *, alt, not_visible_nan, planetocentric):
        return self._obsvec2km(
            self._lonlat2obsvec(
                lon, lat, alt=alt, not_visible_nan=not_visible_nan,
                planetocentric=planetocentric,
            )
        )

    def km2angular(
        self, km_x: FloatOrArray, km_y: FloatOrArray, **angular_kwargs
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Target-plane km -> relative angular coordinates."""
        return self._maybe_transform_as_arrays(
            self._km2angular, km_x, km_y, **angular_kwargs
        )

    def _km2angular(self, km_x, km_y, **angular_kwargs):
        return self._obsvec2angular(
            self._km2obsvec_norm(km_x, km_y), **angular_kwargs
        )

    def angular2km(
        self, angular_x: FloatOrArray, angular_y: FloatOrArray,
        **angular_kwargs,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Relative angular coordinates -> target-plane km."""
        return self._maybe_transform_as_arrays(
            self._angular2km, angular_x, angular_y, **angular_kwargs
        )

    def _angular2km(self, angular_x, angular_y, **angular_kwargs):
        return self._obsvec2km(
            self._angular2obsvec_norm(angular_x, angular_y, **angular_kwargs)
        )

    # ------------------------------------------------------------------
    # Illumination
    # ------------------------------------------------------------------
    def _illumf_from_targvec_radians(self, targvec):
        targvec = np.asarray(targvec, dtype=float)
        scalar = targvec.ndim == 1
        if scalar and not np.all(np.isfinite(targvec)):
            return np.nan, np.nan, np.nan, False, False
        phase, incdnc, emissn, visibl, lit = self._engine.illumf(
            self.et, self.radii, targvec
        )
        if scalar:
            return (
                float(phase), float(incdnc), float(emissn),
                bool(visibl), bool(lit),
            )
        bad = ~np.all(np.isfinite(targvec), axis=-1)
        phase = np.where(bad, np.nan, np.asarray(phase))
        incdnc = np.where(bad, np.nan, np.asarray(incdnc))
        emissn = np.where(bad, np.nan, np.asarray(emissn))
        visibl = np.where(bad, False, np.asarray(visibl))
        lit = np.where(bad, False, np.asarray(lit))
        return phase, incdnc, emissn, visibl, lit

    def _illumination_angles_from_targvec_radians(self, targvec):
        phase, incdnc, emissn, visibl, lit = self._illumf_from_targvec_radians(
            targvec
        )
        return phase, incdnc, emissn

    def illumination_angles_from_lonlat(
        self, lon: float, lat: float, *, alt: float = 0.0,
        planetocentric: bool = False,
    ) -> tuple[float, float, float]:
        """(phase, incidence, emission) angles in degrees for a lonlat."""
        phase, incdnc, emissn = self._illumination_angles_from_targvec_radians(
            self.lonlat2targvec(lon, lat, alt=alt, planetocentric=planetocentric)
        )
        return np.rad2deg(phase), np.rad2deg(incdnc), np.rad2deg(emissn)

    def _azimuth_angle_from_gie_radians(
        self, phase_radians: Numeric, incidence_radians: Numeric,
        emission_radians: Numeric,
    ) -> Numeric:
        # Azimuth from the spherical triangle of the three illumination
        # angles (same formula as the reference, body.py:2319-2332)
        a = np.cos(phase_radians) - np.cos(emission_radians) * np.cos(
            incidence_radians
        )
        b = np.sqrt(1.0 - np.cos(emission_radians) ** 2) * np.sqrt(
            1.0 - np.cos(incidence_radians) ** 2
        )
        return np.pi - np.arccos(a / b)  # type: ignore[return-value]

    def azimuth_angle_from_lonlat(
        self, lon: float, lat: float, *, alt: float = 0.0,
        planetocentric: bool = False,
    ) -> float:
        """Azimuth angle in degrees for a lonlat."""
        azimuth_radians = self._azimuth_angle_from_gie_radians(
            *self._illumination_angles_from_targvec_radians(
                self.lonlat2targvec(
                    lon, lat, alt=alt, planetocentric=planetocentric
                )
            )
        )
        return np.rad2deg(azimuth_radians)

    def _test_if_targvec_illuminated(self, targvec) -> bool:
        phase, incdnc, emissn, visibl, lit = self._illumf_from_targvec_radians(
            targvec
        )
        return lit

    def test_if_lonlat_illuminated(
        self, lon: float, lat: float, *, alt: float = 0.0,
        planetocentric: bool = False,
    ) -> bool:
        """Test if a surface point is illuminated."""
        return self._test_if_targvec_illuminated(
            self.lonlat2targvec(lon, lat, alt=alt, planetocentric=planetocentric)
        )

    # ------------------------------------------------------------------
    # Visibility
    # ------------------------------------------------------------------
    def _test_if_targvec_visible_batch(self, targvec, *, on_surface: bool):
        targvec = np.asarray(targvec, dtype=float)
        if on_surface:
            phase, incdnc, emissn, visibl, lit = (
                self._illumf_from_targvec_radians(targvec)
            )
            return visibl
        # Off-surface: search for an intercept between the observer->point
        # ray and the surface; if found, the point is visible only when it
        # is in front of the intercept (reference body.py:2131-2150).
        obsvec = self._targvec2obsvec(targvec)
        norm = np.linalg.norm(obsvec, axis=-1, keepdims=True)
        d = obsvec / norm
        intercept, trgepc, found = self._engine.sincpt(
            self.et, self.radii, d, self.target_light_time
        )
        found = np.asarray(found)
        intercept = np.asarray(intercept)
        state_i, lt_i = self._engine.spkcpt(
            self.et, np.where(found[..., None], intercept, 0.0)
        )
        state_p, lt_p = self._engine.spkcpt(self.et, targvec)
        visible = (~found) | (np.asarray(lt_p) < np.asarray(lt_i))
        bad = ~np.all(np.isfinite(targvec), axis=-1)
        visible = np.where(bad, False, visible)
        if targvec.ndim == 1:
            return bool(visible)
        return visible

    def _test_if_targvec_visible(self, targvec, *, on_surface: bool) -> bool:
        return self._test_if_targvec_visible_batch(
            targvec, on_surface=on_surface
        )

    def test_if_lonlat_visible(
        self, lon: float, lat: float, *, alt: float = 0.0,
        planetocentric: bool = False,
    ) -> bool:
        """Test if a (possibly elevated) surface point is visible."""
        return self._test_if_targvec_visible(
            self.lonlat2targvec(lon, lat, alt=alt, planetocentric=planetocentric),
            on_surface=alt == 0.0,
        )

    def other_body_los_intercept(
        self, other: 'str | int | Body | BasicBody', *, alt: float = 0.0
    ) -> None | str:
        """
        Line-of-sight intercept classification between the target and
        another body: None / 'hidden' / 'part hidden' / 'transit' /
        'part transit' / 'same'.
        """
        if not isinstance(other, BodyBase):
            other = self.create_other_body(other)

        with _AdjustedSurfaceAltitude(self, alt):
            if isinstance(other, BasicBody):
                try:
                    self.radec2lonlat(
                        other.target_ra, other.target_dec, not_found_nan=False
                    )
                except NotFoundError:
                    return None
                if other.target_distance == self.target_distance:
                    return 'same'
                elif other.target_distance - self.target_distance > 0:
                    return 'hidden'
                else:
                    return 'transit'

            assert isinstance(other, Body)
            if (
                other.target_body_id == self.target_body_id
                or np.allclose(other._target_obsvec, self._target_obsvec)
            ):
                return 'same'
            return self._occultation_classification(other)

    def _occultation_classification(self, other: 'Body') -> None | str:
        """
        Classify disc overlap (``occult`` equivalent): samples each body's
        limb and centre and tests angular containment within the other's
        projected limb.
        """
        n = 180

        def limb_and_centre(body: 'Body'):
            ra, dec = body.limb_radec(npts=n, close_loop=False)
            return ra, dec

        ra_s, dec_s = limb_and_centre(self)
        ra_o, dec_o = limb_and_centre(other)

        # Angular radius containment test: a point is "inside" a body's disc
        # if the ray towards it intercepts the body's ellipsoid.
        def fraction_overlapping(body: 'Body', ra_arr, dec_arr):
            lon, lat = body.radec2lonlat(
                np.asarray(ra_arr), np.asarray(dec_arr)
            )
            return np.mean(np.isfinite(np.asarray(lon)))

        other_on_self = fraction_overlapping(self, ra_o, dec_o)
        centre_on_self = np.isfinite(
            self.radec2lonlat(other.target_ra, other.target_dec)[0]
        )
        self_on_other = fraction_overlapping(other, ra_s, dec_s)
        centre_on_other = np.isfinite(
            other.radec2lonlat(self.target_ra, self.target_dec)[0]
        )

        overlaps = (
            other_on_self > 0 or self_on_other > 0
            or centre_on_self or centre_on_other
        )
        if not overlaps:
            return None
        in_front = other.target_distance < self.target_distance
        fully_covered = other_on_self >= 1.0 and self_on_other == 0.0
        if in_front:
            return 'transit' if fully_covered else 'part transit'
        return 'hidden' if fully_covered else 'part hidden'

    def test_if_other_body_visible(
        self, other: 'str | int | Body | BasicBody', **kwargs
    ) -> bool:
        """False only if the other body is fully hidden behind the target."""
        return self.other_body_los_intercept(other, **kwargs) != 'hidden'

    # ------------------------------------------------------------------
    # Limb
    # ------------------------------------------------------------------
    def _limb_targvec(
        self,
        npts: int = 360,
        close_loop: bool = True,
        method: str = 'TANGENT/ELLIPSOID',
        corloc: str = 'ELLIPSOID LIMB',
    ) -> np.ndarray:
        """
        Limb points in the body-fixed frame (``limbpt`` equivalent): cutting
        half-planes about the observer-target axis with reference vector
        [0, 0, 1], per-point light-time epochs (corloc='ELLIPSOID LIMB').
        """
        rolls = 2 * np.pi * np.arange(npts) / npts
        points = np.asarray(
            self._engine.limbpt(
                self.et, self.radii, rolls, self._sub_consts()
            )
        )
        if close_loop:
            points = self.close_loop(points)
        return points

    def limb_radec(self, *, alt: float = 0.0, **kwargs):
        """RA/Dec coordinates of the target's limb."""
        with _AdjustedSurfaceAltitude(self, alt):
            return self._targvec_arr2radec_arrs(self._limb_targvec(**kwargs))

    def limb_lonlat(
        self, alt: float = 0.0, *, planetocentric: bool = False, **kwargs
    ):
        """Planetographic lonlat coordinates of the target's limb."""
        with _AdjustedSurfaceAltitude(self, alt):
            targvecs = self._limb_targvec(**kwargs)
            lons = np.full(len(targvecs), np.nan)
            lats = np.full(len(targvecs), np.nan)
            for i, tv in enumerate(targvecs):
                lons[i], lats[i] = self.targvec2lonlat(
                    tv, planetocentric=planetocentric
                )
            return lons, lats

    def limb_radec_by_illumination(self, *, alt: float = 0.0, **kwargs):
        """Dayside/nightside split of :func:`limb_radec` (NaN-masked)."""
        with _AdjustedSurfaceAltitude(self, alt):
            targvec_arr = self._limb_targvec(**kwargs)
            ra_day, dec_day = self._targvec_arr2radec_arrs(targvec_arr)
            ra_night = ra_day.copy()
            dec_night = dec_day.copy()
            phase, incdnc, emissn, visibl, lit = (
                self._illumf_from_targvec_radians(targvec_arr)
            )
            lit = np.asarray(lit)
            ra_night[lit] = np.nan
            dec_night[lit] = np.nan
            ra_day[~lit] = np.nan
            dec_day[~lit] = np.nan
            return ra_day, dec_day, ra_night, dec_night

    def limb_coordinates_from_radec(
        self, ra: float, dec: float, *, alt: float = 0.0,
        planetocentric: bool = False,
    ) -> tuple[float, float, float]:
        """(lon, lat, dist) of the closest point on the limb to an RA/Dec."""
        with _AdjustedSurfaceAltitude(self, alt):
            lon, lat, dist = self._limb_coordinates_from_obsvec(
                self._radec2obsvec_norm_radians(
                    *self._degree_pair2radians(ra, dec)
                )
            )
            if planetocentric:
                lon, lat = self.graphic2centric_lonlat(lon, lat)
            return lon, lat, dist

    def _limb_coordinates_from_obsvec(self, obsvec_norm):
        obsvec_norm = np.asarray(obsvec_norm, dtype=float)
        scalar = obsvec_norm.ndim == 1
        if scalar and not np.all(np.isfinite(obsvec_norm)):
            return np.nan, np.nan, np.nan
        origin = np.zeros(3)
        near, dist = geom.nearest_point_on_line(
            origin, obsvec_norm, np.asarray(self._target_obsvec, dtype=float)
        )
        near = np.asarray(near)
        near_targvec = self._obsvec2targvec(near)
        surface = np.asarray(
            geom.radial_surface_point(
                np.asarray(near_targvec), np.asarray(self.radii, dtype=float)
            )
        )
        lon, lat = self._radian_pair2degrees(
            *self._targvec2lonlat_radians(surface)
        )
        dist_out = np.asarray(dist) - np.linalg.norm(surface, axis=-1)
        if scalar:
            return float(lon), float(lat), float(dist_out)
        return lon, lat, dist_out

    # ------------------------------------------------------------------
    # Terminator
    # ------------------------------------------------------------------
    def _terminator_targvec(
        self, *, npts: int, only_visible: bool, close_loop: bool, alt: float,
        method: str, corloc: str,
    ) -> np.ndarray:
        with _AdjustedSurfaceAltitude(self, alt):
            rolls = 2 * np.pi * np.arange(npts) / npts
            umbral = 'UMBRAL' in method.upper()
            targvec_arr = np.asarray(
                self._engine.termpt(
                    self.et, self.radii, rolls, self._sub_consts(),
                    umbral=umbral,
                )
            )
            if close_loop:
                targvec_arr = self.close_loop(targvec_arr)
            if only_visible:
                visible = self._test_if_targvec_visible_batch(
                    targvec_arr, on_surface=alt == 0.0
                )
                targvec_arr = np.where(
                    np.asarray(visible)[..., None], targvec_arr, np.nan
                )
            return targvec_arr

    def terminator_radec(
        self, npts: int = 360, *, only_visible: bool = True,
        close_loop: bool = True, alt: float = 0.0,
        method: str = 'UMBRAL/TANGENT/ELLIPSOID',
        corloc: str = 'ELLIPSOID TERMINATOR',
    ):
        """RA/Dec coordinates of the day/night terminator."""
        return self._targvec_arr2radec_arrs(
            self._terminator_targvec(
                npts=npts, only_visible=only_visible, close_loop=close_loop,
                alt=alt, method=method, corloc=corloc,
            )
        )

    def terminator_lonlat(
        self, npts: int = 360, *, only_visible: bool = False,
        close_loop: bool = True, alt: float = 0.0,
        planetocentric: bool = False,
        method: str = 'UMBRAL/TANGENT/ELLIPSOID',
        corloc: str = 'ELLIPSOID TERMINATOR',
    ):
        """Planetographic lonlat coordinates of the terminator."""
        targvecs = self._terminator_targvec(
            npts=npts, only_visible=only_visible, close_loop=close_loop,
            alt=alt, method=method, corloc=corloc,
        )
        lons = np.full(len(targvecs), np.nan)
        lats = np.full(len(targvecs), np.nan)
        for i, tv in enumerate(targvecs):
            lons[i], lats[i] = self.targvec2lonlat(
                tv, planetocentric=planetocentric, alt=alt
            )
        return lons, lats

    # ------------------------------------------------------------------
    # Local solar time
    # ------------------------------------------------------------------
    def _lst_from_lon(self, lon: float):
        if not math.isfinite(lon):
            return np.nan, np.nan, np.nan, '', ''
        lst = float(self._lst_hours_from_lons(np.asarray(float(lon))))
        total_seconds = int(lst * 3600.0)
        hr = total_seconds // 3600
        mn = (total_seconds % 3600) // 60
        sc = total_seconds % 60
        time_str = f'{hr:02d}:{mn:02d}:{sc:02d}'
        ampm = f'{(hr % 12) or 12:02d}:{mn:02d}:{sc:02d} ' + (
            'A.M.' if hr < 12 else 'P.M.'
        )
        return hr, mn, sc, time_str, ampm

    def _lst_hours_from_lons(self, lon_pgr_deg):
        """
        Numerical local solar time for planetographic longitudes (batched).
        ``et2lst`` equivalent evaluated at et - target light time (matching
        the reference call at body.py:2364-2374). Quantised to whole seconds
        like CSPICE's integer (hr, mn, sc) output.
        """
        et = self.et - self.target_light_time
        sun_lon_e = float(
            np.asarray(self._engine.solar_longitude(et))
        )  # east-positive radians
        lon = np.deg2rad(np.asarray(lon_pgr_deg, dtype=float))
        lon_e = -lon if self.positive_longitude_direction == 'W' else lon
        sign = 1.0 if self.prograde else -1.0
        lst = np.mod(12.0 + sign * (lon_e - sun_lon_e) * 12.0 / np.pi, 24.0)
        if lst_quantization_enabled():
            lst = np.floor(lst * 3600.0) / 3600.0
        return lst

    def local_solar_time_from_lon(self, lon: float) -> float:
        """Numerical local solar time in 'local hours' for a longitude."""
        hr, mn, sc, time_str, ampm = self._lst_from_lon(lon)
        return hr + mn / 60 + sc / 3600

    def local_solar_time_string_from_lon(self, lon: float) -> str:
        """Local solar time as an 'HH:MM:SS' string."""
        hr, mn, sc, time_str, ampm = self._lst_from_lon(lon)
        return time_str

    # ------------------------------------------------------------------
    # Rings
    # ------------------------------------------------------------------
    def _ring_coordinates_from_obsvec(
        self, obsvec, only_visible: bool = True
    ):
        obsvec = np.asarray(obsvec, dtype=float)
        scalar = obsvec.ndim == 1
        origin = np.zeros(3)
        normal, constant = self._ring_plane
        intercept, nxpts = geom.ray_plane_intercept(
            origin, obsvec, normal, constant
        )
        intercept = np.asarray(intercept)
        nxpts = np.asarray(nxpts)
        ok = nxpts == 1

        targvec = self._obsvec2targvec(
            np.where(ok[..., None], intercept, np.nan)
        )
        from .core.scene import _host_device

        with _host_device():  # see _lonlat2targvec_radians
            lon_e, lat, alt = geom.rect_to_geodetic(
                np.asarray(targvec), self.r_eq, self.flattening
            )
        lon_e = np.asarray(lon_e)
        alt = np.asarray(alt)
        if self.positive_longitude_direction == 'W':
            lon = np.mod(-np.rad2deg(lon_e), 360.0)
        else:
            lon = np.mod(np.rad2deg(lon_e), 360.0)
        distance = np.linalg.norm(intercept, axis=-1)
        radius = alt + self.r_eq

        invalid = ~ok | ~np.all(np.isfinite(obsvec), axis=-1)
        if only_visible:
            invalid = invalid | (alt < 0)
            # Mask ring points hidden behind the planet: where the ray hits
            # the surface closer than the ring plane
            norm = np.linalg.norm(obsvec, axis=-1, keepdims=True)
            d = obsvec / norm
            targvec_surf, trgepc, found = self._engine.sincpt(
                self.et, self.radii, d, self.target_light_time
            )
            found = np.asarray(found)
            _state, lt_surf = self._engine.spkcpt(
                self.et,
                np.where(np.asarray(found)[..., None], np.asarray(targvec_surf), 0.0),
            )
            surf_dist = np.asarray(lt_surf) * self.speed_of_light()
            invalid = invalid | (found & (surf_dist < distance))

        radius = np.where(invalid, np.nan, radius)
        lon = np.where(invalid, np.nan, lon)
        distance = np.where(invalid, np.nan, distance)
        if scalar:
            return float(radius), float(lon), float(distance)
        return radius, lon, distance

    def ring_plane_coordinates(
        self, ra: FloatOrArray, dec: FloatOrArray, only_visible: bool = True
    ):
        """(radius, longitude, distance) in the equatorial (ring) plane."""
        ra_r, dec_r = self._degree_pair2radians(
            np.asarray(ra, dtype=float), np.asarray(dec, dtype=float)
        )
        return self._ring_coordinates_from_obsvec(
            self._radec2obsvec_norm_radians(ra_r, dec_r),
            only_visible=only_visible,
        )

    def ring_radec(
        self, radius: float, npts: int = 360, only_visible: bool = True
    ):
        """RA/Dec arrays of a circular ring of the given radius."""
        lons = np.deg2rad(np.linspace(0, 360, npts))
        alt = radius - self.r_eq
        targvecs = self._lonlat2targvec_radians(
            lons, np.zeros_like(lons), alt=alt, not_visible_nan=only_visible
        )
        obsvec = self._targvec2obsvec(targvecs)
        ra, dec = self._obsvec2radec_radians(obsvec)
        return np.rad2deg(np.asarray(ra)), np.rad2deg(np.asarray(dec))

    # ------------------------------------------------------------------
    # Lonlat grid
    # ------------------------------------------------------------------
    def visible_lonlat_grid_radec(
        self, interval: float = 30, **kwargs
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Gridlines of constant lon and lat (for wireframe plotting)."""
        lon_radec = self.visible_lon_grid_radec(
            np.arange(0, 360, interval), **kwargs
        )
        lat_radec = self.visible_lat_grid_radec(
            np.arange(-90, 90, interval), **kwargs
        )
        return lon_radec + lat_radec

    def visible_lon_grid_radec(
        self, lons, npts: int = 60, *, lat_limit: float = 90.0,
        alt: float = 0.0, planetocentric: bool = False,
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """RA/Dec lines of constant longitude (invisible points NaN)."""
        lats = np.linspace(-lat_limit, lat_limit, npts)
        out = []
        for lon in lons:
            lon_arr = np.full(npts, lon)
            lat_arr = lats
            if planetocentric:
                lon_arr, lat_arr = self.centric2graphic_lonlat(lon_arr, lats)
            ra, dec = self.lonlat2radec(
                lon_arr, lat_arr, alt=alt, not_visible_nan=True
            )
            out.append((np.asarray(ra), np.asarray(dec)))
        return out

    def visible_lat_grid_radec(
        self, lats, npts: int = 120, *, lat_limit: float = 90.0,
        alt: float = 0.0, planetocentric: bool = False,
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """RA/Dec lines of constant latitude (invisible points NaN)."""
        lons = np.linspace(0, 360, npts)
        out = []
        for lat in lats:
            if abs(lat) > lat_limit:
                continue
            lon_arr = lons
            lat_arr = np.full(npts, lat)
            if planetocentric:
                lon_arr, lat_arr = self.centric2graphic_lonlat(lons, lat_arr)
            ra, dec = self.lonlat2radec(
                lon_arr, lat_arr, alt=alt, not_visible_nan=True
            )
            out.append((np.asarray(ra), np.asarray(dec)))
        return out

    # ------------------------------------------------------------------
    # State (distance / velocity / doppler)
    # ------------------------------------------------------------------
    def _state_from_targvec(self, targvec):
        state, lt = self._engine.spkcpt(
            self.et, np.asarray(targvec, dtype=float)
        )
        state = np.asarray(state)
        lt = np.asarray(lt)
        position = state[..., :3]
        velocity = state[..., 3:]
        if position.ndim == 1:
            return position, velocity, float(lt)
        return position, velocity, lt

    def _radial_velocity_from_state(self, position, velocity, _lt=None):
        position = np.asarray(position)
        velocity = np.asarray(velocity)
        phat = position / np.linalg.norm(position, axis=-1, keepdims=True)
        rv = np.sum(velocity * phat, axis=-1)
        if rv.ndim == 0:
            return float(rv)
        return rv

    def _radial_velocity_from_targvec(self, targvec):
        return self._radial_velocity_from_state(
            *self._state_from_targvec(targvec)[:2]
        )

    def radial_velocity_from_lonlat(
        self, lon: float, lat: float, *, alt: float = 0.0,
        planetocentric: bool = False,
    ) -> float:
        """Radial velocity of a surface point in km/s (+ve away)."""
        return self._radial_velocity_from_targvec(
            self.lonlat2targvec(lon, lat, alt=alt, planetocentric=planetocentric)
        )

    def distance_from_lonlat(
        self, lon: float, lat: float, *, alt: float = 0.0,
        planetocentric: bool = False,
    ) -> float:
        """Observer distance of a surface point in km."""
        position, velocity, lt = self._state_from_targvec(
            self.lonlat2targvec(lon, lat, alt=alt, planetocentric=planetocentric)
        )
        return lt * self.speed_of_light()

    # ------------------------------------------------------------------
    # Planetographic <-> planetocentric
    # ------------------------------------------------------------------
    def _targvec2lonlat_centric(self, targvec):
        targvec = np.asarray(targvec, dtype=float)
        from .core.scene import _host_device

        with _host_device():  # see _lonlat2targvec_radians
            r, lon_c, lat_c = geom.rect_to_latlon_centric(targvec)
        lon_c = np.asarray(lon_c)
        lat_c = np.asarray(lat_c)
        bad = ~np.all(np.isfinite(targvec), axis=-1)
        lon_c = np.where(bad, np.nan, lon_c)
        lat_c = np.where(bad, np.nan, lat_c)
        if lon_c.ndim == 0:
            return float(np.rad2deg(lon_c)), float(np.rad2deg(lat_c))
        return np.rad2deg(lon_c), np.rad2deg(lat_c)

    def graphic2centric_lonlat(
        self, lon: FloatOrArray, lat: FloatOrArray, *, alt: float = 0.0
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Planetographic -> planetocentric lonlat."""
        return self._maybe_transform_as_arrays(
            self._graphic2centric_lonlat, lon, lat, alt=alt
        )

    def _graphic2centric_lonlat(self, lon, lat, *, alt):
        return self._targvec2lonlat_centric(
            self.lonlat2targvec(lon, lat, alt=alt)
        )

    def centric2graphic_lonlat(
        self, lon_centric: FloatOrArray, lat_centric: FloatOrArray, *,
        alt: float = 0.0,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Planetocentric -> planetographic lonlat."""
        return self._maybe_transform_as_arrays(
            self._centric2graphic_lonlat, lon_centric, lat_centric, alt=alt
        )

    def _centric2graphic_lonlat(self, lon_centric, lat_centric, *, alt):
        lon_c = np.deg2rad(np.asarray(lon_centric, dtype=float))
        lat_c = np.deg2rad(np.asarray(lat_centric, dtype=float))
        # latsrf equivalent: radial surface point at the centric direction
        from .core.scene import _host_device

        with _host_device():  # see _lonlat2targvec_radians
            direction = np.asarray(
                geom.radec_to_rect(np.ones_like(lon_c), lon_c, lat_c)
            )
        surface = np.asarray(
            geom.radial_surface_point(
                direction, np.asarray(self.radii, dtype=float)
            )
        )
        bad = ~(np.isfinite(lon_c) & np.isfinite(lat_c))
        if np.any(bad):
            surface = np.where(np.asarray(bad)[..., None], np.nan, surface)
        lon, lat = self._radian_pair2degrees(
            *self._targvec2lonlat_radians(surface)
        )
        # targvec2lonlat with alt handled by the adjusted-radii context
        if alt != 0.0:
            with _AdjustedSurfaceAltitude(self, alt):
                lon, lat = self._radian_pair2degrees(
                    *self._targvec2lonlat_radians(surface)
                )
        return lon, lat

    # ------------------------------------------------------------------
    # Other
    # ------------------------------------------------------------------
    def north_pole_angle(self) -> float:
        """
        Angle of the north pole vs the positive declination direction, in
        degrees (-180, 180], measured anticlockwise.
        """
        np_x, np_y = self.radec2angular(
            *self.lonlat2radec(0, 90, not_visible_nan=False)
        )
        target_x, target_y = self.radec2angular(self.target_ra, self.target_dec)
        theta = -np.arctan2(target_x - np_x, np_y - target_y)
        theta = np.rad2deg(theta) % 360.0
        if theta > 180:
            theta -= 360
        return float(theta)

    def get_description(self, multiline: bool = True) -> str:
        """Human-readable description of the observation."""
        return '{t} ({tid}){alt}{nl}from {o}{nl}at {d}'.format(
            t=self.target,
            tid=self.target_body_id,
            alt=(
                f', alt = {self._alt_adjustment:g} km'
                if self._alt_adjustment != 0.0
                else ''
            ),
            nl=('\n' if multiline else ' '),
            o=self.observer,
            d=self.dtm.strftime('%Y-%m-%d %H:%M %Z'),
        )


def _spice_rotate(angle: float, axis: int) -> np.ndarray:
    """Coordinate rotation matrix (``spice.rotate`` convention)."""
    c, s = math.cos(angle), math.sin(angle)
    if axis == 1:
        return np.array([[1.0, 0, 0], [0, c, s], [0, -s, c]])
    if axis == 2:
        return np.array([[c, 0, -s], [0, 1.0, 0], [s, 0, c]])
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])


# Wireframe plotting methods are defined in _body_plotting and attached to
# Body there (kept in a separate module for readability).
from . import _body_plotting  # noqa: E402,F401  (attaches plotting methods)
