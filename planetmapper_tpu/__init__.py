"""
planetmapper_tpu: a JAX planetary-geometry framework.

A from-scratch rebuild of the capabilities of PlanetMapper
(github.com/ortk95/planetmapper) for JAX/XLA accelerators: the per-pixel
scalar SPICE loops of the reference become one vmapped, jitted device
pipeline fed by an on-device ephemeris/frame engine compiled from SPICE
kernels at scene-construction time.

Coordinate systems
------------------
Every public transform converts between these systems (each is an adapter
to/from the internal observer-frame rectangular vector, mirroring the
reference's architecture, body.py:876-887):

- ``xy``: image pixel coordinates of an observation. ``(0, 0)`` is the
  centre of the bottom-left pixel; x increases rightwards and y upwards.
  Set by the disc parameters ``(x0, y0, r0, rotation)``.
- ``radec``: J2000 right ascension / declination in degrees, as seen by
  the observer (the sky position).
- ``lonlat``: planetographic longitude / latitude on the target body in
  degrees (positive-west or positive-east following the body's IAU
  convention; ``planetocentric=True`` selects planetocentric instead).
- ``km``: distance in km from the centre of the target in the target
  plane, with the north pole of the body pointing up.
- ``angular``: relative angular coordinates in arcseconds, by default
  centred on the target with celestial north up (customisable origin and
  rotation via ``origin_ra``/``origin_dec``/``coordinate_rotation``).

Internally ``targvec`` (body-fixed rectangular), ``obsvec`` (observer
J2000 rectangular), ``obsvec_norm`` (normalised obsvec) and ``rayvec``
(observer->point ray) appear in private APIs.

Units are degrees, km, seconds and km/s throughout unless a name says
otherwise (``angular`` coordinates and plate scales use arcseconds).

Double precision is enabled globally on import: planetary geometry needs
km-scale precision at ~1e9 km distances, far beyond float32. (The fused
pipeline's default ``'mixed'`` mode re-introduces float32 deliberately
where an error analysis allows it - see :mod:`planetmapper_tpu.pipeline`.)

Compiled programs are kept in JAX's persistent compilation cache: in
``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads it itself),
otherwise in ``.jax_cache`` beside the package directory.
"""

from __future__ import annotations

import os as _os

import jax

jax.config.update('jax_enable_x64', True)

CACHE_DIR_DEFAULT = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    '.jax_cache',
)


def _configure_compilation_cache() -> None:
    if not _os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        try:
            _os.makedirs(CACHE_DIR_DEFAULT, exist_ok=True)
        except OSError:  # read-only install: run without a cache
            return
        jax.config.update('jax_compilation_cache_dir', CACHE_DIR_DEFAULT)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.5)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)


_configure_compilation_cache()

from .common import (  # noqa: E402
    CITATION_BIBTEX,
    CITATION_DOI,
    CITATION_STRING,
    __author__,
    __description__,
    __license__,
    __url__,
    __version__,
)
from .kernels.pool import (  # noqa: E402
    clear_kernels,
    get_kernel_path,
    load_kernels,
    prevent_kernel_loading,
    set_kernel_path,
    sort_kernel_paths,
)

__all__ = [
    'run_gui',
    'set_kernel_path',
    'get_kernel_path',
    'load_kernels',
    'clear_kernels',
    'prevent_kernel_loading',
    'sort_kernel_paths',
    'SpiceBase',
    'Body',
    'Backplane',
    'BodyXY',
    'Observation',
    'BasicBody',
    'AngularCoordinateKwargs',
    'WireframeKwargs',
    'WireframeComponent',
    'DEFAULT_WIREFRAME_FORMATTING',
    'MapKwargs',
    'base',
    'gui',
    'utils',
    'kernel_downloader',
    'data_loader',
    'CITATION_STRING',
    'CITATION_DOI',
    'CITATION_BIBTEX',
]

_BODY_ATTRS = {
    'Body', 'AngularCoordinateKwargs', 'WireframeKwargs',
    'WireframeComponent', 'DEFAULT_WIREFRAME_FORMATTING', 'LonLatGridKwargs',
}
_BODY_XY_ATTRS = {'BodyXY', 'Backplane', 'BackplaneNotFoundError', 'MapKwargs'}
_SUBMODULES = {
    'base', 'body', 'basic_body', 'body_xy', 'observation', 'progress',
    'utils', 'data_loader', 'kernel_downloader', 'cli', 'common',
    'exceptions', 'pipeline', 'parallel', 'io', 'core', 'kernels', 'ops',
}


def __getattr__(name: str):
    # Lazy imports of the heavier API layers keep `import planetmapper_tpu`
    # fast and avoid import cycles. GUI access degrades gracefully when
    # tkinter is unavailable (informative error at use time, like the
    # reference's mock-module pattern).
    if name in ('SpiceBase', 'BodyBase'):
        from . import base

        return getattr(base, name)
    if name in _BODY_ATTRS:
        from . import body

        return getattr(body, name)
    if name == 'BasicBody':
        from .basic_body import BasicBody

        return BasicBody
    if name in _BODY_XY_ATTRS:
        from . import body_xy

        return getattr(body_xy, name)
    if name == 'Observation':
        from .observation import Observation

        return Observation
    if name in ('gui', 'run_gui'):
        import importlib

        try:
            gui = importlib.import_module('.gui', __name__)
        except ImportError as e:
            from ._mock_gui_no_tk import get_mocks as _get_mocks

            gui_mock, run_gui_mock = _get_mocks(e)
            return gui_mock if name == 'gui' else run_gui_mock
        return gui if name == 'gui' else gui.run_gui
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f'.{name}', __name__)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
