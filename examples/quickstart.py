#!/usr/bin/env python3
"""
Quickstart tour of planetmapper_tpu's Python API.

Needs SPICE kernels covering Jupiter/Saturn around 2000-2005. Point
``PLANETMAPPER_KERNEL_PATH`` at any kernel directory (see
``planetmapper_tpu.kernel_downloader`` to fetch generic kernels from
NAIF); without it the example uses the seeded synthetic kernel set
(:mod:`planetmapper_tpu.kernels.synthetic`), which works offline but is a
fixture, not an ephemeris:

    python examples/quickstart.py
"""

import os
import sys

import matplotlib.pyplot as plt
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import planetmapper_tpu as pm  # noqa: E402
from planetmapper_tpu.kernels.synthetic import ensure_kernel_set  # noqa: E402

if not os.environ.get('PLANETMAPPER_KERNEL_PATH'):
    pm.set_kernel_path(ensure_kernel_set())

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'output')


def scene_geometry():
    """Scalar geometry: the Body layer answers single-point questions."""
    body = pm.Body('Jupiter', observer='EARTH', utc='2005-01-01T00:00:00')
    print(body.get_description(multiline=False))
    print('  sub-observer lon/lat:', body.subpoint_lon, body.subpoint_lat)
    print('  sub-solar lon/lat:   ', body.subsol_lon, body.subsol_lat)
    print('  north pole angle:    ', body.north_pole_angle())
    print('  LST at sub-obs lon:  ',
          body.local_solar_time_string_from_lon(body.subpoint_lon))
    ra, dec = body.lonlat2radec(153.1, -3.1)
    print('  lonlat (153.1,-3.1) -> radec:', ra, dec)
    print('  ... and back:', body.radec2lonlat(ra, dec))


def wireframe_plot():
    """The classic wireframe: limb, terminator, grid, poles, rings."""
    body = pm.Body('Saturn', utc='2000-01-01')
    fig, ax = plt.subplots(figsize=(6, 4), dpi=150)
    body.plot_wireframe_radec(ax)
    os.makedirs(OUT, exist_ok=True)
    fig.tight_layout()
    fig.savefig(os.path.join(OUT, 'saturn_wireframe_radec.png'))
    plt.close(fig)
    print('wrote', os.path.join(OUT, 'saturn_wireframe_radec.png'))


def backplanes_on_device():
    """
    The render core: every backplane for every pixel in ONE fused device
    program. The first call compiles; subsequent disc-parameter changes
    re-use the compiled program (disc parameters are traced arguments).
    """
    body = pm.BodyXY('Jupiter', observer='EARTH', utc='2005-01-01', sz=256)
    body.set_disc_params(x0=128, y0=128, r0=100, rotation=12.3)
    emission = body.get_backplane_img('EMISSION')
    lon = body.get_backplane_img('LON-GRAPHIC')
    print('EMISSION at disc centre:', emission[128, 128])
    print('on-disc pixels:', int(np.isfinite(lon).sum()))

    # All 26 planes in one device dispatch:
    from planetmapper_tpu.pipeline import compute_backplanes

    planes = compute_backplanes(body)
    print('computed planes:', sorted(planes)[:5], '...')


def map_projection():
    """Project an observed image into an equirectangular map."""
    body = pm.BodyXY('Jupiter', observer='EARTH', utc='2005-01-01', sz=100)
    body.set_disc_params(50, 50, 40, 0)
    img = np.asarray(body.get_backplane_img('PHASE'))  # any image data
    mapped = body.map_img(img, degree_interval=1, interpolation='cubic')
    print('map shape:', mapped.shape)


def time_series():
    """Vmapped ephemeris-time batches (JWST-cube style observations)."""
    from planetmapper_tpu.parallel import backplane_time_series

    body = pm.BodyXY('Jupiter', observer='EARTH', utc='2005-01-01', sz=50)
    body.set_disc_params(25, 25, 20, 0)
    ets = body.et + 60.0 * np.arange(100)
    out = backplane_time_series(body, ets, names=['EMISSION'])
    print('time series EMISSION shape:', out['EMISSION'].shape)


if __name__ == '__main__':
    scene_geometry()
    wireframe_plot()
    backplanes_on_device()
    map_projection()
    time_series()
