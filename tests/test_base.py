"""Base-layer tests: time conversion, kernel paths, helpers, BasicBody."""

import datetime
import os

import numpy as np
import pytest

from common import KERNEL_PATH, setup_kernels

import planetmapper_tpu
import planetmapper_tpu.base
from planetmapper_tpu import BasicBody
from planetmapper_tpu.base import SpiceBase


@pytest.fixture(scope='module', autouse=True)
def kernels():
    setup_kernels()


@pytest.fixture(scope='module')
def sb():
    return SpiceBase()


class TestKernelPaths:
    def test_get_set(self):
        old = planetmapper_tpu.get_kernel_path()
        try:
            planetmapper_tpu.set_kernel_path('/tmp/some/path')
            assert planetmapper_tpu.get_kernel_path() == '/tmp/some/path'
            path, source = planetmapper_tpu.get_kernel_path(return_source=True)
            assert source == 'set_kernel_path()'
        finally:
            planetmapper_tpu.set_kernel_path(old)
            planetmapper_tpu.load_kernels(
                os.path.join(KERNEL_PATH, '**/*.bsp'),
                os.path.join(KERNEL_PATH, '**/*.tls'),
                os.path.join(KERNEL_PATH, '**/*.tpc'),
            )

    def test_sort_kernel_paths(self):
        paths = ['a/kernel.bsp', 'x/y/z/kernel.bsp', 'kernel_100.bsp',
                 'kernel_101.bsp', 'spk/old/kernel.bsp', 'spk/kernel.bsp']
        out = planetmapper_tpu.sort_kernel_paths(paths)
        # deeper paths first (loaded first = lowest precedence)
        assert out.index('x/y/z/kernel.bsp') < out.index('a/kernel.bsp')
        assert out.index('spk/old/kernel.bsp') < out.index('spk/kernel.bsp')
        assert out.index('kernel_100.bsp') < out.index('kernel_101.bsp')


class TestTime:
    def test_et2dtm(self, sb):
        dtm = sb.et2dtm(157809664.1839331)
        assert dtm == datetime.datetime(
            2005, 1, 1, 0, 0, tzinfo=datetime.timezone.utc
        )

    def test_mjd2dtm(self, sb):
        dtm = sb.mjd2dtm(51544.5)
        assert dtm == datetime.datetime(
            2000, 1, 1, 12, 0, tzinfo=datetime.timezone.utc
        )

    def test_standardise_utc(self):
        f = planetmapper_tpu.base.BodyBase._standardise_utc_to_string
        assert f('2005-01-01T00:00:00') == '2005-01-01T00:00:00'
        assert f(
            datetime.datetime(2005, 1, 1, tzinfo=datetime.timezone.utc)
        ) == '2005-01-01T00:00:00.000000'
        assert f(51544.5) == '2000-01-01T12:00:00.000000'
        assert f(None).startswith('20')  # current time


class TestHelpers:
    def test_standardise_body_name(self, sb):
        for name in ['jupiter', 'JUPITER', ' Jupiter ', '599', 599]:
            assert sb.standardise_body_name(name) == 'JUPITER'
        assert sb.standardise_body_name('<<unknown>>') == '<<unknown>>'
        with pytest.raises(planetmapper_tpu.base.NotFoundError):
            sb.standardise_body_name('<<unknown>>', raise_if_not_found=True)

    def test_speed_of_light(self, sb):
        assert sb.speed_of_light() == 299792.458

    def test_doppler_factor(self, sb):
        assert sb.calculate_doppler_factor(0.0) == 1.0
        assert sb.calculate_doppler_factor(100.0) > 1.0
        assert sb.calculate_doppler_factor(-100.0) < 1.0
        arr = sb.calculate_doppler_factor(np.array([0.0, 100.0]))
        assert arr.shape == (2,)

    def test_angular_dist(self, sb):
        assert sb.angular_dist(10, 0, 20, 0) == pytest.approx(10.0)
        assert sb.angular_dist(0, 0, 0, 90) == pytest.approx(90.0)
        # clip guard: identical points
        assert sb.angular_dist(42.0, 13.0, 42.0, 13.0) == pytest.approx(0.0)

    def test_close_loop(self, sb):
        arr = np.array([1.0, 2.0, 3.0])
        np.testing.assert_array_equal(
            sb.close_loop(arr), np.array([1.0, 2.0, 3.0, 1.0])
        )

    def test_unit_vector(self, sb):
        v = sb.unit_vector(np.array([3.0, 4.0, 0.0]))
        assert sb.vector_magnitude(v) == pytest.approx(1.0)

    def test_repr_eq_copy(self, sb):
        assert repr(sb) == 'SpiceBase()'
        assert sb == SpiceBase()
        assert sb != SpiceBase(optimize_speed=False)
        assert sb.copy() == sb
        assert sb.replace(optimize_speed=False) == SpiceBase(
            optimize_speed=False
        )
        assert hash(sb) == hash(SpiceBase())


class TestBasicBody:
    @pytest.mark.reference_data
    def test_attributes(self):
        body = BasicBody('Jupiter', observer='HST', utc='2005-01-01T00:00:00')
        assert body.target == 'JUPITER'
        assert body.target_body_id == 599
        assert body.et == pytest.approx(157809664.1839331)
        assert body.target_light_time == pytest.approx(
            2734.018326542542, abs=1e-6
        )
        assert body.target_distance == pytest.approx(819638074.3312353, abs=0.1)
        assert body.target_ra == pytest.approx(196.37198562427025, abs=1e-7)
        assert body.target_dec == pytest.approx(-5.565793847134351, abs=1e-7)
        assert not hasattr(body, 'subpoint_lon')

    def test_daphnis(self):
        # DAPHNIS only has a type 17 (equinoctial) segment and no radii data
        body = BasicBody('daphnis', utc='2005-01-01T00:00:00')
        assert body.target == 'DAPHNIS'
        assert np.isfinite(body.target_ra)

    def test_repr(self):
        body = BasicBody('Jupiter', observer='HST', utc='2005-01-01T00:00:00')
        assert repr(body) == (
            "BasicBody('JUPITER', '2005-01-01T00:00:00.000000', "
            "observer='HST')"
        )


class TestGeometryEdgeCases:
    """Degenerate-geometry contracts of the closed-form geometry core."""

    def test_geodetic_inside_evolute_equatorial(self):
        # Equatorial-plane points inside the evolute have their nearest
        # surface point OFF the equator (two symmetric solutions); the
        # parameter-equation bisection alone diverges here
        import jax.numpy as jnp

        from planetmapper_tpu.core import geometry as geom

        lon, lat, alt = geom.rect_to_geodetic(
            jnp.array([1.0, 0.0, 0.0]), 6378.137, 1 / 298.257
        )
        assert np.degrees(float(lat)) == pytest.approx(88.662, abs=1e-2)
        assert float(alt) == pytest.approx(-6356.74, abs=0.01)
        # sign follows z, continuously from the z != 0 neighbourhood
        re, f = 125.0, 1 - 64 / 125
        for z, sign in ((1e-11, 1), (-1e-11, -1), (0.0, 1)):
            lon, lat, alt = geom.rect_to_geodetic(
                jnp.array([73.0, 0.0, z]), re, f
            )
            assert np.degrees(float(lat)) == pytest.approx(
                sign * 56.4544, abs=1e-3
            )
            assert float(alt) == pytest.approx(-46.9332, abs=1e-3)
        # spheres never take the branch
        lon, lat, alt = geom.rect_to_geodetic(
            jnp.array([0.5, 0.0, 0.0]), 1.0, 0.0
        )
        assert float(lat) == 0.0 and float(alt) == pytest.approx(-0.5)

    def test_ray_intercept_from_inside(self):
        # smallest POSITIVE root: rays starting inside the ellipsoid
        # exit through the far intersection (surfpt semantics)
        import jax.numpy as jnp

        from planetmapper_tpu.core import geometry as geom

        radii = jnp.array([125.0, 73.0, 64.0])
        s, found = geom.ray_ellipsoid_intercept(
            jnp.zeros(3), jnp.array([1.0, 0.0, 0.0]), radii
        )
        assert bool(found) and float(s) == pytest.approx(125.0)
        s, found = geom.ray_ellipsoid_intercept(
            jnp.array([1000.0, 0.0, 0.0]), jnp.array([1.0, 0.0, 0.0]),
            radii,
        )
        assert not bool(found)

    def test_ray_plane_edge_on_is_parallel(self):
        # near-edge-on rays would intersect at ~1e12+ km of pure rounding
        # noise; they must classify as parallel (nxpts = 0), not return a
        # garbage point
        import jax.numpy as jnp

        from planetmapper_tpu.core import geometry as geom

        point, nxpts = geom.ray_plane_intercept(
            jnp.array([0.0, 0.0, 1.0]),
            jnp.array([1.0, 0.0, 1e-14]),
            jnp.array([0.0, 0.0, 1.0]),
            jnp.float64(0.0),
        )
        assert int(nxpts) == 0
        assert np.isnan(np.asarray(point)).all()

    def test_fastmath_domain_contracts(self):
        import jax.numpy as jnp

        from planetmapper_tpu.ops import fastmath as fm

        assert np.isnan(float(fm.sqrt64(jnp.float64(np.nan))))
        assert np.isnan(float(fm.rsqrt64(jnp.float64(-1.0))))
        assert float(fm.sqrt64(jnp.float64(-1.0))) == 0.0
        assert float(fm.sqrt64(jnp.float64(1e40))) > 0.0  # finite, positive
        assert np.isfinite(float(fm.sqrt64(jnp.float64(1e40))))
        assert np.isnan(
            float(fm.norm3_64(jnp.array([1.0, np.nan, 2.0])))
        )
        assert float(fm.sqrt64(jnp.float64(4.0))) == pytest.approx(
            2.0, rel=1e-14
        )
