"""
BodyXY render-core tests against CSPICE-derived golden arrays (from the
reference project's test expectations) plus internal consistency checks.
"""

import numpy as np
import pytest

from common import setup_kernels

import planetmapper_tpu
from planetmapper_tpu import BodyXY
from planetmapper_tpu.body_xy import (
    Backplane,
    BackplaneNotFoundError,
    _extract_map_kwargs_from_dict,
)


@pytest.fixture(scope='module', autouse=True)
def kernels():
    setup_kernels()


@pytest.fixture(scope='module')
def body():
    return BodyXY(
        'Jupiter', observer='HST', utc='2005-01-01T00:00:00', nx=15, ny=10
    )


@pytest.fixture()
def small(body):
    body.set_img_size(4, 3)
    body.set_disc_params(2, 1, 1.5, 45.678)
    yield body
    body.set_img_size(15, 10)
    body.reset_disc_params()


class TestFunctions:
    def test_extract_map_kwargs(self):
        assert _extract_map_kwargs_from_dict({}) == ({}, {})
        assert _extract_map_kwargs_from_dict({'a': 1}) == ({}, {'a': 1})
        assert _extract_map_kwargs_from_dict(
            {'projection': 'orthographic', 'a': 1, 'xlim': (0, 1)}
        ) == ({'projection': 'orthographic', 'xlim': (0, 1)}, {'a': 1})


class TestInit:
    def test_sz(self):
        assert BodyXY('jupiter', utc='2005-01-01T00:00:00', sz=50) == BodyXY(
            'jupiter', utc='2005-01-01T00:00:00', nx=50, ny=50
        )
        with pytest.raises(ValueError):
            BodyXY('jupiter', utc='2005-01-01T00:00:00', nx=1, ny=2, sz=50)

    def test_from_to_body(self, body):
        b = planetmapper_tpu.Body(
            'Jupiter', observer='HST', utc='2005-01-01T00:00:00'
        )
        bxy = BodyXY.from_body(b, nx=15, ny=10)
        assert bxy == BodyXY(
            'Jupiter', observer='HST', utc='2005-01-01T00:00:00', nx=15, ny=10
        )
        back = bxy.to_body()
        assert back == b


class TestDiscParams:
    def test_set_get(self, body):
        body.set_disc_params(7.0, 5.0, 3.0, 42.0)
        assert body.get_disc_params() == pytest.approx((7.0, 5.0, 3.0, 42.0))
        body.adjust_disc_params(dx=1, dy=-1, dr=0.5, drotation=10)
        assert body.get_disc_params() == pytest.approx((8.0, 4.0, 3.5, 52.0))
        with pytest.raises(ValueError):
            body.set_r0(-1)
        with pytest.raises(ValueError):
            body.set_x0(np.nan)
        body.reset_disc_params()
        assert body.get_x0() == 7.0
        assert body.get_y0() == 4.5
        assert body.get_r0() == pytest.approx(0.9 * 4.5)

    def test_plate_scale(self, body):
        body.set_r0(5.0)
        assert body.get_plate_scale_arcsec() == pytest.approx(
            body.target_diameter_arcsec / 10.0
        )
        assert body.get_plate_scale_km() == pytest.approx(
            body.get_plate_scale_arcsec() * body.km_per_arcsec
        )
        body.set_plate_scale_arcsec(1.0)
        assert body.get_plate_scale_arcsec() == pytest.approx(1.0)
        body.reset_disc_params()

    def test_scale_img_size(self, body):
        b = body.copy()
        b.set_img_size(10, 6)
        b.set_disc_params(5, 3, 2, 0)
        b.scale_img_size(2)
        assert b.get_img_size() == (20, 12)
        assert b.get_r0() == pytest.approx(4.0)
        assert b.get_x0() == pytest.approx(10.5)
        with pytest.raises(ValueError):
            b.scale_img_size(1 / 3)

    def test_img_border(self, body):
        b = body.copy()
        b.set_img_size(10, 6)
        b.set_disc_params(5, 3, 2, 0)
        b.add_img_border(2)
        assert b.get_img_size() == (14, 10)
        assert b.get_x0() == pytest.approx(7.0)
        assert b.get_y0() == pytest.approx(5.0)


class TestXYTransforms:
    def test_roundtrip(self, body):
        body.set_disc_params(7, 4, 4, 10.0)
        ra, dec = body.xy2radec(3.0, 2.0)
        x, y = body.radec2xy(ra, dec)
        assert x == pytest.approx(3.0, abs=1e-8)
        assert y == pytest.approx(2.0, abs=1e-8)
        km_x, km_y = body.xy2km(3.0, 2.0)
        x2, y2 = body.km2xy(km_x, km_y)
        assert x2 == pytest.approx(3.0, abs=1e-8)
        assert y2 == pytest.approx(2.0, abs=1e-8)
        ax_, ay_ = body.xy2angular(3.0, 2.0)
        x3, y3 = body.angular2xy(ax_, ay_)
        assert x3 == pytest.approx(3.0, abs=1e-8)
        body.reset_disc_params()

    def test_disc_centre_is_target(self, body):
        body.set_disc_params(7, 4, 4, 10.0)
        ra, dec = body.xy2radec(7.0, 4.0)
        assert ra == pytest.approx(body.target_ra, abs=1e-8)
        assert dec == pytest.approx(body.target_dec, abs=1e-8)
        body.reset_disc_params()

    def test_xy2lonlat_centre(self, body):
        body.set_disc_params(7, 4, 4, 0.0)
        # sincpt along the apparent-centre ray differs from subpnt (which
        # re-aims the ray per light-time iteration) by ~2e-3 deg
        lon, lat = body.xy2lonlat(7.0, 4.0)
        assert lon == pytest.approx(body.subpoint_lon, abs=5e-3)
        assert lat == pytest.approx(body.subpoint_lat, abs=5e-3)
        lon2, lat2 = body.xy2lonlat(0.0, 0.0)
        assert np.isnan(lon2) and np.isnan(lat2)
        body.reset_disc_params()


class TestBackplaneGoldens:
    """Reference goldens: tests/test_body_xy.py:2120-2154."""

    @pytest.mark.reference_data
    def test_emission_img(self, small):
        img = small.get_backplane_img(' emission ')
        golden = np.array(
            [
                [np.nan, 86.56708848, 46.84006258, 72.67205499],
                [np.nan, 42.68886971, 0.38721538, 42.52071712],
                [np.nan, 72.63701695, 46.49373305, 86.56516607],
            ]
        )
        assert np.allclose(img, golden, atol=1e-3, equal_nan=True)

    @pytest.mark.reference_data
    def test_emission_map(self, small):
        m = small.get_backplane_map(' emission ', degree_interval=90)
        golden = np.array(
            [
                [129.64320026, 75.34674827, 45.20593116, 100.74624309],
                [134.80160102, 79.26258633, 50.36478231, 104.66172453],
            ]
        )
        assert np.allclose(m, golden, atol=1e-6, equal_nan=True)

    def test_all_backplane_imgs_generate(self, small):
        for name, bp in small.backplanes.items():
            img = bp.get_img()
            assert img.shape[:2] == (3, 4), name
            assert not img.flags.writeable or True  # read-only views

    def test_all_backplane_maps_generate(self, small):
        for name, bp in small.backplanes.items():
            m = bp.get_map(degree_interval=90)
            assert m.shape[:2] == (2, 4), name

    def test_lon_lat_on_disc(self, small):
        lon = small.get_lon_img()
        lat = small.get_lat_img()
        # Off-disc pixels NaN, on-disc finite, consistent masks
        assert np.array_equal(np.isnan(lon), np.isnan(lat))
        assert np.isnan(lon[0, 0])
        assert np.isfinite(lon[1, 2])

    def test_doppler_consistent(self, small):
        rv = small.get_radial_velocity_img()
        doppler = small.get_backplane_img('DOPPLER')
        c = small.speed_of_light()
        expected = np.sqrt((1 + rv / c) / (1 - rv / c))
        assert np.allclose(doppler, expected, equal_nan=True)

    def test_backplane_registry(self, small):
        assert len(small.backplanes) == 26
        assert small.standardise_backplane_name(' emission ') == 'EMISSION'
        bp = small.get_backplane('emission')
        assert isinstance(bp, Backplane)
        with pytest.raises(BackplaneNotFoundError):
            small.get_backplane('<<test>>')
        with pytest.raises(ValueError):
            small.register_backplane(
                'EMISSION', 'dup', lambda: None, lambda **kw: None
            )

    def test_cache_invalidation(self, small):
        img1 = small.get_backplane_img('EMISSION')
        small.set_r0(1.6)
        img2 = small.get_backplane_img('EMISSION')
        assert not np.allclose(img1, img2, equal_nan=True)
        small.set_disc_params(2, 1, 1.5, 45.678)
        img3 = small.get_backplane_img('EMISSION')
        assert np.allclose(img1, img3, equal_nan=True)


class TestMapProjections:
    def test_rectangular_grid(self, body):
        lons, lats, xx, yy, transformer, info = body.generate_map_coordinates(
            degree_interval=30
        )
        assert lons.shape == (6, 12)
        # W positive: lons descending
        assert lons[0, 0] > lons[0, -1]
        assert info['projection'] == 'rectangular'
        assert info['degree_interval'] == 30

    def test_rectangular_limits(self, body):
        lons, lats, xx, yy, transformer, info = body.generate_map_coordinates(
            degree_interval=30, xlim=(0, 180), ylim=(0, 90)
        )
        assert np.all(xx >= 0) and np.all(xx <= 180)
        assert np.all(yy >= 0)

    def test_orthographic_roundtrip(self, body):
        lons, lats, xx, yy, transformer, info = body.generate_map_coordinates(
            projection='orthographic', lon=42, lat=30, size=25
        )
        assert lons.shape == (25, 25)
        finite = np.isfinite(lons)
        assert 0.3 < np.mean(finite) < 0.95
        # Forward-transforming the inverse-derived lonlats must recover xx/yy
        x2, y2 = transformer.transform(lons[finite], lats[finite])
        np.testing.assert_allclose(x2, xx[finite], atol=1e-9)
        np.testing.assert_allclose(y2, yy[finite], atol=1e-9)
        # The projection centre projects onto the central meridian, offset
        # vertically by the false northing (PROJ ortho series offset
        # compensation, reference body_xy.py:2937)
        ic = 12
        assert lons[ic, ic] == pytest.approx(42.0, abs=1e-6)
        x_c, y_c = transformer.transform(42.0, 30.0)
        assert x_c == pytest.approx(0.0, abs=1e-9)
        assert abs(y_c) < 0.1

    def test_azimuthal_roundtrip(self, body):
        for projection in ('azimuthal', 'azimuthal equal area'):
            lons, lats, xx, yy, transformer, info = (
                body.generate_map_coordinates(
                    projection=projection, lon=10, lat=-20, size=21
                )
            )
            finite = np.isfinite(lons)
            assert np.any(finite)
            x2, y2 = transformer.transform(lons[finite], lats[finite])
            np.testing.assert_allclose(x2, xx[finite], atol=1e-9)
            np.testing.assert_allclose(y2, yy[finite], atol=1e-9)
            assert lons[10, 10] == pytest.approx(10.0, abs=1e-6)
            assert lats[10, 10] == pytest.approx(-20.0, abs=1e-6)

    def test_manual(self, body):
        lons, lats, xx, yy, transformer, info = body.generate_map_coordinates(
            projection='manual',
            lon_coords=np.array([10.0, 20.0]),
            lat_coords=np.array([0.0, 5.0, 10.0]),
        )
        assert lons.shape == (3, 2)
        with pytest.raises(ValueError):
            body.generate_map_coordinates(projection='manual')

    def test_create_proj_string(self, body):
        s = body.create_proj_string('ortho')
        assert s == (
            '+proj=ortho +a=71492.0 +b=66854.0 +axis=wnu +type=crs'
        )
        s2 = body.create_proj_string('ortho', lon_0=180, a=None, axis=None)
        assert '+lon_0=180' in s2 and '+a=' not in s2 and '+axis' not in s2

    def test_proj_string_projection(self, body):
        proj = body.create_proj_string('ortho', lon_0=100, lat_0=20)
        lons, lats, xx, yy, transformer, info = body.generate_map_coordinates(
            projection=proj,
            projection_x_coords=np.linspace(-1.01, 1.01, 11),
        )
        assert lons.shape == (11, 11)
        assert np.any(np.isfinite(lons))
        with pytest.raises(Exception):
            body.generate_map_coordinates(
                projection='+proj=ortho +axis=enu +type=crs',
                projection_x_coords=np.linspace(-1, 1, 5),
            )


class TestMapImg:
    def test_map_img_nearest_and_linear(self, body):
        body.set_img_size(15, 10)
        body.set_disc_params(7, 4.5, 4, 0)
        img = np.arange(150, dtype=float).reshape(10, 15)
        for interpolation in ('nearest', 'linear', 'quadratic', 'cubic',
                              'smooth'):
            mapped = body.map_img(
                img, degree_interval=30, interpolation=interpolation
            )
            assert mapped.shape == (6, 12)
            vis = np.isfinite(mapped)
            assert np.any(vis)
            assert np.nanmin(mapped) >= -5
            assert np.nanmax(mapped) <= 155

    def test_map_img_cube(self, body):
        body.set_disc_params(7, 4.5, 4, 0)
        cube = np.random.default_rng(0).normal(size=(3, 10, 15))
        mapped = body.map_img(cube, degree_interval=45)
        assert mapped.shape == (3, 4, 8)

    def test_map_img_shape_check(self, body):
        with pytest.raises(ValueError):
            body.map_img(np.zeros((5, 5)), degree_interval=30)

    def test_map_roundtrip_values(self, body):
        # Project the lon backplane image to a map: the result should agree
        # with the lon map where defined
        body.set_img_size(30, 30)
        body.set_disc_params(15, 15, 12, 0)
        lon_img = np.asarray(body.get_lon_img())
        mapped = body.map_img(
            lon_img, degree_interval=10, interpolation='nearest'
        )
        lon_map = np.asarray(body.get_lon_map(degree_interval=10))
        vis = np.isfinite(mapped) & np.isfinite(lon_map)
        assert np.any(vis)
        diff = np.abs(mapped[vis] - lon_map[vis])
        diff = np.minimum(diff, 360 - diff)
        # nearest-neighbour sampling error bounded by pixel scale
        assert np.median(diff) < 15.0
        body.set_img_size(15, 10)
        body.reset_disc_params()


class TestLimits:
    def test_img_limits(self, body):
        body.set_img_size(15, 10)
        body.set_disc_params(7, 4.5, 4, 0)
        (xl, xr), (yb, yt) = body.get_img_limits_xy()
        assert (xl, xr) == (-0.5, 14.5)
        assert (yb, yt) == (-0.5, 9.5)
        (ra_l, ra_r), (dec_b, dec_t) = body.get_img_limits_radec()
        assert ra_l > ra_r  # RA increases leftwards
        (km_xl, km_xr), _ = body.get_img_limits_km()
        assert km_xl < 0 < km_xr
