"""
Body API tests against CSPICE-derived golden values (from the reference
project's test expectations).

Tolerance notes: configurations observed from EARTH exercise only Chebyshev
SPK segments and match CSPICE essentially exactly (<1e-8 deg). HST-observer
configurations involve an independent SGP4 implementation that agrees with
CSPICE to ~20 m in HST's position, i.e. ~2e-5 deg in surface coordinates -
50x tighter than the sub-millidegree requirement.
"""

import datetime

import numpy as np
import pytest

from common import setup_kernels

import planetmapper_tpu  # noqa: F401  (x64 config side-effect)
from planetmapper_tpu import BasicBody, Body
from planetmapper_tpu.base import BodiesNotDistinctError, NotFoundError


@pytest.fixture(scope='module', autouse=True)
def kernels():
    setup_kernels()


@pytest.fixture(scope='module')
def body():
    return Body('Jupiter', observer='HST', utc='2005-01-01T00:00:00')


class TestInit:
    @pytest.mark.reference_data
    def test_subpoint_golden_earth(self):
        assert Body('Jupiter', utc='2005-01-01').subpoint_lon == pytest.approx(
            153.12547767272153, abs=1e-8
        )

    @pytest.mark.reference_data
    def test_subpoint_golden_cn_plus_s(self):
        assert Body(
            'Jupiter', utc='2005-01-01', aberration_correction='CN+S'
        ).subpoint_lon == pytest.approx(153.12614128206837, abs=1e-6)

    @pytest.mark.reference_data
    def test_custom_target_frame(self):
        b = Body('Jupiter', utc='2005-01-01', target_frame='iau_jupiter')
        assert b.subpoint_lon == pytest.approx(153.12547767272153, abs=1e-8)
        assert b.target_frame == 'iau_jupiter'

    def test_saturn_rings_auto_added(self):
        saturn = Body('saturn', '2000-01-01')
        assert saturn.target == 'SATURN'
        assert saturn.target_body_id == 699
        assert saturn.ring_radii == {
            74658.0, 91975.0, 117507.0, 122340.0, 136780.0
        }

    def test_bodies_not_distinct(self):
        with pytest.raises(BodiesNotDistinctError):
            Body('earth', observer='earth', utc='2005-01-01')


class TestRotationSense:
    @pytest.mark.parametrize(
        'target,positive_dir,prograde',
        [
            ('sun', 'E', True),
            ('moon', 'E', True),
            ('earth', 'E', True),
            ('jupiter', 'W', True),
            ('amalthea', 'W', True),
            ('uranus', 'E', False),
        ],
    )
    def test_rotation_sense(self, target, positive_dir, prograde):
        b = Body(target, observer='HST', utc='2005-01-01T00:00:00')
        assert b.positive_longitude_direction == positive_dir
        assert b.prograde == prograde


class TestAttributes:
    """Reference goldens: tests/test_body.py:106-165."""

    @pytest.mark.reference_data
    def test_attributes(self, body):
        assert body.target == 'JUPITER'
        assert body.utc == '2005-01-01T00:00:00.000000'
        assert body.observer == 'HST'
        assert body.et == pytest.approx(157809664.1839331, abs=1e-6)
        assert body.dtm == datetime.datetime(
            2005, 1, 1, 0, 0, tzinfo=datetime.timezone.utc
        )
        assert body.target_body_id == 599
        assert body.r_eq == 71492.0
        assert body.r_polar == 66854.0
        assert body.flattening == pytest.approx(0.0648743915403122, abs=1e-12)
        assert body.prograde is True
        assert body.positive_longitude_direction == 'W'
        assert body.target_light_time == pytest.approx(
            2734.018326542542, abs=1e-6
        )
        assert body.target_distance == pytest.approx(819638074.3312353, abs=0.1)
        assert body.target_ra == pytest.approx(196.37198562427025, abs=1e-7)
        assert body.target_dec == pytest.approx(-5.565793847134351, abs=1e-7)
        assert body.target_diameter_arcsec == pytest.approx(
            35.98242689969618, abs=1e-6
        )
        assert body.km_per_arcsec == pytest.approx(3973.7175149019004, abs=1e-5)
        assert body.subpoint_distance == pytest.approx(819566594.28005, abs=0.1)
        assert body.subpoint_lon == pytest.approx(153.12585514751467, abs=2e-5)
        assert body.subpoint_lat == pytest.approx(-3.0886644594385193, abs=2e-5)
        assert body.subsol_lon == pytest.approx(163.44768812575543, abs=2e-5)
        assert body.subsol_lat == pytest.approx(-2.7185371707509427, abs=2e-5)
        assert body.named_ring_data == {
            'Halo': [89400.0, 123000.0],
            'Main Ring': [123000.0, 128940.0],
            'Amalthea Ring': [128940.0, 181350.0],
            'Thebe Ring': [181350.0, 221900.0],
            'Thebe Extension': [221900.0, 280000.0],
        }
        assert body.ring_radii == set()
        assert body.coordinates_of_interest_lonlat == []
        assert body.coordinates_of_interest_radec == []
        assert body.other_bodies_of_interest == []
        assert body._alt_adjustment == 0.0
        assert type(body.flattening) is float
        assert type(body.km_per_arcsec) is float
        assert type(body.r_eq) is float
        assert type(body.r_polar) is float
        assert type(body.target_ra) is float

    def test_sun_moon(self):
        moon = Body('moon', '2005-01-01')
        assert moon.positive_longitude_direction == 'E'
        assert moon.prograde
        sun = Body('sun', '2005-01-01')
        assert sun.positive_longitude_direction == 'E'
        assert sun.prograde
        assert np.isnan(sun.subsol_lon)
        assert np.isnan(sun.subsol_lat)


class TestReprEqHash:
    def test_repr(self, body):
        assert repr(body) == (
            "Body('JUPITER', '2005-01-01T00:00:00.000000', observer='HST')"
        )

    def test_eq(self, body):
        assert body == body
        assert body == Body('Jupiter', observer='HST', utc='2005-01-01T00:00:00')
        assert body != BasicBody(
            'Jupiter', observer='HST', utc='2005-01-01T00:00:00'
        )
        assert body != Body('Jupiter', observer='HST', utc='2005-01-01T00:00:01')
        assert body != Body('Jupiter', utc='2005-01-01T00:00:00')
        assert body != Body(
            'Jupiter', observer='HST', utc='2005-01-01T00:00:00',
            aberration_correction='CN+S',
        )

    def test_hash(self, body):
        assert hash(body) == hash(
            Body('Jupiter', observer='HST', utc='2005-01-01T00:00:00')
        )
        d = {}
        for time in ['2005-01-01T00:00:00', '2005-01-01T00:00:00',
                     '2005-01-01T00:00:01', '2005-01-01T00:00:02']:
            d[Body('Jupiter', observer='HST', utc=time)] = time
        assert len(d) == 3

    def test_copy_replace(self, body):
        new = body.copy()
        assert new == body
        assert new is not body
        replaced = body.replace(utc='2005-01-01T12:34:56')
        assert replaced != body
        assert replaced.utc == '2005-01-01T12:34:56.000000'
        assert replaced.replace(utc='2005-01-01T00:00:00') == body


class TestCreateOtherBody:
    def test_create_other_body(self, body):
        assert body.create_other_body('amalthea') == Body(
            'AMALTHEA', observer='HST', utc='2005-01-01T00:00:00'
        )
        assert body.create_other_body('daphnis') == BasicBody(
            'DAPHNIS', observer='HST', utc='2005-01-01T00:00:00'
        )
        from planetmapper_tpu.kernels.pool import KernelVarNotFoundError

        with pytest.raises(KernelVarNotFoundError):
            body.create_other_body('daphnis', fallback_to_basic_body=False)
        with pytest.raises(NotFoundError):
            body.create_other_body('<<< test >>>')


class TestTransforms:
    """Golden transform pairs from the reference tests/test_body.py."""

    @pytest.mark.reference_data
    def test_lonlat2radec_goldens(self, body):
        pairs = [
            [(0, 90), (196.37390490466322, -5.561534444253404)],
            [(0, 0), (196.36982789576643, -5.565060944053696)],
            [(123.456, -56.789), (196.3691609381441, -5.5685956879058764)],
        ]
        for (lon, lat), (ra_g, dec_g) in pairs:
            ra, dec = body.lonlat2radec(lon, lat, not_visible_nan=False)
            assert ra == pytest.approx(ra_g, abs=1e-7)
            assert dec == pytest.approx(dec_g, abs=1e-7)

    def test_lonlat2radec_nan(self, body):
        for lon, lat in [(np.nan, np.nan), (np.nan, 0), (0, np.nan),
                         (np.inf, np.inf)]:
            ra, dec = body.lonlat2radec(lon, lat)
            assert np.isnan(ra) and np.isnan(dec)

    @pytest.mark.reference_data
    def test_radec2lonlat_golden(self, body):
        lon, lat = body.radec2lonlat(
            196.37198562427025, -5.565793847134351
        )
        assert lon == pytest.approx(153.1235185909613, abs=5e-5)
        assert lat == pytest.approx(-3.0887371238645795, abs=5e-5)

    def test_radec2lonlat_miss(self, body):
        lon, lat = body.radec2lonlat(0, 0)
        assert np.isnan(lon) and np.isnan(lat)
        with pytest.raises(NotFoundError):
            body.radec2lonlat(0, 0, not_found_nan=False)

    def test_roundtrip(self, body):
        lons = np.array([100.0, 140.0, 200.0])
        lats = np.array([10.0, -20.0, 5.0])
        ra, dec = body.lonlat2radec(lons, lats, not_visible_nan=False)
        lon2, lat2 = body.radec2lonlat(ra, dec)
        vis = np.isfinite(lon2)
        assert np.any(vis)
        np.testing.assert_allclose(lon2[vis], lons[vis], atol=1e-4)
        np.testing.assert_allclose(lat2[vis], lats[vis], atol=1e-4)

    def test_array_scalar_consistency(self, body):
        lons = np.array([100.0, 153.0])
        lats = np.array([-3.0, 40.0])
        ra_arr, dec_arr = body.lonlat2radec(lons, lats, not_visible_nan=False)
        for i in range(len(lons)):
            ra, dec = body.lonlat2radec(
                float(lons[i]), float(lats[i]), not_visible_nan=False
            )
            assert ra == pytest.approx(float(ra_arr[i]), abs=1e-10)
            assert dec == pytest.approx(float(dec_arr[i]), abs=1e-10)

    def test_targvec2lonlat(self, body):
        pairs = [
            (np.array([0, 0, 0]), (0.0, 90.0)),
            (np.array([1, 2, 3]), (296.565051177078, 89.98665551067639)),
            (np.array([-9876, 543210, 0]), (268.9584308375042, 0.0)),
        ]
        for targvec, (lon_g, lat_g) in pairs:
            lon, lat = body.targvec2lonlat(targvec)
            assert lon == pytest.approx(lon_g, abs=1e-8)
            assert lat == pytest.approx(lat_g, abs=1e-8)
        lon, lat = body.targvec2lonlat(np.array([np.nan, 0, 0]))
        assert np.isnan(lon) and np.isnan(lat)

    def test_angular_roundtrip(self, body):
        x, y = body.radec2angular(body.target_ra, body.target_dec)
        assert x == pytest.approx(0.0, abs=1e-9)
        assert y == pytest.approx(0.0, abs=1e-9)
        ra, dec = body.angular2radec(12.3, -45.6)
        x2, y2 = body.radec2angular(ra, dec)
        assert x2 == pytest.approx(12.3, abs=1e-9)
        assert y2 == pytest.approx(-45.6, abs=1e-9)

    def test_km_roundtrip(self, body):
        ra, dec = body.km2radec(10000.0, -5000.0)
        km_x, km_y = body.radec2km(ra, dec)
        assert km_x == pytest.approx(10000.0, abs=1e-4)
        assert km_y == pytest.approx(-5000.0, abs=1e-4)

    @pytest.mark.reference_data
    def test_north_pole_angle(self, body):
        assert body.north_pole_angle() == pytest.approx(
            -24.15516987997688, abs=1e-6
        )
        body2 = Body('Jupiter', observer='HST', utc='2009-01-01T00:00:00')
        assert body2.north_pole_angle() == pytest.approx(
            13.550583134129457, abs=1e-6
        )


class TestVisibilityIllumination:
    def test_subpoint_visible(self, body):
        assert body.test_if_lonlat_visible(body.subpoint_lon, body.subpoint_lat)
        far_lon = (body.subpoint_lon + 180.0) % 360.0
        assert not body.test_if_lonlat_visible(far_lon, -body.subpoint_lat)

    def test_subsol_illuminated(self, body):
        assert body.test_if_lonlat_illuminated(body.subsol_lon, body.subsol_lat)
        far_lon = (body.subsol_lon + 180.0) % 360.0
        assert not body.test_if_lonlat_illuminated(far_lon, -body.subsol_lat)

    def test_illumination_angles(self, body):
        # At the intercept-method sub-solar point of an oblate body the
        # geodetic normal differs from the radial sun direction by up to
        # ~f*sin(2 lat) (~0.35 deg for Jupiter at lat -2.7).
        phase, incidence, emission = body.illumination_angles_from_lonlat(
            body.subsol_lon, body.subsol_lat
        )
        assert incidence == pytest.approx(0.0, abs=0.5)
        phase2, incidence2, emission2 = body.illumination_angles_from_lonlat(
            body.subpoint_lon, body.subpoint_lat
        )
        assert emission2 == pytest.approx(0.0, abs=0.5)
        # Phase angle ~ separation of sun and observer from the surface
        assert 10.0 < phase2 < 11.0

    def test_limb_on_disc_edge(self, body):
        ra, dec = body.limb_radec(npts=36)
        assert np.all(np.isfinite(ra))
        # limb should be ~target_diameter/2 from the centre
        dist = body.angular_dist(ra, dec, body.target_ra, body.target_dec)
        expected = body.target_diameter_arcsec / 3600.0 / 2.0
        np.testing.assert_allclose(dist[:-1], expected, rtol=0.07)

    def test_terminator(self, body):
        ra, dec = body.terminator_radec(npts=36)
        n_vis = np.sum(np.isfinite(ra))
        assert 0 < n_vis < len(ra)
        lon, lat = body.terminator_lonlat(npts=36, only_visible=False)
        assert np.all(np.isfinite(lon))

    def test_limb_coordinates_from_radec(self, body):
        # At the target centre, the limb distance is about -r
        lon, lat, dist = body.limb_coordinates_from_radec(
            body.target_ra, body.target_dec
        )
        assert dist == pytest.approx(-body.r_eq, rel=0.05)


class TestLst:
    def test_subsol_is_noon(self, body):
        lst = body.local_solar_time_from_lon(body.subsol_lon)
        assert lst == pytest.approx(12.0, abs=0.02)

    def test_string(self, body):
        s = body.local_solar_time_string_from_lon(body.subsol_lon)
        assert s.startswith('11:5') or s.startswith('12:0')


class TestGraphicCentric:
    def test_roundtrip(self, body):
        lon_c, lat_c = body.graphic2centric_lonlat(123.456, -56.789)
        lon_g, lat_g = body.centric2graphic_lonlat(lon_c, lat_c)
        assert np.mod(lon_g, 360) == pytest.approx(123.456, abs=1e-6)
        assert lat_g == pytest.approx(-56.789, abs=1e-6)

    def test_equator_unchanged(self, body):
        lon_c, lat_c = body.graphic2centric_lonlat(100.0, 0.0)
        assert lat_c == pytest.approx(0.0, abs=1e-10)

    def test_centric_less_than_graphic(self, body):
        # |planetocentric lat| < |planetographic lat| for oblate bodies
        lon_c, lat_c = body.graphic2centric_lonlat(0.0, 45.0)
        assert 0 < lat_c < 45.0


class TestStateVelocity:
    def test_radial_velocity_matches_doppler(self, body):
        rv = body.radial_velocity_from_lonlat(
            body.subpoint_lon, body.subpoint_lat
        )
        # Jupiter-HST range rate at 2005-01-01 is ~-26.5 km/s (approaching)
        assert -30.0 < rv < -20.0

    def test_distance(self, body):
        d = body.distance_from_lonlat(body.subpoint_lon, body.subpoint_lat)
        assert d == pytest.approx(body.subpoint_distance, abs=1.0)
        d2 = body.distance_from_lonlat(
            (body.subpoint_lon + 90) % 360, body.subpoint_lat
        )
        assert d2 > d


class TestRings:
    def test_ring_radec_shape(self, body):
        ra, dec = body.ring_radec(100000.0, npts=50)
        assert ra.shape == (50,)
        assert np.any(np.isfinite(ra))

    def test_ring_plane_coordinates(self, body):
        radius, lon, dist = body.ring_plane_coordinates(
            body.target_ra, body.target_dec, only_visible=False
        )
        # Ray towards the centre of the disc crosses the ring plane close
        # to the target centre
        assert radius < body.r_eq * 3
        assert dist == pytest.approx(body.target_distance, rel=0.01)

    def test_ring_radii_from_name(self, body):
        assert body.ring_radii_from_name('Halo') == [89400.0, 123000.0]
        assert body.ring_radii_from_name('halo') == [89400.0, 123000.0]
        assert body.ring_radii_from_name('Main Ring') == [123000.0, 128940.0]
        assert body.ring_radii_from_name('main') == [123000.0, 128940.0]
        with pytest.raises(ValueError):
            body.ring_radii_from_name('<<test>>')

    def test_add_named_rings(self, body):
        b = body.copy()
        b.ring_radii.clear()
        b.add_named_rings('halo', 'main')
        assert b.ring_radii == {89400.0, 123000.0, 128940.0}
        b.add_named_rings()
        assert len(b.ring_radii) > 3


class TestOtherBodyVisibility:
    @pytest.mark.reference_data
    def test_thebe_hidden(self):
        # Reference test_body.py:384-390: THEBE is hidden behind Jupiter at
        # 2005-01-01 04:00, AMALTHEA is visible
        utc = '2005-01-01 04:00:00'
        jupiter = Body('Jupiter', utc)
        jupiter.add_other_bodies_of_interest('THEBE', only_visible=True)
        assert jupiter.other_bodies_of_interest == []
        jupiter.add_other_bodies_of_interest(
            'AMALTHEA', 'THEBE', only_visible=True
        )
        assert jupiter.other_bodies_of_interest == [Body('AMALTHEA', utc)]

    def test_los_intercept_same(self, body):
        assert body.other_body_los_intercept(body.copy()) == 'same'
