"""
Observation layer tests, including full FITS regression comparisons against
the reference project's committed output files (generated with CSPICE +
astropy + pyproj + photutils). These exercise the entire stack end-to-end:
kernel parsing, ephemeris, frames, geometry, projections, interpolation and
FITS I/O.
"""

import os

import numpy as np
import pytest

from common import REFERENCE_DATA_PATH, setup_kernels

import planetmapper_tpu  # noqa: F401  (x64 config side-effect)
from planetmapper_tpu import Observation
from planetmapper_tpu.io import fits

INPUTS = os.path.join(REFERENCE_DATA_PATH, 'inputs')
OUTPUTS = os.path.join(REFERENCE_DATA_PATH, 'outputs')


@pytest.fixture(scope='module', autouse=True)
def kernels():
    setup_kernels()


@pytest.fixture()
def observation():
    obs = Observation(os.path.join(INPUTS, 'test.fits'))
    obs.set_disc_params(2.5, 3.1, 3.9, 123.456)
    obs.set_disc_method('<<<test>>>')
    return obs


def compare_fits_to_reference(
    path: str, reference_name: str, *, atol=1e-6, rtol=1e-5,
    primary_tolerances=None,
):
    """
    HDU-by-HDU comparison mirroring the reference test's
    ``compare_fits_to_reference`` (test_observation.py:1203-1260),
    including the WIREFRAME HDU at the reference's loose ``atol=64``
    (reference test_observation.py:1252-1257: a matplotlib raster, so
    environment/font sensitive - but the geometry must land on the
    same pixels; the repo's renderer reproduces the committed rasters
    to ~1 grey level).

    Tolerance notes: atol=1e-6 + rtol=1e-5 are the reference's own values
    (its test_observation.py:1203-1260). The independent SGP4 + TEME
    implementation places the HST observer within ~10 cm of CSPICE's
    EV2LIN for these epochs, so no extra slack is needed.
    Longitude planes are compared with circular difference, ignoring cells
    at the poles where longitude is undefined (projection libraries return
    arbitrary-but-different values there).
    """
    path_ref = os.path.join(OUTPUTS, reference_name)
    with fits.open(path) as hdul, fits.open(path_ref) as hdul_ref:
        hdul_ref = list(hdul_ref)
        hdul = list(hdul)
        assert len(hdul) == len(hdul_ref), (
            f'{len(hdul)} HDUs vs reference {len(hdul_ref)}'
        )
        assert set(h.name for h in hdul) == set(h.name for h in hdul_ref)
        ref_by_name = {h.name: h for h in hdul_ref}
        lat_ref = None
        if 'LAT-GRAPHIC' in ref_by_name:
            lat_ref = np.asarray(ref_by_name['LAT-GRAPHIC'].data, dtype=float)
        for hdu in hdul:
            hdu_ref = ref_by_name[hdu.name]
            data = np.asarray(hdu.data, dtype=float)
            data_ref = np.asarray(hdu_ref.data, dtype=float)
            assert data.shape == data_ref.shape, hdu.name
            if primary_tolerances and hdu.name in ('', 'PRIMARY'):
                # (the io.fits primary HDU has no EXTNAME; astropy
                # reports it as 'PRIMARY')
                # Per-plane tolerances for the mapped data cube
                # (reference test_observation.py:1233-1244: scipy's
                # smoothing-spline knot placement varies between
                # versions, so some planes compare loosely)
                for i, (atol_i, rtol_i) in enumerate(primary_tolerances):
                    assert np.array_equal(
                        np.isnan(data[i]), np.isnan(data_ref[i])
                    ), f'PRIMARY[{i}]: NaN masks differ'
                    d = np.abs(data[i] - data_ref[i])
                    ok = np.all(
                        np.isnan(d)
                        | (d <= atol_i + rtol_i * np.abs(data_ref[i]))
                    )
                    assert ok, f'PRIMARY[{i}]: {np.nanmax(d)}'
                continue
            assert np.array_equal(
                np.isnan(data), np.isnan(data_ref)
            ), f'{hdu.name}: NaN masks differ'
            diff = np.abs(data - data_ref)
            if 'LON' in hdu.name:
                diff = np.minimum(diff, 360.0 - diff)
            if ('LON' in hdu.name or hdu.name == 'LOCAL-SOLAR-TIME') and (
                lat_ref is not None and lat_ref.shape == data.shape
            ):
                # Longitude (and so local solar time) is undefined at the
                # poles; projection implementations return arbitrary values
                diff = np.where(np.abs(np.abs(lat_ref) - 90) < 1e-9,
                                np.nan, diff)
            atol_hdu, rtol_hdu = (
                (64.0, 0.0) if hdu.name == 'WIREFRAME' else (atol, rtol)
            )
            ok = np.all(
                np.isnan(diff)
                | (diff <= atol_hdu + rtol_hdu * np.abs(data_ref))
            )
            assert ok, (
                f'{hdu.name}: max abs diff {np.nanmax(diff)}'
            )


class TestLoading:
    @pytest.mark.reference_data
    def test_planmap_fits(self):
        obs = Observation(os.path.join(INPUTS, 'planmap.fits'))
        assert obs.target == 'JUPITER'
        assert obs.observer == 'HST'
        assert obs.utc == '2005-01-01T12:00:00.000000'
        assert np.array_equal(
            obs.data,
            np.array([[[1, 2, 3], [4, 5, 6]], [[7, 8, 9], [10, 11, 12]]]),
        )
        assert obs.get_disc_params() == pytest.approx((1.1, 2.2, 3.3, 4.4))
        assert obs.get_disc_method() == 'header'

    @pytest.mark.reference_data
    def test_planmap_override(self):
        obs = Observation(
            os.path.join(INPUTS, 'planmap.fits'), observer='EARTH',
            utc='2005-01-01',
        )
        assert obs.observer == 'EARTH'
        assert obs.utc == '2005-01-01T00:00:00.000000'

    @pytest.mark.reference_data
    def test_wcs_fits(self):
        obs = Observation(os.path.join(INPUTS, 'wcs.fits'))
        assert obs.get_x0() == pytest.approx(198.87871682168858, abs=0.2)
        assert obs.get_y0() == pytest.approx(-31.89770255438151, abs=0.2)
        assert obs.get_r0() == pytest.approx(164.4473594677842, abs=0.2)
        assert obs.get_rotation() == pytest.approx(260.32237572846986, abs=0.2)
        assert obs.get_disc_method() == 'wcs'

    @pytest.mark.reference_data
    def test_wcs_fits_sin_projection(self):
        # Same observation navigated through an orthographic (SIN) WCS:
        # the target sits close to the reference point, so the disc
        # parameters must land on the TAN goldens (all zenithal
        # projections agree on-axis), exercising the non-TAN path
        # end-to-end through disc_from_wcs
        with fits.open(os.path.join(INPUTS, 'wcs.fits')) as hdul:
            header = hdul[0].header.copy()
            data = hdul[0].data
        header['CTYPE1'] = 'RA---SIN'
        header['CTYPE2'] = 'DEC--SIN'
        obs = Observation(data=data, header=header)
        obs.disc_from_wcs(suppress_warnings=True)
        assert obs.get_x0() == pytest.approx(198.87871682168858, abs=0.5)
        assert obs.get_y0() == pytest.approx(-31.89770255438151, abs=0.5)
        assert obs.get_r0() == pytest.approx(164.4473594677842, abs=0.5)
        assert obs.get_rotation() == pytest.approx(
            260.32237572846986, abs=0.5
        )
        assert obs.get_disc_method() == 'wcs'

    @pytest.mark.reference_data
    def test_extended_fits(self):
        obs = Observation(os.path.join(INPUTS, 'extended.fits'))
        assert obs.target == 'JUPITER'
        assert obs.utc == '2005-01-01T12:00:00.000000'
        assert np.array_equal(
            obs.data,
            np.array([[[1, 2, 3], [4, 5, 6]], [[7, 8, 9], [10, 11, 12]]]),
        )

    @pytest.mark.reference_data
    def test_2d_image_fits_mjd(self):
        obs = Observation(os.path.join(INPUTS, '2d_image.fits'))
        # MJD-BEG/END 51544/51545 -> midpoint 51544.5 = 2000-01-01T12:00
        assert obs.utc == '2000-01-01T12:00:00.000000'
        assert obs.data.shape == (1, 2, 2)

    @pytest.mark.reference_data
    def test_image_png(self):
        obs = Observation(
            os.path.join(INPUTS, '2d_image.png'), target='jupiter',
            observer='HST', utc='2005-01-01',
        )
        assert obs.data.shape == (1, 2, 2)
        # PIL loads flipped vertically relative to FITS convention
        assert np.array_equal(obs.data[0], np.array([[1, 2], [3, 4]]))

    def test_data_only(self):
        data = np.ones((5, 6, 7))
        obs = Observation(
            data=data, target='Jupiter', observer='hst',
            utc='2005-01-01T00:00:00',
        )
        assert obs.get_img_size() == (7, 6)
        assert obs.header['OBJECT'] == 'JUPITER'
        with pytest.raises(ValueError):
            Observation()
        with pytest.raises(TypeError):
            Observation(data=data, target='jupiter', utc='2005-01-01', nx=5)
        with pytest.raises(TypeError):
            obs.set_img_size(5, 5)

    @pytest.mark.reference_data
    def test_empty_fits(self):
        with pytest.raises(ValueError):
            Observation(os.path.join(INPUTS, 'empty.fits'))


class TestDiscFitting:
    def test_fit_disc(self):
        data = np.ones((5, 10, 8))
        data[:, 3:5, 2:4] = 10
        obs = Observation(
            data=data, target='Jupiter', observer='hst',
            utc='2005-01-01T00:00:00',
        )
        obs.set_disc_params(0, 0, 99, 99)
        obs.fit_disc_position()
        assert obs.get_x0() == pytest.approx(2.5)
        assert obs.get_y0() == pytest.approx(3.5)
        assert obs.get_disc_method() == 'fit_position'
        obs.fit_disc_radius()
        assert obs.get_r0() == pytest.approx(1.5)
        assert obs.get_disc_method() == 'fit_r0'
        assert obs.get_rotation() == pytest.approx(99)

    def test_fit_radius_out_of_frame(self):
        obs = Observation(
            data=np.ones((30, 30)), target='Jupiter', observer='hst',
            utc='2005-01-01T00:00:00',
        )
        obs.set_disc_params(x0=-1)
        with pytest.raises(ValueError):
            obs.fit_disc_radius()


@pytest.mark.reference_data
class TestNavRegression:
    """Full regression against the reference's committed output FITS."""

    def test_save_observation(self, observation, tmp_path):
        path = str(tmp_path / 'test_nav.fits')
        observation.save_observation(
            path, print_info=False,
            wireframe_kwargs=dict(output_size=20, dpi=20),
        )
        compare_fits_to_reference(path, 'test_nav.fits')

    def test_save_observation_alt(self, observation, tmp_path):
        # The km<->angular matrix (north pole angle) is cached at first
        # access, like the reference; the reference regression file was
        # generated after a no-alt save, so its matrix was cached at alt=0.
        # Trigger the same cache state before the alt save.
        observation.north_pole_angle()
        observation._get_km2angular_matrix()
        path = str(tmp_path / 'test_nav_alt.fits')
        observation.save_observation(
            path, print_info=False, alt=34567.8912,
            # output_size=19: the reference generated this file with 19
            # (its test_observation.py:1061)
            wireframe_kwargs=dict(output_size=19, dpi=20),
        )
        compare_fits_to_reference(path, 'test_nav_alt.fits')

    def test_save_custom_backplanes(self, observation, tmp_path):
        path = str(tmp_path / 'test_nav_custom_backplanes.fits')
        observation.save_observation(
            path, print_info=False,
            backplanes_to_save=[
                'RA', '   dec   ', 'DISTANCE', 'radial-VELOCITY',
                '<some other backplane>',
            ],
            backplanes_to_skip=['DEC', 'dISTANCE   ', 'LIMB-DISTANCE'],
            # default wireframe size: the reference generated this file
            # with the 1500px default (its test_observation.py:1065-1080)
        )
        compare_fits_to_reference(path, 'test_nav_custom_backplanes.fits')


MAP_CONFIGS = {
    'rectangular-nearest': dict(degree_interval=30, interpolation='nearest'),
    'rectangular-nearest-alt': dict(
        degree_interval=30, interpolation='nearest', alt=34567.8912
    ),
    'rectangular-linear': dict(
        degree_interval=30, interpolation='linear', include_wireframe=False
    ),
    'rectangular-quadratic': dict(
        degree_interval=30, interpolation='quadratic',
        include_backplanes=False, include_wireframe=False,
    ),
    'rectangular-cubic': dict(
        degree_interval=30, interpolation='cubic', include_backplanes=False,
        include_wireframe=False,
    ),
    'rectangular-smooth': dict(
        degree_interval=30, interpolation='smooth', include_backplanes=False,
        include_wireframe=False,
    ),
    # anisotropic spline orders + FITPACK smoothing (reference
    # test_observation.py:1116-1122)
    'rectangular-interpolation': dict(
        degree_interval=30, interpolation=(1, 3), spline_smoothing=2.34,
        include_backplanes=False, include_wireframe=False,
    ),
    'orthographic-1': dict(
        projection='orthographic', size=10, include_wireframe=False
    ),
    'orthographic-2': dict(projection='orthographic', lat=90, size=5),
    'orthographic-3': dict(
        projection='orthographic', lat=-21.3, lon=-42, size=4,
        include_wireframe=False,
    ),
    'azimuthal-1': dict(projection='azimuthal', size=10, include_wireframe=False),
    'azimuthal-2': dict(projection='azimuthal', lat=-90, size=5),
    'azimuthal-3': dict(
        projection='azimuthal', lat=42, lon=12.345, size=4,
        include_wireframe=False,
    ),
}


@pytest.mark.reference_data
class TestMapRegression:
    @pytest.mark.parametrize('map_type', sorted(MAP_CONFIGS))
    def test_save_mapped_observation(self, observation, tmp_path, map_type):
        map_kw = dict(MAP_CONFIGS[map_type])
        path = str(tmp_path / f'map_{map_type}.fits')
        observation.save_mapped_observation(
            path, print_info=False, **map_kw,
            wireframe_kwargs=dict(output_size=20, dpi=20),
        )
        primary_tolerances = None
        if map_type == 'rectangular-interpolation':
            # The exact smoothing-spline solution can vary between scipy
            # versions in extreme cases, so the reference relaxes two
            # planes (its test_observation.py:1163-1170)
            primary_tolerances = [(1e-6, 1e-5)] * 9
            primary_tolerances[6] = (1e-1, 1e-1)
            primary_tolerances[7] = (10, 1)
        compare_fits_to_reference(
            path, f'map_{map_type}.fits',
            primary_tolerances=primary_tolerances,
        )

    def test_save_mapped_custom_backplanes(self, observation, tmp_path):
        # reference test_observation.py:1184-1201
        path = str(tmp_path / 'map_custom_backplanes.fits')
        observation.save_mapped_observation(
            path, print_info=False,
            backplanes_to_save=[
                'RA', '   dec   ', 'DISTANCE', 'radial-VELOCITY',
                '<some other backplane>',
            ],
            backplanes_to_skip=['DEC', 'dISTANCE   ', 'LIMB-DISTANCE'],
            degree_interval=30, interpolation='nearest',
            wireframe_kwargs=dict(output_size=20, dpi=20),
        )
        compare_fits_to_reference(path, 'map_custom_backplanes.fits')


@pytest.mark.reference_data
class TestSaveReload:
    def test_roundtrip(self, observation, tmp_path):
        path = str(tmp_path / 'roundtrip.fits')
        observation.save_observation(
            path, print_info=False, include_wireframe=False,
        )
        reloaded = Observation(path)
        assert reloaded.get_disc_params() == pytest.approx(
            observation.get_disc_params()
        )
        assert reloaded.get_disc_method() == 'header'
        assert reloaded.target == observation.target
        assert reloaded.observer == observation.observer
        assert reloaded.utc == observation.utc
        np.testing.assert_allclose(reloaded.data, observation.data)

    def test_get_mapped_data(self, observation):
        mapped = observation.get_mapped_data(degree_interval=30)
        assert mapped.shape == (10, 6, 12)
        mapped2 = observation.get_mapped_data(degree_interval=30)
        np.testing.assert_array_equal(mapped, mapped2, strict=True)

    def test_make_filename(self, observation):
        assert observation.make_filename() == 'JUPITER_2005-01-01T000000.fits'

    def test_wcs_offsets(self):
        obs = Observation(os.path.join(INPUTS, 'wcs.fits'))
        obs.adjust_disc_params(dx=1.5, dy=-2.0)
        dx, dy, dr, drot = obs.get_wcs_offset(suppress_warnings=True)
        assert dx == pytest.approx(1.5, abs=1e-6)
        assert dy == pytest.approx(-2.0, abs=1e-6)
        assert dr == pytest.approx(0.0, abs=1e-6)
        dra, ddec = obs.get_wcs_arcsec_offset(suppress_warnings=True)
        assert abs(dra) > 0 or abs(ddec) > 0

    def test_partial_wcs_navigation(self):
        # reference tests/test_observation.py:523 (test_stuff_from_wcs)
        no_wcs = Observation(
            data=np.ones((4, 5, 6)),
            header={'OBJECT': 'jupiter', 'DATE-OBS': '2005-01-01'},
        )
        for fn in (
            no_wcs.disc_from_wcs, no_wcs.position_from_wcs,
            no_wcs.rotation_from_wcs, no_wcs.plate_scale_from_wcs,
        ):
            with pytest.raises(ValueError):
                fn(suppress_warnings=True)
        x0, y0 = 198.87871682168858, -31.89770255438151
        r0, rotation = 164.4473594677842, 260.32237572846986
        obs = Observation(os.path.join(INPUTS, 'wcs.fits'))
        obs.set_disc_params(0, 0, 1, 0)
        obs.disc_from_wcs(suppress_warnings=True)
        assert obs.get_disc_method() == 'wcs'
        np.testing.assert_allclose(
            obs.get_disc_params(), (x0, y0, r0, rotation), atol=0.2
        )
        obs.set_disc_params(0, 0, 1, 0)
        obs.position_from_wcs(suppress_warnings=True)
        assert obs.get_disc_method() == 'wcs_position'
        assert obs.get_x0() == pytest.approx(x0, abs=0.2)
        assert obs.get_y0() == pytest.approx(y0, abs=0.2)
        assert obs.get_r0() == 1  # untouched
        obs.set_disc_params(0, 0, 1, 0)
        obs.rotation_from_wcs(suppress_warnings=True)
        assert obs.get_disc_method() == 'wcs_rotation'
        assert obs.get_rotation() == pytest.approx(rotation, abs=0.2)
        assert obs.get_x0() == 0
        obs.set_disc_params(0, 0, 1, 0)
        obs.plate_scale_from_wcs(suppress_warnings=True)
        assert obs.get_disc_method() == 'wcs_plate_scale'
        assert obs.get_r0() == pytest.approx(r0, abs=0.2)
        assert obs.get_x0() == 0

    def test_wcs_offset_reference_goldens(self):
        # reference tests/test_observation.py:714 (test_wcs_offset)
        obs = Observation(os.path.join(INPUTS, 'wcs.fits'))
        obs.disc_from_wcs(suppress_warnings=True)
        np.testing.assert_allclose(
            obs.get_disc_params(),
            (198.87871682168858, -31.89770255438151,
             164.4473594677842, 260.32237572846986),
            atol=0.2,
        )
        adjustment = (1.23, -4.56, 7.89, 10.11)
        obs.adjust_disc_params(*adjustment)
        np.testing.assert_allclose(
            obs.get_wcs_offset(suppress_warnings=True), adjustment,
            atol=1e-6,
        )
        obs.adjust_disc_params(dx=10)
        np.testing.assert_allclose(
            obs.get_wcs_offset(suppress_warnings=True),
            (11.23, -4.56, 7.89, 10.11), atol=1e-6,
        )
        obs.disc_from_wcs(suppress_warnings=True)
        obs.add_arcsec_offset(1, 2.5)
        np.testing.assert_allclose(
            obs.get_wcs_arcsec_offset(suppress_warnings=True), (1, 2.5),
            atol=1e-3,
        )
        obs.add_arcsec_offset(10)
        np.testing.assert_allclose(
            obs.get_wcs_arcsec_offset(suppress_warnings=True), (11, 2.5),
            atol=1e-3,
        )
        # scale/rotation changes make the arcsec offset ill-defined
        # unless the position-only check is disabled
        obs.disc_from_wcs(suppress_warnings=True)
        obs.adjust_disc_params(dr=10)
        with pytest.raises(ValueError):
            obs.get_wcs_arcsec_offset(suppress_warnings=True)
        obs.get_wcs_arcsec_offset(
            suppress_warnings=True, check_is_position_offset_only=False
        )
        obs.disc_from_wcs(suppress_warnings=True)
        obs.adjust_disc_params(drotation=123)
        with pytest.raises(ValueError):
            obs.get_wcs_arcsec_offset(suppress_warnings=True)
        obs.get_wcs_arcsec_offset(
            suppress_warnings=True, check_is_position_offset_only=False
        )
        # no wraparound false-positive for a tiny negative drotation
        obs.disc_from_wcs(suppress_warnings=True)
        obs.adjust_disc_params(drotation=-1e-6)
        obs.get_wcs_arcsec_offset(suppress_warnings=True)
