"""
Tests for the user-facing shells: GUI logic (headless), the tkinter-less
fallback, the CLI, the kernel downloader (offline, URL functions patched
like the reference's tests/test_kernel_downloader.py), wireframe plotting
contracts and the API-contract meta-test
(reference tests/common_testing.py:147-170).
"""

import inspect
import os
import unittest.mock as mock

import matplotlib

matplotlib.use('Agg')

import numpy as np
import pytest

from common import REFERENCE_DATA_PATH, observation_fits, setup_kernels

import planetmapper_tpu
from planetmapper_tpu import BasicBody, Body, BodyXY, Observation
from planetmapper_tpu import _mock_gui_no_tk, cli, kernel_downloader
from planetmapper_tpu.observation import Observation as ObservationClass

INPUTS = os.path.join(REFERENCE_DATA_PATH, 'inputs')


@pytest.fixture(scope='module', autouse=True)
def kernels():
    setup_kernels()


@pytest.fixture()
def observation():
    obs = Observation(observation_fits())
    obs.set_disc_params(2.5, 3.1, 3.9, 123.456)
    return obs


@pytest.fixture()
def gui(observation):
    from planetmapper_tpu import gui as gui_module

    g = gui_module.GUI()
    g.observation = observation
    return g


class TestGUILogic:
    """GUI behaviour that does not need a display."""

    def test_shortcut_table(self, gui):
        keys = [k for keys in gui.shortcuts.values() for k in keys]
        for expected in (
            '<Up>', '<Down>', '<Left>', '<Right>', 'w', 'a', 's', 'd',
            '[', ']', '+', '-', '<less>', '.', ',',
            '<Control-s>', '<Control-o>', '<Control-h>', '<Control-p>',
            'c', '<Shift-C>',
        ):
            assert expected in keys, expected
        assert len(set(keys)) == len(keys)  # no conflicting bindings

    def test_disc_finding_registry(self, gui):
        sections = gui.disc_finding_routines
        assert set(sections) == {
            'Reset disc', 'Use FITS header metadata',
            'Use WCS data from FITS header', 'Fit observation',
        }
        for rows in sections.values():
            for fn, label, tooltip, requirement in rows:
                assert callable(fn)
                assert label and tooltip
                assert requirement in (None, 'header', 'wcs')

    def test_click_coords(self, gui):
        gui.last_click_location = (2.5, 3.1)
        coords = gui.get_click_coords()
        for key in (
            'x', 'y', 'ra', 'dec', 'lon', 'lat', 'lon_centric',
            'lat_centric', 'phase', 'incidence', 'emission', 'azimuth',
            'limb_distance',
        ):
            assert key in coords, key
        # On-disc pixel: lon/lat match the direct conversion
        lon, lat = gui.get_observation().xy2lonlat(2.5, 3.1)
        assert coords['lon'] == pytest.approx(lon, abs=1e-6)
        assert coords['lat'] == pytest.approx(lat, abs=1e-6)

    def test_click_json_and_formatted_strings(self, gui):
        gui.last_click_location = (2.5, 3.1)
        coords = gui.get_click_coords()
        s = gui.make_click_json_string(coords)
        import json

        parsed = json.loads(s)
        assert parsed['xy'] == [2.5, 3.1]
        assert 'lonlat' in parsed and 'phase' in parsed
        strs = gui.get_click_coords_formatted_strings(coords)
        formatted = gui.make_click_formatted_string(strs)
        assert 'Pixel coordinates' in formatted
        assert '°' in strs['ra']  # DMS formatted

    def test_click_off_disc(self, gui):
        coords = gui._get_coords_for_location(-30.0, -30.0)
        assert 'lon' not in coords
        s = gui.make_click_json_string(coords)
        assert 'lonlat' not in s
        assert 'limb_distance' in s

    def test_image_modes(self, gui):
        obs = gui.get_observation()
        nz = obs.data.shape[0]
        assert gui.image_sum().shape == obs.data.shape[1:]
        assert gui.image_single().shape == obs.data.shape[1:]
        rgb = gui.image_rgb()
        assert rgb.shape == obs.data.shape[1:] + (3,)
        assert np.nanmax(rgb) <= 1.0
        gui.plot_settings['_']['image_mode'] = 'sum'
        assert gui.get_image().shape == obs.data.shape[1:]
        gui.plot_settings['_']['image_idx_single'] = nz - 1
        gui.plot_settings['_']['image_mode'] = 'single'
        assert gui.get_image().shape == obs.data.shape[1:]

    def test_image_limits(self, gui):
        img = np.linspace(0.0, 10.0, 100).reshape(10, 10)
        misc = gui.plot_settings['_']
        misc['image_limit_type'] = 'relative'
        misc['image_vmin'], misc['image_vmax'] = 0, 100
        assert gui.get_image_limits(img) == (0.0, 10.0)
        misc['image_limit_type'] = 'absolute'
        misc['image_vmin'], misc['image_vmax'] = 2.0, 5.0
        assert gui.get_image_limits(img) == (2.0, 5.0)
        misc['image_limit_type'] = 'percentile'
        misc['image_vmin'], misc['image_vmax'] = 0, 50
        lo, hi = gui.get_image_limits(img)
        assert lo == pytest.approx(0.0)
        assert hi == pytest.approx(np.percentile(img, 50))

    def test_step_logic(self, gui):
        gui.set_step(2.0)
        assert gui.step_size == 2.0
        with pytest.raises(ValueError):
            gui.set_step(-1.0)
        with pytest.raises(ValueError):
            gui.set_step(float('nan'))

    def test_adjust_disc_via_shortcut_fns(self, gui):
        obs = gui.get_observation()
        # no widgets built: the ui callbacks are empty, plot update no-ops
        x0 = obs.get_x0()
        gui.step_size = 1.5
        gui.move_right()
        assert obs.get_x0() == pytest.approx(x0 + 1.5)
        r0 = obs.get_r0()
        gui.increase_radius()
        assert obs.get_r0() == pytest.approx(r0 + 1.5)

    def test_x11_translation(self, gui):
        with mock.patch.dict(
            os.environ, {'PLANETMAPPER_USE_X11_FONT_BUGFIX': '1'}
        ):
            assert '°' not in gui._x11('45°30′')

    @pytest.mark.reference_data
    def test_wcs_offsets_roundtrip(self):
        from planetmapper_tpu import gui as gui_module

        gui = gui_module.GUI()
        obs = Observation(os.path.join(INPUTS, 'wcs.fits'))
        gui.observation = obs
        obs.disc_from_wcs(suppress_warnings=True, validate=False,
                          use_header_offsets=False)
        dra, ddec, dr0, drot = gui._get_wcs_offsets()
        assert dra == pytest.approx(0.0, abs=1e-8)
        assert ddec == pytest.approx(0.0, abs=1e-8)
        gui._set_wcs_offsets(dra_arcsec=1.0, ddec_arcsec=-0.5)
        dra, ddec, _, _ = gui._get_wcs_offsets()
        # set/get linearise the radec<->xy mapping at slightly different
        # points, so the roundtrip is approximate at the 1e-5 arcsec level
        assert dra == pytest.approx(1.0, abs=1e-3)
        assert ddec == pytest.approx(-0.5, abs=1e-3)

    def test_plot_settings_defaults(self, gui):
        from planetmapper_tpu.gui import DEFAULT_PLOT_SETTINGS

        for key in (
            'image', 'limb', 'limb_illuminated', 'terminator', 'grid',
            'pole', 'ring', 'marked_coord', '_',
        ):
            assert key in DEFAULT_PLOT_SETTINGS
        assert gui.plot_settings is not DEFAULT_PLOT_SETTINGS
        gui.plot_settings['limb']['color'] = 'r'
        assert DEFAULT_PLOT_SETTINGS['limb']['color'] == 'w'

    def test_artist_field_specs(self, gui):
        from planetmapper_tpu import _gui_settings

        _gui_settings._build_specs()
        for key in _gui_settings.ARTIST_LABELS:
            assert key in _gui_settings.ARTIST_FIELD_SPECS, key
            for field, kind, label, extra in (
                _gui_settings.ARTIST_FIELD_SPECS[key]
            ):
                assert kind in ('color', 'float', 'int', 'bool', 'choice')
                if kind == 'choice':
                    assert extra

    def test_run_gui_with_mocked_class(self, observation):
        with mock.patch('planetmapper_tpu.gui.GUI') as mock_gui:
            instance = mock_gui.return_value
            instance.click_locations = [(1.0, 2.0)]
            out = observation.run_gui()
        mock_gui.assert_called_once_with(allow_open=False)
        instance.set_observation.assert_called_once_with(observation)
        instance.run.assert_called_once_with()
        assert out == [(1.0, 2.0)]


class TestGUINoTk:
    def test_raise_for_missing_tkinter(self):
        exc = ModuleNotFoundError('No module named tkinter', name='tkinter')
        with pytest.raises(ModuleNotFoundError) as excinfo:
            _mock_gui_no_tk.raise_tkinter_import_error(exc)
        assert 'tkinter' in str(excinfo.value)
        assert excinfo.value.name == 'tkinter'

    def test_reraise_other_import_errors(self):
        exc = ImportError('something else', name='numpy')
        with pytest.raises(ImportError) as excinfo:
            _mock_gui_no_tk.raise_tkinter_import_error(exc)
        assert excinfo.value is exc

    def test_mocks(self):
        exc = ModuleNotFoundError('No module named tkinter', name='tkinter')
        gui_mock, run_gui_mock = _mock_gui_no_tk.get_mocks(exc)
        with pytest.raises(ModuleNotFoundError):
            gui_mock.GUI
        with pytest.raises(ModuleNotFoundError):
            run_gui_mock()


class TestCLI:
    def test_version(self, capsys):
        with pytest.raises(SystemExit) as excinfo:
            cli.main(['--version'])
        assert excinfo.value.code == 0
        out = capsys.readouterr().out
        assert 'planetmapper_tpu' in out
        assert planetmapper_tpu.__version__ in out

    def test_launches_gui(self):
        with mock.patch(
            'planetmapper_tpu.gui._run_gui_from_cli'
        ) as mock_run:
            cli.main([])
        mock_run.assert_called_once_with(None)

    def test_launches_gui_with_path(self):
        with mock.patch(
            'planetmapper_tpu.gui._run_gui_from_cli'
        ) as mock_run:
            cli.main(['some_file.fits'])
        mock_run.assert_called_once_with('some_file.fits')

    def test_precision_flag(self):
        from planetmapper_tpu import pipeline

        before = pipeline.DEFAULT_PRECISION
        try:
            with mock.patch('planetmapper_tpu.gui._run_gui_from_cli'):
                cli.main(['--precision', 'double'])
            assert pipeline.DEFAULT_PRECISION == 'double'
        finally:
            pipeline.DEFAULT_PRECISION = before

    def test_bad_precision(self):
        with pytest.raises(SystemExit):
            cli.main(['--precision', 'bogus'])

    def test_prewarm_dispatch(self):
        # --prewarm runs the AOT compile path (with parsed sizes) and
        # never launches the GUI
        with mock.patch.object(cli, '_prewarm') as mock_prewarm, \
                mock.patch(
                    'planetmapper_tpu.gui._run_gui_from_cli'
                ) as mock_gui:
            cli.main(['--prewarm', '64', '128', '--target', 'Saturn'])
        mock_prewarm.assert_called_once_with('Saturn', 'EARTH', [64, 128])
        mock_gui.assert_not_called()

    def test_prewarm_real_tiny(self, capsys):
        # End-to-end on a tiny grid: compiles the fused pipeline + map
        # programs into the persistent cache and prints progress
        cli.main(['--prewarm', '16'])
        out = capsys.readouterr().out
        assert 'fused pipeline compiled' in out
        assert 'map reprojection compiled' in out
        assert 'persistent cache' in out


class TestKernelDownloader:
    """Offline: every network function is patched."""

    def test_url_root(self):
        assert kernel_downloader.URL_ROOT == 'https://naif.jpl.nasa.gov/pub/'

    def test_url_path_conversions(self):
        url = kernel_downloader.URL_ROOT + 'naif/generic_kernels/pck/x.tpc'
        kp = kernel_downloader._get_kernel_path(url)
        assert kp == os.path.normpath('naif/generic_kernels/pck/x.tpc')
        assert kernel_downloader._kernel_path_to_url(kp.replace(
            os.path.sep, '/')) .startswith(kernel_downloader.URL_ROOT)
        local = kernel_downloader._convert_url_to_local_path(url)
        assert local.startswith(
            os.path.normpath(planetmapper_tpu.get_kernel_path())
        )
        with pytest.raises(ValueError):
            kernel_downloader._get_kernel_path('/somewhere/else/x.tpc')

    def test_download_urls_dispatch(self):
        file_url = kernel_downloader.URL_ROOT + 'naif/a/b.bsp'
        page_url = kernel_downloader.URL_ROOT + 'naif/a/dir'
        with mock.patch.object(
            kernel_downloader, 'download_kernel'
        ) as mock_file, mock.patch.object(
            kernel_downloader, 'download_kernels_from_webpage'
        ) as mock_page:
            kernel_downloader.download_urls(file_url, page_url)
        mock_file.assert_called_once()
        mock_page.assert_called_once()

    def test_download_kernel_skips_existing(self, tmp_path):
        url = kernel_downloader.URL_ROOT + 'naif/a/b.bsp'
        with mock.patch.object(
            kernel_downloader, '_check_kernel_exists_locally',
            return_value=True,
        ), mock.patch.object(
            kernel_downloader, 'download_file'
        ) as mock_dl:
            kernel_downloader.download_kernel(url)
        mock_dl.assert_not_called()

    def test_download_kernel_downloads(self):
        url = kernel_downloader.URL_ROOT + 'naif/a/b.bsp'
        with mock.patch.object(
            kernel_downloader, '_check_kernel_exists_locally',
            return_value=False,
        ), mock.patch.object(
            kernel_downloader, 'download_file'
        ) as mock_dl:
            kernel_downloader.download_kernel(url)
        mock_dl.assert_called_once()
        called_url, local_path = mock_dl.call_args[0]
        assert called_url == url
        assert local_path.endswith('b.bsp')

    def test_get_kernel_paths_from_webpage(self):
        page = '\n'.join(
            [
                '<html>junk<!--start data_content-->',
                '<img src="/icons/x.gif"> <a href="de440.bsp">de440</a>',
                '<img src="/icons/x.gif"> <a href="subdir/">sub</a>',
                'not a row',
                '</table>rest',
            ]
        )
        url = kernel_downloader.URL_ROOT + 'naif/generic_kernels/spk'
        opened = mock.MagicMock()
        opened.read.return_value = page.encode()
        with mock.patch(
            'urllib.request.urlopen', return_value=opened
        ) as mock_open:
            paths = kernel_downloader.get_kernel_paths_from_webpage(url)
        mock_open.assert_called_once_with(url)
        assert paths == [url + '/de440.bsp']

    def _fake_response(self, chunks, fail_after=None):
        response = mock.MagicMock()
        response.__enter__.return_value = response
        response.headers = {'Content-Length': str(sum(map(len, chunks)))}
        queue = list(chunks) + [b'']

        def read(n):
            if fail_after is not None and len(queue) <= fail_after:
                raise OSError('connection dropped')
            return queue.pop(0)

        response.read.side_effect = read
        return response

    def test_download_file_atomic(self, tmp_path):
        target = str(tmp_path / 'sub' / 'file.bsp')
        with mock.patch(
            'urllib.request.urlopen',
            return_value=self._fake_response([b'DA', b'TA']),
        ):
            kernel_downloader.download_file('http://x/file.bsp', target)
        assert open(target, 'rb').read() == b'DATA'
        assert not os.path.exists(target + '.temp')

    def test_download_file_cleans_up_partial(self, tmp_path):
        # A mid-stream failure must leave NEITHER the target nor the
        # temp file behind
        target = str(tmp_path / 'sub' / 'file.bsp')
        with mock.patch(
            'urllib.request.urlopen',
            return_value=self._fake_response([b'DA', b'TA'], fail_after=2),
        ):
            with pytest.raises(OSError):
                kernel_downloader.download_file('http://x/file.bsp', target)
        assert not os.path.exists(target)
        assert not os.path.exists(target + '.temp')


class TestWireframeContract:
    """Wireframe plotting contracts (reference common_testing.py:80-145)."""

    def test_radec_wireframe(self, observation):
        import matplotlib.pyplot as plt

        ax = observation.plot_wireframe_radec(show=False)
        assert ax.get_xlabel() == 'Right Ascension'
        assert ax.get_ylabel() == 'Declination'
        assert ax.xaxis_inverted()
        assert len(ax.lines) > 0
        plt.close('all')

    def test_km_and_angular_wireframes(self, observation):
        import matplotlib.pyplot as plt

        for fn in (
            observation.plot_wireframe_km,
            observation.plot_wireframe_angular,
        ):
            ax = fn(show=False)
            assert len(ax.lines) > 0
            plt.close('all')

    def test_xy_wireframe(self, observation):
        import matplotlib.pyplot as plt

        ax = observation.plot_wireframe_xy(show=False)
        assert len(ax.lines) > 0
        plt.close('all')

    def test_formatting_dict_materialises_on_read(self):
        # Regression: the lazy defaults dict only filled via
        # __missing__, so .get()/.keys() readers (including
        # _get_wireframe_kw itself) saw an EMPTY dict on fresh
        # sessions - dropping all styling and, critically, the
        # per-plot coordinate transform (wireframes rendered in the
        # wrong coordinate system; the FITS WIREFRAME HDU was wrong).
        from planetmapper_tpu.body import _LazyFormattingDict

        d = _LazyFormattingDict()
        assert d.get('grid', {}).get('linestyle') == ':'
        d2 = _LazyFormattingDict()
        assert 'limb' in d2.keys()
        d3 = _LazyFormattingDict()
        assert 'terminator' in d3
        # user customisations made before first read survive
        d4 = _LazyFormattingDict()
        dict.__setitem__(d4, 'grid', {'color': 'r'})
        assert d4.get('grid') == {'color': 'r'}
        assert d4.get('limb', {}).get('linewidth') == 0.5
        # len/bool/copy/eq/repr are reads too
        d5 = _LazyFormattingDict()
        assert len(d5) > 0 and bool(d5)
        d6 = _LazyFormattingDict()
        c = d6.copy()
        assert isinstance(c, dict) and c.get('grid', {}) != {}
        d7 = _LazyFormattingDict()
        assert 'grid' in repr(d7)

    def test_xy_wireframe_artists_carry_transform(self, observation):
        # Regression companion: the xy wireframe's artists must use the
        # angular->xy affine (composed with transData), not raw
        # transData - their DATA are angular coordinates.
        import matplotlib.pyplot as plt

        ax = observation.plot_wireframe_xy(show=False)
        assert all(
            ln.get_transform() is not ax.transData for ln in ax.lines
        )
        plt.close('all')


class TestAPIContract:
    """_get_default_init_kwargs must match the actual signatures."""

    def _check(self, cls, skip_instance_keys=(), **setup_kwargs):
        obj = cls(**setup_kwargs)
        for k, default in obj._get_default_init_kwargs().items():
            if k in setup_kwargs or k in skip_instance_keys:
                continue
            assert obj._get_kwargs()[k] == default, k
        signature = inspect.signature(cls)
        for k, default in cls._get_default_init_kwargs().items():
            try:
                signature_default = signature.parameters[k].default
            except KeyError:
                continue  # only in **kwargs: tested via the parent class
            if signature_default is inspect.Signature.empty:
                continue
            assert signature_default == default, k

    def test_body(self):
        self._check(Body, target='Jupiter', utc='2005-01-01')

    def test_body_xy(self):
        self._check(BodyXY, target='Jupiter', utc='2005-01-01', nx=4, ny=3)

    def test_basic_body(self):
        self._check(BasicBody, target='Jupiter', utc='2005-01-01')

    def test_observation(self):
        self._check(
            ObservationClass,
            path=observation_fits(),
            # filled in from the FITS header rather than the signature
            skip_instance_keys=('target', 'utc', 'observer'),
        )


class TestGUIWidgetConstruction:
    """
    Execute the widget-building code with tk fully mocked (the reference
    tests the GUI the same way, tests/test_gui.py:19-44): no display is
    needed and wiring mistakes in the construction paths still surface.
    """

    def test_build_gui(self, observation):
        from planetmapper_tpu import gui as gui_module

        g = gui_module.GUI()
        g.observation = observation
        with mock.patch.object(gui_module, 'tk', mock.MagicMock()), \
                mock.patch.object(gui_module, 'ttk', mock.MagicMock()), \
                mock.patch.object(
                    gui_module, 'FigureCanvasTkAgg', mock.MagicMock()
                ), \
                mock.patch.object(
                    gui_module, 'NavigationToolbar2Tk', mock.MagicMock()
                ), \
                mock.patch.object(gui_module, 'Figure') as mock_figure, \
                mock.patch(
                    'planetmapper_tpu._gui_settings.tk', mock.MagicMock()
                ), \
                mock.patch(
                    'planetmapper_tpu._gui_settings.ttk', mock.MagicMock()
                ):
            mock_figure.return_value = mock.MagicMock()
            g.root = mock.MagicMock()
            g.build_gui()
            # all tabs built and keyboard bound
            assert g.notebook is not None
            assert g.root.bind.called
            assert set(g.numeric_entries) == {
                'x0', 'y0', 'r0', 'rotation', 'step'
            }
            assert g._wcs_offset_vars
            assert g.coords_tab_labels

    def test_run_with_mocked_tk(self, observation):
        from planetmapper_tpu import gui as gui_module

        g = gui_module.GUI(allow_open=False)
        g.observation = observation
        with mock.patch.object(gui_module, 'tk', mock.MagicMock()), \
                mock.patch.object(gui_module, 'ttk', mock.MagicMock()), \
                mock.patch.object(
                    gui_module, 'FigureCanvasTkAgg', mock.MagicMock()
                ), \
                mock.patch.object(
                    gui_module, 'NavigationToolbar2Tk', mock.MagicMock()
                ), \
                mock.patch.object(gui_module, 'Figure', mock.MagicMock()), \
                mock.patch(
                    'planetmapper_tpu._gui_settings.tk', mock.MagicMock()
                ), \
                mock.patch(
                    'planetmapper_tpu._gui_settings.ttk', mock.MagicMock()
                ), \
                mock.patch.object(
                    gui_module.GUI, 'after_setting_observation'
                ) as mock_after:
            g.run()
            mock_after.assert_called_once_with()


class TestProjections:
    """Named-projection support beyond the four built-ins (VERDICT #6)."""

    NAMED = ('stere', 'gnom', 'eqc', 'merc', 'mill', 'cea', 'sinu', 'moll')

    def test_round_trips(self):
        from planetmapper_tpu.ops import projections as P

        rng = np.random.default_rng(2)
        lon = rng.uniform(-170, 170, 200)
        lat = rng.uniform(-85, 85, 200)
        for kind in self.NAMED:
            t = P.ProjectionTransformer(
                kind=kind, a=71492.0, b=71492.0, lon_0=5.0,
                lat_0=20.0 if kind in P._AZIMUTHAL_KINDS else 0.0,
            )
            x, y = t.transform(lon, lat)
            lon2, lat2 = t.transform(x, y, direction='INVERSE')
            ok = np.isfinite(lon2)
            assert ok.mean() > 0.4  # gnomonic drops the far hemisphere
            dlon = np.abs((lon2 - lon + 180) % 360 - 180)[ok]
            assert np.max(dlon) < 1e-9
            assert np.max(np.abs(lat2 - lat)[ok]) < 1e-9

    def test_goldens(self):
        import math

        from planetmapper_tpu.ops import projections as P

        t = P.ProjectionTransformer(kind='moll', a=1.0)
        x, _ = t.transform(180.0, 0.0)
        assert x == pytest.approx(2 * math.sqrt(2))
        _, y = t.transform(0.0, 90.0)
        assert y == pytest.approx(math.sqrt(2))
        _, y = P.ProjectionTransformer(kind='merc', a=1.0).transform(0, 45.0)
        assert y == pytest.approx(math.log(math.tan(math.radians(67.5))))
        # CEA is equal-area: the full map has area 4 pi a^2
        t = P.ProjectionTransformer(kind='cea', a=1.0)
        x1, y1 = t.transform(180.0, 90.0)
        assert 2 * x1 * 2 * y1 == pytest.approx(4 * np.pi)

    def test_proj_string_parsing(self):
        from planetmapper_tpu.ops.projections import (
            transformer_from_proj_string,
        )

        t = transformer_from_proj_string(
            '+proj=moll +a=71492000 +lon_0=10 +axis=wnu +type=crs'
        )
        assert t.kind == 'moll'
        assert t.west_positive
        assert t.a == pytest.approx(71492000)
        try:
            import pyproj  # noqa: F401

            has_pyproj = True
        except ImportError:
            has_pyproj = False
        if has_pyproj:
            # unknown names fall back to pyproj when it is available
            t2 = transformer_from_proj_string('+proj=bonne +a=1 +type=crs')
            assert t2 is not None
        else:
            with pytest.raises(NotImplementedError):
                transformer_from_proj_string('+proj=bonne +a=1 +type=crs')



    def test_cylindrical_longitude_wrap(self):
        # PROJ wraps input longitudes into lon_0 +/- 180 (adjlon): lon
        # 270 must project onto the negative-x half and round-trip
        from planetmapper_tpu.ops import projections as P

        for kind in ('merc', 'eqc', 'cea', 'mill', 'sinu', 'moll'):
            t = P.ProjectionTransformer(kind=kind, a=1.0)
            x, _ = t.transform(270.0, 10.0)
            x_neg, _ = t.transform(-90.0, 10.0)
            assert x == pytest.approx(x_neg), kind
            lon2, lat2 = t.transform(*t.transform(270.0, 10.0),
                                     direction='INVERSE')
            assert lon2 % 360.0 == pytest.approx(270.0, abs=1e-9), kind
            assert lat2 == pytest.approx(10.0, abs=1e-9), kind

    def test_ortho_far_hemisphere_masked(self):
        # PROJ refuses points behind the limb; the parallel projection
        # would otherwise fold them onto the visible disc (drawing
        # far-side gridlines and both pole labels on wireframes)
        from planetmapper_tpu.ops import projections as P

        t = P.ProjectionTransformer(kind='ortho', a=1.0, b=0.9, lat_0=30.0)
        x, y = t.transform(180.0, -30.0)  # antipode of the centre
        assert np.isnan(x) and np.isnan(y)
        x, y = t.transform(0.0, -90.0)  # far pole
        assert np.isnan(x) and np.isnan(y)
        x, y = t.transform(0.0, 30.0)  # centre
        assert x == pytest.approx(0.0) and np.isfinite(y)

    def test_ortho_false_easting(self):
        from planetmapper_tpu.ops import projections as P

        t = P.ProjectionTransformer(kind='ortho', a=1.0, b=1.0, x_0=5.0)
        x, _ = t.transform(0.0, 0.0)
        assert x == pytest.approx(5.0)
        lon2, lat2 = t.transform(5.0, 0.0, direction='INVERSE')
        assert lon2 == pytest.approx(0.0, abs=1e-9)
        assert lat2 == pytest.approx(0.0, abs=1e-9)

    def test_inverse_out_of_range_nans_both(self):
        from planetmapper_tpu.ops import projections as P

        t = P.ProjectionTransformer(kind='eqc', a=1.0)
        lon, lat = t.transform(0.0, 2.0, direction='INVERSE')
        assert np.isnan(lon) and np.isnan(lat)
        t = P.ProjectionTransformer(kind='sinu', a=1.0)
        lon, lat = t.transform(0.5, 1.9, direction='INVERSE')
        assert np.isnan(lon) and np.isnan(lat)

    def test_lonlat_west_positive(self):
        from planetmapper_tpu.ops.projections import (
            transformer_from_proj_string,
        )

        t = transformer_from_proj_string(
            '+proj=longlat +axis=wnu +type=crs'
        )
        x, y = t.transform(10.0, 5.0)
        assert (x, y) == (-10.0, 5.0)
        lon, lat = t.transform(x, y, direction='INVERSE')
        assert (lon, lat) == (10.0, 5.0)

    def test_direction_enum_like(self):
        from planetmapper_tpu.ops import projections as P

        class FakeDirection:
            name = 'INVERSE'

            def __str__(self):
                return 'TransformDirection.INVERSE'

        t = P.ProjectionTransformer(kind='eqc', a=1.0)
        lon, lat = t.transform(0.5, 0.25, direction=FakeDirection())
        assert lat == pytest.approx(np.degrees(0.25))

    def test_ellipsoidal_params_rejected_without_pyproj(self):
        from planetmapper_tpu.ops.projections import (
            ProjStringError,
            transformer_from_proj_string,
        )

        try:
            import pyproj  # noqa: F401
            pytest.skip('pyproj installed: falls back instead')
        except ImportError:
            pass
        # PROJ computes ellipsoidal Mercator for +b != +a: silently
        # using the sphere would be degree-scale wrong
        with pytest.raises(NotImplementedError, match='pyproj'):
            transformer_from_proj_string(
                '+proj=merc +a=71492 +b=66854 +type=crs'
            )
        # but spherical-only PROJ kinds legitimately ignore +b
        t = transformer_from_proj_string(
            '+proj=moll +a=71492 +b=66854 +type=crs'
        )
        assert t.kind == 'moll'
        with pytest.raises(ProjStringError, match='6378km'):
            transformer_from_proj_string('+proj=merc +a=6378km +type=crs')

    def test_mollweide_near_pole(self):
        from planetmapper_tpu.ops import projections as P

        t = P.ProjectionTransformer(kind='moll', a=1.0)
        lat = np.array([89.9, 89.99, 89.999, -89.99])
        x, y = t.transform(np.zeros_like(lat), lat)
        lon2, lat2 = t.transform(x, y, direction='INVERSE')
        assert np.max(np.abs(lat2 - lat)) < 1e-6
        # residual of the defining equation must be ~0
        import math
        theta = np.arcsin(np.clip(y / math.sqrt(2), -1, 1))
        resid = 2 * theta + np.sin(2 * theta) - np.pi * np.sin(
            np.deg2rad(lat)
        )
        assert np.max(np.abs(resid)) < 1e-9

    def test_false_easting_northing_and_eqc_lat0(self):
        from planetmapper_tpu.ops import projections as P

        t = P.ProjectionTransformer(
            kind='eqc', a=1.0, lat_0=10.0, x_0=0.25, y_0=0.5
        )
        x, y = t.transform(0.0, 10.0)
        assert x == pytest.approx(0.25)
        assert y == pytest.approx(0.5)
        lon2, lat2 = t.transform(x, y, direction='INVERSE')
        assert lon2 == pytest.approx(0.0, abs=1e-12)
        assert lat2 == pytest.approx(10.0, abs=1e-12)

    def test_generate_map_coordinates_with_proj_string(self, observation):
        import math

        body = observation
        proj = body.create_proj_string('moll')
        # Mollweide spans x in [-2 sqrt(2) a, 2 sqrt(2) a]
        lim = 2 * math.sqrt(2) * body.r_eq
        xs = np.linspace(-lim, lim, 41)
        lons, lats, xx, yy, transformer, info = (
            body.generate_map_coordinates(
                projection=proj, projection_x_coords=xs,
                projection_y_coords=xs / 2,
            )
        )
        assert lons.shape == lats.shape == (41, 41)
        finite = np.isfinite(lons)
        assert finite.any()
        assert np.nanmax(np.abs(lats[finite])) <= 90.0
        # Backplane map machinery works end-to-end on the custom grid
        emission = body.get_backplane_map(
            'EMISSION', projection=proj, projection_x_coords=xs,
            projection_y_coords=xs / 2,
        )
        assert emission.shape == lons.shape
        assert np.isfinite(emission).any()


class TestDeviceInterp:
    """Device map-interpolation kernels vs scipy ground truth."""

    def test_large_source_stays_on_device_path(self):
        # sources past the old 1024 gate (up to _DEVICE_SOLVE_MAX) run
        # the device-resident solve + tiled/windowed evaluation instead
        # of falling to host FITPACK; values must still match scipy
        import scipy.interpolate

        from planetmapper_tpu.ops import interp_device

        assert interp_device._DEVICE_SOLVE_MAX >= 2048
        n = 1100
        rng = np.random.default_rng(5)
        img = rng.normal(size=(n, n))
        my, mx = 48, 64
        yy, xx = np.meshgrid(
            np.linspace(2, n - 3, my), np.linspace(2, n - 3, mx),
            indexing='ij',
        )
        x = xx + 2 * np.sin(yy / 50.0)
        y = yy + 3 * np.cos(xx / 70.0)
        out = interp_device.spline_interpolation_device(
            img, x, y, interpolation=1, warn_nan=False,
            propagate_nan=False, spline_smoothing=0,
        )
        sp = scipy.interpolate.RectBivariateSpline(
            np.arange(n), np.arange(n), img, kx=1, ky=1, s=0
        )
        ref = sp.ev(y.ravel(), x.ravel()).reshape(x.shape)
        # ~1.6e-4: the f32 basis's coordinate cancellation at ~1100-px
        # magnitudes (grows linearly with grid size; the small-map
        # chunked evaluator has no f64 re-centring). Measured identical
        # on the pre-gate host-FITPACK path - not a regression, just
        # the f32 evaluation noise floor at this size.
        np.testing.assert_allclose(out, ref, atol=5e-4)

    def test_out_of_grid_clamps_like_scipy(self):
        import scipy.interpolate

        from planetmapper_tpu.ops import interp_device

        rng = np.random.default_rng(3)
        img = rng.normal(size=(20, 24))
        x = rng.uniform(-5, 28, 400).reshape(20, 20)
        y = rng.uniform(-5, 24, 400).reshape(20, 20)
        sp = scipy.interpolate.RectBivariateSpline(
            np.arange(20), np.arange(24), img, kx=3, ky=3, s=0
        )
        ref = sp.ev(y.ravel(), x.ravel()).reshape(x.shape)
        out = interp_device.spline_interpolation_device(
            img, x, y, interpolation=3, warn_nan=False,
            propagate_nan=False, spline_smoothing=0,
        )
        np.testing.assert_allclose(out, ref, atol=1e-5)

    @pytest.mark.parametrize('propagate_nan', [True, False])
    def test_tiled_window_large_grid(self, propagate_nan):
        # Grid above _TILING_MIN_CELLS + map-sized sample field: engages
        # the tiled-window one-hot contraction (device-solve s=0 path).
        # One tile is scattered to exercise the full-grid fallback.
        import scipy.interpolate

        from planetmapper_tpu.ops import interp_device

        rng = np.random.default_rng(31)
        img = rng.normal(size=(460, 430)).cumsum(axis=0) * 0.05
        if propagate_nan:
            img[100:104, 200:207] = np.nan
        assert 460 * 430 > interp_device._TILING_MIN_CELLS
        v = np.linspace(0.0, 1.0, 72)[:, None]
        u = np.linspace(0.0, 1.0, 80)[None, :]
        x = 5.0 + 400.0 * (0.5 - 0.5 * np.cos(np.pi * u)) + 12.0 * v
        y = 2.0 + 440.0 * v**1.3 + 9.0 * u * v
        x = np.broadcast_to(x, (72, 80)).copy()
        y = np.broadcast_to(y, (72, 80)).copy()
        x[64:, 64:] = rng.uniform(0, 429, x[64:, 64:].shape)
        y[64:, 64:] = rng.uniform(0, 459, y[64:, 64:].shape)
        out = interp_device.spline_interpolation_device(
            img, x, y, interpolation=3, warn_nan=False,
            propagate_nan=propagate_nan, spline_smoothing=0,
        )
        from planetmapper_tpu.ops import interp

        ref = np.full(x.shape, np.nan)
        interp.spline_interpolation(
            img, x, y, ref, interpolation=3, warn_nan=False,
            propagate_nan=propagate_nan, spline_smoothing=0,
        )
        assert np.array_equal(np.isnan(out), np.isnan(ref))
        # f32 basis evaluation carries ~coordinate * 6e-8 px of effective
        # sample-position rounding (same contract as the untiled device
        # path; the tiled path's per-tile re-centring is tighter still)
        scale = np.nanmax(np.abs(ref)) if np.isfinite(ref).any() else 1.0
        np.testing.assert_allclose(
            out, ref, atol=3e-5 * max(scale, 1.0), equal_nan=True
        )

    def test_tiled_window_beyond_onehot_gate(self):
        # Coefficient grids past _ONEHOT_MAX_COEFFS previously fell back
        # to the scalarized-gather evaluator; with tiling the matmul one-hot
        # path handles them (host-FITPACK coefficients + tiled eval)
        import scipy.interpolate

        from planetmapper_tpu.ops import interp_device

        n = interp_device._ONEHOT_MAX_COEFFS + 40
        rng = np.random.default_rng(32)
        img = rng.normal(size=(n, 80)).cumsum(axis=0) * 0.02
        # one long axis is enough to demand tiling
        assert interp_device._use_tiling(n, 80, (70, 70))
        v = np.linspace(0.05, 0.95, 70)[:, None]
        u = np.linspace(0.05, 0.95, 70)[None, :]
        y = np.broadcast_to((n - 1) * v, (70, 70)).copy()
        x = np.broadcast_to(79.0 * u + 0.5 * v, (70, 70)).copy()
        out = interp_device.spline_interpolation_device(
            img, x, y, interpolation=3, warn_nan=False,
            propagate_nan=False, spline_smoothing=0,
        )
        sp = scipy.interpolate.RectBivariateSpline(
            np.arange(n), np.arange(80), img, kx=3, ky=3, s=0
        )
        ref = sp.ev(y.ravel(), x.ravel()).reshape(x.shape)
        np.testing.assert_allclose(
            out, ref, atol=1e-5 * max(np.abs(ref).max(), 1.0)
        )

    def test_tiled_window_cube(self):
        # Batched (cube) frames through the tiled contraction
        import scipy.interpolate

        from planetmapper_tpu.ops import interp_device

        rng = np.random.default_rng(33)
        cube = rng.normal(size=(3, 440, 420)).cumsum(axis=1) * 0.05
        v = np.linspace(0.02, 0.98, 66)[:, None]
        u = np.linspace(0.02, 0.98, 66)[None, :]
        y = np.broadcast_to(439.0 * v, (66, 66)).copy()
        x = np.broadcast_to(419.0 * u + 2.0 * v, (66, 66)).copy()
        out = interp_device.spline_interpolation_device(
            cube, x, y, interpolation=3, warn_nan=False,
            propagate_nan=False, spline_smoothing=0,
        )
        for i in range(3):
            sp = scipy.interpolate.RectBivariateSpline(
                np.arange(440), np.arange(420), cube[i], kx=3, ky=3, s=0
            )
            ref = sp.ev(y.ravel(), x.ravel()).reshape(x.shape)
            np.testing.assert_allclose(
                out[i], ref, atol=3e-5 * max(np.abs(ref).max(), 1.0)
            )

    def test_tiled_window_cube_nan(self):
        # Batched frames with per-frame NaN patches through the tiled
        # contraction's windowed NaN indicators, against host FITPACK
        from planetmapper_tpu.ops import interp, interp_device

        rng = np.random.default_rng(34)
        cube = rng.normal(size=(2, 440, 420)).cumsum(axis=1) * 0.05
        cube[0, 100:104, 200:207] = np.nan
        cube[1, 300:303, 50:60] = np.nan
        v = np.linspace(0.02, 0.98, 66)[:, None]
        u = np.linspace(0.02, 0.98, 66)[None, :]
        y = np.broadcast_to(439.0 * v, (66, 66)).copy()
        x = np.broadcast_to(419.0 * u + 2.0 * v, (66, 66)).copy()
        assert interp_device._use_tiling(440, 420, x.shape)
        out = np.asarray(interp_device.spline_interpolation_device(
            cube, x, y, interpolation=3, warn_nan=False,
            propagate_nan=True, spline_smoothing=0,
        ))
        for i in range(2):
            ref = np.full(x.shape, np.nan)
            interp.spline_interpolation(
                cube[i], x, y, ref, interpolation=3, warn_nan=False,
                propagate_nan=True, spline_smoothing=0,
            )
            assert np.array_equal(np.isnan(out[i]), np.isnan(ref))
            np.testing.assert_allclose(
                out[i], ref, atol=3e-5 * max(np.nanmax(np.abs(ref)), 1.0),
                equal_nan=True,
            )

    def test_smoothing_cube_per_frame_knots(self):
        import scipy.interpolate

        from planetmapper_tpu.ops import interp_device

        rng = np.random.default_rng(4)
        cube = rng.normal(size=(3, 20, 24))
        cube[1] *= 5  # different scale -> different adaptive FITPACK knots
        x = rng.uniform(0, 23, 100).reshape(10, 10)
        y = rng.uniform(0, 19, 100).reshape(10, 10)
        out = interp_device.spline_interpolation_device(
            cube, x, y, interpolation=3, warn_nan=False,
            propagate_nan=False, spline_smoothing=10.0,
        )
        for i in range(3):
            sp = scipy.interpolate.RectBivariateSpline(
                np.arange(20), np.arange(24), cube[i], kx=3, ky=3, s=10.0
            )
            ref = sp.ev(y.ravel(), x.ravel()).reshape(x.shape)
            np.testing.assert_allclose(
                out[i], ref, atol=2e-5 + 1e-5 * np.abs(ref).max()
            )


class TestDeviceSolveInterp:
    """
    The fully device-resident s=0 spline path (NaN infill + collocation
    solve + evaluation in one program) against the pure-host
    implementation (``ops.interp``) it replaces on the default path.
    """

    def _host_reference(self, img, x, y, interpolation, propagate_nan):
        from planetmapper_tpu.ops import interp

        projected = np.full(x.shape, np.nan)
        interp.spline_interpolation(
            img, x, y, projected, interpolation=interpolation,
            warn_nan=False, propagate_nan=propagate_nan,
            spline_smoothing=0,
        )
        return projected

    @pytest.mark.parametrize('interpolation', [1, 2, 3])
    @pytest.mark.parametrize('propagate_nan', [True, False])
    def test_matches_host_with_nans(self, interpolation, propagate_nan):
        from planetmapper_tpu.ops import interp_device

        rng = np.random.default_rng(7)
        img = rng.normal(size=(21, 17))
        img[3, 4] = np.nan  # isolated NaN (3x3-mean infill)
        img[10:14, 6:11] = np.nan  # NaN block (median infill inside)
        img[0, 0] = np.nan  # corner NaN
        img[5, 16] = np.inf  # inf treated as NaN
        x = rng.uniform(-2, 19, 300).reshape(15, 20)
        y = rng.uniform(-2, 23, 300).reshape(15, 20)
        out = interp_device.spline_interpolation_device(
            img, x, y, interpolation=interpolation, warn_nan=False,
            propagate_nan=propagate_nan, spline_smoothing=0,
        )
        ref = self._host_reference(
            img, x, y, interpolation, propagate_nan
        )
        assert np.array_equal(np.isnan(out), np.isnan(ref))
        np.testing.assert_allclose(out, ref, atol=2e-5, equal_nan=True)

    def test_infill_matches_host(self):
        import jax.numpy as jnp

        from planetmapper_tpu.ops import interp, interp_device

        rng = np.random.default_rng(8)
        img = rng.normal(size=(12, 9))
        img[0, :3] = np.nan
        img[5:8, 2:7] = np.nan
        img[11, 8] = np.nan
        img[2, 2] = -np.inf
        ref = interp.replace_nans_with_interpolated_values(img, False)
        cleaned, nans = interp_device._infill_device(jnp, jnp.asarray(img))
        np.testing.assert_allclose(
            np.asarray(cleaned), ref, atol=1e-12
        )
        assert np.array_equal(np.asarray(nans), np.isnan(img))

    def test_infill_all_nan(self):
        import jax.numpy as jnp

        from planetmapper_tpu.ops import interp, interp_device

        img = np.full((6, 6), np.nan)
        ref = interp.replace_nans_with_interpolated_values(img, False)
        cleaned, _ = interp_device._infill_device(jnp, jnp.asarray(img))
        np.testing.assert_allclose(np.asarray(cleaned), ref)

    def test_all_nan_frame_in_cube(self):
        from planetmapper_tpu.ops import interp_device

        rng = np.random.default_rng(9)
        cube = rng.normal(size=(3, 10, 11))
        cube[1] = np.nan
        x = rng.uniform(0, 10, 64).reshape(8, 8)
        y = rng.uniform(0, 9, 64).reshape(8, 8)
        out = interp_device.spline_interpolation_device(
            cube, x, y, interpolation=3, warn_nan=False,
            propagate_nan=False, spline_smoothing=0,
        )
        assert np.all(np.isnan(np.asarray(out)[1]))
        assert np.isfinite(np.asarray(out)[0]).all()

    def test_map_img_returns_device_array_by_default(self):
        import jax

        import planetmapper_tpu

        body = planetmapper_tpu.BodyXY(
            'Jupiter', observer='HST', utc='2005-01-01T00:00:00',
            nx=15, ny=10,
        )
        body.set_disc_params(7, 4.5, 4, 0)
        img = np.arange(150, dtype=float).reshape(10, 15)
        m = body.map_img(img, degree_interval=30)
        assert isinstance(m, jax.Array)
        m_np = body.map_img(img, degree_interval=30, as_numpy=True)
        assert isinstance(m_np, np.ndarray)
        np.testing.assert_allclose(
            np.asarray(m), m_np, equal_nan=True
        )


class TestMapEvaluatorSelection:
    """map_img takes the XLA evaluators whatever the backend says."""

    @pytest.mark.parametrize('backend', ['gpu', 'cpu'])
    def test_same_programs_on_every_backend(self, monkeypatch, backend):
        import jax

        import planetmapper_tpu
        from planetmapper_tpu.ops import interp_device, pchip_device

        body = planetmapper_tpu.BodyXY(
            'Jupiter', observer='EARTH', utc='2005-01-01', sz=24
        )
        body.set_disc_params(12, 12, 9, 0.0)
        img = np.random.default_rng(0).random((24, 24))
        expected = {
            mode: np.asarray(body.map_img(
                img, interpolation=mode, degree_interval=10
            ))
            for mode in ('linear', 'cubic', 'smooth')
        }
        monkeypatch.setattr(jax, 'default_backend', lambda: backend)
        solve = interp_device._spline_solve_eval_fn.cache_info()
        smooth = pchip_device._smooth_fn.cache_info()
        for mode, ref in expected.items():
            got = np.asarray(body.map_img(
                img, interpolation=mode, degree_interval=10
            ))
            np.testing.assert_array_equal(got, ref, err_msg=mode)
        # served by the cached XLA programs: no new program was built
        after = interp_device._spline_solve_eval_fn.cache_info()
        assert after.hits == solve.hits + 2
        assert after.currsize == solve.currsize
        after_s = pchip_device._smooth_fn.cache_info()
        assert after_s.hits == smooth.hits + 1
        assert after_s.currsize == smooth.currsize


class TestDeviceSmooth:
    """Device PCHIP 'smooth' mode vs the host scipy implementation."""

    def test_all_nan_y_map(self):
        # regression: an all-NaN y_map with finite x_map crashed with
        # "cannot convert float NaN to integer" in the box computation
        from planetmapper_tpu.ops import pchip_device

        img = np.arange(12.0).reshape(3, 4)
        x = np.full((5, 6), 1.0)
        y = np.full((5, 6), np.nan)
        out = pchip_device.smooth_interpolation_device(
            img, x, y, propagate_nan=True, oversample_by=5,
            max_oversampled_img_size=10000,
        )
        assert np.isnan(out).all()

    def test_translation_reuses_program(self):
        # regression: the compiled program was keyed on the box's
        # absolute pixel coordinates, so translating the map (GUI
        # scrubbing, disc fitting) recompiled every call
        from planetmapper_tpu.ops import interp, pchip_device

        rng = np.random.default_rng(17)
        img = rng.normal(size=(40, 40)).cumsum(axis=0) * 0.1
        base_x = rng.uniform(8.0, 16.0, (9, 11))
        base_y = rng.uniform(9.0, 17.0, (9, 11))
        pchip_device._smooth_fn.cache_clear()
        for shift in (0.0, 3.0, 11.0):
            out = pchip_device.smooth_interpolation_device(
                img, base_x + shift, base_y + shift,
                propagate_nan=True, oversample_by=5,
                max_oversampled_img_size=10000,
            )
            ref = np.full(base_x.shape, np.nan)
            interp.smooth_interpolation(
                img, base_x + shift, base_y + shift, ref,
                propagate_nan=True, oversample_by=5,
                max_oversampled_img_size=10000,
            )
            assert np.array_equal(np.isnan(out), np.isnan(ref))
            np.testing.assert_allclose(
                np.nan_to_num(out), np.nan_to_num(ref), atol=2e-6
            )
        assert pchip_device._smooth_fn.cache_info().currsize == 1

    @pytest.mark.parametrize('propagate_nan', [True, False])
    def test_matches_host(self, propagate_nan):
        from planetmapper_tpu.ops import interp, pchip_device

        rng = np.random.default_rng(11)
        img = rng.normal(size=(24, 19))
        img[3, 4] = np.nan
        img[10:13, 5:9] = np.nan
        img[:, 0] = np.nan
        x = rng.uniform(-3, 21, 300).reshape(15, 20)
        y = rng.uniform(-3, 26, 300).reshape(15, 20)
        x[0, :4] = np.nan
        ref = np.full(x.shape, np.nan)
        interp.smooth_interpolation(
            img, x, y, ref, propagate_nan=propagate_nan,
            oversample_by=5, max_oversampled_img_size=10000,
        )
        out = pchip_device.smooth_interpolation_device(
            img, x, y, propagate_nan=propagate_nan, oversample_by=5,
            max_oversampled_img_size=10000,
        )
        assert np.array_equal(np.isnan(out), np.isnan(ref))
        np.testing.assert_allclose(out, ref, atol=2e-5, equal_nan=True)

    @pytest.mark.parametrize('propagate_nan', [True, False])
    def test_tiled_window_path_matches_host(self, propagate_nan):
        # Large oversampled grid + map-sized sample field: engages the
        # tiled-window sampler (_TILE/_WIN in pchip_device). One tile is
        # scattered across the whole grid to force its full-grid
        # fallback branch.
        from planetmapper_tpu.ops import interp, pchip_device

        rng = np.random.default_rng(21)
        img = rng.normal(size=(120, 110)).cumsum(axis=1) * 0.1
        img[20:24, 30:37] = np.nan
        img[0, :] = np.nan
        # smooth (map-like) coordinate fields over a 72x80 output
        v = np.linspace(0.0, 1.0, 72)[:, None]
        u = np.linspace(0.0, 1.0, 80)[None, :]
        x = 5.0 + 100.0 * (0.5 - 0.5 * np.cos(np.pi * u)) + 3.0 * v
        y = 2.0 + 110.0 * v**1.2 + 4.0 * u * v
        x = np.broadcast_to(x, (72, 80)).copy()
        y = np.broadcast_to(y, (72, 80)).copy()
        # scatter one tile's points over the full image -> fallback
        x[64:, 64:] = rng.uniform(0, 109, x[64:, 64:].shape)
        y[64:, 64:] = rng.uniform(0, 119, y[64:, 64:].shape)
        # some invalid + out-of-box samples
        x[0, :3] = np.nan
        y[5, 5] = -20.0
        # sanity: this configuration must actually use the tiled path
        # (gate shared with interp_device)
        from planetmapper_tpu.ops import interp_device

        n_box = 120 * 5 - 4
        assert interp_device._use_tiling(
            n_box, 110 * 5 - 4, (72, 80)
        )
        assert x.size >= pchip_device._TILE**2
        ref = np.full(x.shape, np.nan)
        interp.smooth_interpolation(
            img, x, y, ref, propagate_nan=propagate_nan,
            oversample_by=5, max_oversampled_img_size=10000,
        )
        out = pchip_device.smooth_interpolation_device(
            img, x, y, propagate_nan=propagate_nan, oversample_by=5,
            max_oversampled_img_size=10000,
        )
        assert np.array_equal(np.isnan(out), np.isnan(ref))
        np.testing.assert_allclose(out, ref, atol=2e-4, equal_nan=True)

    def test_oversample_fallback(self):
        # max_oversampled_img_size forces a lower (or unit) oversampling
        # factor; semantics must still match the host implementation
        from planetmapper_tpu.ops import interp, pchip_device

        rng = np.random.default_rng(12)
        img = rng.normal(size=(30, 40))
        x = rng.uniform(0, 39, 100).reshape(10, 10)
        y = rng.uniform(0, 29, 100).reshape(10, 10)
        for max_size in (50, 80, 10000):
            ref = np.full(x.shape, np.nan)
            interp.smooth_interpolation(
                img, x, y, ref, propagate_nan=True,
                oversample_by=5, max_oversampled_img_size=max_size,
            )
            out = pchip_device.smooth_interpolation_device(
                img, x, y, propagate_nan=True, oversample_by=5,
                max_oversampled_img_size=max_size,
            )
            assert np.array_equal(np.isnan(out), np.isnan(ref)), max_size
            np.testing.assert_allclose(
                out, ref, atol=2e-5, equal_nan=True
            )

    def test_all_nan_image(self):
        from planetmapper_tpu.ops import pchip_device

        img = np.full((10, 10), np.nan)
        x = np.linspace(0, 9, 25).reshape(5, 5)
        out = pchip_device.smooth_interpolation_device(
            img, x, x.T.copy(), propagate_nan=True, oversample_by=5,
            max_oversampled_img_size=10000,
        )
        assert np.all(np.isnan(out))

