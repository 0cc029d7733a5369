"""
The DAF/SPK writer and the seeded synthetic kernel set
(planetmapper_tpu.kernels.synthetic): round trips through the readers,
reproducibility, and the text kernels' contents.
"""

import filecmp
import os

import numpy as np
import pytest

from common import KERNEL_PATH

from planetmapper_tpu.core.time import LeapSecondData, utc_string_to_et
from planetmapper_tpu.kernels import synthetic
from planetmapper_tpu.kernels.daf import read_daf_python, write_daf
from planetmapper_tpu.kernels.pool import KernelPool
from planetmapper_tpu.kernels.spk import (
    chebyshev_state,
    pack_type_2,
    parse_spk_file,
)


@pytest.fixture(scope='module')
def segments():
    return parse_spk_file(os.path.join(KERNEL_PATH, synthetic.SPK_NAME))


class TestDafWriter:
    def test_many_arrays_span_summary_records(self, tmp_path):
        # 25 summaries fit one summary record (ND=2, NI=6): 60 arrays
        # need a chain of three (summary, name) record pairs
        arrays = [
            ((float(i), float(i) + 1.0), (i, 0, 1, 2), np.arange(i + 1.0))
            for i in range(60)
        ]
        path = str(tmp_path / 'many.bsp')
        write_daf(path, arrays, names=[f'A{i}' for i in range(60)])
        daf = read_daf_python(path)
        assert (daf.nd, daf.ni) == (2, 6)
        assert daf.idword.startswith('DAF/SPK')
        assert len(daf.summaries) == 60
        for i, summary in enumerate(daf.summaries):
            assert summary.doubles == (float(i), float(i) + 1.0)
            assert summary.integers[:4] == (i, 0, 1, 2)
            start, end = summary.integers[4:]
            np.testing.assert_array_equal(
                daf.words(start, end), np.arange(i + 1.0)
            )

    def test_native_reader_agrees(self, tmp_path):
        from planetmapper_tpu.kernels import daf_native

        arrays = [((0.0, 1.0), (7, 0, 1, 2), np.linspace(0, 1, 300))]
        path = str(tmp_path / 'one.bsp')
        write_daf(path, arrays)
        native = daf_native.read_daf_native(path)
        if native is None:
            pytest.skip('no C++ compiler for the native DAF reader')
        py = read_daf_python(path)
        assert native.summaries == py.summaries
        np.testing.assert_array_equal(
            native.words(1, py._data.size), py.words(1, py._data.size)
        )

    def test_type_2_round_trip(self, tmp_path):
        rng = np.random.default_rng(1)
        coeffs = rng.normal(size=(5, 3, 7))
        words = pack_type_2(100.0, 20.0, coeffs)
        path = str(tmp_path / 'cheb.bsp')
        write_daf(path, [((100.0, 200.0), (99, 10, 1, 2), words)])
        (seg,) = parse_spk_file(path)
        assert (seg.target, seg.center, seg.frame_id, seg.data_type) == (
            99, 10, 1, 2
        )
        assert (seg.start_et, seg.end_et) == (100.0, 200.0)
        np.testing.assert_array_equal(seg.data.coeffs, coeffs)
        np.testing.assert_array_equal(
            seg.data.mids, 110.0 + 20.0 * np.arange(5)
        )
        np.testing.assert_array_equal(seg.data.radii, np.full(5, 10.0))


class TestSyntheticSet:
    def test_two_runs_byte_identical(self, tmp_path):
        a = synthetic.write_kernel_set(tmp_path / 'a')
        b = synthetic.write_kernel_set(tmp_path / 'b')
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b))
        assert {synthetic.SPK_NAME, synthetic.LSK_NAME,
                synthetic.PCK_NAME} <= set(names)
        for name in names:
            assert filecmp.cmp(
                os.path.join(a, name), os.path.join(b, name), shallow=False
            ), name

    def test_ensure_regenerates_stale_set(self, tmp_path):
        directory = str(tmp_path / 'kernels')
        assert synthetic.ensure_kernel_set(directory) == directory
        spk = os.path.join(directory, synthetic.SPK_NAME)
        mtime = os.path.getmtime(spk)
        assert synthetic.ensure_kernel_set(directory) == directory
        assert os.path.getmtime(spk) == mtime  # current: left alone
        with open(os.path.join(directory, 'VERSION'), 'w') as f:
            f.write('stale')
        synthetic.ensure_kernel_set(directory)
        with open(os.path.join(directory, 'VERSION')) as f:
            assert f.read() == synthetic.SET_VERSION
        assert not [n for n in os.listdir(tmp_path) if n.startswith('.')]

    def test_bodies_and_spans(self, segments):
        by_target = {}
        for seg in segments:
            assert seg.data_type == 2 and seg.frame_id == 1
            by_target.setdefault(seg.target, []).append(seg)
        expected = (
            {10, 199, 299, 399, 301, 499, 599, 699, 799, 899, 999}
            | set(range(1, 10)) | {501, 502, 503, 504, 505, 635, -48}
        )
        assert set(by_target) == expected
        start, end = synthetic.LONG_SPAN
        assert start <= synthetic.calendar_to_j2000_seconds(1995, 1, 1)
        assert end >= synthetic.calendar_to_j2000_seconds(2035, 1, 1)
        for body in (10, 3, 5, 6, 301, 399, 501, 502, 503, 504):
            (seg,) = by_target[body]
            assert (seg.start_et, seg.end_et) == (start, end)
        for year in (2005, 2009):
            et = synthetic.calendar_to_j2000_seconds(year, 1, 1)
            assert any(s.covers(et) for s in by_target[-48])

    def test_matches_analytic_orbits(self, segments):
        # tolerance: fit_tolerance_km of the orbit (the generator checks
        # it between nodes of three records; here at random epochs)
        rng = np.random.default_rng(2)
        for seg in segments:
            t = rng.uniform(seg.start_et, seg.end_et, 64)
            state = np.asarray(chebyshev_state(seg.data, t))
            ref = synthetic.analytic_position(seg.target, t)
            scale = max(float(np.abs(ref).max()), 1.0)
            err = np.abs(state[:, :3] - ref).max()
            assert err <= 2 * synthetic.fit_tolerance_km(scale), (
                seg.target, err
            )
            # velocity: derivative of the analytic orbit (central
            # difference over +-1 s; its truncation is far below 1e-6)
            vel = (
                synthetic.analytic_position(seg.target, t + 1.0)
                - synthetic.analytic_position(seg.target, t - 1.0)
            ) / 2.0
            np.testing.assert_allclose(state[:, 3:], vel, atol=1e-6)

    def test_jupiter_seen_from_earth(self):
        # two-body planets from Standish's mean elements: Jupiter at
        # 2005-01-01 was ~5.5 AU from Earth, seen within ~11 deg of
        # opposition's phase geometry (sub-solar near sub-observer point)
        import planetmapper_tpu as pm

        pm.set_kernel_path(KERNEL_PATH)
        body = pm.Body('Jupiter', observer='EARTH', utc='2005-01-01')
        assert body.target_distance / synthetic.AU_KM == pytest.approx(
            5.48, abs=0.05
        )
        dlon = (body.subsol_lon - body.subpoint_lon + 180.0) % 360.0 - 180.0
        assert 0.0 < abs(dlon) < 12.0


class TestTextKernels:
    @pytest.fixture(scope='class')
    def pool(self):
        pool = KernelPool()
        pool.furnsh(os.path.join(KERNEL_PATH, synthetic.LSK_NAME))
        pool.furnsh(os.path.join(KERNEL_PATH, synthetic.PCK_NAME))
        return pool

    def test_lsk(self, pool):
        lsk = LeapSecondData.from_pool(pool.text)
        assert lsk.delta_t_a == 32.184
        assert lsk.k == 1.657e-3
        assert lsk.eb == 1.671e-2
        assert (lsk.m0, lsk.m1) == (6.239996, 1.99096871e-7)
        assert len(lsk.leap_table) == 28
        assert lsk.leap_table[-1][0] == 37.0
        # CSPICE str2et of 2005-01-01T00:00:00 with naif0012.tls
        assert utc_string_to_et('2005-01-01T00:00:00', lsk) == (
            pytest.approx(157809664.1839331, abs=1e-6)
        )

    def test_pck(self, pool):
        np.testing.assert_array_equal(
            pool.bodvar(599, 'RADII'), [71492.0, 71492.0, 66854.0]
        )
        np.testing.assert_array_equal(
            pool.bodvar(599, 'POLE_RA'), [268.056595, -0.006499, 0.0]
        )
        np.testing.assert_array_equal(
            pool.bodvar(599, 'PM'), [284.95, 870.536, 0.0]
        )
        for body in (10, 199, 299, 399, 301, 499, 501, 502, 503, 504, 505,
                     699, 799, 899, 999):
            assert pool.bodvar(body, 'RADII', 3).shape == (3,)
            assert pool.bodvar(body, 'POLE_DEC', 3).shape == (3,)
        assert 'BODY635_RADII' not in pool  # as in pck00010: a BasicBody
